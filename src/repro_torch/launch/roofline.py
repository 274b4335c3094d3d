"""Roofline terms of the dry-run's records (counterpart of
`repro.launch.roofline`), for one NVIDIA H100 SXM a device.

Per (arch x shape x mesh) cell, per device and step:
  compute term    = max(traced FLOPs, model FLOPs) / peak FLOP/s
  memory term     = max(traced bytes, the parameter floor) / HBM rate
  collective term = collective bytes / link rate

The dry-run (`launch/dryrun.py`) traces the per-device program, so its
FLOPs and bytes are already per device, as XLA's cost analysis of the
partitioned module is in the JAX package. Also per cell:
  MODEL_FLOPS = 6 N D (train; N_active for MoE) / 2 N D (inference), plus
  the attention score and value products, which 6 N D leaves out;
  useful_ratio = MODEL_FLOPS per device / traced FLOPs (remat shows as a
  ratio below 1).

`roofline_terms(rec, hw)` takes a `Hardware` row; the default is `H100`,
each rate from the card's data sheet (derived beside it). `pod_bw` is the
rate between hosts, which the terms do not use yet, as the JAX module's
DCN figure is not.

    PYTHONPATH=src python -m repro_torch.launch.roofline --dir \\
        experiments/dryrun_torch [--mesh pod16x16] [--markdown]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, NamedTuple, Optional


class Hardware(NamedTuple):
    name: str
    peak_flops: float     # dense FLOP/s a device, the compute dtype
    hbm_bw: float         # bytes/s a device
    link_bw: float        # bytes/s a device, one direction, within a host
    pod_bw: float         # bytes/s a device, one direction, between hosts


H100 = Hardware(
    name="h100-sxm",
    # Dense bf16 on the tensor cores: 989.4 TFLOP/s at the 700 W limit
    # (data sheet; 1979 with 2:4 sparsity), the figure PERF.md section 2
    # uses for the model-FLOP share.
    peak_flops=989e12,
    # HBM3, 5 stacks: 3.35 TB/s (data sheet).
    hbm_bw=3.35e12,
    # NVLink 4: 18 links x 25 GB/s a direction = 450 GB/s a direction
    # (the data sheet's 900 GB/s counts both).
    link_bw=450e9,
    # One 400 Gb/s InfiniBand NDR port a GPU (a DGX H100 has eight, one a
    # card): 400e9 / 8 = 50 GB/s a direction.
    pod_bw=50e9)


def load_cells(dirpath: str, mesh: Optional[str] = None) -> List[dict]:
    cells = []
    for f in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        r["_mesh_name"] = os.path.basename(f).split("__")[2].split(".")[0]
        if mesh and r["_mesh_name"] != mesh:
            continue
        cells.append(r)
    return cells


def analytic_flops_per_chip(rec: dict) -> float:
    """MODEL_FLOPS per device: 6 N_active D (train) or 2 N_active D
    (inference), plus the attention products, 4 S_eff H hd a token and
    attention layer (S_eff the causal half-band, at most the window)."""
    from repro_torch.configs import get_config
    cfg = get_config(rec["arch"])
    cell = _cell_of(rec)
    chips = 1
    for v in rec["mesh"].values():
        chips *= v
    tokens = _tokens_of(rec)
    n_active = rec.get("active_param_count") or rec.get("param_count")
    mult = 6 if rec["kind"] == "train" else 2
    core = mult * n_active * tokens
    s_ctx = cell.seq_len
    attn_layers = sum(1 for kind in cfg.period
                      if kind in ("attn", "attn_local", "moe")) \
        * cfg.num_periods
    if "mamba_shared_attn" in cfg.period:
        attn_layers += cfg.num_periods
    s_eff = s_ctx / 2 if cfg.causal else s_ctx
    if cfg.sliding_window:
        s_eff = min(s_eff, cfg.sliding_window)
    attn = (mult / 2) * 4 * s_eff * cfg.num_heads * cfg.resolved_head_dim \
        * attn_layers * tokens
    return (core + attn) / chips


def roofline_terms(rec: dict, hw: Hardware = H100
                   ) -> Optional[Dict[str, float]]:
    """The cell's terms on `hw`, or None for a skipped or failed cell."""
    if "skipped" in rec or "error" in rec:
        return None
    chips = 1
    for v in rec["mesh"].values():
        chips *= v
    hlo_flops = rec["cost"].get("flops", 0.0)
    model_flops = analytic_flops_per_chip(rec)
    flops = max(hlo_flops, model_flops)
    bytes_acc = rec["cost"].get("bytes accessed", 0.0)
    # memory floor: parameter (+ gradient + optimiser) traffic a step
    param_bytes = 4.0 * (rec.get("param_count") or 0) / chips
    mem_mult = 3.0 if rec["kind"] == "train" else 0.5
    bytes_eff = max(bytes_acc, mem_mult * param_bytes)
    coll = rec["collectives"]["total_bytes"]
    t_compute = flops / hw.peak_flops
    t_memory = bytes_eff / hw.hbm_bw
    t_coll = coll / hw.link_bw
    dominant = max(("compute", t_compute), ("memory", t_memory),
                   ("collective", t_coll), key=lambda kv: kv[1])[0]
    total_overlap = max(t_compute, t_memory, t_coll)
    total_serial = t_compute + t_memory + t_coll
    t_useful = model_flops / hw.peak_flops
    return {
        "arch": rec["arch"], "shape": rec["shape"],
        "mesh": rec["_mesh_name"], "chips": chips,
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "model_flops_per_chip": model_flops,
        "hlo_flops_per_chip": hlo_flops,
        "useful_ratio": (model_flops / hlo_flops) if hlo_flops
        else float("inf"),
        "bound_time_s": total_overlap,
        # the model-FLOP share if the step ran at its resource limits:
        # 'overlap' hides the two smaller terms under the largest (an upper
        # bound), 'serial' adds them (a lower bound)
        "mfu_overlap": t_useful / total_overlap if total_overlap else 0.0,
        "mfu_serial": t_useful / total_serial if total_serial else 0.0,
        "temp_gb": rec.get("memory", {}).get("temp_size_in_bytes", 0) / 1e9,
    }


def _cell_of(rec: dict):
    """The record's shape cell: one of `SHAPES`, or its own ('cell')."""
    from repro_torch.configs.base import SHAPES, ShapeCell
    if "cell" in rec:
        return ShapeCell(**rec["cell"])
    return SHAPES[rec["shape"]]


def _tokens_of(rec: dict) -> float:
    cell = _cell_of(rec)
    if rec["kind"] == "decode":
        return cell.global_batch          # one token a sequence a step
    return cell.global_batch * cell.seq_len


def render(rows: List[dict], markdown: bool = False) -> str:
    cols = ["arch", "shape", "mesh", "t_compute_s", "t_memory_s",
            "t_collective_s", "dominant", "mfu_overlap", "mfu_serial",
            "temp_gb"]
    out = []
    if markdown:
        out.append("| " + " | ".join(cols) + " |")
        out.append("|" + "---|" * len(cols))
        for r in rows:
            out.append("| " + " | ".join(_fmt(r[c]) for c in cols) + " |")
    else:
        out.append(",".join(cols))
        for r in rows:
            out.append(",".join(_fmt(r[c]) for c in cols))
    return "\n".join(out)


def _fmt(v) -> str:
    if isinstance(v, float):
        if v == 0:
            return "0"
        if abs(v) < 1e-3 or abs(v) >= 1e4:
            return f"{v:.3e}"
        return f"{v:.4f}"
    return str(v)


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(
        description="roofline terms of the dry-run's records (H100)")
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rows = []
    skips = []
    for rec in load_cells(args.dir, args.mesh):
        t = roofline_terms(rec)
        if t is None:
            skips.append((rec["arch"], rec["shape"], rec["_mesh_name"],
                          rec.get("skipped", rec.get("error", "?"))))
        else:
            rows.append(t)
    text = render(rows, args.markdown)
    if skips:
        text += "\n\nskipped cells:\n" + "\n".join(
            f"  {a} {s} {m}: {r}" for a, s, m, r in skips)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return text


if __name__ == "__main__":
    main()
