"""The port's dry-run (`repro_torch.launch.dryrun`) on the CPU: against the
JAX package's `repro.launch.dryrun` compiled in a 4-device subprocess, the
meta kernels' counts against PERF.md's bound column, and every cell of
the (16, 16) mesh traced.

Against JAX (a reduced qwen1.5-0.5b on a (data=2, model=2) mesh, a train,
a prefill and a decode cell), with these tolerances:
- `argument_size_in_bytes`: equal. Both are each leaf's bytes over the
  mesh axes its spec shards it on, and the specs are equal
  (tests/test_torch_specs.py, tests/test_torch_sharding.py).
- FLOPs: within [1.0, 1.6] x JAX's `analytic_flops_per_chip` (the remat
  recompute of the layers' forward lifts a train step to about 1.37 x;
  XLA:CPU's own count misses the oneDNN products, so it is no yardstick).
- Collectives, per kind (ROADMAP section 3 says why they differ): the
  port derives them from the specs, XLA chooses its own. all-gather bytes
  within [0.5, 2] x JAX's; the gradient and tensor-parallel reductions
  (all-reduce plus reduce-scatter, which XLA emits as all-reduces) within
  [1/3, 3] x; the total within [1/3, 3] x; the all-to-alls and permutes
  XLA adds for its own reshardings at most 10 % of its total, and the
  port has none. Counts: the port counts executions, the JAX parser ops in
  the program text, so each kind the port models runs at least as often
  as JAX lists it.
"""

import dataclasses
import json

import pytest
import torch

from _torch_parity import run_jax
from repro.configs import applicable_shapes as japplicable
from repro.configs import get_config as jget_config
from repro_torch.configs import ARCH_IDS, SHAPES, reduced_config
from repro_torch.configs.base import ShapeCell
from repro_torch.kernels import meta, ops
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, device_array

CELLS = {"tiny_train": (128, 8, "train"), "tiny_prefill": (128, 4, "prefill"),
         "tiny_decode": (128, 4, "decode")}
ARCH = "qwen1.5-0.5b"

JAX_BODY = """
import json
from jax.sharding import Mesh
import repro.configs as C
from repro.configs import reduced_config
from repro.configs.base import SHAPES, ShapeCell
from repro.launch import dryrun as jd, roofline as jr
cfg = reduced_config("qwen1.5-0.5b")
for name, (seq, batch, kind) in json.loads(I["cells"].tobytes()).items():
    SHAPES[name] = ShapeCell(name, seq, batch, kind)
C.get_config = lambda a: cfg
jd.get_config = lambda a: cfg
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
out = {}
for name in json.loads(I["cells"].tobytes()):
    rec = jd.lower_cell("qwen1.5-0.5b", name, mesh, num_microbatches=2)
    rec["analytic_flops"] = jr.analytic_flops_per_chip(rec)
    out[name] = rec
O["json"] = np.frombuffer(json.dumps(out).encode(), np.uint8)
"""


@pytest.fixture(scope="module")
def jax_recs(tmp_path_factory):
    import numpy as np
    cells = np.frombuffer(json.dumps(CELLS).encode(), np.uint8)
    out = run_jax(tmp_path_factory.mktemp("dryrun"), JAX_BODY,
                  {"cells": cells}, devices=4)
    return json.loads(out["json"].tobytes().decode())


@pytest.fixture(scope="module")
def port_recs():
    mesh = Mesh(device_array(list(range(4)), (2, 2)), ("data", "model"))
    cfg = reduced_config(ARCH)
    return {name: dryrun.lower_cell(ARCH, ShapeCell(name, *cell), mesh,
                                    num_microbatches=2, config=cfg)
            for name, cell in CELLS.items()}


@pytest.mark.parametrize("cell", list(CELLS))
def test_argument_bytes_equal_jax(jax_recs, port_recs, cell):
    assert port_recs[cell]["memory"]["argument_size_in_bytes"] == \
        jax_recs[cell]["memory"]["argument_size_in_bytes"]
    assert port_recs[cell]["param_count"] == jax_recs[cell]["param_count"]


@pytest.mark.parametrize("cell", list(CELLS))
def test_flops_within_the_model_count(jax_recs, port_recs, cell):
    ratio = port_recs[cell]["cost"]["flops"] / jax_recs[cell][
        "analytic_flops"]
    assert 1.0 <= ratio <= 1.6, ratio
    assert port_recs[cell]["cost"]["bytes accessed"] > 0


@pytest.mark.parametrize("cell", list(CELLS))
def test_collectives_held_to_jax(jax_recs, port_recs, cell):
    got, want = port_recs[cell]["collectives"], jax_recs[cell]["collectives"]

    def within(a, b, lo, hi):
        return lo * b <= a <= hi * b

    assert within(got["all-gather"]["bytes"], want["all-gather"]["bytes"],
                  0.5, 2.0)
    red = lambda c: c["all-reduce"]["bytes"] + c["reduce-scatter"]["bytes"]  # noqa: E731
    assert within(red(got), red(want), 1 / 3, 3.0)
    assert within(got["total_bytes"], want["total_bytes"], 1 / 3, 3.0)
    other = want["all-to-all"]["bytes"] + want["collective-permute"]["bytes"]
    assert other <= 0.1 * want["total_bytes"]
    assert got["all-to-all"]["bytes"] == got["collective-permute"][
        "bytes"] == 0
    for op in ("all-gather", "all-reduce"):
        assert got[op]["count"] >= want[op]["count"]


def test_record_keys_match_jax(jax_recs, port_recs):
    for cell in CELLS:
        got, want = port_recs[cell], jax_recs[cell]
        for key in ("arch", "kind", "mesh", "num_microbatches",
                    "param_count", "active_param_count"):
            assert got[key] == want[key], key
        for key in ("argument_size_in_bytes", "output_size_in_bytes",
                    "temp_size_in_bytes"):
            assert key in got["memory"]
        assert set(want["collectives"]) == set(got["collectives"])


# --- the record is the step traced in full ----------------------------------

DEEP = {"train": ShapeCell("deep_train", 64, 16, "train"),
        "prefill": ShapeCell("deep_prefill", 64, 4, "prefill")}


@pytest.mark.parametrize("kind", sorted(DEEP))
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "zamba2-1.2b"])
def test_record_counts_the_step_traced_in_full(arch, kind):
    """A config of three periods, four microbatches: the record's FLOPs,
    bytes accessed, peak and kernel calls equal a CostMode's around the
    per-device step built here from the model's entry points, run once
    through every layer and microbatch (a peak does not extrapolate from
    shallower traces, so the record must hold the full one); under
    'flash_train' rows 12 and 13 run in every attention layer of every
    microbatch, row 12 again under remat."""
    from repro_torch.models import model as model_lib
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts_lib

    base = reduced_config(arch)
    cfg = dataclasses.replace(base, num_layers=3 * len(base.period),
                              attn_impl="flash_train")
    mesh = Mesh(device_array(list(range(4)), (2, 2)), ("data", "model"))
    cell, nm = DEEP[kind], 4 if kind == "train" else 1
    rec = dryrun.lower_cell(arch, cell, mesh, num_microbatches=nm,
                            config=cfg)
    lcfg = dryrun.local_config(cfg, mesh)
    params = model_lib.abstract_params(lcfg)
    batch = {"tokens": torch.empty((cell.global_batch // 2, cell.seq_len),
                                   dtype=torch.int32, device="meta")}
    if kind == "train":
        opt = opt_lib.init(params)
        step = ts_lib.make_train_step(lcfg, ts_lib.TrainConfig(
            num_microbatches=nm))
        mode, _ = dryrun._trace(lambda: step(params, opt, batch))
    else:
        with torch.no_grad():
            mode, _ = dryrun._trace(
                lambda: model_lib.forward(params, batch, lcfg)[0])
    assert rec["cost"] == {"flops": float(mode.flops + mode.kernels.ops),
                           "bytes accessed": float(mode.bytes
                                                   + mode.kernels.bytes)}
    assert rec["memory"]["temp_size_in_bytes"] == mode.peak
    assert rec["ops_dispatched"] == mode.n_ops
    assert {n: k["calls"] for n, k in rec["kernels"].items()} == {
        n: c for n, (c, _, _) in mode.kernels.by_kernel.items()}
    n_attn = sum(k != "mamba" for k in cfg.period) * 3
    if kind == "train":
        assert rec["kernels"]["flash_attention_bwd"]["calls"] == n_attn * nm
        assert rec["kernels"]["flash_attention_fwd_lse"]["calls"] == \
            2 * n_attn * nm


# --- the meta kernels against PERF.md's bound column -------------------------

HBM, BF16 = 3.35e12, 989e12


def _meta(shape, dtype=torch.int64):
    return torch.empty(shape, dtype=dtype, device="meta")


def _charged(fn):
    cost = meta.KernelCost()
    with meta.counting(cost):
        fn()
    return cost


def _rows_and_bounds():
    rows, n, b = 8, 30720, 257
    nt = -(-n // ops.TILE)
    ids = _meta((rows, n), torch.int32)
    keys, w = _meta((rows, n)), _meta((rows, n), torch.int32)
    q = _meta((4, 16, 4096, 64), torch.bfloat16)
    o, lse = q, _meta((4, 16, 4096), torch.float32)
    band = dict(causal=True, window=None, softcap=None, scale=0.125)
    m_mers = _meta((2048, 144))
    return [
        # (row, call, expected bytes, ops, PERF.md's bound ms or None)
        ("1 hist", lambda: ops.bucket_hist(ids, b),
         rows * n * 4 + rows * nt * b * 4, 0, 0.000367),
        ("1 prefix", lambda: ops.bucket_prefix(ids, b),
         rows * n * 4 + rows * (nt + 2) * b * 4, 0, 0.000372),
        ("2", lambda: ops.bucket_positions(ids, _meta((rows, nt, b),
                                                      torch.int32)),
         rows * n * 4 * 2 + rows * nt * b * 4, 0, 0.000661),
        ("3 flags", lambda: ops.segment_accumulate(keys, w, sentinel_val=-1),
         rows * n * (8 + 4) + rows * n * (1 + 1 + 4), 0, 0.001321),
        ("3 compact", lambda: ops.segment_accumulate(
            keys, None, sentinel_val=-1, compact=True),
         rows * n * (8 + 8 + 4), 0, 0.001467),
        # rows 4 and 5 depend on the data, which meta tensors have not:
        # every batch slot live (insert_bounds of chip_smoke.py with live =
        # rows x width), every query one probe and a hit (lookup_bounds with
        # a step and a hit a query), where PERF.md's bound counts the live
        # items and walks of phase 6's data
        ("4", lambda: ops.hash_insert(
            _meta((8, 1024)), _meta((8, 1024), torch.int32),
            _meta((8, 138240)), _meta((8, 138240), torch.int32), None,
            sentinel_val=-1, dropped=_meta((8,), torch.int32), word_bits=64),
         8 * 138240 * 8 + 8 * 138240 * 4 + 8 * 138240 * (8 + 4) * 2, 0,
         None),
        ("5", lambda: ops.hash_lookup(
            _meta((8, 1024)), _meta((8, 1024), torch.int32),
            _meta((8, 1048576)), None, sentinel_val=-1, word_bits=64),
         8 * 1048576 * (8 + 4 + 4) + 8 * 1048576 * (8 + 4), 0, None),
        ("6", lambda: ops.sliding_min(m_mers, 25),
         2048 * (144 + 120) * 8, 0, 0.001291),
        ("7", lambda: ops.sliding_min_pair(m_mers, m_mers, 25),
         2048 * (144 + 120) * 8 * 2, 0, 0.002582),
        ("11", lambda: ops.flash_attention(q, q, q, **band),
         4 * q.numel() * 2, 4 * 64 * 4 * 16 * 4096 * 4097 // 2, 0.1390),
        ("12", lambda: ops.flash_attention_fwd_lse(q, q, q, **band),
         4 * q.numel() * 2 + lse.numel() * 4,
         4 * 64 * 4 * 16 * 4096 * 4097 // 2, 0.1390),
        ("13", lambda: ops.flash_attention_bwd(q, q, q, o, lse, q, **band),
         8 * q.numel() * 2 + lse.numel() * 4,
         10 * 64 * 4 * 16 * 4096 * 4097 // 2, 0.3475),
    ]


@pytest.mark.parametrize("i", range(12))
def test_meta_kernel_counts_match_the_bound_column(i):
    row, call, nbytes, nops, perf_ms = _rows_and_bounds()[i]
    ops.reset_launches()
    cost = _charged(call)
    assert cost.bytes == nbytes and cost.ops == nops, row
    # nothing launched, no launch counted
    assert not any(ops.launch_counts().values())
    assert not any(ops.f32_launch_counts().values())
    if perf_ms is not None:
        bound = max(nbytes / HBM, nops / BF16) * 1e3
        assert abs(bound - perf_ms) <= 0.5 * _last_digit(perf_ms), \
            (row, bound, perf_ms)


def _last_digit(x: float) -> float:
    """The unit of the last printed digit of PERF.md's number."""
    s = repr(x)
    return 10.0 ** -(len(s.split(".")[1]) if "." in s else 0)


def test_meta_outputs_have_the_kernel_shapes():
    ids = _meta((3, 2500), torch.int32)
    base, totals, starts = ops.bucket_prefix(ids, 9)
    assert base.shape == (3, 3, 9) and totals.shape == starts.shape == (3, 9)
    u, c, n = ops.segment_accumulate(_meta((3, 40)), None, sentinel_val=-1,
                                     compact=True)
    assert (u.dtype, c.dtype, n.shape) == (torch.int64, torch.int32, (3,))
    assert ops.sliding_min(_meta((5, 30)), 7).shape == (5, 24)
    q = _meta((2, 4, 100, 16), torch.bfloat16)
    kv = _meta((2, 2, 100, 16), torch.bfloat16)
    o, lse = ops.flash_attention_fwd_lse(q, kv, kv, causal=True, window=None,
                                         softcap=None, scale=0.25)
    assert o.shape == q.shape and lse.shape == (2, 4, 100)
    dq, dk, dv = ops.flash_attention_bwd(q, kv, kv, o, lse, q, causal=True,
                                         window=None, softcap=None,
                                         scale=0.25)
    assert dk.shape == kv.shape and dq.shape == q.shape


def test_rows_8_to_10_have_no_meta_path():
    with pytest.raises(ValueError, match="no meta path"):
        ops.kmer_extract(_meta((4, 40), torch.uint8), 13)
    with pytest.raises(ValueError, match="no meta path"):
        ops.radix_hist(_meta((2048,)), 0)
    with pytest.raises(ValueError, match="no meta path"):
        ops.segment_boundaries(_meta((2, 64)), sentinel_val=-1)


@pytest.mark.parametrize("window,q_offset", [(None, 0), (5, 0), (None, 7),
                                             (3, 11)])
def test_band_pairs_count_the_kept_pairs(window, q_offset):
    sq, skv = 13, 30
    kept = sum(1 for i in range(sq) for j in range(skv)
               if j <= q_offset + i
               and (window is None or j > q_offset + i - window))
    assert meta.band_pairs(sq, skv, causal=True, window=window,
                           q_offset=q_offset) == kept
    assert meta.band_pairs(sq, skv, causal=False, window=None) == sq * skv


def test_cost_mode_counts_products_bytes_and_peak():
    a = _meta((64, 32), torch.float32)
    b = _meta((32, 16), torch.float32)
    mode, out = dryrun._trace(lambda: (a @ b).relu().sum())
    assert out.shape == () and out.device.type == "meta"
    assert mode.flops == 2 * 64 * 32 * 16
    # mm reads a and b and writes (64, 16); relu reads and writes it; sum
    # reads it and writes a scalar
    out = 64 * 16 * 4
    assert mode.bytes == (64 * 32 + 32 * 16) * 4 + out + 2 * out + out + 4
    # the product and the relu live at once; views are free
    assert mode.peak == 2 * out


# --- every cell of the production mesh ----------------------------------------

JAX_APPLICABLE = {a: japplicable(jget_config(a)) for a in ARCH_IDS}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_cell_traces_or_skips_with_jax_reason(arch, tmp_path):
    mesh = dryrun.abstract_mesh(False)
    for shape in SHAPES:
        ok, reason = JAX_APPLICABLE[arch][shape]
        if not ok:
            continue
        rec = dryrun.lower_cell(arch, shape, mesh, compile_it=False)
        assert rec["kind"] == SHAPES[shape].kind and "memory" not in rec
    recs = dryrun.main(["--arch", arch, "--shape", "decode_32k",
                        "--no-compile", "--out", str(tmp_path)])
    ok, reason = JAX_APPLICABLE[arch]["decode_32k"]
    assert (recs[0].get("skipped") == reason) == (not ok)
    assert recs[0]["mesh"] == {"data": 16, "model": 16}


def test_main_traces_cells_in_worker_processes(tmp_path):
    """`--jobs 2` traces the cells in two worker processes and writes and
    returns the records the in-process run does (their trace times
    aside), a skipped cell with its reason."""
    argv = ["--arch", ARCH, "--mesh", "both", "--microbatches", "2"]
    recs = {}
    for jobs in ("1", "2"):
        out = tmp_path / jobs
        got = dryrun.main(argv + ["--shape", "decode_32k", "--jobs", jobs,
                                  "--out", str(out)])
        got += dryrun.main(argv + ["--shape", "long_500k", "--jobs", jobs,
                                   "--out", str(out)])
        for rec in got:
            rec.pop("lower_seconds", None)
        recs[jobs] = sorted(got, key=lambda r: (r["shape"], str(r["mesh"])))
        assert len(list(out.iterdir())) == 4
    assert recs["1"] == recs["2"]
    ok, reason = JAX_APPLICABLE[ARCH]["long_500k"]
    assert not ok and [r["skipped"] for r in recs["2"]
                       if r["shape"] == "long_500k"] == [reason] * 2
