"""Run one cell of BENCHMARK.json once on the card and print its result.

    python kcbench/run.py --workload count.synth26 --seed 7 --seconds 30 \\
        --trace 0

From the root of a checkout. `--trace 0` prints the cell's end-to-end
metrics, `--trace 1` its per-layer metrics, read from the spans, counters
and profiler trace of the units after the window (`window`). The last line
of standard output is one JSON object: correct, attempted, failed,
metrics, device, with --trace 1 breakdown, and last `checks`, each number
the judge compared beside its limit; the last lines of standard error
repeat the checks.

Exits non-zero and prints no result without enough CUDA cards, when the
port cannot be imported, or when a module of JAX or of the JAX package
`repro` is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))
# Build and kernel caches at fixed places inside the checkout, so that
# only a cell's first run there builds. The port's kernel libraries go to
# build/repro_torch_kernels, which it fixes itself, inside the checkout too.
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "nv_compute_cache")):
    os.environ[_var] = str(ROOT / "build" / "kcbench" / _sub)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole: `repro_torch` is not `repro`."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def result(run, cell: dict, trace: bool, spec) -> dict:
    import torch

    from kcbench.reference import LIMITS, verdict

    entries = cell["per_layer"] if trace else cell["end_to_end"]
    metrics = {}
    for m in entries:
        value = spec.metric_module(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = run.device
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": cell["entry"]["chips"],
              "memory_peak_bytes": run.peak_total}
    out = {"correct": False, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if trace and run.trace is not None and run.trace.window():
        lo, hi = run.trace.window()
        device["busy_s"] = run.trace.busy(lo, hi)[0] / 1e9
        device["window_s"] = (hi - lo) / 1e9
        out["breakdown"] = run.trace.breakdown()
    checks = {name: {"value": v, "limit": LIMITS[name]}
              for name, v in run.checks.items()}
    out["correct"] = verdict(run.checks, run.failed)
    out["card"] = card_limit()
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from kcbench import spec
    cell = spec.load_cell(args.workload)
    import torch
    chips = cell["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"kcbench: {args.workload} needs {chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    loop = spec.loop_module(cell["traffic"]["loop"])
    run = loop.run(cell, args.seed, args.seconds, bool(args.trace), T_START)
    bad = forbidden_modules()
    if bad:
        print(f"kcbench: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 3
    out = result(run, cell, bool(args.trace), spec)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
