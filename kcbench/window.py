"""The measured window, common to every loop: set-up's end, the window,
the traced units after it, and the judge.

A loop (`kcbench/loops/<loop>.py`, named by the mix's `loop`) builds an
object in set-up with three methods, and drives the port in closed loop:
the next unit starts when the last has returned.

- `run_unit(i, run)`: unit `i` (a job, a cycle), appending a `Unit` to
  `run.units` and recording a span around each call into the port;
- `close_window(run)`: after the window's last unit, keep what the judge
  needs of it;
- `judge(run)`: once every unit has run, free the program's state and set
  `run.checks` and `run.failed` against the plain reference.

The window starts after set-up and ends when the first unit that finishes
after `seconds` ends. With `trace`, the loop then goes on under the
profiler: units for `TRACE_SECONDS` in the span `kcbench.traced`, then
one unit in `kcbench.metered` with the kernel meter on (the `METER`
entries of the cell's per-layer metric files). Those units are judged
too, and counted in no end-to-end metric.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from kcbench import tracing

TRACE_SECONDS = 3.0
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


@dataclass
class Unit:
    """One unit of the port's work (a job, a batch), from its DAKCStats."""
    seconds: float
    raw: int
    sent: int
    wire: int
    load: float
    retries: int
    steps: int


@dataclass
class Run:
    device: torch.device
    setup_s: float = 0.0
    window_s: float = 0.0
    units: List[Unit] = field(default_factory=list)
    peak_window: int = 0
    peak_total: int = 0
    store: Optional[Tuple[int, int, int]] = None  # slots, bytes/slot, distinct
    trace: Optional[tracing.Trace] = None
    attempted: int = 0
    failed: int = 0
    checks: Dict[str, int] = field(default_factory=dict)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def free(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def peak(dev: torch.device) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of `t` (pinned where it comes from the card), so that
    what the judge keeps takes no device memory."""
    if t.device.type != "cuda":
        return t.clone()
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)


def unit_from_stats(seconds: float, st, steps_a_round: int) -> Unit:
    retries = (st.retry_route_slack + st.retry_store_rehash
               + st.retry_hop2_fallback)
    return Unit(seconds=seconds, raw=int(st.raw_kmers),
                sent=int(st.sent_words), wire=int(st.wire_bytes),
                load=float(st.load_max_over_mean), retries=int(retries),
                steps=steps_a_round * (1 + int(retries)))


def worst(into: Dict[str, int], nums: Dict[str, int]) -> None:
    for name, v in nums.items():
        into[name] = max(into.get(name, 0), int(v))


def meters(cell: dict) -> dict:
    """The `METER` entries of the cell's per-layer metric files: the `ops`
    entry points to wrap in the metered unit, each with its recorder."""
    from kcbench import spec
    out = {}
    for m in cell["per_layer"]:
        out.update(getattr(spec.metric_module(m["name"]), "METER", {}))
    return out


def drive(loop, cell: dict, seconds: float, trace: bool, dev: torch.device,
          t_start: float) -> Run:
    """Run the window (and with `trace` the traced units) of a loop built
    in set-up, then judge. `t_start`: the process's start on the host
    clock, for `setup_s`."""
    run = Run(device=dev)
    sync(dev)
    peak_setup = peak(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    run.setup_s = t0 - t_start
    i = 0
    while True:
        loop.run_unit(i, run)
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    run.window_s = time.perf_counter() - t0
    run.peak_window = peak(dev)
    times = sorted(u.seconds for u in run.units)
    log(f"setup {run.setup_s:.3f} s; window {run.window_s:.3f} s, "
        f"{len(times)} units of {times[0]:.3f}-{times[-1]:.3f} s "
        f"(median {times[len(times) // 2]:.3f}): "
        + " ".join(f"{u.seconds:.3f}" for u in run.units))
    loop.close_window(run)
    run.attempted = len(run.units)
    if trace:
        from repro_torch.kernels import ops
        meter = tracing.Meter(ops, meters(cell))
        traced = Run(device=dev)
        with tracing.profiler(dev) as prof:
            with tracing.span("traced"):
                t1 = time.perf_counter()
                while True:
                    loop.run_unit(i, traced)
                    i += 1
                    if time.perf_counter() - t1 >= TRACE_SECONDS:
                        break
            steps = sum(u.steps for u in traced.units)
            with meter.active(), tracing.span("metered"):
                loop.run_unit(i, traced)
                i += 1
            sync(dev)
        run.trace = tracing.read_profile(
            prof, tracing.port_kernel_names(CSRC))
        run.trace.calls = meter.calls()
        run.trace.steps = steps
        run.attempted += len(traced.units)
    run.peak_total = max(peak_setup, peak(dev))
    loop.judge(run)
    return run


def log(msg: str) -> None:
    print(f"kcbench: {msg}", file=sys.stderr, flush=True)
