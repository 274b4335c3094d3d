"""Named host spans of the counter's launch path, on the profiler's clock.

`span(name)` is `torch.profiler.record_function("repro_torch." + name)`
while a profiler runs, so that each span lies on the clock the device's
kernels are on and an idle gap of the card can be laid against what the
host was doing; otherwise it is one shared null context, at the cost of
one module attribute read. There is no switch: a `torch.profiler.profile`
over a count turns them on.

The spans are flat: none opens inside another, so each is an outermost
host operation of the trace. `fabsp` places them:

- `place`: the read set's move to the device, once a call;
- `plan`: the store sizing and the valid-slot sample, once a call, and
  each retry round's capacities;
- `compress`: a scan step's extraction (or super-k-mer segmentation)
  through L3 and an injected route drop, up to the first route;
- `route`: every route of the scan step (compaction, owners,
  `route_lanes`);
- `insert`: the scan step's receiver (decode and store insert, the spill
  sink, or the stacked receiver's append);
- `histogram`: the round's histogram of the store or of the stacked tiles;
- `stats`: the round's one device-to-host read of its stats.
"""

from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _profiler

PREFIX = "repro_torch."
NAMES = ("place", "plan", "compress", "route", "insert", "histogram",
         "stats")

_OFF = contextlib.nullcontext()


def span(name: str):
    """The span `name` (one of `NAMES`) while a profiler runs, else a
    null context. The flag is read through its module on every call: the
    profiler sets it when it starts."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(PREFIX + name)
    return _OFF
