"""Spans, the kernel meter and the reduction of a profiler trace.

The harness records a span (`torch.profiler.record_function`, a no-op
with the profiler off) around each call into the port, named by its loop
(`kcbench.job` around `count_kmers`), and around the traced units,
`kcbench.traced` (no meter) and `kcbench.metered` (`Meter` on).

`read_profile` turns the profiler's raw events into a `Trace`: the device
operations (kernels, copies, sets), the harness's spans and the outermost
host operations of the thread that holds the spans. Times are in
nanoseconds on the profiler's clock, which it shares between host and
device events.
"""

from __future__ import annotations

import bisect
import contextlib
import re
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

SPAN = "kcbench."
Interval = Tuple[int, int, str]


def span(name: str):
    return torch.profiler.record_function(SPAN + name)


def port_kernel_names(csrc: Path) -> frozenset:
    """The `__global__` functions the port's CUDA sources define."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)"
                     r"\s*)?(\w+)\s*\(", re.S)
    names = set()
    for src in sorted(csrc.glob("*.cu")):
        names.update(pat.findall(src.read_text()))
    return frozenset(names)


class Meter:
    """While `active`, wraps entry points of the port's `ops` module, each
    named in `recorders` with a function that takes the call's arguments
    and returns what to keep of it (a metric file's `METER`, such as the
    batch slots and a device tensor of the live items). What it keeps stays
    as returned until `calls` reads it, after the run, turning tensors into
    ints. An entry point the module no longer has is left out."""

    def __init__(self, ops, recorders: Dict[str, Callable]):
        self._ops = ops
        self._recorders = dict(recorders)
        self._calls: Dict[str, list] = {n: [] for n in self._recorders}

    def _wrap(self, name: str, orig: Callable, record: Callable) -> Callable:
        def fn(*a, **kw):
            self._calls[name].append(record(*a, **kw))
            return orig(*a, **kw)
        # the entry point counts its launches on the module's name
        fn.launches = getattr(orig, "launches", 0)
        return fn

    @contextlib.contextmanager
    def active(self):
        orig = {n: getattr(self._ops, n) for n in self._recorders
                if hasattr(self._ops, n)}
        wrapped = {n: self._wrap(n, f, self._recorders[n])
                   for n, f in orig.items()}
        for n, fn in wrapped.items():
            setattr(self._ops, n, fn)
        try:
            yield self
        finally:
            for n, fn in wrapped.items():
                orig[n].launches = fn.launches
                setattr(self._ops, n, orig[n])

    def calls(self) -> Dict[str, List[tuple]]:
        return {n: [tuple(int(x) for x in c) for c in cs]
                for n, cs in self._calls.items()}


@dataclass
class Trace:
    device_ops: List[Interval]      # sorted by start
    spans: List[Interval]           # the harness's spans, sorted by start
    host_ops: List[Interval]        # outermost host ops, sorted, disjoint
    port_kernels: frozenset = frozenset()
    calls: Dict[str, List[Tuple[int, int]]] = field(default_factory=dict)
    steps: int = 0                  # scan steps in the traced units

    def spans_named(self, name: str) -> List[Interval]:
        return [s for s in self.spans if s[2] == SPAN + name]

    def window(self) -> Optional[Tuple[int, int]]:
        """The `kcbench.traced` span: the traced window without the
        meter."""
        got = self.spans_named("traced")
        return (got[0][0], got[0][1]) if got else None

    def port_spans(self) -> List[Interval]:
        """The spans around calls into the port inside the traced window:
        every harness span there but `traced` and `metered`."""
        win = self.window()
        if win is None:
            return []
        skip = (SPAN + "traced", SPAN + "metered")
        return [s for s in self.spans
                if s[2] not in skip and win[0] <= s[0] <= win[1]]

    def ops_in(self, intervals, name_part: str = "") -> List[Interval]:
        """Device ops that start inside any of `intervals` (whose names
        contain `name_part`)."""
        out = []
        for lo, hi, _ in intervals:
            i = bisect.bisect_left(self.device_ops, (lo,))
            while i < len(self.device_ops) and self.device_ops[i][0] < hi:
                if name_part in self.device_ops[i][2]:
                    out.append(self.device_ops[i])
                i += 1
        return out

    def busy(self, lo: int, hi: int) -> Tuple[int, List[Tuple[int, int]]]:
        """(ns in which any device op ran, the idle gaps) within [lo, hi]."""
        busy, gaps, cur = 0, [], lo
        for s, e, _ in self.device_ops:
            if s >= hi:             # sorted by start: the rest are later
                break
            s, e = max(s, lo), min(e, hi)
            if e <= cur:
                continue
            if s > cur:
                gaps.append((cur, s))
                cur = s
            busy += e - cur
            cur = e
        if cur < hi:
            gaps.append((cur, hi))
        return busy, gaps

    def host_label(self, t: int) -> str:
        """What the host was doing at `t`: the innermost harness span and
        the outermost host op (or 'python' between ops)."""
        inner = "harness"
        j = bisect.bisect_right(self.spans, (t, float("inf"))) - 1
        while j >= 0:
            s, e, name = self.spans[j]
            if e >= t and name not in (SPAN + "traced", SPAN + "metered"):
                inner = name[len(SPAN):]
                break
            j -= 1
        i = bisect.bisect_right(self.host_ops, (t, float("inf"))) - 1
        op = "python"
        if i >= 0 and self.host_ops[i][0] <= t <= self.host_ops[i][1]:
            op = self.host_ops[i][2]
        return f"{inner}/{op}"

    def breakdown(self, top: int = 10) -> Optional[dict]:
        win = self.window()
        if win is None:
            return None
        by_op: Dict[str, float] = defaultdict(float)
        for s, e, name in self.device_ops:
            s, e = max(s, win[0]), min(e, win[1])
            if e > s:
                by_op[name[:160]] += (e - s) / 1e9
        _, gaps = self.busy(*win)
        by_gap: Dict[str, float] = defaultdict(float)
        for s, e in gaps:
            by_gap[self.host_label((s + e) // 2)] += (e - s) / 1e9
        rank = lambda d: [[k, v] for k, v in
                          sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(by_op), "idle_gaps": rank(by_gap)}


def _raw_events(prof):
    """(name, on_device, start_ns, end_ns, thread, annotation) of every
    event of the profiler's raw kineto results."""
    dev_cpu = torch.autograd.DeviceType.CPU
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        yield (e.name(), e.device_type() != dev_cpu, start,
               start + e.duration_ns(), e.start_thread_id(),
               e.is_user_annotation())


def read_profile(prof, port_kernels: frozenset = frozenset()) -> Trace:
    device, spans, host = [], [], []
    for name, on_device, start, end, thread, note in _raw_events(prof):
        harness = name.startswith(SPAN) or name.startswith("ProfilerStep")
        if on_device:
            if not (harness or note):
                device.append((start, end, name))
        elif name.startswith(SPAN):
            spans.append((start, end, name, thread))
        elif not harness:
            host.append((start, end, name, thread))
    main = spans[0][3] if spans else None
    host.sort(key=lambda h: (h[0], -h[1]))
    outer, cur_end = [], None
    for s, e, name, thread in host:
        if thread == main and (cur_end is None or s >= cur_end):
            outer.append((s, e, name))
            cur_end = e
    device.sort()
    spans.sort()
    return Trace(device_ops=device, spans=[s[:3] for s in spans],
                 host_ops=outer, port_kernels=port_kernels)


def profiler(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)
