"""The port's own spans in a traced run: host time and device idle by layer.

The port names its launch path's stages with flat host spans
(`torch.profiler.record_function`, `repro_torch.<stage>`), so they are
outermost host operations of the harness's thread and `read_profile`
keeps them among `Trace.host_ops`, as it stands. A reader here takes the
spans that start inside the traced window (`kcbench.traced`: the metered
job after it is left out) and lays them against the window's idle gaps
(`Trace.busy`): the idle inside a span is the exact overlap of the two,
so a gap across a span's edge counts only its inside part. "A step"
divides by the traced units' scan steps (`Trace.steps`), "a job" by the
`kcbench.job` spans inside the window.

Each reader returns None when the trace holds no port span, as a build
of the port without them gives.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from kcbench import tracing

PREFIX = "repro_torch."
STEP = ("compress", "route", "insert")


def _spans(t: tracing.Trace) -> Optional[Tuple[Tuple[int, int], list]]:
    """(the window, the port's spans that start inside it), or None."""
    win = t.window() if t is not None else None
    if win is None:
        return None
    got = [h for h in t.host_ops
           if h[2].startswith(PREFIX) and win[0] <= h[0] <= win[1]]
    return (win, got) if got else None


def _overlap(spans, gaps: List[Tuple[int, int]]) -> int:
    """ns of `gaps` inside `spans`; each list sorted and disjoint."""
    total, j = 0, 0
    for s, e, _ in spans:
        while j < len(gaps) and gaps[j][1] <= s:
            j += 1
        k = j
        while k < len(gaps) and gaps[k][0] < e:
            total += min(e, gaps[k][1]) - max(s, gaps[k][0])
            k += 1
    return total


def _idle_in(run, stage: str) -> Optional[int]:
    got = _spans(run.trace)
    if got is None:
        return None
    win, spans = got
    _, gaps = run.trace.busy(*win)
    return _overlap([s for s in spans if s[2] == PREFIX + stage], gaps)


def _per_step(run, ns: Optional[int]) -> Optional[float]:
    if ns is None or not run.trace.steps:
        return None
    return ns / 1e6 / run.trace.steps


def step_host_ms(run) -> Optional[float]:
    """Host ms of a scan step's `compress`, `route` and `insert` spans:
    the launch path's host time a step, whether or not the card waits."""
    got = _spans(run.trace)
    if got is None:
        return None
    names = {PREFIX + s for s in STEP}
    return _per_step(run, sum(e - s for s, e, n in got[1] if n in names))


def plan_idle_ms(run) -> Optional[float]:
    """Device idle ms a job inside the `plan` spans (the store's sizing
    sample and each round's capacities)."""
    ns = _idle_in(run, "plan")
    if ns is None:
        return None
    lo, hi = run.trace.window()
    jobs = [s for s in run.trace.spans_named("job") if lo <= s[0] <= hi]
    return ns / 1e6 / len(jobs) if jobs else None


def compress_idle_ms(run) -> Optional[float]:
    """Device idle ms a scan step inside the `compress` spans."""
    return _per_step(run, _idle_in(run, "compress"))


def route_idle_ms(run) -> Optional[float]:
    """Device idle ms a scan step inside the `route` spans."""
    return _per_step(run, _idle_in(run, "route"))


def insert_idle_ms(run) -> Optional[float]:
    """Device idle ms a scan step inside the `insert` spans."""
    return _per_step(run, _idle_in(run, "insert"))


def idle_unspanned(run) -> Optional[float]:
    """The share of the traced window's device idle time that lies in no
    port span, in %: what the spans leave unexplained."""
    got = _spans(run.trace)
    if got is None:
        return None
    win, spans = got
    _, gaps = run.trace.busy(*win)
    idle = sum(e - s for s, e in gaps)
    if not idle:
        return None
    return 100.0 * (idle - _overlap(spans, gaps)) / idle
