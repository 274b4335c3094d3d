"""The arithmetic of the metrics that more than one metric file reads.

A quantity whose cells report different end-to-end metrics is one metric
a kind of cell (`<quantity>.count` moves `kmer_rate`); the files of a
quantity's kinds all read it here. Each reader takes the `window.Run` and
returns a number, or None where the run has nothing to read.
"""

from __future__ import annotations

import re

import torch

from kcbench import kernel_bytes


def rate(run):
    """k-mer instances of the window's units over the window."""
    if not run.units or run.window_s <= 0:
        return None
    return sum(u.raw for u in run.units) / run.window_s


def retry_rounds(run):
    """Retry rounds a unit of the window (route slack, store
    rehash and hop-2 fallback, from its DAKCStats); each replays the whole
    job or batch."""
    if not run.units:
        return None
    return sum(u.retries for u in run.units) / len(run.units)


def launches_per_step(run):
    """Device kernel records (copies and sets left out) that start inside
    the traced units' calls into the port, over those units' scan steps
    (rounds x reads / (PEs x chunk_reads))."""
    t = run.trace
    if t is None or not t.steps:
        return None
    kernels = [op for op in t.ops_in(t.port_spans())
               if not op[2].startswith(("Memcpy", "Memset"))]
    return len(kernels) / t.steps if kernels else None


def sent_per_kmer(run):
    """Payload slots put on the wire (DAKCStats.sent_words) per k-mer
    instance over the window's units: what the L3 compressor or
    the super-k-mer segmentation leaves to route."""
    raw = sum(u.raw for u in run.units)
    return sum(u.sent for u in run.units) / raw if raw else None


def wire_bytes_per_kmer(run):
    """The route's exact padded bytes (DAKCStats.wire_bytes) per k-mer
    instance over the window's units."""
    raw = sum(u.raw for u in run.units)
    return sum(u.wire for u in run.units) / raw if raw else None


def load_max_over_mean(run):
    """The busiest owner's received items over the mean owner's
    (DAKCStats.load_max_over_mean), averaged over the window's units."""
    if not run.units:
        return None
    return sum(u.load for u in run.units) / len(run.units)


def kernel_roofline(run, kernel, nbytes):
    """The metered unit's calls of `kernel`: their least time over their
    device time, in %. Least time: `nbytes(slots, live)` of each call (the
    harness's wrapper of the `ops` entry point records both) over
    `kernel_bytes.HBM_BYTES_PER_S`. Device time: the profiler's records
    of kernels whose names hold `kernel`, in the metered unit, paired
    with the calls in order. Neither side is capped."""
    t = run.trace
    if t is None:
        return None
    calls = t.calls.get(kernel, [])
    kernels = t.ops_in(t.spans_named("metered"), kernel)
    n = min(len(calls), len(kernels))
    device_s = sum(e - s for s, e, _ in kernels[:n]) / 1e9
    if n == 0 or device_s <= 0:
        return None
    bound_s = (sum(nbytes(*c) for c in calls[:n])
               / kernel_bytes.HBM_BYTES_PER_S)
    return 100.0 * bound_s / device_s


def hash_insert_live(table_keys, table_counts, keys, weights, *a, **kw):
    """What the meter keeps of an `ops.hash_insert` call: its batch slots
    and its live items (keys not the sentinel, with non-zero weights)."""
    live = (keys != kw["sentinel_val"]) & (weights != 0)
    return keys.numel(), torch.count_nonzero(live)


def hash_insert_roofline(run):
    return kernel_roofline(run, "hash_insert",
                           kernel_bytes.hash_insert_bytes)


def device_idle(run):
    """The share of the traced window (the `kcbench.traced` span, no
    meter) in which no device operation ran: 1 - the union of the
    profiler's kernel, copy and set intervals over the window, in %."""
    t = run.trace
    if t is None or t.window() is None:
        return None
    lo, hi = t.window()
    busy, _ = t.busy(lo, hi)
    return 100.0 * (1.0 - busy / (hi - lo)) if busy else None


def aten_share(run):
    """The share of the traced window's device time in operations the
    port did not write, in %. Rule: an operation is the port's when its
    name holds, as a whole word, a `__global__` function of the port's
    `csrc/*.cu` (read from the checkout's sources); every other kernel,
    copy and set is PyTorch's or its libraries'."""
    t = run.trace
    if t is None or t.window() is None or not t.port_kernels:
        return None
    lo, hi = t.window()
    port = re.compile(r"(?<!\w)(?:%s)(?!\w)"
                      % "|".join(sorted(map(re.escape, t.port_kernels))))
    total = others = 0
    for s, e, name in t.device_ops:
        d = min(e, hi) - max(s, lo)
        if d > 0:
            total += d
            if not port.search(name):
                others += d
    return 100.0 * others / total if total else None
