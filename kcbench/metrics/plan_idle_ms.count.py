"""plan_idle_ms.count: device idle ms a job inside the plan spans, in the count
cells (whole count_kmers jobs), from the port's own spans. The arithmetic is
`kcbench.port_spans.plan_idle_ms`."""

from kcbench.port_spans import plan_idle_ms as read  # noqa: F401

UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "Planning (core/fabsp.py _resolve_store_capacity, _valid_estimate, _plan_caps)"
MOVES = "kmer_rate"
