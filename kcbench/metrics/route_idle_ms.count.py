"""route_idle_ms.count: device idle ms a scan step inside the route spans, in
the count cells (whole count_kmers jobs), from the port's own spans. The
arithmetic is `kcbench.port_spans.route_idle_ms`."""

from kcbench.port_spans import route_idle_ms as read  # noqa: F401

UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "Route (core/aggregation.py)"
MOVES = "kmer_rate"
