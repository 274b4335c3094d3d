"""insert_idle_ms.count: device idle ms a scan step inside the insert spans, in
the count cells (whole count_kmers jobs), from the port's own spans. The
arithmetic is `kcbench.port_spans.insert_idle_ms`."""

from kcbench.port_spans import insert_idle_ms as read  # noqa: F401

UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "Receiver store (core/countstore.py)"
MOVES = "kmer_rate"
