"""step_host_ms.count: host ms of a scan step's compress, route and insert
spans, in the count cells (whole count_kmers jobs), from the port's own
spans. The arithmetic is `kcbench.port_spans.step_host_ms`."""

from kcbench.port_spans import step_host_ms as read  # noqa: F401

UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "Scan step (core/fabsp.py _stream_fold)"
MOVES = "kmer_rate"
