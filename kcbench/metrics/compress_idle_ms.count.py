"""compress_idle_ms.count: device idle ms a scan step inside the compress
spans, in the count cells (whole count_kmers jobs), from the port's own
spans. The arithmetic is `kcbench.port_spans.compress_idle_ms`."""

from kcbench.port_spans import compress_idle_ms as read  # noqa: F401

UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "L3 compressor and super-k-mer segmentation (fabsp._l3_split_dual, core/minimizer.py)"
MOVES = "kmer_rate"
