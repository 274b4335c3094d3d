"""idle_unspanned.count: the share of the traced window's device idle in no
port span, in the count cells (whole count_kmers jobs), from the port's own
spans. The arithmetic is `kcbench.port_spans.idle_unspanned`."""

from kcbench.port_spans import idle_unspanned as read  # noqa: F401

UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "Device (H100)"
MOVES = "kmer_rate"
