"""device_idle.count: the traced window's device idle share, in the count
cells (whole count_kmers jobs). The arithmetic is
`kcbench.readers.device_idle`."""

from kcbench.readers import device_idle as read  # noqa: F401

UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "Device (H100)"
MOVES = "kmer_rate"
