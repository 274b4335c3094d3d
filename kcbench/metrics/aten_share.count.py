"""aten_share.count: device time in kernels PyTorch launched, not the port's,
in the count cells (whole count_kmers jobs). The arithmetic is
`kcbench.readers.aten_share`."""

from kcbench.readers import aten_share as read  # noqa: F401

UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "Device (H100)"
MOVES = "kmer_rate"
