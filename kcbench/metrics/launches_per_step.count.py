"""launches_per_step.count: device kernel records a scan step, in the count
cells (whole count_kmers jobs). The arithmetic is
`kcbench.readers.launches_per_step`."""

from kcbench.readers import launches_per_step as read  # noqa: F401

UNIT = "launches"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "Scan step (core/fabsp.py _stream_fold)"
MOVES = "kmer_rate"
