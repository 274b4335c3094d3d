"""load_max_over_mean.count: the busiest owner's load over the mean, in the
count cells (whole count_kmers jobs). The arithmetic is
`kcbench.readers.load_max_over_mean`."""

from kcbench.readers import load_max_over_mean as read  # noqa: F401

UNIT = "ratio"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "Route (core/aggregation.py)"
MOVES = "kmer_rate"
