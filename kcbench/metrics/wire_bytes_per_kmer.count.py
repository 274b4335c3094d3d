"""wire_bytes_per_kmer.count: routed bytes a k-mer instance, in the count
cells (whole count_kmers jobs). The arithmetic is
`kcbench.readers.wire_bytes_per_kmer`."""

from kcbench.readers import wire_bytes_per_kmer as read  # noqa: F401

UNIT = "B/kmer"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "Route (core/aggregation.py)"
MOVES = "kmer_rate"
