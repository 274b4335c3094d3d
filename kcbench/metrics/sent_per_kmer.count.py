"""sent_per_kmer.count: wire payload slots a k-mer instance, in the count
cells (whole count_kmers jobs). The arithmetic is
`kcbench.readers.sent_per_kmer`."""

from kcbench.readers import sent_per_kmer as read  # noqa: F401

UNIT = "slots/kmer"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "L3 compressor and super-k-mer segmentation (fabsp._l3_split_dual, core/minimizer.py)"
MOVES = "kmer_rate"
