"""retry_rounds.count: retry rounds a job, in the count cells
(whole count_kmers jobs). The arithmetic is
`kcbench.readers.retry_rounds`."""

from kcbench.readers import retry_rounds as read  # noqa: F401

UNIT = "rounds"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "Entry and retry loop (core/fabsp.py count_kmers, KmerCounter.update)"
MOVES = "kmer_rate"
