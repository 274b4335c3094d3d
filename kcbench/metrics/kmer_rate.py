"""kmer_rate: k-mer instances taken into the exact count a second by whole
count_kmers jobs back to back, over all the jobs and all the time of the
window (`kcbench.readers.rate`)."""

from kcbench.readers import rate as read  # noqa: F401

UNIT = "kmers/s"
BETTER = "higher"
SOURCE = "host_clock"
