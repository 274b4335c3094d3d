"""hash_insert_roofline.count: the insert kernel's share of its HBM roofline,
in the count cells (whole count_kmers jobs). The meter wraps
`ops.hash_insert` in the metered unit (`METER`); the arithmetic is
`kcbench.readers.hash_insert_roofline`."""

from kcbench.readers import hash_insert_live
from kcbench.readers import hash_insert_roofline as read  # noqa: F401

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "Kernels (kernels/*.py, csrc/*.cu)"
MOVES = "kmer_rate"
METER = {"hash_insert": hash_insert_live}
