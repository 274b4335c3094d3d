"""The bytes each metered kernel must move, and the card's peak.

Frozen from the port's own counts (its `kernels/meta.py` and its
PERF.md's kernel table, row 4) and recast to count only the live
items a call really has, never every batch slot, so that no share can
pass 100 %. Each input byte is read once and each output byte written
once; each live item also touches its table slot's 32-byte sector at
random, one sector an item (the key and the count sit in two arrays, so
the real kernel touches at least two: the count here is a lower bound).

The peak is NVIDIA's data sheet for the H100 SXM: 3.35e12 bytes/s of HBM3,
at the card's full power limit of 700 W; a card set lower runs below it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
SECTOR = 32


def hash_insert_bytes(slots: int, live: int) -> int:
    """An insert-or-add of a batch of `slots` (key, weight) pairs, `live`
    of them real: every slot's 8-byte key read (a padding key has to be
    read to be skipped), each live item's 4-byte weight read, and one
    sector of the table touched by each live item."""
    return 8 * slots + 4 * live + SECTOR * live

