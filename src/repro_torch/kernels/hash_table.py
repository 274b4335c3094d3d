"""Open-addressing insert-or-add and read-only lookup: the streaming
receiver's count store and the query path's probe of it.

Counterparts of `repro.kernels.hash_table.hash_insert_pallas` and
`hash_lookup_pallas`; the CUDA kernels are in `csrc/hash_table.cu`. Row p of
the (P, cap) table is PE p's store. The insert updates the table in place:
a copy of the store per chunk would cost its whole size on every scan step.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_SIGNATURES = {
    "hash_insert_launch": (_P, _P, _I64, _I64, _P, _P, _P, _I64, _I64, _INT,
                           _P, _P),
    "hash_lookup_launch": (_P, _P, _I64, _I64, _P, _P, _I64, _I64, _INT,
                           _P, _P, _P, _P),
}


def hash_insert_cuda(table_keys: torch.Tensor, table_counts: torch.Tensor,
                     keys: torch.Tensor, weights: torch.Tensor,
                     slots: Optional[torch.Tensor], sentinel_val: int,
                     dropped: torch.Tensor, word_bits: int) -> None:
    """Fold a (P, n) batch into the (P, cap) table in place; the items each
    row drops are added to `dropped` (P,) int32. With `slots` None the
    kernel computes each key's home slot (`countstore.store_slots` of a
    `word_bits`-bit word)."""
    build.check_arg(table_keys, "table_keys", torch.int64, 2)
    dev = table_keys.device
    build.check_arg(table_counts, "table_counts", torch.int32, 2, dev)
    build.check_arg(keys, "keys", torch.int64, 2, dev)
    build.check_arg(weights, "weights", torch.int32, 2, dev)
    if slots is not None:
        build.check_arg(slots, "slots", torch.int32, 2, dev)
    build.check_arg(dropped, "dropped", torch.int32, 1, dev)
    rows, cap = table_keys.shape
    if (table_counts.shape != table_keys.shape
            or weights.shape != keys.shape
            or (slots is not None and slots.shape != keys.shape)
            or keys.shape[0] != rows or dropped.shape[0] != rows):
        raise ValueError("table, batch and dropped shapes disagree")
    if not 1 <= cap < (1 << 31) or word_bits not in (32, 64):
        raise ValueError(f"capacity {cap} outside [1, 2**31) or word_bits "
                         f"{word_bits} not 32 or 64")
    n = keys.shape[1]
    if rows and n:
        lib = build.load("hash_table", _SIGNATURES)
        build.check_status(lib.hash_insert_launch(
            table_keys.data_ptr(), table_counts.data_ptr(), rows, cap,
            keys.data_ptr(), weights.data_ptr(),
            None if slots is None else slots.data_ptr(), n, sentinel_val,
            word_bits, dropped.data_ptr(), build.stream_ptr(keys)),
            "hash_insert")


def hash_lookup_cuda(table_keys: torch.Tensor, table_counts: torch.Tensor,
                     keys: torch.Tensor, slots: Optional[torch.Tensor],
                     sentinel_val: int, word_bits: int,
                     stats: Optional[torch.Tensor] = None):
    """Probe a (P, n) batch against the (P, cap) table, read only; returns
    ((P, n) int32 counts, (P, n) int32 probe lengths). With `slots` None
    the kernel computes each key's home slot (`countstore.store_slots` of
    a `word_bits`-bit word). `stats` (P, 3) int64, when given, gets each
    row's hits added to column 0, its probe sum to column 1, and column 2
    raised to its longest walk."""
    build.check_arg(table_keys, "table_keys", torch.int64, 2)
    dev = table_keys.device
    build.check_arg(table_counts, "table_counts", torch.int32, 2, dev)
    build.check_arg(keys, "keys", torch.int64, 2, dev)
    if slots is not None:
        build.check_arg(slots, "slots", torch.int32, 2, dev)
    if stats is not None:
        build.check_arg(stats, "stats", torch.int64, 2, dev)
    rows, cap = table_keys.shape
    if (table_counts.shape != table_keys.shape
            or (slots is not None and slots.shape != keys.shape)
            or keys.shape[0] != rows
            or (stats is not None and tuple(stats.shape) != (rows, 3))):
        raise ValueError("table, batch and stats shapes disagree")
    if not 1 <= cap < (1 << 31) or word_bits not in (32, 64):
        raise ValueError(f"capacity {cap} outside [1, 2**31) or word_bits "
                         f"{word_bits} not 32 or 64")
    n = keys.shape[1]
    counts = torch.empty(keys.shape, dtype=torch.int32, device=dev)
    probes = torch.empty_like(counts)
    if rows and n:
        lib = build.load("hash_table", _SIGNATURES)
        build.check_status(lib.hash_lookup_launch(
            table_keys.data_ptr(), table_counts.data_ptr(), rows, cap,
            keys.data_ptr(), None if slots is None else slots.data_ptr(), n,
            sentinel_val, word_bits, counts.data_ptr(),
            probes.data_ptr(), None if stats is None else stats.data_ptr(),
            build.stream_ptr(keys)), "hash_lookup")
    return counts, probes
