"""The kernels on `meta` tensors: outputs of each kernel's shapes and
dtypes, and its work charged to the active cost counter.

`kernels/ops.py` sends a meta tensor here (a CPU tensor to the plain
version, a CUDA tensor to the kernel). Nothing is launched and no
`launches` counter moves: the dry-run (`launch/dryrun.py`,
`launch/kc_dryrun.py`) traces a step over meta tensors and reads the
kernels' work from here, and the ops around them from its dispatch mode.

Each kernel charges what PERF.md's `bound ms` column counts for its row:
the bytes it must move (each input read once, each output written once)
and, for the flash rows, the causal products' operations (2 hd per kept
(row, col) pair and product: 2 products forward, 5 backward). Where that
count depends on the data, a meta tensor has none, so the count is the
shape's: rows 4 and 5 take every batch slot as live, and each lookup walks
one probe and hits.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import numpy as np
import torch


class KernelCost:
    """Operations and bytes charged by the kernels, by kernel name."""

    def __init__(self):
        self.ops = 0.0
        self.bytes = 0.0
        self.by_kernel = {}

    def charge(self, name: str, ops: float, nbytes: float) -> None:
        self.ops += ops
        self.bytes += nbytes
        n, o, b = self.by_kernel.get(name, (0, 0.0, 0.0))
        self.by_kernel[name] = (n + 1, o + ops, b + nbytes)


_ACTIVE: List[KernelCost] = []


@contextlib.contextmanager
def counting(cost: KernelCost):
    """Charge the meta kernels run inside the block to `cost`."""
    _ACTIVE.append(cost)
    try:
        yield cost
    finally:
        _ACTIVE.remove(cost)


def charge(name: str, ops: float, nbytes: float) -> None:
    for c in _ACTIVE:
        c.charge(name, ops, nbytes)


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _empty(shape, dtype, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=like.device)


# --- rows 1-3: the partition plan and the accumulate ------------------------

def bucket_hist(buckets: torch.Tensor, num_buckets: int,
                tile: int) -> torch.Tensor:
    p, n = buckets.shape
    out = _empty((p, -(-n // tile), num_buckets), torch.int32, buckets)
    charge("bucket_hist", 0, _nbytes(buckets, out))
    return out


def bucket_prefix(buckets: torch.Tensor, num_buckets: int, tile: int):
    p, n = buckets.shape
    n_tiles = -(-n // tile)
    base = _empty((p, n_tiles, num_buckets), torch.int32, buckets)
    totals = _empty((p, num_buckets), torch.int32, buckets)
    starts = _empty((p, num_buckets), torch.int32, buckets)
    charge("bucket_prefix", 0, _nbytes(buckets, base, totals, starts))
    return base, totals, starts


def bucket_positions(buckets: torch.Tensor,
                     base: torch.Tensor) -> torch.Tensor:
    out = _empty(buckets.shape, torch.int32, buckets)
    charge("bucket_positions", 0, _nbytes(buckets, base, out))
    return out


def segment_accumulate(sorted_keys: torch.Tensor,
                       weights: Optional[torch.Tensor], compact: bool):
    p, n = sorted_keys.shape
    read = _nbytes(sorted_keys, weights)
    if compact:
        out = (_empty((p, n), sorted_keys.dtype, sorted_keys),
               _empty((p, n), torch.int32, sorted_keys),
               _empty((p,), torch.int32, sorted_keys))
        charge("segment_accumulate", 0, read + _nbytes(*out[:2]))
    else:
        out = (_empty((p, n), torch.bool, sorted_keys),
               _empty((p, n), torch.bool, sorted_keys),
               _empty((p, n), torch.int32, sorted_keys))
        charge("segment_accumulate", 0, read + _nbytes(*out))
    return out


# --- rows 4 and 5: the count store -------------------------------------------

def hash_insert(keys: torch.Tensor) -> None:
    """Every batch slot live: its 8 B key and 4 B weight read, and its
    table key and count read and written."""
    live = keys.numel()
    charge("hash_insert", 0, live * 8 + live * 4 + live * (8 + 4) * 2)


def hash_lookup(keys: torch.Tensor):
    """Every query walks one probe and hits: the 8 B key read, the 4 B
    count and probe length written, one 8 B table key and one 4 B count
    read."""
    counts = _empty(keys.shape, torch.int32, keys)
    probes = _empty(keys.shape, torch.int32, keys)
    n = keys.numel()
    charge("hash_lookup", 0, n * (8 + 4 + 4) + n * 8 + n * 4)
    return counts, probes


# --- rows 6 and 7: the sliding minimum ---------------------------------------

def sliding_min(vals: torch.Tensor, window: int) -> torch.Tensor:
    shape = vals.shape[:-1] + (vals.shape[-1] - window + 1,)
    out = _empty(shape, vals.dtype, vals)
    charge("sliding_min", 0, _nbytes(vals, out))
    return out


def sliding_min_pair(keys: torch.Tensor, vals: torch.Tensor, window: int):
    shape = keys.shape[:-1] + (keys.shape[-1] - window + 1,)
    out = (_empty(shape, keys.dtype, keys), _empty(shape, vals.dtype, vals))
    charge("sliding_min_pair", 0, _nbytes(keys, vals, *out))
    return out


# --- rows 11-13: flash attention ---------------------------------------------

def band_pairs(sq: int, skv: int, *, causal: bool, window: Optional[int],
               q_offset: int = 0) -> int:
    """The kept (row, col) pairs of one head: query row i at position
    q_offset + i keeps the keys at most that position (causal) and within
    `window` of it."""
    pos = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(pos, skv - 1) if causal else np.full(sq, skv - 1)
    lo = (np.maximum(pos - window + 1, 0) if window is not None
          else np.zeros(sq, dtype=np.int64))
    return int(np.clip(hi - lo + 1, 0, None).sum())


def _flash_pairs(q, k, causal, window, q_offset) -> int:
    b, hq, sq, _ = q.shape
    return b * hq * band_pairs(sq, k.shape[2], causal=causal, window=window,
                               q_offset=q_offset)


def flash_fwd(q, k, v, *, with_lse: bool, causal: bool, window, q_offset,
              name: str):
    o = torch.empty_like(q)
    lse = (_empty(q.shape[:3], torch.float32, q) if with_lse else None)
    pairs = _flash_pairs(q, k, causal, window, q_offset)
    charge(name, 4 * q.shape[-1] * pairs, _nbytes(q, k, v, o, lse))
    return (o, lse) if with_lse else o


def flash_bwd(q, k, v, o, lse, do, *, causal: bool, window, q_offset):
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    pairs = _flash_pairs(q, k, causal, window, q_offset)
    charge("flash_attention_bwd", 10 * q.shape[-1] * pairs,
           _nbytes(q, k, v, o, lse, do, dq, dk, dv))
    return dq, dk, dv
