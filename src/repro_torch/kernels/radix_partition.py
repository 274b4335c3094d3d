"""Stable bucket partition: the routing and radix-sort engine.

Counterpart of `repro.kernels.radix_partition`. A partition plan gives
every element its slot in a stable partition by bucket id, from one
per-tile histogram pass, which also writes the plan's prefix, and one
rank pass (CUDA kernels in `csrc/radix_partition.cu`); a plan is then
applied to any number of payload lanes by scatters. Every tensor here is
stacked: row p of a (P, n) tensor belongs to processing element p, and
each row is partitioned on its own.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import build

# Elements per block in both kernels; must equal kTile in the source. The
# positions of a stable partition do not depend on it.
TILE = 1024
# The rank kernel keeps an (8 warps, B) int32 table and the tile's B bases
# beside the 4 KB tile in the 48 KB of shared memory a launch gets without
# opting in: B up to 1251 would fit; 1024 keeps a margin.
MAX_BUCKETS = 1024
# The histogram kernel writes a row's prefix itself when the row's
# (tiles, B) table of int32 counts fits the 48 KB of shared memory a
# launch gets without opting in, less 1 KB kept for the kernel's static
# shared memory: the block that finishes a row last scans the whole table
# there. A scan step's plans are far below it (30 tiles x 257 buckets =
# 7,710 cells); larger rows (the store histogram's, the sweeps') take the
# plain counts and the prefix in tensor code. Must equal kPrefixCells in
# the source.
PREFIX_MAX_CELLS = (48 - 1) * 1024 // 4

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "bucket_hist_launch": (_P, _I64, _I64, ctypes.c_int, _P, _P),
    "bucket_prefix_launch": (_P, _I64, _I64, ctypes.c_int, _P, _P, _P, _P,
                             _P),
    "bucket_positions_launch": (_P, _P, _I64, _I64, ctypes.c_int, _P, _P),
}


class PartitionPlan(NamedTuple):
    """A stable bucket partition of every row of a (P, n) id tensor."""
    positions: torch.Tensor  # (P, n) int32 destination of every element
    totals: torch.Tensor     # (P, B) int32 per-bucket counts
    starts: torch.Tensor     # (P, B) int32 exclusive prefix of totals

    def tile_slots(self, key: torch.Tensor, valid: torch.Tensor,
                   capacity: int):
        """Padded-tile destination of every element under this plan.

        The plan was built over B bucket ids whose LAST bucket is the
        invalid/trash bucket; payload rows are the first B - 1. Returns
        (dst, fill, overflow): `dst` (P, n) int64 is the slot in a row's
        ((B - 1) * capacity,) destination-major tile, every dropped element
        (invalid, or past its bucket's capacity) pointing one past the end;
        `fill` (P, B - 1) int32 is the per-bucket count clamped to capacity
        and `overflow` (P,) int32 counts the clamped-off entries.
        """
        num_rows = self.totals.shape[1] - 1
        hist = self.totals[:, :num_rows]
        key64 = key.to(torch.int64)
        within = (self.positions - self.starts.gather(1, key64)).to(torch.int64)
        ok = valid & (key64 < num_rows) & (within < capacity)
        dst = torch.where(ok, key64 * capacity + within, num_rows * capacity)
        fill = torch.clamp(hist, max=capacity).to(torch.int32)
        overflow = torch.clamp(hist - capacity, min=0).sum(1).to(torch.int32)
        return dst, fill, overflow


@functools.cache
def _lib():
    lib = build.load("radix_partition", _SIGNATURES)
    if lib.partition_tile() != TILE:
        raise RuntimeError("csrc/radix_partition.cu tile differs from TILE")
    if lib.partition_prefix_cells() != PREFIX_MAX_CELLS:
        raise RuntimeError("csrc/radix_partition.cu prefix cells differ from "
                           "PREFIX_MAX_CELLS")
    return lib


# (device index, stream) -> (rows,) uint32 row tickets of the prefix
# kernel, zero between its launches. One buffer per stream, so launches on
# two streams never share a ticket.
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def hist_prefix(hist: torch.Tensor):
    """(P, T, B) int32 per-tile counts -> the plan's prefix: (base (P, T,
    B), totals (P, B), starts (P, B)), int32. The base of (tile t, bucket
    k) is the count of every element of a smaller bucket plus those of
    bucket k in earlier tiles: one exclusive scan in bucket-major,
    tile-major order. Each row holds fewer than 2**31 elements."""
    p, n_tiles, num_buckets = hist.shape
    totals = hist.sum(1, dtype=torch.int32)
    flat = hist.transpose(1, 2).reshape(p, num_buckets * n_tiles)
    base = (torch.cumsum(flat, 1, dtype=torch.int32) - flat).view(
        p, num_buckets, n_tiles)
    starts = base[:, :, 0].clone() if n_tiles else torch.zeros_like(totals)
    return base.transpose(1, 2).contiguous(), totals, starts


def bucket_hist_cuda(buckets: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """(P, n) int32 ids -> (P, ceil(n / TILE), B) int32 histograms."""
    build.check_arg(buckets, "buckets", torch.int32, 2)
    rows, n = buckets.shape
    n_tiles = -(-n // TILE)
    hist = torch.empty((rows, n_tiles, num_buckets), dtype=torch.int32,
                       device=buckets.device)
    if hist.numel():
        build.check_status(_lib().bucket_hist_launch(
            buckets.data_ptr(), rows, n, num_buckets, hist.data_ptr(),
            build.stream_ptr(buckets)), "bucket_hist")
    return hist


def bucket_prefix_cuda(buckets: torch.Tensor, num_buckets: int):
    """(P, n) int32 ids -> (base, totals, starts) as `hist_prefix` of their
    histograms, in one launch; a row's (tiles, B) table must fit
    PREFIX_MAX_CELLS."""
    build.check_arg(buckets, "buckets", torch.int32, 2)
    rows, n = buckets.shape
    n_tiles = -(-n // TILE)
    if n_tiles * num_buckets > PREFIX_MAX_CELLS:
        raise ValueError(f"{n_tiles} tiles x {num_buckets} buckets > "
                         f"{PREFIX_MAX_CELLS} cells")
    if rows > 65535:
        raise ValueError(f"{rows} rows > 65535")
    dev = buckets.device
    base = torch.empty((rows, n_tiles, num_buckets), dtype=torch.int32,
                       device=dev)
    totals = torch.empty((rows, num_buckets), dtype=torch.int32, device=dev)
    starts = torch.empty_like(totals)
    if n == 0:
        return base, totals.zero_(), starts.zero_()
    stream = build.stream_ptr(buckets)
    key = (dev.index, stream)
    tickets = _TICKETS.get(key)
    if tickets is None or tickets.numel() < rows:
        tickets = _TICKETS[key] = torch.zeros(max(rows, 8), dtype=torch.int32,
                                              device=dev)
    build.check_status(_lib().bucket_prefix_launch(
        buckets.data_ptr(), rows, n, num_buckets, base.data_ptr(),
        totals.data_ptr(), starts.data_ptr(), tickets.data_ptr(), stream),
        "bucket_prefix")
    return base, totals, starts


def bucket_positions_cuda(buckets: torch.Tensor,
                          base: torch.Tensor) -> torch.Tensor:
    """(P, n) int32 ids + (P, n_tiles, B) int32 bases -> (P, n) int32
    stable destinations."""
    build.check_arg(buckets, "buckets", torch.int32, 2)
    build.check_arg(base, "base", torch.int32, 3, buckets.device)
    rows, n = buckets.shape
    num_buckets = base.shape[2]
    if base.shape[:2] != (rows, -(-n // TILE)):
        raise ValueError(f"base {tuple(base.shape)} does not match ids "
                         f"{tuple(buckets.shape)} at tile {TILE}")
    if num_buckets > MAX_BUCKETS:
        raise ValueError(f"{num_buckets} buckets > {MAX_BUCKETS}")
    pos = torch.empty((rows, n), dtype=torch.int32, device=buckets.device)
    if pos.numel():
        build.check_status(_lib().bucket_positions_launch(
            buckets.data_ptr(), base.data_ptr(), rows, n, num_buckets,
            pos.data_ptr(), build.stream_ptr(buckets)), "bucket_positions")
    return pos
