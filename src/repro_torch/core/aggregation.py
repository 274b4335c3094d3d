"""Message aggregation, 1d topology (counterpart of `repro.core.aggregation`).

The JAX package runs one PE per device under `shard_map`; the port holds
the P PEs as the leading dimension of every tensor on one device. A route
buckets each PE's lanes into a destination-major (P_dst, capacity) tile
off ONE partition plan, and the 1d `all_to_all(tiled=True)` becomes a
transpose of the (P_src, P_dst, capacity) stack: each receiver gets its
tiles in source-major order, the JAX receive order.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch import words as W
from repro_torch.core import encoding
from repro_torch.core.sort import accumulate, radix_sort, sort_with_weights
from repro_torch.kernels import ops, ref


class RouteResult(NamedTuple):
    """One `route_lanes` exchange; every field has one row per PE."""
    lanes: Tuple[torch.Tensor, ...]  # received lanes, each (P, P * capacity)
    sent_valid: torch.Tensor         # (P,) int32 valid slots this PE sent
    wire_bytes: int                  # padded bytes each PE moved
    overflow: torch.Tensor           # (P,) int32 bucket-capacity drops
    hop2_dropped: torch.Tensor       # (P,) int32, 0 on the 1d route
    fill: torch.Tensor               # (P, P) int32 per-destination counts


def lane_wire_bytes(kinds: Sequence[str], word_bits: int) -> int:
    """Bytes of ONE routed tile slot: word lanes cost their word width,
    'i32' header/count lanes 4."""
    total = 0
    for kind in kinds:
        if kind == "word":
            total += word_bits // 8
        elif kind == "i32":
            total += 4
        else:
            raise ValueError(f"unknown lane kind {kind!r}")
    return total


def route_tiles(lanes, kinds, owners, valid, num_pes: int, capacity: int, *,
                word_bits: int, impl: str = "radix"):
    """Bucket a lane list into destination-major (P, num_pes, capacity)
    tiles off ONE partition plan per PE.

    lanes: tuple of (P, n) tensors routed by the same (owners, valid);
    kinds: per-lane 'word' (invalid slots hold the sentinel) or 'i32'
    (zero padding). impl: 'radix' (partition kernels) or 'argsort' (the
    stable-argsort plan); both drive the same tile build.
    Returns (tiles, fill (P, num_pes), overflow (P,)). On overflow the first
    `capacity` entries per destination in stream order are kept.
    """
    if len(lanes) != len(kinds) or not lanes:
        raise ValueError("lanes/kinds must be equal-length and non-empty")
    lane_wire_bytes(kinds, word_bits)
    key = torch.where(valid, owners.to(torch.int32), num_pes)
    if impl == "radix":
        plan = ops.make_partition_plan(key, num_pes + 1)
    elif impl == "argsort":
        plan = ref.partition_plan(key, num_pes + 1)
    else:
        raise ValueError(f"unknown route impl {impl!r}")
    dst, fill, overflow = plan.tile_slots(key, valid, capacity)
    sent = W.sentinel(word_bits)
    tiles = []
    for lane, kind in zip(lanes, kinds):
        if kind == "word":
            src, pad = torch.where(valid, lane, sent), sent
        else:
            src, pad = torch.where(valid, lane.to(torch.int32), 0), 0
        p = src.shape[0]
        flat = torch.full((p, num_pes * capacity + 1), pad, dtype=src.dtype,
                          device=src.device)
        flat.scatter_(1, dst, src)
        tiles.append(flat[:, :-1].reshape(p, num_pes, capacity))
    return tuple(tiles), fill, overflow


def route_lanes(lanes, kinds, owners, valid, *, num_pes: int, capacity: int,
                word_bits: int, grid=None, impl: str = "radix",
                hop2_capacity: Optional[int] = None) -> RouteResult:
    """Bucket a lane list by owner, exchange, account exact wire bytes.

    Only the 1d topology (`grid=None`) is in this package so far; the 2d
    routes come with ROADMAP.md section 1 item 9.
    """
    if grid is not None:
        raise NotImplementedError(
            "the 2d topology is not ported yet (ROADMAP.md section 1, item 9)")
    if hop2_capacity is not None:
        raise ValueError("hop2_capacity (compact hop 2) requires the 2d "
                         "'oneplan' topology; the 1d route has no second hop")
    slot_bytes = lane_wire_bytes(kinds, word_bits)
    tiles, fill, ovf = route_tiles(lanes, kinds, owners, valid, num_pes,
                                   capacity, word_bits=word_bits, impl=impl)
    out = tuple(t.transpose(0, 1).reshape(num_pes, num_pes * capacity)
                for t in tiles)
    return RouteResult(
        lanes=out, sent_valid=fill.sum(1, dtype=torch.int32),
        wire_bytes=num_pes * capacity * slot_bytes, overflow=ovf,
        hop2_dropped=torch.zeros_like(ovf), fill=fill)


def compact_lanes(lanes, kinds, valid, capacity: int, *, word_bits: int,
                  impl: str = "radix"):
    """Pre-route prefix compaction: shrink every row's lanes to its valid
    entries, in stream order, kept in the first `capacity` slots.

    A stable 2-bucket partition (valid first, invalid in the trash bucket)
    through the same `PartitionPlan.tile_slots` the router uses. Owners are
    computed before compaction and ride as an 'i32' lane. Valid entries past
    `capacity` are dropped and counted in the returned overflow, which the
    caller's retry round absorbs.

    lanes: tuple of (P, n) tensors; kinds: 'word' (sentinel padding) or
    'i32' (zero padding). Returns (lanes each (P, capacity), new_valid
    (P, capacity) bool, overflow (P,) int32).
    """
    if len(lanes) != len(kinds) or not lanes:
        raise ValueError("lanes/kinds must be equal-length and non-empty")
    key = torch.where(valid, 0, 1).to(torch.int32)
    if impl == "radix":
        plan = ops.make_partition_plan(key, 2)
    elif impl == "argsort":
        plan = ref.partition_plan(key, 2)
    else:
        raise ValueError(f"unknown compact impl {impl!r}")
    dst, fill, overflow = plan.tile_slots(key, valid, capacity)
    sent = W.sentinel(word_bits)
    out = []
    for lane, kind in zip(lanes, kinds):
        if kind == "word":
            src, pad = torch.where(valid, lane, sent), sent
        elif kind == "i32":
            src, pad = torch.where(valid, lane.to(torch.int32), 0), 0
        else:
            raise ValueError(f"unknown lane kind {kind!r}")
        buf = torch.full((src.shape[0], capacity + 1), pad, dtype=src.dtype,
                         device=src.device)
        buf.scatter_(1, dst, src)
        out.append(buf[:, :capacity])
    new_valid = (torch.arange(capacity, device=valid.device)[None, :]
                 < fill[:, :1])
    return tuple(out), new_valid, overflow


def plan_capacity(num_items: int, num_pes: int, slack: float = 1.5,
                  align: int = 8) -> int:
    """Per-destination tile capacity for ~uniform (hashed) traffic."""
    expected = num_items / num_pes
    cap = int(math.ceil(expected * slack))
    return max(align, ((cap + align - 1) // align) * align)


def l3_compress(words: torch.Tensor, k: int, bits_per_symbol: int = 2, *,
                impl: str = "radix"):
    """L3: sort + accumulate each row, pack counts into the spare high bits.

    words: (P, C3) raw k-mer words (sentinel for padding). Returns
    (packed, valid): count-packed words, sentinel-padded, and their mask.
    """
    sent = encoding.sentinel(k, bits_per_symbol)
    if impl == "radix":
        swords = radix_sort(words, encoding.kmer_bits(k, bits_per_symbol),
                            sentinel_val=sent)
        acc = accumulate(swords, sentinel_val=sent, impl="fused")
    else:
        acc = accumulate(sort_with_weights(words, torch.zeros_like(words))[0],
                         sentinel_val=sent)
    n = words.shape[1]
    valid = (torch.arange(n, device=words.device)[None, :]
             < acc.num_unique[:, None])
    packed = torch.where(
        valid,
        encoding.pack_counts(acc.unique & encoding.kmer_mask(k, bits_per_symbol),
                             torch.clamp(acc.counts, min=1), k,
                             bits_per_symbol),
        sent)
    return packed, valid


def l3_decompress(packed_tile: torch.Tensor, k: int,
                  bits_per_symbol: int = 2):
    """Receiver side: split count-packed words into (kmer, count) lanes;
    sentinel entries yield count 0. Works on any shape."""
    sent = encoding.sentinel(k, bits_per_symbol)
    kmers, counts = encoding.unpack_counts(packed_tile, k, bits_per_symbol)
    is_valid = packed_tile != sent
    return (torch.where(is_valid, kmers, sent),
            torch.where(is_valid, counts, 0))
