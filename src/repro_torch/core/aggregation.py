"""Message aggregation (counterpart of `repro.core.aggregation`).

The JAX package runs one PE per device under `shard_map`; the port holds
the P PEs as the leading dimension of every tensor on one device. A route
buckets each PE's lanes into a destination-major (P_dst, capacity) tile
off ONE partition plan, and the 1d `all_to_all(tiled=True)` becomes a
transpose of the (P_src, P_dst, capacity) stack: each receiver gets its
tiles in source-major order, the JAX receive order.

The 2d topology takes a (rows, cols) grid, PE p = (p // cols, p % cols),
the row-major fold of the JAX package's ('row', 'col') mesh. Its two
`all_to_all`s become transposes of (rows, cols, ...) views, in the JAX
order: hop 1 among the `cols` PEs of a row, the swap, hop 2 among the
`rows` PEs of a column. The 'oneplan' route buckets once by the two-digit
(dest_col, dest_row) key, and with `hop2_capacity` only each bucket's
first slots travel hop 2 (the compact hop 2); the 'perhop' oracle
re-derives owners from the words hop 1 delivered and plans again.
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
    lanes: Tuple[torch.Tensor, ...]  # received lanes, each (P, recv_slots)
    sent_valid: torch.Tensor         # (P,) int32 valid slots this PE sent
    wire_bytes: int                  # padded bytes each PE moved
    overflow: torch.Tensor           # (P,) int32 bucket-capacity drops
    hop2_dropped: torch.Tensor       # (P,) int32 compact-hop-2 drops
    fill: torch.Tensor               # (P, P) int32 hop-1 bucket counts
                                     # (under 2d 'oneplan' in bucket-key
                                     # order; zeros under 'perhop')


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


def oneplan_bucket_key(owners: torch.Tensor, rows: int,
                       cols: int) -> torch.Tensor:
    """Two-digit bucket key of the one-plan 2d route, col-major
    (dest_col, dest_row): hop 1's chunks are contiguous per destination
    column and already partitioned by destination row."""
    return (owners % cols) * rows + torch.div(owners, cols,
                                              rounding_mode="floor")


def _oneplan_two_hop(tiles, rows: int, cols: int, cap2: int):
    """Both hops of tiles bucketed by `oneplan_bucket_key`: (P, P, cap)
    stacks indexed [(src_row, src_col), (dest_col, dest_row)] -> (P,
    P * cap2) receive lanes in source-major order. Each bucket keeps its
    first `cap2` slots after the swap, as the JAX package slices hop 2."""
    out = []
    for t in tiles:
        t = t.view(rows, cols, cols, rows, t.shape[-1])
        # hop 1 over 'col': PE (r, c) receives chunk c of every PE of row
        # r, concatenated by source column -> [r, c, src_col, dest_row]
        h1 = t.transpose(1, 2)
        # the swap (src_col, dest_row) -> (dest_row, src_col), then the
        # compact slice of each bucket row
        h1 = h1.transpose(2, 3)[..., :cap2]
        # hop 2 over 'row': PE (r, c) receives row r of every PE of column
        # c, concatenated by source row -> [r, c, src_row, src_col]
        out.append(h1.permute(2, 1, 0, 3, 4).reshape(rows * cols, -1))
    return tuple(out)


def _hop_transpose(tiles, rows: int, cols: int, axis: str):
    """One tiled `all_to_all` over the grid's 'col' (within a row) or
    'row' (within a column) axis of (P, B, cap) tiles whose B buckets are
    that axis' PEs: (P, B * cap) lanes, concatenated by source index."""
    out = []
    for t in tiles:
        cap = t.shape[-1]
        if axis == "col":    # [r, src_c, dest_c] -> [r, dest_c, src_c]
            t = t.view(rows, cols, cols, cap).transpose(1, 2)
        else:                # [src_r, c, dest_r] -> [dest_r, c, src_r]
            t = t.view(rows, cols, rows, cap).permute(2, 1, 0, 3)
        out.append(t.reshape(rows * cols, -1))
    return tuple(out)


def route_lanes(lanes, kinds, owners, valid, *, num_pes: int, capacity: int,
                word_bits: int, grid=None, impl: str = "radix",
                route2d: str = "oneplan",
                hop2_capacity: Optional[int] = None,
                rederive_owners=None) -> RouteResult:
    """Bucket a lane list by owner, exchange, account exact wire bytes.

    grid: None for the 1d topology, or (rows, cols) with rows * cols ==
    num_pes for the 2d one. route2d: 'oneplan' (one two-digit plan; with
    `hop2_capacity` only each bucket's first slots travel hop 2, the rest
    counted in `hop2_dropped`) or 'perhop' (re-plans per hop; needs
    kinds[0] == 'word' and `rederive_owners`, which maps received words to
    owner PEs). Received lanes are (P, P * capacity), or (P, P * cap2)
    under the compact hop 2. Wire bytes and `sent_valid` follow the JAX
    package: each PE charges its own fills for both hops.
    """
    slot_bytes = lane_wire_bytes(kinds, word_bits)
    if grid is None:
        if hop2_capacity is not None:
            raise ValueError("hop2_capacity (compact hop 2) requires the "
                             "2d 'oneplan' topology; the 1d route has no "
                             "second hop to compact")
        tiles, fill, ovf = route_tiles(lanes, kinds, owners, valid, num_pes,
                                       capacity, word_bits=word_bits,
                                       impl=impl)
        out = tuple(t.transpose(0, 1).reshape(num_pes, num_pes * capacity)
                    for t in tiles)
        return RouteResult(
            lanes=out, sent_valid=fill.sum(1, dtype=torch.int32),
            wire_bytes=num_pes * capacity * slot_bytes, overflow=ovf,
            hop2_dropped=torch.zeros_like(ovf), fill=fill)

    rows, cols = grid
    if rows * cols != num_pes:
        raise ValueError(
            f"grid {rows} x {cols} does not hold {num_pes} PEs")
    if route2d == "oneplan":
        cap2 = capacity if hop2_capacity is None \
            else min(hop2_capacity, capacity)
        tiles, fill, ovf = route_tiles(
            lanes, kinds, oneplan_bucket_key(owners, rows, cols), valid,
            num_pes, capacity, word_bits=word_bits, impl=impl)
        out = _oneplan_two_hop(tiles, rows, cols, cap2)
        # each PE charges its own fills for both hops; entries past cap2
        # in a bucket are sliced off on hop 2
        fwd = torch.clamp(fill, max=cap2)
        return RouteResult(
            lanes=out,
            sent_valid=(fill.sum(1) + fwd.sum(1)).to(torch.int32),
            wire_bytes=num_pes * (capacity + cap2) * slot_bytes,
            overflow=ovf,
            hop2_dropped=(fill - fwd).sum(1).to(torch.int32), fill=fill)

    if route2d != "perhop":
        raise ValueError(f"unknown route2d {route2d!r}")
    if hop2_capacity is not None:
        raise ValueError("hop2_capacity (compact hop 2) requires the "
                         "'oneplan' 2d route")
    if rederive_owners is None or kinds[0] != "word":
        raise ValueError("the 'perhop' oracle re-plans from the received "
                         "word lane: kinds[0] must be 'word' and "
                         "rederive_owners must be provided")
    # hop 1 routes to the destination column at a capacity the column's
    # `rows` destinations share; hop 2 re-derives owners from the words
    cap1 = capacity * rows
    tiles1, fill1, ovf1 = route_tiles(lanes, kinds, owners % cols, valid,
                                      cols, cap1, word_bits=word_bits,
                                      impl=impl)
    recv1 = _hop_transpose(tiles1, rows, cols, "col")
    valid1 = recv1[0] != W.sentinel(word_bits)
    dest_row = torch.div(rederive_owners(recv1[0]), cols,
                         rounding_mode="floor")
    cap2 = capacity * cols
    tiles2, fill2, ovf2 = route_tiles(recv1, kinds, dest_row, valid1, rows,
                                      cap2, word_bits=word_bits, impl=impl)
    out = _hop_transpose(tiles2, rows, cols, "row")
    return RouteResult(
        lanes=out,
        sent_valid=(fill1.sum(1) + fill2.sum(1)).to(torch.int32),
        wire_bytes=(cols * cap1 + rows * cap2) * slot_bytes,
        overflow=ovf1 + ovf2, hop2_dropped=torch.zeros_like(ovf1),
        fill=torch.zeros((num_pes, num_pes), dtype=torch.int32,
                         device=ovf1.device))


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
