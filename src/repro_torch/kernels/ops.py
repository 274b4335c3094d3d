"""Dispatch for the kernels of the port.

A tensor on the CPU goes to the kernel's plain version (`kernels.ref`); a
CUDA tensor launches the CUDA kernel, and a failed build or launch raises.
There is no fallback from the card to the plain version. A `meta` tensor
(the dry-run's trace) gets outputs of the kernel's shapes and its work
charged to the active cost counter (`kernels.meta`); it launches nothing
and counts no launch.

Each wrapper counts its kernel launches in a plain int attribute,
`<wrapper>.launches`, so a run can show that it went through the kernels
(`reset_launches` / `launch_counts`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core import encoding
from repro_torch.kernels import flash_attention as flash_kernels
from repro_torch.kernels import (hash_table, meta, minimizer, radix_partition,
                                 ref, segment_count)
from repro_torch.kernels import kmer_extract as extract_kernels
from repro_torch.kernels import radix_hist as radix_hist_kernels
from repro_torch.kernels.radix_partition import (PREFIX_MAX_CELLS, TILE,
                                                 PartitionPlan)


def _route(t: torch.Tensor, *, meta: bool = True) -> str:
    """'cpu' (the plain version), 'cuda' (the kernel) or 'meta' (shapes
    and cost alone). Rows 8-10, which no traced step reaches, pass
    meta=False: a meta tensor raises there."""
    if t.device.type == "meta" and not meta:
        raise ValueError("this kernel has no meta path: no dry-run trace "
                         "reaches it")
    if t.device.type in ("cpu", "cuda", "meta"):
        return t.device.type
    raise ValueError(f"no kernel for device {t.device}")


def _rows(t: torch.Tensor) -> torch.Tensor:
    """A (n,) stream as one (1, n) row; a (P, n) tensor as it is."""
    if t.dim() not in (1, 2):
        raise ValueError(f"expected a 1-d or 2-d tensor, got {t.dim()}-d")
    return t.reshape(1, -1) if t.dim() == 1 else t


def kmer_extract(reads: torch.Tensor, k: int, bits_per_symbol: int = 2, *,
                 canonical: bool = False) -> torch.Tensor:
    """(n_reads, m) codes below 2**bits_per_symbol -> (n_reads, m - k + 1)
    int64 k-mer words; with `canonical` (2-bit DNA only), min(forward,
    reverse complement) of each. k * bits_per_symbol <= 62."""
    if reads.dim() != 2:
        raise ValueError(f"reads must be (n_reads, m), got {reads.dim()}-d")
    if not 1 <= bits_per_symbol <= 8 or k < 1:
        raise ValueError(f"k={k}, bits_per_symbol={bits_per_symbol}: need "
                         f"k >= 1 and 1 <= bits_per_symbol <= 8")
    encoding.word_bits(k, bits_per_symbol)      # raises above 62 bits
    if reads.shape[1] < k:
        raise ValueError(f"reads of length {reads.shape[1]} are shorter "
                         f"than k={k}")
    if canonical and bits_per_symbol != 2:
        raise ValueError("canonical k-mers are defined for 2-bit DNA codes")
    if _route(reads, meta=False) == "cpu":
        return ref.kmer_extract(reads, k, bits_per_symbol, canonical)
    out = extract_kernels.kmer_extract_cuda(reads.contiguous(), k,
                                            bits_per_symbol, canonical)
    kmer_extract.launches += 1
    return out


def radix_hist(keys: torch.Tensor, shift: int, digit_bits: int = 4,
               tile: int = 1024) -> torch.Tensor:
    """(n,) or (P, n) int64-carried words -> (n // tile, 2**digit_bits) or
    (P, n // tile, 2**digit_bits) int32 per-tile counts of the digit
    `(word >> shift) & (2**digit_bits - 1)`, the shift logical on the
    unsigned word (digit 0 for a shift of 64 or more)."""
    if keys.shape[-1] % tile != 0:
        raise ValueError(f"n {keys.shape[-1]} % tile {tile} != 0")
    if shift < 0 or digit_bits < 1:
        raise ValueError(f"shift {shift} and digit_bits {digit_bits}: need "
                         f"shift >= 0 and digit_bits >= 1")
    rows = _rows(keys)
    if _route(keys, meta=False) == "cpu":
        hist = ref.radix_hist(rows, shift, digit_bits, tile)
    else:
        hist = radix_hist_kernels.radix_hist_cuda(rows.contiguous(), shift,
                                                  digit_bits, tile)
        radix_hist.launches += 1
    return hist[0] if keys.dim() == 1 else hist


def segment_boundaries(sorted_keys: torch.Tensor, *,
                       sentinel_val: int) -> torch.Tensor:
    """(n,) or (P, n) sorted int64-carried words -> bool run-start flags of
    the same shape: a valid word that differs from the one before it, the
    sentinel standing before index 0."""
    rows = _rows(sorted_keys)
    if _route(sorted_keys, meta=False) == "cpu":
        flags = ref.segment_boundaries(rows, sentinel_val)
    else:
        flags = segment_count.segment_boundaries_cuda(rows.contiguous(),
                                                      sentinel_val)
        segment_boundaries.launches += 1
    return flags.view(sorted_keys.shape)


def bucket_hist(buckets: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """(P, n) int32 ids -> (P, ceil(n / TILE), B) int32 per-tile counts."""
    route = _route(buckets)
    if route == "cpu":
        return ref.bucket_hist(buckets, num_buckets, TILE)
    if route == "meta":
        return meta.bucket_hist(buckets, num_buckets, TILE)
    out = radix_partition.bucket_hist_cuda(buckets, num_buckets)
    bucket_hist.launches += 1
    return out


def bucket_prefix(buckets: torch.Tensor, num_buckets: int):
    """(P, n) int32 ids -> the partition plan's prefix of their per-tile
    histograms: (base (P, n_tiles, B), totals (P, B), starts (P, B)).

    On the card one launch of the histogram kernel, which writes the
    prefix itself, where a row's (tiles, B) table fits PREFIX_MAX_CELLS;
    a larger row takes `bucket_hist`'s counts and the prefix in tensor
    code (`radix_partition.hist_prefix`)."""
    route = _route(buckets)
    if route == "cpu":
        return ref.bucket_prefix(buckets, num_buckets, TILE)
    if -(-buckets.shape[1] // TILE) * num_buckets > PREFIX_MAX_CELLS:
        return radix_partition.hist_prefix(bucket_hist(buckets, num_buckets))
    if route == "meta":
        return meta.bucket_prefix(buckets, num_buckets, TILE)
    out = radix_partition.bucket_prefix_cuda(buckets, num_buckets)
    bucket_prefix.launches += 1
    return out


def bucket_positions(buckets: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """(P, n) int32 ids + (P, n_tiles, B) bases -> (P, n) int32 slots."""
    route = _route(buckets)
    if route == "cpu":
        return ref.bucket_positions(buckets, base, TILE)
    if route == "meta":
        return meta.bucket_positions(buckets, base)
    out = radix_partition.bucket_positions_cuda(buckets, base)
    bucket_positions.launches += 1
    return out


def segment_accumulate(sorted_keys: torch.Tensor,
                       weights: Optional[torch.Tensor], *,
                       sentinel_val: int, compact: bool = False):
    """The fused boundary + run-total sweep of (P, n) sorted words, int32
    weights or None (every valid word weighs 1), one launch on the card:
    (is_new, is_end, run_totals); with `compact`, the runs compacted
    instead: (unique keys, counts, num_unique), the slots past num_unique
    holding the sentinel and 0."""
    route = _route(sorted_keys)
    if route == "cpu":
        plain = ref.segment_compact if compact else ref.segment_accumulate
        return plain(sorted_keys, weights, sentinel_val)
    if route == "meta":
        return meta.segment_accumulate(sorted_keys, weights, compact)
    out = segment_count.segment_accumulate_cuda(sorted_keys, weights,
                                                sentinel_val, compact)
    segment_accumulate.launches += 1
    return out


def hash_insert(table_keys: torch.Tensor, table_counts: torch.Tensor,
                keys: torch.Tensor, weights: torch.Tensor,
                slots: Optional[torch.Tensor], *, sentinel_val: int,
                dropped: torch.Tensor,
                word_bits: Optional[int] = None) -> None:
    """Insert-or-add a (P, n) batch into the (P, cap) table IN PLACE and add
    each row's dropped items to `dropped` (P,) int32.

    `slots` (P, n) are the items' home slots; with None, each key's home
    slot is `ref.home_slots` of a `word_bits`-bit word, which the kernel
    computes on the card. On the CPU the items fold in stream order (the
    slot layout of the sequential reference); on the card they fold in
    parallel, which gives the same (key, count) set and drops exactly when
    a row is full.
    """
    if slots is None and word_bits is None:
        raise ValueError("hash_insert: slots=None needs word_bits")
    route = _route(table_keys)
    if route == "meta":
        return meta.hash_insert(keys)
    if route == "cpu":
        if slots is None:
            slots = ref.home_slots(keys, table_keys.shape[1], word_bits)
        dropped += ref.hash_insert(table_keys, table_counts, keys,
                                   weights.to(torch.int32),
                                   slots.to(torch.int32), sentinel_val)
        return
    hash_table.hash_insert_cuda(table_keys, table_counts, keys, weights,
                                slots, sentinel_val, dropped,
                                64 if word_bits is None else word_bits)
    hash_insert.launches += 1


def hash_lookup(table_keys: torch.Tensor, table_counts: torch.Tensor,
                keys: torch.Tensor, slots: Optional[torch.Tensor], *,
                sentinel_val: int, word_bits: Optional[int] = None,
                stats: Optional[torch.Tensor] = None):
    """Read-only probe of a (P, n) batch against the (P, cap) table:
    ((P, n) int32 counts, 0 = miss; (P, n) int32 probe-walk lengths).

    `slots` (P, n) are the queries' home slots; with None, each key's home
    slot is `ref.home_slots` of a `word_bits`-bit word, which the kernel
    computes on the card. `stats` (P, 3) int64, zeroed by the caller, gets
    each row's live-query hits (count > 0) and probe sum added and its
    longest walk maxed in (`ref.lookup_stats`); on the card the kernel
    sums them."""
    if slots is None and word_bits is None:
        raise ValueError("hash_lookup: slots=None needs word_bits")
    route = _route(table_keys)
    if route == "meta":
        return meta.hash_lookup(keys)
    if route == "cpu":
        if slots is None:
            slots = ref.home_slots(keys, table_keys.shape[1], word_bits)
        counts, probes = ref.hash_lookup(table_keys, table_counts, keys,
                                         slots, sentinel_val)
        if stats is not None:
            part = ref.lookup_stats(counts, probes)
            stats[:, :2] += part[:, :2]
            stats[:, 2] = torch.maximum(stats[:, 2], part[:, 2])
        return counts, probes
    if slots is not None:
        slots = slots.to(torch.int32).contiguous()
    out = hash_table.hash_lookup_cuda(table_keys, table_counts, keys, slots,
                                      sentinel_val,
                                      64 if word_bits is None else word_bits,
                                      stats)
    hash_lookup.launches += 1
    return out


def _check_window(n_pos: int, window: int) -> None:
    if not 1 <= window <= n_pos:
        raise ValueError(f"window {window} outside [1, {n_pos}]")


def sliding_min(vals: torch.Tensor, window: int) -> torch.Tensor:
    """(rows, n_pos) words -> (rows, n_pos - window + 1) windowed minima,
    unsigned (minimizer selection, 'plain' order)."""
    _check_window(vals.shape[-1], window)
    route = _route(vals)
    if route == "cpu":
        return ref.sliding_min(vals, window)
    if route == "meta":
        return meta.sliding_min(vals, window)
    out = minimizer.sliding_min_cuda(vals.contiguous(), window)
    sliding_min.launches += 1
    return out


def sliding_min_pair(keys: torch.Tensor, vals: torch.Tensor, window: int):
    """Minimum by unsigned KEY over each window, carrying the value lane
    ('hashed' order): ((rows, n_out) keys, (rows, n_out) vals)."""
    _check_window(keys.shape[-1], window)
    route = _route(keys)
    if route == "cpu":
        return ref.sliding_min_pair(keys, vals, window)
    if route == "meta":
        return meta.sliding_min_pair(keys, vals, window)
    out = minimizer.sliding_min_pair_cuda(keys.contiguous(), vals.contiguous(),
                                          window)
    sliding_min_pair.launches += 1
    return out


def _resolved_scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return q.shape[-1] ** -0.5 if scale is None else scale


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Flash attention forward (kernel 11): q (B, Hq, Sq, D), k and v
    (B, Hkv, Skv, D), GQA by index -> (B, Hq, Sq, D) in q's dtype.

    Forward only, as a `pallas_call` has no VJP: it raises when autograd
    would need its gradient (`flash_attention_trainable` trains)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention is forward only: train with "
                           "flash_attention_trainable (attn_impl="
                           "'flash_train')")
    band = dict(causal=causal, window=window, softcap=softcap,
                scale=_resolved_scale(q, scale), q_offset=q_offset)
    route = _route(q)
    if route == "cpu":
        return ref.flash_fwd(q, k, v, **band)
    if route == "meta":
        return meta.flash_fwd(q, k, v, with_lse=False, causal=causal,
                              window=window, q_offset=q_offset,
                              name="flash_attention")
    out = flash_kernels.flash_fwd_cuda(q.contiguous(), k.contiguous(),
                                       v.contiguous(), with_lse=False, **band)
    flash_attention.launches += 1
    flash_attention.tc_launches += int(q.dtype == torch.bfloat16)
    return out


def flash_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool,
                            window: Optional[int], softcap: Optional[float],
                            scale: float, q_offset: int = 0):
    """The flash forward with the per-row logsumexp (kernel 12): (o,
    (B, Hq, Sq) f32 lse), the residual of the backward."""
    band = dict(causal=causal, window=window, softcap=softcap, scale=scale,
                q_offset=q_offset)
    route = _route(q)
    if route == "cpu":
        return ref.flash_fwd(q, k, v, with_lse=True, **band)
    if route == "meta":
        return meta.flash_fwd(q, k, v, with_lse=True, causal=causal,
                              window=window, q_offset=q_offset,
                              name="flash_attention_fwd_lse")
    out = flash_kernels.flash_fwd_cuda(q.contiguous(), k.contiguous(),
                                       v.contiguous(), with_lse=True, **band)
    flash_attention_fwd_lse.launches += 1
    flash_attention_fwd_lse.tc_launches += int(q.dtype == torch.bfloat16)
    return out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool, window: Optional[int],
                        softcap: Optional[float], scale: float,
                        q_offset: int = 0):
    """The flash backward (kernel 13: one dq launch and one dk/dv launch)
    at the full head count -> (dq, dk, dv) like q, k, v."""
    band = dict(causal=causal, window=window, softcap=softcap, scale=scale,
                q_offset=q_offset)
    route = _route(q)
    if route == "cpu":
        return ref.flash_bwd(q, k, v, o, lse, do, **band)
    if route == "meta":
        return meta.flash_bwd(q, k, v, o, lse, do, causal=causal,
                              window=window, q_offset=q_offset)
    out = flash_kernels.flash_bwd_cuda(
        q.contiguous(), k.contiguous(), v.contiguous(), o.contiguous(),
        lse.contiguous(), do.contiguous(), **band)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.tc_launches += int(q.dtype == torch.bfloat16)
    return out


class _FlashTrainable(torch.autograd.Function):
    """Forward through kernel 12, saving only o and the logsumexp; backward
    through kernel 13, with kv expanded to the query heads and dk, dv
    summed back over each GQA group."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        band = dict(causal=causal, window=window, softcap=softcap,
                    scale=scale)
        o, lse = flash_attention_fwd_lse(q, k, v, **band)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.band = band
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        b, hq = q.shape[:2]
        hkv, skv, d = k.shape[1:]
        group = hq // hkv
        kq = k.repeat_interleave(group, 1) if group > 1 else k
        vq = v.repeat_interleave(group, 1) if group > 1 else v
        dq, dk, dv = flash_attention_bwd(q, kq, vq, o, lse, do, **ctx.band)
        if group > 1:
            dk = dk.view(b, hkv, group, skv, d).sum(2)
            dv = dv.view(b, hkv, group, skv, d).sum(2)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def flash_attention_trainable(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: Optional[int] = None,
                              softcap: Optional[float] = None,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention with the backward kernels (the training path):
    q (B, Hq, S, D), k and v (B, Hkv, S, D) -> (B, Hq, S, D)."""
    return _FlashTrainable.apply(q, k, v, causal, window, softcap,
                                 _resolved_scale(q, scale))


# Row 1 has two entry points: `bucket_prefix` (the histogram kernel with
# the plan's prefix) and `bucket_hist` (its plain counts).
KERNELS = (bucket_hist, bucket_prefix, bucket_positions, segment_accumulate,
           hash_insert, hash_lookup, sliding_min, sliding_min_pair,
           flash_attention, flash_attention_fwd_lse, flash_attention_bwd,
           segment_boundaries, kmer_extract, radix_hist)
# The flash kernels run on the tensor cores for bf16 (and on the CUDA
# cores for f32): `tc_launches` counts the tensor-core launches.
FLASH_KERNELS = (flash_attention, flash_attention_fwd_lse, flash_attention_bwd)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
    for k in FLASH_KERNELS:
        k.tc_launches = 0


reset_launches()


def launch_counts() -> Dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


def tc_launch_counts() -> Dict[str, int]:
    return {k.__name__: k.tc_launches for k in FLASH_KERNELS}


def radix_partition_plan(buckets: torch.Tensor, num_buckets: int):
    """(positions, per-bucket totals) of the stable sort-free partition of
    every row (`make_partition_plan` without its starts)."""
    plan = make_partition_plan(buckets, num_buckets)
    return plan.positions, plan.totals


def make_partition_plan_ref(buckets: torch.Tensor,
                            num_buckets: int) -> PartitionPlan:
    """The stable-argsort oracle of `make_partition_plan`, the same plan
    (`ref.partition_plan`); the routes' impl='argsort' builds it."""
    return ref.partition_plan(buckets, num_buckets)


def make_partition_plan(buckets: torch.Tensor,
                        num_buckets: int) -> PartitionPlan:
    """Stable partition plan of every row of (P, n) int32 bucket ids: the
    histogram with its prefix (`bucket_prefix`), then the ranks. On the
    card that is two launches where a row's (tiles, B) table fits
    PREFIX_MAX_CELLS. Each row holds fewer than 2**31 elements."""
    b = buckets.to(torch.int32).contiguous()
    base, totals, starts = bucket_prefix(b, num_buckets)
    pos = bucket_positions(b, base)
    return PartitionPlan(positions=pos, totals=totals, starts=starts)
