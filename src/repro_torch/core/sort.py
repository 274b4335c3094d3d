"""Sorting and accumulation (counterpart of `repro.core.sort`).

Every function works on stacked rows: row p of a (P, n) tensor is PE p's
stream, sorted and accumulated on its own.

- `radix_sort` / `radix_sort_with_weights`: LSD passes, each a stable
  partition by one digit through the partition kernels; an optional
  sentinel goes to a tail bucket of its own on every pass.
- `sort_with_weights(impl='argsort')`: the comparison-sort oracle.
- `accumulate`: the sorted-run sweep. 'fused' runs the boundary and
  run-total kernel once, compacting in it; 'segment_sum' is the two-pass
  oracle, whose run-start flags come from a tensor expression or the
  boundary kernel.
- `merge_accum`: two accumulated results merged into one.
- `sort_words`: a plain sort of words in their unsigned order.

Words are int64 (see `repro_torch.words`). The radix passes read logical
digits and the oracle sorts in unsigned order, so both see the same order
as the JAX package's unsigned words.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch import words as W
from repro_torch.kernels import ops, ref

_SIGN = -(1 << 63)


class AccumResult(NamedTuple):
    unique: torch.Tensor      # unique keys, ascending; sentinel past num_unique
    counts: torch.Tensor      # int32 counts; 0 past num_unique
    num_unique: torch.Tensor  # (P,) int32


def sort_words(words: torch.Tensor) -> torch.Tensor:
    """Words of either width sorted along the last axis in their unsigned
    order: a 64-bit word with its top bit set (negative as int64) sorts
    above every word without it, as in the 'argsort' oracle."""
    return torch.sort(words ^ _SIGN).values ^ _SIGN


def _radix_sort_lanes(keys: torch.Tensor, lanes: Sequence[torch.Tensor],
                      total_bits: int, digit_bits: int,
                      sentinel_val: Optional[int]):
    radix = 1 << digit_bits
    num_buckets = radix + (1 if sentinel_val is not None else 0)
    lanes = tuple(lanes)
    for shift in range(0, total_bits, digit_bits):
        digit = (W.srl(keys, shift) & (radix - 1)).to(torch.int32)
        if sentinel_val is not None:
            digit = torch.where(keys == sentinel_val, radix, digit)
        pos = ops.make_partition_plan(digit, num_buckets).positions
        del digit
        pos = pos.to(torch.int64)
        keys = torch.empty_like(keys).scatter_(1, pos, keys)
        lanes = tuple(torch.empty_like(l).scatter_(1, pos, l) for l in lanes)
    return keys, lanes


def radix_sort(words: torch.Tensor, total_bits: int, digit_bits: int = 8, *,
               sentinel_val: Optional[int] = None,
               impl: str = "radix") -> torch.Tensor:
    """Sort every row by the low `total_bits` of each word; bits above must
    be equal across a row (they are not read)."""
    if impl == "argsort":
        return sort_with_weights(words, torch.zeros_like(words))[0]
    if impl != "radix":
        raise ValueError(f"unknown sort impl {impl!r}")
    return _radix_sort_lanes(words, (), total_bits, digit_bits,
                             sentinel_val)[0]


def radix_sort_with_weights(keys: torch.Tensor, weights: torch.Tensor,
                            total_bits: int, digit_bits: int = 8, *,
                            sentinel_val: Optional[int] = None):
    """Stable radix sort of (key, weight) rows by the low `total_bits`;
    sentinel padding comes out last."""
    keys, (w,) = _radix_sort_lanes(keys, (weights,), total_bits, digit_bits,
                                   sentinel_val)
    return keys, w


def sort_with_weights(keys: torch.Tensor, weights: torch.Tensor, *,
                      impl: str = "argsort",
                      total_bits: Optional[int] = None,
                      digit_bits: int = 8,
                      sentinel_val: Optional[int] = None):
    """Stable sort of key rows carrying a weight lane. 'argsort' sorts in
    the unsigned order of the words; 'radix' needs `total_bits`."""
    if impl == "radix":
        if total_bits is None:
            raise ValueError("impl='radix' needs total_bits")
        return radix_sort_with_weights(keys, weights, total_bits, digit_bits,
                                       sentinel_val=sentinel_val)
    if impl != "argsort":
        raise ValueError(f"unknown sort impl {impl!r}")
    order = torch.argsort(keys ^ _SIGN, dim=1, stable=True)
    return keys.gather(1, order), weights.gather(1, order)


def accumulate(sorted_keys: torch.Tensor,
               weights: Optional[torch.Tensor] = None, *,
               sentinel_val: int,
               boundaries_impl: str = "inline",
               impl: str = "segment_sum") -> AccumResult:
    """Sweep sorted rows into (unique keys, counts), the paper's Accumulate.

    sorted_keys: (P, n) ascending per row, padding == sentinel_val (last).
    weights: optional int32 multiplicities; 1 per valid entry by default.
    impl: 'fused' runs the boundary + run-total kernel in its compacting
    mode (on the card two fills and one launch); 'segment_sum' is the
    two-pass oracle. Bit-identical results.
    boundaries_impl ('segment_sum' only; 'fused' ignores it): 'inline'
    takes the run-start flags from their plain tensor expression, 'kernel'
    from the `segment_boundaries` kernel -- the JAX package's 'jnp' and
    'pallas'.
    """
    if impl == "fused":
        if weights is not None:
            weights = weights.to(torch.int32).contiguous()
        unique, counts, num_unique = ops.segment_accumulate(
            sorted_keys.contiguous(), weights, sentinel_val=sentinel_val,
            compact=True)
        return AccumResult(unique=unique, counts=counts,
                           num_unique=num_unique)
    if impl != "segment_sum":
        raise ValueError(f"unknown accumulate impl {impl!r}")
    p, n = sorted_keys.shape
    valid = sorted_keys != sentinel_val
    if weights is None:
        w = valid.to(torch.int32)
    else:
        w = torch.where(valid, weights.to(torch.int32), 0)
    if boundaries_impl == "kernel":
        is_new = ops.segment_boundaries(sorted_keys.contiguous(),
                                        sentinel_val=sentinel_val)
    elif boundaries_impl == "inline":
        is_new = ref.segment_boundaries(sorted_keys, sentinel_val)
    else:
        raise ValueError(f"unknown boundaries impl {boundaries_impl!r}")
    seg = torch.clamp(torch.cumsum(is_new, 1, dtype=torch.int64) - 1, min=0)
    counts = torch.zeros((p, n), dtype=torch.int64, device=sorted_keys.device)
    counts.scatter_add_(1, seg, w.to(torch.int64))
    unique = ref.scatter_drop(torch.where(is_new, seg, n), sorted_keys,
                              sentinel_val)
    num_unique = is_new.sum(1, dtype=torch.int32)
    live = torch.arange(n, device=sorted_keys.device)[None, :] \
        < num_unique[:, None]
    counts = torch.where(live, counts, 0).to(torch.int32)
    return AccumResult(unique=unique, counts=counts, num_unique=num_unique)


def merge_accum(a: AccumResult, b: AccumResult, *, sentinel_val: int,
                impl: str = "radix",
                total_bits: Optional[int] = None) -> AccumResult:
    """Merge two accumulated results into one (the serving path's merge of
    per-shard outputs): concatenate each row's keys and counts, sort, and
    accumulate again. Takes (n,) results, as the JAX package's, or stacked
    (P, n) rows, merged row by row.

    'radix' (default) runs the partition and run-sweep kernels (rows 1-3
    on the card); `total_bits` defaults to the words' full width, which
    the sentinel gives (0xFFFFFFFF: 32, -1: 64). 'argsort' is the
    comparison-sort oracle, in the words' unsigned order. Bit-identical
    results."""
    flat = a.unique.dim() == 1
    keys = torch.cat([a.unique, b.unique], -1)
    w = torch.cat([a.counts, b.counts], -1)
    if flat:
        keys, w = keys[None, :], w[None, :]
    if impl == "radix":
        if total_bits is None:
            total_bits = 32 if sentinel_val == W.sentinel(32) else 64
        keys, w = sort_with_weights(keys, w, impl="radix",
                                    total_bits=total_bits,
                                    sentinel_val=sentinel_val)
        out = accumulate(keys, w, sentinel_val=sentinel_val, impl="fused")
    elif impl == "argsort":
        keys, w = sort_with_weights(keys, w)
        out = accumulate(keys, w, sentinel_val=sentinel_val)
    else:
        raise ValueError(f"unknown merge impl {impl!r}")
    if flat:
        return AccumResult(unique=out.unique[0], counts=out.counts[0],
                           num_unique=out.num_unique[0])
    return out
