"""128-bit k-mers: k in (31, 63] as (hi, lo) word pairs (counterpart of
`repro.core.encoding128`).

The paper (Sec. VII) names k-mers wider than 64 bits as future work: a
64-bit word caps k at 31, which constrains long-read assembly. Here:

- packing: a two-lane shift-or; bits [0, 64) in `lo`, bits [64, 2k) in
  `hi`. Both lanes are int64 tensors: `lo` carries all 64 bits (negative
  as int64 when its top bit is set), `hi` 2k - 64 <= 62 bits;
- ordering: lexicographic (hi, lo), the 128-bit number's order, by two
  stable sorts (by lo, then by hi), each in the unsigned order of its
  lane (`x ^ (1 << 63)`), so the all-ones padding pair sorts last;
- ownership: an avalanche mix of hi ^ mix(lo), with the unsigned
  remainder (`words.umod`);
- accumulate: run boundaries compare both lanes.

The JAX module runs no Pallas kernel (argsort and segment_sum), and
neither does this one: `torch.sort(stable=True)` and a scatter-add.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import words as W
from repro_torch.core.owner import _mix64

_SIGN = -(1 << 63)


class Kmer128(NamedTuple):
    hi: torch.Tensor
    lo: torch.Tensor


class Accum128(NamedTuple):
    hi: torch.Tensor          # (n,) unique hi lanes; -1 past num_unique
    lo: torch.Tensor          # (n,) unique lo lanes; -1 past num_unique
    counts: torch.Tensor      # (n,) int32; 0 past num_unique
    num_unique: torch.Tensor  # () int32


def _check_k(k: int) -> None:
    if not 31 < k <= 63:
        raise ValueError(f"k={k}: this module covers 31 < k <= 63; "
                         "use core.encoding for k <= 31")


def pack_kmers128(codes: torch.Tensor, k: int) -> Kmer128:
    """(..., m) 2-bit codes -> Kmer128 of (..., m - k + 1) word pairs."""
    _check_k(k)
    n_pos = codes.shape[-1] - k + 1
    if n_pos <= 0:
        raise ValueError(f"reads of length {codes.shape[-1]} are shorter "
                         f"than k={k}")
    hi = torch.zeros(codes.shape[:-1] + (n_pos,), dtype=torch.int64,
                     device=codes.device)
    lo = torch.zeros_like(hi)
    for j in range(k):
        # 128-bit left shift by 2: hi takes lo's top 2 bits
        hi = (hi << 2) | W.srl(lo, 62)
        lo = (lo << 2) | codes[..., j:j + n_pos].to(torch.int64)
    return Kmer128(hi=hi & ((1 << (2 * k - 64)) - 1), lo=lo)


def extract_kmers128(reads: torch.Tensor, k: int) -> Kmer128:
    p = pack_kmers128(reads, k)
    return Kmer128(hi=p.hi.reshape(-1), lo=p.lo.reshape(-1))


def sort128(kmers: Kmer128) -> Kmer128:
    """Lexicographic unsigned (hi, lo) sort: stable two-pass (LSD at word
    width)."""
    order = torch.argsort(kmers.lo ^ _SIGN, stable=True)
    hi1, lo1 = kmers.hi[order], kmers.lo[order]
    del order
    order = torch.argsort(hi1 ^ _SIGN, stable=True)
    return Kmer128(hi=hi1[order], lo=lo1[order])


def owner_pe128(kmers: Kmer128, num_pes: int) -> torch.Tensor:
    h = _mix64(kmers.hi ^ _mix64(kmers.lo))
    return W.umod(h, num_pes, 64).to(torch.int32)


def accumulate128(sorted_kmers: Kmer128) -> Accum128:
    """Run-length accumulate over a (hi, lo)-sorted stream; padding is the
    all-ones pair (-1, -1), which sorts last, as in the 64-bit path."""
    hi, lo = sorted_kmers.hi, sorted_kmers.lo
    n = hi.shape[0]
    sent = W.sentinel(64)
    valid = ~((hi == sent) & (lo == sent))
    # the first pair's predecessor is the padding pair, so it starts a
    # run exactly when it is valid
    is_new = valid.clone()
    is_new[1:] &= (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    seg = torch.clamp(torch.cumsum(is_new, 0) - 1, min=0)
    counts = torch.zeros((n,), dtype=torch.int32, device=hi.device)
    counts.scatter_add_(0, seg, valid.to(torch.int32))
    del valid
    starts = torch.nonzero(is_new).reshape(-1)
    num_unique = starts.numel()
    out_hi = torch.full((n,), sent, dtype=torch.int64, device=hi.device)
    out_lo = torch.full_like(out_hi, sent)
    out_hi[:num_unique] = hi[starts]
    out_lo[:num_unique] = lo[starts]
    counts[num_unique:] = 0
    return Accum128(hi=out_hi, lo=out_lo, counts=counts,
                    num_unique=torch.tensor(num_unique, dtype=torch.int32,
                                            device=hi.device))


def count_kmers_serial128(reads: torch.Tensor, k: int) -> Accum128:
    """Algorithm 1 at k in (31, 63]."""
    return accumulate128(sort128(extract_kmers128(reads, k)))


def kmer128_to_int(hi: int, lo: int) -> int:
    """Host-side: (hi, lo) -> Python int (arbitrary precision); an int64
    lane with its top bit set reads as unsigned."""
    mask = (1 << 64) - 1
    return ((int(hi) & mask) << 64) | (int(lo) & mask)
