"""Minimizer-routed super-k-mer transport (counterpart of
`repro.core.minimizer`).

A read is cut into super-k-mers: maximal runs of consecutive k-mers that
share one (w, m)-minimizer, w = k - m + 1, capped at w k-mers. A run
travels as its bases packed into fixed payload words plus an int32 length
header, to the owner of its minimizer; the receiver re-extracts the k-mers.
The minimizer of a k-mer is the m-mer VALUE that is smallest among its w
m-mers under the order: 'plain' compares the words, 'hashed' compares
`owner.order_key` of the words. Both compare unsigned (the sliding-minimum
kernels, `kernels.ops.sliding_min` / `sliding_min_pair`).

Every function takes any leading dimensions: the counting path passes
(P, reads, bases) chunks, one row per processing element. Words are
int64-carried (`repro_torch.words`): payload words have the width of the
k-mer word, minimizers the width of the m-mer word.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.core import encoding, owner
from repro_torch.kernels import ops


def window_size(k: int, m: int) -> int:
    """w: m-mer positions inside one k-mer."""
    if not 1 <= m <= k:
        raise ValueError(f"minimizer length m={m} outside [1, k={k}]")
    return k - m + 1


def max_bases(k: int, m: int) -> int:
    """Longest super-k-mer in bases: k + w - 1 = 2k - m."""
    return k + window_size(k, m) - 1


def bases_per_word(k: int, bits_per_symbol: int = 2) -> int:
    """Payload bases per wire word (the full k-mer word width)."""
    return encoding.word_bits(k, bits_per_symbol) // bits_per_symbol


def superkmer_words(k: int, m: int, bits_per_symbol: int = 2) -> int:
    """Payload words per super-k-mer slot (the worst-case length)."""
    return -(-max_bases(k, m) // bases_per_word(k, bits_per_symbol))


def slot_bytes(k: int, m: int, bits_per_symbol: int = 2) -> int:
    """Wire bytes per slot: payload words plus the int32 length header."""
    word_b = encoding.word_bits(k, bits_per_symbol) // 8
    return superkmer_words(k, m, bits_per_symbol) * word_b + 4


def expected_superkmers(n_reads: int, read_len: int, k: int, m: int) -> int:
    """Expected super-k-mer slots per chunk: minimizer density 2 / (w + 1)
    per k-mer plus one run per read head, at most one run per k-mer."""
    n_kmers = read_len - k + 1
    w = window_size(k, m)
    per_read = min(int(math.ceil(n_kmers * 2.0 / (w + 1))) + 1, n_kmers)
    return n_reads * per_read


class SuperKmers(NamedTuple):
    """One slot per k-mer position (reads row-major), per leading row."""
    words: torch.Tensor       # (..., n_slots, S) payload words, zero-padded
    lengths: torch.Tensor     # (..., n_slots) int32 run length; 0 = invalid
    minimizers: torch.Tensor  # (..., n_slots) m-mer words (any where invalid)


def window_minimizers(codes: torch.Tensor, k: int, m: int,
                      bits_per_symbol: int = 2, *, canonical: bool = False,
                      canonical_impl: str = "fused",
                      order: str = "plain") -> torch.Tensor:
    """(..., n_reads, mlen) codes -> (..., n_reads, mlen - k + 1) minimizer
    words: entry p is the m-mer value of the k-mer at base p that is
    smallest under `order`."""
    w = window_size(k, m)
    mmers = encoding.pack_kmers(codes, m, bits_per_symbol,
                                canonical=canonical,
                                canonical_impl=canonical_impl)
    lead, n_pos = mmers.shape[:-1], mmers.shape[-1]
    flat = mmers.reshape(-1, n_pos)
    if order == "hashed":
        key = owner.order_key(flat, encoding.word_bits(m, bits_per_symbol))
        minz = ops.sliding_min_pair(key, flat, w)[1]
    elif order == "plain":
        minz = ops.sliding_min(flat, w)
    else:
        raise ValueError(f"unknown minimizer order {order!r}")
    return minz.reshape(lead + (n_pos - w + 1,))


def _pack_windows(cpad: torch.Tensor, valid_bases: torch.Tensor,
                  n_slots: int, n_words: int, bpw: int,
                  bits_per_symbol: int) -> torch.Tensor:
    """Pack the base window starting at every slot into `n_words` words,
    LSB-first, bases at or past `valid_bases` zeroed: one gather over a
    (n_slots, n_words * bpw) index, one shift, then an OR tree over the
    bases of each word (their bit fields are disjoint)."""
    span = n_words * bpw
    dev = cpad.device
    t = torch.arange(span, device=dev)
    idx = torch.clamp(torch.arange(n_slots, device=dev)[:, None] + t[None, :],
                      max=cpad.shape[-1] - 1)
    bases = cpad[..., idx]                             # (..., n_slots, span)
    bases = torch.where(t < valid_bases[..., None], bases, 0)
    x = bases.to(torch.int64) << (bits_per_symbol * (t % bpw))
    x = x.reshape(x.shape[:-1] + (n_words, bpw))
    while x.shape[-1] > 1:                             # bpw is a power of 2
        half = x.shape[-1] // 2
        x = x[..., :half] | x[..., half:]
    return x[..., 0]


def segment_superkmers(codes: torch.Tensor, k: int, m: int,
                       bits_per_symbol: int = 2, *, canonical: bool = False,
                       canonical_impl: str = "fused",
                       order: str = "plain") -> SuperKmers:
    """Segment (..., n_reads, mlen) reads into super-k-mers and pack them.

    Slot (r, p) is valid (length > 0) iff k-mer position p starts a run in
    read r; it then covers `length` k-mers, `length + k - 1` bases from p.
    A run starts at position 0, where the minimizer value changes, and
    every w positions within a run of one value.
    """
    lead = codes.shape[:-2]
    n_reads, mlen = codes.shape[-2:]
    n_kmers = mlen - k + 1
    if n_kmers < 1:
        raise ValueError(f"reads of length {mlen} shorter than k={k}")
    w = window_size(k, m)
    bpw = bases_per_word(k, bits_per_symbol)
    if bpw & (bpw - 1):
        raise ValueError(f"{bits_per_symbol}-bit symbols do not fill the "
                         f"payload word evenly")
    codes = codes.reshape(-1, mlen)
    dev = codes.device
    minz = window_minimizers(codes, k, m, bits_per_symbol,
                             canonical=canonical,
                             canonical_impl=canonical_impl, order=order)
    rows = codes.shape[0]
    first = torch.ones((rows, 1), dtype=torch.bool, device=dev)
    is_start = torch.cat([first, minz[:, 1:] != minz[:, :-1]], 1)
    idx = torch.arange(n_kmers, device=dev)[None, :]
    cur_start = torch.cummax(torch.where(is_start, idx, -1), dim=1).values
    is_start = is_start | (((idx - cur_start) % w) == 0)
    start_idx = torch.where(is_start, idx, n_kmers)
    shifted = torch.cat([start_idx[:, 1:],
                         torch.full((rows, 1), n_kmers, device=dev)], 1)
    next_start = torch.flip(torch.cummin(torch.flip(shifted, [1]), dim=1)
                            .values, [1])
    lengths = torch.where(is_start, next_start - idx, 0).to(torch.int32)
    valid_bases = torch.where(is_start, lengths + (k - 1), 0)
    cpad = torch.cat([codes, torch.zeros((rows, w - 1), dtype=codes.dtype,
                                         device=dev)], 1)
    words = _pack_windows(cpad, valid_bases, n_kmers,
                          superkmer_words(k, m, bits_per_symbol), bpw,
                          bits_per_symbol)
    n_slots = n_reads * n_kmers
    return SuperKmers(
        words=words.reshape(lead + (n_slots, words.shape[-1])),
        lengths=lengths.reshape(lead + (n_slots,)),
        minimizers=minz.reshape(lead + (n_slots,)))


def _unpack_bases(words: torch.Tensor, n_bases: int, bpw: int,
                  bits_per_symbol: int) -> torch.Tensor:
    """(..., S) payload words -> (..., n_bases) int64 base codes. The mask
    keeps only the bits the shift brought down, so the arithmetic shift of
    a word with its top bit set reads the same codes as a logical one."""
    t = torch.arange(n_bases, device=words.device)
    per_base = words[..., t // bpw]
    return (per_base >> (bits_per_symbol * (t % bpw))) \
        & ((1 << bits_per_symbol) - 1)


def superkmer_to_kmers(words: torch.Tensor, lengths: torch.Tensor, k: int,
                       m: int, bits_per_symbol: int = 2, *,
                       canonical: bool = False,
                       canonical_impl: str = "fused"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Receiver side: (..., n_slots, S) payloads and (..., n_slots) lengths
    -> ((..., n_slots * w) k-mer words, int32 counts). Positions past a
    slot's length (and empty slots, length 0) carry the sentinel and 0."""
    w = window_size(k, m)
    bpw = bases_per_word(k, bits_per_symbol)
    codes = _unpack_bases(words, max_bases(k, m), bpw, bits_per_symbol)
    kmers = encoding.pack_kmers(codes, k, bits_per_symbol,
                                canonical=canonical,
                                canonical_impl=canonical_impl)
    pos_valid = (torch.arange(w, device=words.device)
                 < lengths.to(torch.int64)[..., None])
    sent = encoding.sentinel(k, bits_per_symbol)
    lead = lengths.shape[:-1]
    out = torch.where(pos_valid, kmers, sent).reshape(lead + (-1,))
    return out, pos_valid.to(torch.int32).reshape(lead + (-1,))


def superkmer_minimizers(words: torch.Tensor, k: int, m: int,
                         bits_per_symbol: int = 2, *, canonical: bool = False,
                         canonical_impl: str = "fused",
                         order: str = "plain") -> torch.Tensor:
    """Receiver side: each slot's minimizer, recovered from its payload as
    the minimizer of its first k-mer (bases [0, k)). Any value where the
    slot is empty."""
    bpw = bases_per_word(k, bits_per_symbol)
    codes = _unpack_bases(words, k, bpw, bits_per_symbol)
    return window_minimizers(codes[..., None, :], k, m, bits_per_symbol,
                             canonical=canonical,
                             canonical_impl=canonical_impl,
                             order=order)[..., 0, 0]
