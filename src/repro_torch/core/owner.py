"""Owner-PE and slot hashes (counterpart of `repro.core.owner`).

murmur3 / splitmix finalizers over int64-carried words. The 32-bit mixer
masks to 32 bits after each multiply; the 64-bit mixer's constants are
above 2**63 and are written as their signed equivalents. Multiplication of
int64 wraps modulo 2**64 on the CPU and on CUDA alike, which is exactly
the unsigned product's low 64 bits.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import words as W

_M32 = 0xFFFFFFFF


def _signed64(c: int) -> int:
    return c - (1 << 64) if c >= (1 << 63) else c


_C64_1 = _signed64(0xBF58476D1CE4E5B9)
_C64_2 = _signed64(0x94D049BB133111EB)
_SLOT_SALT32 = 0x9E3779B9
_SLOT_SALT64 = _signed64(0x9E3779B97F4A7C15)
_ORDER_SALT32 = 0x165667B1
_ORDER_SALT64 = _signed64(0x165667B19E3779F9)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    x = x & _M32
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _M32
    return x ^ (x >> 16)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    x = x ^ W.srl(x, 30)
    x = x * _C64_1
    x = x ^ W.srl(x, 27)
    x = x * _C64_2
    return x ^ W.srl(x, 31)


def hash_kmers(kmers: torch.Tensor, word_bits: int) -> torch.Tensor:
    """Avalanche hash of packed k-mer words (same width as the input)."""
    return _mix64(kmers) if word_bits == 64 else _mix32(kmers)


def slot_hash(kmers: torch.Tensor, word_bits: int) -> torch.Tensor:
    """Second hash family, independent of `hash_kmers` (count-store slots)."""
    if word_bits == 64:
        return _mix64(_mix64(kmers) ^ _SLOT_SALT64)
    return _mix32(_mix32(kmers) ^ _SLOT_SALT32)


def order_key(mmers: torch.Tensor, word_bits: int) -> torch.Tensor:
    """Fourth hash family: the comparison key of the hashed minimizer order.
    Bijective, so equal keys mean equal m-mers. A 64-bit key may have its
    top bit set (negative as int64): compare keys unsigned."""
    if word_bits == 64:
        return _mix64(_mix64(mmers) ^ _ORDER_SALT64)
    return _mix32(_mix32(mmers) ^ _ORDER_SALT32)


def owner_pe(kmers: torch.Tensor, num_pes: int,
             word_bits: int) -> torch.Tensor:
    """OwnerPE(kmer, P) -> int32 destination in [0, P)."""
    h = hash_kmers(kmers, word_bits)
    if num_pes & (num_pes - 1) == 0:
        return (h & (num_pes - 1)).to(torch.int32)
    return W.umod(h, num_pes, word_bits).to(torch.int32)


def owner_pe_2d(kmers: torch.Tensor, rows: int, cols: int,
                word_bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Owner of each k-mer on a rows x cols PE grid, as (row, col) int32:
    the flat owner `owner_pe(kmers, rows * cols)` folded row-major, so PE
    p is (p // cols, p % cols)."""
    flat = owner_pe(kmers, rows * cols, word_bits)
    return flat // cols, flat % cols
