"""2-bit DNA encoding and k-mer packing (counterpart of `repro.core.encoding`).

Words are int64 tensors with a static word width (see `repro_torch.words`):
32 bits for k * bits_per_symbol <= 30, 64 bits up to 62. Spare high bits
keep the sentinel distinct from every valid k-mer and hold L3 counts.
Host-side helpers read ASCII into codes (`encode_ascii`) and codes and
words back into strings (`decode_codes_np`, `unpack_kmer_np`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch import words as W

BASE_TO_CODE = {"A": 0, "C": 1, "G": 2, "T": 3}
CODE_TO_BASE = "ACGT"


def kmer_bits(k: int, bits_per_symbol: int = 2) -> int:
    return k * bits_per_symbol


def word_bits(k: int, bits_per_symbol: int = 2) -> int:
    """Width of the word that holds a k-mer plus at least 2 spare bits."""
    bits = kmer_bits(k, bits_per_symbol)
    if bits <= 30:
        return 32
    if bits <= 62:
        return 64
    raise ValueError(
        f"k={k} at {bits_per_symbol} bits a symbol needs {bits} bits, past "
        f"the 62 a 64-bit word holds with its 2 spare bits (max k is 31 "
        f"for DNA; core.encoding128 counts DNA k-mers up to k=63)")


def spare_bits(k: int, bits_per_symbol: int = 2) -> int:
    return word_bits(k, bits_per_symbol) - kmer_bits(k, bits_per_symbol)


def kmer_mask(k: int, bits_per_symbol: int = 2) -> int:
    return (1 << kmer_bits(k, bits_per_symbol)) - 1


def sentinel(k: int, bits_per_symbol: int = 2) -> int:
    """Padding word: sorts after every valid (possibly count-packed) word."""
    return W.sentinel(word_bits(k, bits_per_symbol))


_ASCII_LUT = np.full((256,), 255, dtype=np.uint8)
for _b, _c in BASE_TO_CODE.items():
    _ASCII_LUT[ord(_b)] = _c
    _ASCII_LUT[ord(_b.lower())] = _c


def encode_ascii(ascii_bytes) -> torch.Tensor:
    """uint8 ASCII read characters (array or tensor) -> uint8 2-bit codes,
    255 for non-ACGT, on the input's device."""
    if not isinstance(ascii_bytes, torch.Tensor):
        ascii_bytes = torch.from_numpy(np.ascontiguousarray(ascii_bytes))
    lut = torch.from_numpy(_ASCII_LUT).to(ascii_bytes.device)
    return lut[ascii_bytes.to(torch.int64)]


def decode_codes_np(codes: np.ndarray) -> str:
    return "".join(CODE_TO_BASE[int(c)] for c in codes)


def pack_kmers(codes: torch.Tensor, k: int, bits_per_symbol: int = 2, *,
               canonical: bool = False,
               canonical_impl: str = "fused") -> torch.Tensor:
    """(..., m) symbol codes -> (..., m - k + 1) int64 k-mer words.

    Shift-or over the k window offsets. With `canonical` the word is
    min(forward, reverse complement): 'fused' builds the reverse complement
    in the same loop, 'sweep' packs first and runs `revcomp` after.
    """
    word_bits(k, bits_per_symbol)
    m = codes.shape[-1]
    n_pos = m - k + 1
    if n_pos <= 0:
        raise ValueError(f"reads of length {m} are shorter than k={k}")
    if canonical and bits_per_symbol != 2:
        raise ValueError("canonical k-mers are defined for 2-bit DNA codes")
    if canonical and canonical_impl not in ("fused", "sweep"):
        raise ValueError(f"unknown canonical_impl {canonical_impl!r}")
    acc = torch.zeros(codes.shape[:-1] + (n_pos,), dtype=torch.int64,
                      device=codes.device)
    fused = canonical and canonical_impl == "fused"
    rc = torch.zeros_like(acc) if fused else None
    for j in range(k):
        window = codes[..., j:j + n_pos].to(torch.int64)
        acc = (acc << bits_per_symbol) | window
        if fused:
            rc = rc | ((window ^ 3) << (2 * j))
    if fused:
        return torch.minimum(acc, rc)
    if canonical:
        return torch.minimum(acc, revcomp(acc, k))
    return acc


def extract_kmers(reads: torch.Tensor, k: int, bits_per_symbol: int = 2, *,
                  canonical: bool = False,
                  canonical_impl: str = "fused") -> torch.Tensor:
    """(..., n_reads, m) codes -> (..., n_reads * (m - k + 1)) words."""
    words = pack_kmers(reads, k, bits_per_symbol, canonical=canonical,
                       canonical_impl=canonical_impl)
    return words.reshape(words.shape[:-2] + (-1,))


def unpack_kmer_np(word: int, k: int, bits_per_symbol: int = 2) -> str:
    """Host-side decode of a packed DNA k-mer word to its string. An
    int64-carried 64-bit word with its top bit set reads as unsigned."""
    word = int(word) & ((1 << 64) - 1)
    out = []
    mask = (1 << bits_per_symbol) - 1
    for j in reversed(range(k)):
        out.append(CODE_TO_BASE[(word >> (j * bits_per_symbol)) & mask])
    return "".join(out)


def revcomp(kmers: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of packed 2-bit DNA k-mers (A<->T, C<->G)."""
    comp = (~kmers) & kmer_mask(k)
    out = torch.zeros_like(kmers)
    for _ in range(k):
        out = (out << 2) | (comp & 3)
        comp = W.srl(comp, 2)
    return out


def canonical(kmers: torch.Tensor, k: int) -> torch.Tensor:
    # Both words are below 2**62, so the signed minimum is the unsigned one.
    return torch.minimum(kmers, revcomp(kmers, k))


def count_capacity(k: int, bits_per_symbol: int = 2) -> int:
    """Max count representable in the spare high bits (0 -> no packing)."""
    s = spare_bits(k, bits_per_symbol)
    if s < 2:
        return 0
    # the all-ones word stays the sentinel
    return (1 << s) - 2


def pack_counts(kmers: torch.Tensor, counts: torch.Tensor, k: int,
                bits_per_symbol: int = 2) -> torch.Tensor:
    """Pack per-k-mer counts (>= 1, saturating) into the spare high bits."""
    cap = count_capacity(k, bits_per_symbol)
    if cap == 0:
        raise ValueError(f"k={k}: no spare bits for count packing")
    c = torch.clamp(counts.to(torch.int64), max=cap)
    return kmers | (c << kmer_bits(k, bits_per_symbol))


def unpack_counts(packed: torch.Tensor, k: int, bits_per_symbol: int = 2
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split count-packed words into (k-mer words, int32 counts)."""
    shift = kmer_bits(k, bits_per_symbol)
    kmers = packed & kmer_mask(k, bits_per_symbol)
    counts = W.srl(packed, shift, word_bits(k, bits_per_symbol))
    return kmers, counts.to(torch.int32)
