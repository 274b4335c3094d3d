"""The word representation of the port.

PyTorch has no shifts, comparisons, min or scatter for uint32/uint64 on the
CPU, so every k-mer word travels as int64 beside a static `word_bits`
(32 for k <= 15, 64 above, as the JAX package picks uint32/uint64):

- a 32-bit word is zero-extended, so it is a non-negative int64;
- a 64-bit word is the same 64 bits read as two's complement.

Three consequences the rest of the port relies on:

- the sentinel (all ones) is 0xFFFFFFFF for 32-bit words and -1 for 64-bit
  words (`sentinel`);
- a right shift must be logical (`srl`), since `>>` on int64 copies the
  sign bit;
- the remainder of an unsigned 64-bit hash is composed from 32-bit halves
  (`umod`), since `%` on int64 is signed.

`to_torch_words` / `to_numpy_words` convert at the boundary to numpy, which
is how data and stores built by the JAX package cross over.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF


def word_bits_of(dtype) -> int:
    """32 or 64 for a numpy unsigned word dtype."""
    dt = np.dtype(dtype)
    if dt == np.uint32:
        return 32
    if dt == np.uint64:
        return 64
    raise ValueError(f"not a word dtype: {dt}")


def sentinel(word_bits: int) -> int:
    """The all-ones padding word, as the int64 value that carries it."""
    if word_bits == 32:
        return _MASK32
    if word_bits == 64:
        return -1
    raise ValueError(f"word_bits must be 32 or 64, got {word_bits}")


def srl(x: torch.Tensor, s: int, word_bits: int = 64) -> torch.Tensor:
    """Logical right shift of int64-carried words by a static amount."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (word_bits - s)) - 1)


def umod(h: torch.Tensor, c: int, word_bits: int) -> torch.Tensor:
    """Unsigned `h % c` of int64-carried words, for 1 <= c < 2**31.

    A 64-bit word with its top bit set is negative as int64, so the
    remainder is composed from its 32-bit halves; every product stays
    below 2**62.
    """
    if not 1 <= c < (1 << 31):
        raise ValueError(f"modulus {c} outside [1, 2**31)")
    if word_bits == 32:
        return h % c
    hi = srl(h, 32)
    lo = h & _MASK32
    return ((hi % c) * ((1 << 32) % c) + lo % c) % c


def to_torch_words(arr, device=None) -> Tuple[torch.Tensor, int]:
    """numpy uint32/uint64 words -> (int64 tensor, word_bits); a copy, so
    in-place updates of the tensor never reach the array."""
    arr = np.asarray(arr)
    bits = word_bits_of(arr.dtype)
    as64 = arr.astype(np.int64) if bits == 32 else arr.view(np.int64)
    return torch.from_numpy(np.array(as64, order="C")).to(device), bits


def to_numpy_words(t: torch.Tensor, word_bits: int) -> np.ndarray:
    """int64-carried words -> numpy uint32/uint64."""
    a = t.detach().to("cpu").contiguous().numpy()
    if word_bits == 32:
        return a.astype(np.uint32)
    if word_bits == 64:
        return a.view(np.uint64)
    raise ValueError(f"word_bits must be 32 or 64, got {word_bits}")
