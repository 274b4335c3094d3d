"""Radix digit histogram: per-tile counts of one digit of every key.

Counterpart of `repro.kernels.radix_hist.radix_hist_pallas`; the CUDA
kernel is `csrc/radix_hist.cu`. Rows of a (P, n) tensor are independent
key streams; the digit is read from the unsigned word.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# 2**MAX_DIGIT_BITS int32 bins fill 32 KB of the kernel's shared memory;
# must equal kMaxBits in the source.
MAX_DIGIT_BITS = 13

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_SIGNATURES = {
    "radix_hist_launch": (_P, _I64, _I64, _INT, _INT, _I64, _P, _P),
}


def radix_hist_cuda(keys: torch.Tensor, shift: int, digit_bits: int,
                    tile: int) -> torch.Tensor:
    """(P, n) int64 words -> (P, n // tile, 2**digit_bits) int32 per-tile
    digit counts. The caller checks that tile divides n."""
    build.check_arg(keys, "keys", torch.int64, 2)
    if not 1 <= digit_bits <= MAX_DIGIT_BITS:
        raise ValueError(f"digit_bits {digit_bits} outside [1, "
                         f"{MAX_DIGIT_BITS}] on the card")
    rows, n = keys.shape
    hist = torch.zeros((rows, n // tile, 1 << digit_bits), dtype=torch.int32,
                       device=keys.device)
    if keys.numel():
        lib = build.load("radix_hist", _SIGNATURES)
        build.check_status(lib.radix_hist_launch(
            keys.data_ptr(), rows, n, shift, digit_bits, tile,
            hist.data_ptr(), build.stream_ptr(keys)), "radix_hist")
    return hist
