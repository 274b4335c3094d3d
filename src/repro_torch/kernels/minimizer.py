"""Sliding-window minimum: minimizer selection of the super-k-mer transport.

Counterpart of `repro.kernels.minimizer` (`sliding_min_pallas`,
`sliding_min_pair_pallas`); the CUDA kernels are in `csrc/minimizer.cu`.
Words are int64-carried and compared unsigned. A launch covers every row;
the block's layout follows the row length (`_plain_layout`, `_pair_block`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_SIGNATURES = {
    "sliding_min_launch": (_P, _P, _I64, _I64, _INT, _INT, _INT, _P),
    "sliding_min_pair_launch": (_P, _P, _P, _P, _I64, _I64, _INT, _INT, _INT,
                                _P),
}
_THREADS = 256
_SMEM_BYTES = 48 * 1024
_MAX_POS_TILES = 65535
# The 'plain' kernel: rows of up to _ROW_WORDS words go whole, as many to a
# block as fit in _ROW_WORDS; a longer row goes in position tiles of at
# least _MIN_TILE outputs. A block stages its words and their forward
# minima, 16 bytes apiece, within the 227 KB of shared memory a block can
# have.
_ROW_WORDS = 2048
_MIN_TILE = 256
_MAX_SPAN = (227 * 1024 // 8 - 2) // 2


@functools.cache
def _plain_layout(n_pos: int, window: int):
    """(seg_rows, tp) of the 'plain' kernel: seg_rows whole rows a block
    (tp = 0), or tp positions of one row a block (seg_rows = 1)."""
    if n_pos <= _ROW_WORDS:
        return _ROW_WORDS // n_pos, 0
    n_out = n_pos - window + 1
    tp = max(_MIN_TILE, _ROW_WORDS - (window - 1))
    if min(tp, n_out) + window - 1 > _MAX_SPAN:
        raise ValueError(f"window {window} too wide for the kernel's "
                         f"shared-memory tile")
    return 1, tp


@functools.cache
def _pair_block(n_out: int, window: int):
    """(tp, rb): output positions and rows per block of the pair kernel. tp
    is the smallest power of two covering the row's outputs (at most 128),
    rb fills the block to 256 threads and is halved until the staged keys
    and values fit 48 KB."""
    tp = 1
    while tp < min(n_out, 128):
        tp *= 2
    rb = max(1, _THREADS // tp)
    while rb > 1 and 2 * rb * (tp + window - 1) * 8 > _SMEM_BYTES:
        rb //= 2
    if 2 * rb * (tp + window - 1) * 8 > _SMEM_BYTES:
        raise ValueError(f"window {window} too wide for the kernel's "
                         f"shared-memory tile")
    if -(-n_out // tp) > _MAX_POS_TILES:
        raise ValueError(f"{n_out} outputs per row exceed the kernel's grid")
    return tp, rb


def sliding_min_cuda(vals: torch.Tensor, window: int) -> torch.Tensor:
    """(rows, n_pos) words -> (rows, n_pos - window + 1) unsigned minima."""
    build.check_arg(vals, "vals", torch.int64, 2)
    rows, n_pos = vals.shape
    out = torch.empty((rows, n_pos - window + 1), dtype=torch.int64,
                      device=vals.device)
    if out.numel():
        seg_rows, tp = _plain_layout(n_pos, window)
        lib = build.load("minimizer", _SIGNATURES)
        build.check_status(lib.sliding_min_launch(
            vals.data_ptr(), out.data_ptr(), rows, n_pos, window, seg_rows,
            tp, build.stream_ptr(vals)), "sliding_min")
    return out


def sliding_min_pair_cuda(keys: torch.Tensor, vals: torch.Tensor,
                          window: int):
    """Minimum by unsigned key over each window, carrying the value; the
    earliest position wins a tie. Returns (keys, vals), (rows, n_out)."""
    build.check_arg(keys, "keys", torch.int64, 2)
    build.check_arg(vals, "vals", torch.int64, 2, keys.device)
    if vals.shape != keys.shape:
        raise ValueError(f"keys {tuple(keys.shape)} != vals "
                         f"{tuple(vals.shape)}")
    rows, n_pos = keys.shape
    n_out = n_pos - window + 1
    kout = torch.empty((rows, n_out), dtype=torch.int64, device=keys.device)
    vout = torch.empty_like(kout)
    if kout.numel():
        tp, rb = _pair_block(n_out, window)
        lib = build.load("minimizer", _SIGNATURES)
        build.check_status(lib.sliding_min_pair_launch(
            keys.data_ptr(), vals.data_ptr(), kout.data_ptr(),
            vout.data_ptr(), rows, n_pos, window, tp, rb,
            build.stream_ptr(keys)), "sliding_min_pair")
    return kout, vout
