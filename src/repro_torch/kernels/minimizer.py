"""Sliding-window minimum: minimizer selection of the super-k-mer transport.

Counterpart of `repro.kernels.minimizer` (`sliding_min_pallas`,
`sliding_min_pair_pallas`); the CUDA kernels are in `csrc/minimizer.cu`.
Words are int64-carried and compared unsigned. A launch covers every row;
the block shape follows the row length (see `_block`).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_SIGNATURES = {
    "sliding_min_launch": (_P, _P, _P, _P, _I64, _I64, _INT, _INT, _INT, _INT,
                           _P),
}
_THREADS = 256
_SMEM_BYTES = 48 * 1024
_MAX_POS_TILES = 65535


def _block(n_out: int, window: int, lanes: int):
    """(tp, rb): output positions and rows per block. tp is the smallest
    power of two covering the row's outputs (at most 128), rb fills the
    block to 256 threads and is halved until the staged words fit 48 KB."""
    tp = 1
    while tp < min(n_out, 128):
        tp *= 2
    rb = max(1, _THREADS // tp)
    while rb > 1 and lanes * rb * (tp + window - 1) * 8 > _SMEM_BYTES:
        rb //= 2
    if lanes * rb * (tp + window - 1) * 8 > _SMEM_BYTES:
        raise ValueError(f"window {window} too wide for the kernel's "
                         f"shared-memory tile")
    if -(-n_out // tp) > _MAX_POS_TILES:
        raise ValueError(f"{n_out} outputs per row exceed the kernel's grid")
    return tp, rb


def _launch(keys, vals, window: int):
    pair = vals is not None
    build.check_arg(keys, "keys", torch.int64, 2)
    if pair:
        build.check_arg(vals, "vals", torch.int64, 2, keys.device)
        if vals.shape != keys.shape:
            raise ValueError(f"keys {tuple(keys.shape)} != vals "
                             f"{tuple(vals.shape)}")
    rows, n_pos = keys.shape
    n_out = n_pos - window + 1
    kout = torch.empty((rows, n_out), dtype=torch.int64, device=keys.device)
    vout = torch.empty_like(kout) if pair else None
    if kout.numel():
        tp, rb = _block(n_out, window, 2 if pair else 1)
        lib = build.load("minimizer", _SIGNATURES)
        build.check_status(lib.sliding_min_launch(
            keys.data_ptr(), vals.data_ptr() if pair else None,
            kout.data_ptr(), vout.data_ptr() if pair else None, rows, n_pos,
            window, int(pair), tp, rb, build.stream_ptr(keys)),
            "sliding_min_pair" if pair else "sliding_min")
    return kout, vout


def sliding_min_cuda(vals: torch.Tensor, window: int) -> torch.Tensor:
    """(rows, n_pos) words -> (rows, n_pos - window + 1) unsigned minima."""
    return _launch(vals, None, window)[0]


def sliding_min_pair_cuda(keys: torch.Tensor, vals: torch.Tensor,
                          window: int):
    """Minimum by unsigned key over each window, carrying the value; the
    earliest position wins a tie. Returns (keys, vals), (rows, n_out)."""
    return _launch(keys, vals, window)
