"""Sorted-run sweeps (the Accumulate phase): run-start flags, and the
fused run-boundary and run-total sweep.

Counterparts of `repro.kernels.segment_count.segment_boundaries_pallas`
and `segment_accumulate_pallas`; the CUDA kernels are in
`csrc/segment_count.cu`. Rows of a (P, n) tensor are independent sorted
streams.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

BLOCK = 1024  # must equal kBlock in the source

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "segment_boundaries_launch": (_P, _I64, _I64, _I64, _P, _P),
    "segment_accumulate_launch": (_P, _P, _I64, _I64, _I64, _P, _P, _P, _P,
                                  _P, _P),
}


@functools.cache
def _lib():
    lib = build.load("segment_count", _SIGNATURES)
    if lib.segment_block() != BLOCK:
        raise RuntimeError("csrc/segment_count.cu block differs from BLOCK")
    return lib


def segment_boundaries_cuda(sorted_keys: torch.Tensor,
                            sentinel_val: int) -> torch.Tensor:
    """(P, n) sorted int64 words -> (P, n) bool run-start flags."""
    build.check_arg(sorted_keys, "sorted_keys", torch.int64, 2)
    rows, n = sorted_keys.shape
    is_new = torch.empty((rows, n), dtype=torch.bool,
                         device=sorted_keys.device)
    if is_new.numel():
        build.check_status(_lib().segment_boundaries_launch(
            sorted_keys.data_ptr(), rows, n, sentinel_val, is_new.data_ptr(),
            build.stream_ptr(sorted_keys)), "segment_boundaries")
    return is_new


def segment_accumulate_cuda(sorted_keys: torch.Tensor, weights: torch.Tensor,
                            sentinel_val: int):
    """(P, n) sorted int64 words + int32 weights -> (is_new, is_end,
    run_totals): bool, bool, int32, each (P, n)."""
    build.check_arg(sorted_keys, "sorted_keys", torch.int64, 2)
    build.check_arg(weights, "weights", torch.int32, 2, sorted_keys.device)
    if weights.shape != sorted_keys.shape:
        raise ValueError("weights and keys differ in shape")
    rows, n = sorted_keys.shape
    dev = sorted_keys.device
    is_new = torch.empty((rows, n), dtype=torch.bool, device=dev)
    is_end = torch.empty((rows, n), dtype=torch.bool, device=dev)
    run_tot = torch.empty((rows, n), dtype=torch.int32, device=dev)
    if rows and n:
        n_blocks = -(-n // BLOCK)
        blk_f = torch.empty((rows, n_blocks), dtype=torch.int32, device=dev)
        blk_v = torch.empty((rows, n_blocks), dtype=torch.int32, device=dev)
        build.check_status(_lib().segment_accumulate_launch(
            sorted_keys.data_ptr(), weights.data_ptr(), rows, n, sentinel_val,
            blk_f.data_ptr(), blk_v.data_ptr(), is_new.data_ptr(),
            is_end.data_ptr(), run_tot.data_ptr(),
            build.stream_ptr(sorted_keys)), "segment_accumulate")
    return is_new, is_end, run_tot
