"""Flash attention forward and backward: the LM stack's attention kernels.

Counterparts of `repro.kernels.flash_attention.flash_attention_pallas` and
`flash_attention_fwd_lse` (one CUDA kernel in `csrc/flash_attention.cu`,
whose logsumexp output is optional) and of
`repro.kernels.flash_attention_bwd.flash_attention_bwd_pallas`
(`csrc/flash_attention_bwd.cu`: a dq kernel and a dk/dv kernel). Layout
(B, H, S, D), contiguous, float32 or bfloat16, D <= 256. Both dtypes run
on the tensor cores (wgmma). The bfloat16 kernels round P, and in the
backward dS, to bf16 before their products, as `ref.flash_fwd` /
`ref.flash_bwd` do. The float32 kernels split every f32 operand into
three bf16 parts and take each product as six bf16 products with f32
sums (`ref.split_bf16x3`, `ref.matmul_bf16x3`), which keeps f32 accuracy.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

MAX_HEAD_DIM = 256
# The kernels' smallest row tile (64 rows: the f32 kernels' q and key
# tiles, one warpgroup); a grid's y dimension holds at most 65535 tiles.
_MAX_TILES = 65535
_MIN_TILE = 64

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_F = ctypes.c_float
_BAND = (_F, _I, _I, _I64, _I, _F, _I64, _I, _P)
_SIGNATURES = {
    "flash_fwd_launch": (_P,) * 5 + (_I64,) * 6 + _BAND,
}
_BWD_SIGNATURES = {
    "flash_bwd_launch": (_P,) * 9 + (_I64,) * 4 + _BAND,
}


def _dtype_flag(t: torch.Tensor) -> int:
    if t.dtype == torch.bfloat16:
        return 1
    if t.dtype == torch.float32:
        return 0
    raise ValueError(f"flash attention takes float32 or bfloat16, got "
                     f"{t.dtype}")


def _band_args(scale: float, causal: bool, window: Optional[int],
               softcap: Optional[float], q_offset: int):
    if q_offset < 0:
        raise ValueError("q_offset must be >= 0")
    return (float(scale), int(causal), int(window is not None),
            int(window or 0), int(softcap is not None),
            float(softcap or 0.0), int(q_offset))


def _check_rows(n: int, d: int) -> None:
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {MAX_HEAD_DIM}")
    if -(-n // _MIN_TILE) > _MAX_TILES:
        raise ValueError(f"sequence of {n} rows is too long for the grid")


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, window: Optional[int],
                   softcap: Optional[float], scale: float, q_offset: int,
                   with_lse: bool):
    """q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D), Hq a multiple of Hkv ->
    o like q, and (B, Hq, Sq) f32 logsumexp when `with_lse`."""
    is_bf16 = _dtype_flag(q)
    build.check_arg(q, "q", q.dtype, 4)
    build.check_arg(k, "k", q.dtype, 4, q.device)
    build.check_arg(v, "v", q.dtype, 4, q.device)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or hkv == 0 or hq % hkv):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} disagree")
    _check_rows(sq, d)
    o = torch.empty_like(q)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if b * hq * sq:
        lib = build.load("flash_attention", _SIGNATURES)
        build.check_status(lib.flash_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), b, hq, hkv, sq, skv, d,
            *_band_args(scale, causal, window, softcap, q_offset), is_bf16,
            build.stream_ptr(q)), "flash_attention forward")
    return (o, lse) if with_lse else o


def flash_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                   causal: bool, window: Optional[int],
                   softcap: Optional[float], scale: float, q_offset: int):
    """Full head count: q, o, do (B, H, Sq, D); k, v (B, H, Skv, D); lse
    (B, H, Sq) f32 -> (dq, dk, dv) like q, k, v. rowsum(dO * O) is computed
    here in f32, outside the kernels, as the TPU wrapper does."""
    is_bf16 = _dtype_flag(q)
    for t, name in ((q, "q"), (k, "k"), (v, "v"), (o, "o"), (do, "do")):
        build.check_arg(t, name, q.dtype, 4, q.device)
    build.check_arg(lse, "lse", torch.float32, 3, q.device)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if (k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d
            or o.shape != q.shape or do.shape != q.shape
            or lse.shape != q.shape[:3]):
        raise ValueError("flash backward shapes disagree")
    _check_rows(max(sq, skv), d)
    dsum = (do.float() * o.float()).sum(-1).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if b * h * sq and skv:
        lib = build.load("flash_attention_bwd", _BWD_SIGNATURES)
        build.check_status(lib.flash_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b * h, sq, skv, d,
            *_band_args(scale, causal, window, softcap, q_offset), is_bf16,
            build.stream_ptr(q)), "flash_attention backward")
    else:
        for t in (dq, dk, dv):
            t.zero_()
    return dq, dk, dv
