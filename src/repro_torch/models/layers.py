"""Shared neural layers: norms, RoPE, gated MLP, embedding, LM head.

Counterpart of `repro.models.layers`. Parameters are plain dicts of f32
tensors (`param_dtype`), cast to `compute_dtype` at use; the weight layouts
are the JAX package's, so the products read the same.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def truncated_normal(gen: torch.Generator, shape, scale: float,
                     device) -> torch.Tensor:
    """scale * a standard normal truncated to [-2, 2], f32."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.device.type == "meta":
        return t
    return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                       generator=gen).mul_(scale)


# --- RMSNorm -----------------------------------------------------------------

def init_rmsnorm(d: int, device) -> dict:
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6,
            mean=None) -> torch.Tensor:
    """Zero-centred scale, gemma-style: (1 + scale) * x / rms(x), in f32,
    cast back to x's dtype. `mean` maps the f32 squares (..., d) to their
    mean (..., 1) where x is one rank's share of the normed width."""
    x32 = x.float()
    sq = x32 * x32
    var = sq.mean(-1, keepdim=True) if mean is None else mean(sq)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + params["scale"])).to(x.dtype)


def gated_rmsnorm(params: dict, x: torch.Tensor, gate: torch.Tensor,
                  eps: float = 1e-6, mean=None) -> torch.Tensor:
    """Mamba2's output gate: rmsnorm(x * silu(gate)), the silu in f32 and
    cast to x's dtype before the product."""
    return rmsnorm(params, x * F.silu(gate.float()).to(x.dtype), eps, mean)


# --- RoPE --------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding on the two halves of the head dim, in f32.
    x (B, T, H, hd); positions (T,) or (B, T)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freq          # (B, T, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().split(half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --- Gated MLP (SwiGLU) ------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, d_ff: int, device) -> dict:
    return {"wi": truncated_normal(gen, (d, d_ff), d ** -0.5, device),
            "wg": truncated_normal(gen, (d, d_ff), d ** -0.5, device),
            "wo": truncated_normal(gen, (d_ff, d), d_ff ** -0.5, device)}


def mlp(params: dict, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    h = x @ params["wi"].to(compute_dtype)
    g = x @ params["wg"].to(compute_dtype)
    h = F.silu(g.float()).to(compute_dtype) * h
    return h @ params["wo"].to(compute_dtype)


# --- Embedding / LM head -----------------------------------------------------

def init_embed(gen: torch.Generator, vocab: int, d: int, device) -> dict:
    return {"tok": truncated_normal(gen, (vocab, d), 1.0, device)}


def embed(params: dict, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    """The rows of the f32 table, cast to the compute dtype: the same
    values as casting the table first, with the table's gradient summed in
    f32 (the JAX package sums it in the compute dtype)."""
    return F.embedding(tokens, params["tok"]).to(compute_dtype)


class _HeadMatmul(torch.autograd.Function):
    """x (..., d) . w (V, d)^T -> f32 logits, from compute-dtype operands
    with f32 accumulation (the products of bf16 values are exact in f32).
    The backward casts the cotangent to the compute dtype before both
    products and returns dx, dw in the operands' dtypes, as the JAX head's
    custom VJP does."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.matmul(x.float(), w.float().t())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g16 = g.to(w.dtype)
        dx = torch.matmul(g16, w).to(x.dtype)
        dw = torch.matmul(g16.reshape(-1, g16.shape[-1]).t(),
                          x.reshape(-1, x.shape[-1])).to(w.dtype)
        return dx, dw


def logits(params: dict, x: torch.Tensor, head: Optional[dict],
           softcap: Optional[float]) -> torch.Tensor:
    """LM head, tied (the embedding table) or separate; f32 output, capped
    as cap * tanh(z / cap) with a final softcap."""
    w = (head["w"] if head is not None else params["tok"]).to(x.dtype)
    out = _HeadMatmul.apply(x, w)
    if softcap is not None:
        out = softcap * torch.tanh(out / softcap)
    return out


def init_head(gen: torch.Generator, vocab: int, d: int, device) -> dict:
    return {"w": truncated_normal(gen, (vocab, d), d ** -0.5, device)}
