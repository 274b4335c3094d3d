"""GQA attention block: QKV (+ bias), RoPE, attention, output projection.

Counterpart of `repro.models.attention` on its path without a KV cache
(training and full-sequence forward). `cfg.attn_impl` picks the attention:
- 'flash_train': the flash forward and backward kernels (rows 12 and 13 of
  PERF.md's table), through `ops.flash_attention_trainable`;
- 'flash': the forward kernel alone (row 11), which raises when a gradient
  is asked for;
- 'ref': the plain `ref.mha_ref`.
Any impl but 'flash_train' takes the blockwise `ref.flash_ref` when the kv
is longer than 8192, as the JAX package does.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models import layers

LONG_KV = 8192


def init_attention(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    d, h, hkv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
    p = {"wq": layers.truncated_normal(gen, (d, h, hd), d ** -0.5, device),
         "wk": layers.truncated_normal(gen, (d, hkv, hd), d ** -0.5, device),
         "wv": layers.truncated_normal(gen, (d, hkv, hd), d ** -0.5, device),
         "wo": layers.truncated_normal(gen, (h, hd, d), (h * hd) ** -0.5,
                                       device)}
    if cfg.qkv_bias:
        for name, heads in (("bq", h), ("bk", hkv), ("bv", hkv)):
            p[name] = torch.zeros((heads, hd), dtype=torch.float32,
                                  device=device)
    return p


def _project(x: torch.Tensor, w: torch.Tensor, cdt) -> torch.Tensor:
    """'btd,dhk->bthk' on the (d, h, hd) layout."""
    d, h, hd = w.shape
    return (x @ w.to(cdt).reshape(d, h * hd)).view(*x.shape[:2], h, hd)


def attention(params: dict, x: torch.Tensor, *, cfg: ModelConfig,
              window: Optional[int], positions: torch.Tensor,
              cache=None) -> torch.Tensor:
    """x (B, T, D) -> (B, T, D): full-sequence attention, no KV cache."""
    if cache is not None:
        raise NotImplementedError(
            "attention with a KV cache (prefill and decode) is not ported "
            "yet: ROADMAP.md section 1, item 12 (LM serving)")
    cdt = getattr(torch, cfg.compute_dtype)
    q = _project(x, params["wq"], cdt)
    k = _project(x, params["wk"], cdt)
    v = _project(x, params["wv"], cdt)
    if cfg.qkv_bias:
        q = q + params["bq"].to(cdt)
        k = k + params["bk"].to(cdt)
        v = v + params["bv"].to(cdt)
    q = layers.rope(q, positions, cfg.rope_theta)
    k = layers.rope(k, positions, cfg.rope_theta)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))     # (B, H, T, hd)
    band = dict(causal=cfg.causal, window=window,
                softcap=cfg.attn_logit_softcap)
    if cfg.attn_impl == "flash_train":
        out = ops.flash_attention_trainable(q, k, v, **band)
    elif cfg.attn_impl not in ("flash", "ref"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    elif k.shape[2] > LONG_KV:
        out = ref.flash_ref(q, k, v, **band)
    elif cfg.attn_impl == "flash":
        out = ops.flash_attention(q, k, v, **band)
    else:
        out = ref.mha_ref(q, k, v, **band)
    h, hd = out.shape[1], out.shape[3]
    out = out.transpose(1, 2).reshape(*x.shape[:2], h * hd)   # (B, T, H*hd)
    return out @ params["wo"].to(cdt).reshape(h * hd, -1)
