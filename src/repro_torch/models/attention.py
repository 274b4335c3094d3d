"""GQA attention block: QKV (+ bias), RoPE, attention, output projection,
with an optional KV cache.

Counterpart of `repro.models.attention`. With a `KVCache` (serving), the
new keys and values are written into the cache at `cache_index` (prefill:
positions [cache_index, cache_index + T); decode: position cache_index),
IN PLACE, and the attention reads the whole cache cast to the compute
dtype through the plain `ref.mha_ref` with q_offset=cache_index, as the
JAX package does. So a bf16 cache rounds k and v even under f32 compute.
Without a cache (training and full-sequence forward), `cfg.attn_impl`
picks the attention:
- 'flash_train': the flash forward and backward kernels (rows 12 and 13 of
  PERF.md's table), through `ops.flash_attention_trainable`;
- 'flash': the forward kernel alone (row 11), which raises when a gradient
  is asked for;
- 'ref': the plain `ref.mha_ref`.
Any impl but 'flash_train' takes the blockwise `ref.flash_ref` when the kv
is longer than 8192, as the JAX package does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models import layers

LONG_KV = 8192


class KVCache(NamedTuple):
    k: torch.Tensor      # (B, Hkv, S_max, hd)
    v: torch.Tensor


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, *, device) -> KVCache:
    shape = (batch, cfg.num_kv_heads, max_seq, cfg.resolved_head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


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
              cache: Optional[KVCache] = None, cache_index: int = 0,
              ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """x (B, T, D) -> (y (B, T, D), cache). With a cache, T is the count of
    new tokens (decode: 1) and `cache_index` their first position; the
    cache is updated in place and returned."""
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
    if cache is not None:
        end = cache_index + q.shape[2]
        cache.k[:, :, cache_index:end] = k.to(cache.k.dtype)
        cache.v[:, :, cache_index:end] = v.to(cache.v.dtype)
        out = ref.mha_ref(q, cache.k.to(q.dtype), cache.v.to(q.dtype),
                          q_offset=cache_index, **band)
    elif cfg.attn_impl == "flash_train":
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
    return out @ params["wo"].to(cdt).reshape(h * hd, -1), cache
