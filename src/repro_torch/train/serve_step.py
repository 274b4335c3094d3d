"""Serving: prefill and decode steps, and batched generation.

Counterpart of `repro.train.serve_step` on one device. `generate` prefills
the caches once and then decodes one token a step for every sequence of
the batch, greedy (temperature 0) or sampled at a temperature from a
`torch.Generator`. Greedy tokens are the JAX package's; sampled ones
cannot be, as `jax.random` draws other numbers.

Decode steps start at the prefill's sequence length: the prompt's tokens
plus, for a VLM, the patches before them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_seq: int
    temperature: float = 0.0      # 0: greedy
    cache_dtype: str = "bfloat16"


def make_prefill_step(cfg: ModelConfig, scfg: ServeConfig):
    """prefill_step(params, batch, caches) -> (last logits (B, 1, V),
    caches)."""
    def prefill_step(params, batch, caches):
        return model_lib.prefill(params, batch, caches, cfg)
    return prefill_step


def make_decode_step(cfg: ModelConfig, scfg: ServeConfig):
    """decode(params, tokens (B, 1), caches, cache_index, gen) ->
    (next tokens (B, 1) int64, logits (B, 1, V), caches)."""
    def decode(params, tokens, caches, cache_index: int,
               gen: Optional[torch.Generator] = None):
        logits, caches = model_lib.decode_step(params, tokens, caches,
                                               cache_index, cfg)
        if scfg.temperature > 0:
            probs = torch.softmax(logits[:, -1] / scfg.temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=gen)
        else:
            nxt = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        return nxt, logits, caches
    return decode


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def generate(params: Dict, prompt: torch.Tensor, cfg: ModelConfig,
             scfg: ServeConfig, num_tokens: int, *,
             gen: Optional[torch.Generator] = None,
             extra_batch: Optional[Dict[str, torch.Tensor]] = None,
             timings: Optional[Dict[str, List[float]]] = None
             ) -> torch.Tensor:
    """Prefill `prompt` (B, S) (with `extra_batch`, e.g. a VLM's patches)
    once, then decode: -> (B, num_tokens) int64 new tokens, the first the
    prefill's argmax. With `timings`, the device is synchronised after the
    prefill and after every decode step, and their wall seconds are put
    under "prefill" and "decode" (one entry a step)."""
    dev = prompt.device
    b = prompt.shape[0]
    caches = model_lib.init_caches(cfg, b, scfg.max_seq,
                                   getattr(torch, scfg.cache_dtype),
                                   device=dev)
    batch = {"tokens": prompt, **(extra_batch or {})}
    prefill = make_prefill_step(cfg, scfg)
    decode = make_decode_step(cfg, scfg)
    t0 = time.perf_counter()
    logits, caches = prefill(params, batch, caches)
    tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
    if timings is not None:
        _sync(dev)
        timings["prefill"] = [time.perf_counter() - t0]
        timings["decode"] = []
    pos = prompt.shape[1] + (batch["patches"].shape[1]
                             if cfg.frontend.kind == "vision" else 0)
    out = [tok]
    for i in range(num_tokens - 1):
        t0 = time.perf_counter()
        tok, _, caches = decode(params, tok, caches, pos + i, gen)
        out.append(tok)
        if timings is not None:
            _sync(dev)
            timings["decode"].append(time.perf_counter() - t0)
    return torch.cat(out, dim=1)
