"""Serving: prefill and decode steps, and batched generation.

Counterpart of `repro.train.serve_step`. `generate` prefills the caches
once and then decodes one token a step for every sequence of the batch,
greedy (temperature 0) or sampled at a temperature from a
`torch.Generator`. Greedy tokens are the JAX package's; sampled ones
cannot be, as `jax.random` draws other numbers.

Decode steps start at the prefill's sequence length: the prompt's tokens
plus, for a VLM, the patches before them.

Sharded (`group=`, a `launch.mesh.MeshGroup` whose `.mesh` is the JAX
`mesh=`; one process a rank, every rank calling with the same
arguments): each rank holds its blocks of the parameters
(`sharding.shard_params`) and runs `models/parallel.py`'s `RankModel`.
The batch rows split over `data` where they divide, and each rank's
caches take the local blocks of `sharding.cache_specs` (the conv state
its channels): head-parallel where the KV heads divide `model`, else
the cache sequence over `model`, and over `data` too where the rows do
not split, with a distributed flash-decode. The logits are
vocab-parallel: a greedy pick is one (max, index) all-gather over
`model`, a sampled one draws from the gathered logits with a generator
every rank seeds alike. `generate` takes the global prompt on every rank
and returns every row's tokens on every rank.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib
from repro_torch.models import parallel


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_seq: int
    temperature: float = 0.0      # 0: greedy
    cache_dtype: str = "bfloat16"


def rank_model(cfg: ModelConfig, scfg: ServeConfig, group, batch: int
               ) -> parallel.RankModel:
    """The rank's model serving a global batch of `batch` rows on
    `group` (a `launch.mesh.MeshGroup`): its `rows`, `init_caches`,
    `prefill`, `decode_step` and token picks."""
    return parallel.RankModel(cfg, group, serve_batch=batch,
                              max_seq=scfg.max_seq)


def _rank(cfg, scfg, group, batch, rank):
    if rank is None and group is not None:
        rank = rank_model(cfg, scfg, group, batch)
    return rank


def make_prefill_step(cfg: ModelConfig, scfg: ServeConfig, *, group=None,
                      batch: Optional[int] = None,
                      rank: Optional[parallel.RankModel] = None):
    """prefill_step(params, batch, caches) -> (last logits (B, 1, V),
    caches). With `group` and the global `batch` size, or with `rank`
    (a `rank_model`, to share its caches' layout and collectives
    counter): the rank's blocks, rows and caches (`init_caches`), and
    logits of its vocabulary's columns."""
    rm = _rank(cfg, scfg, group, batch, rank)
    if rm is not None:
        return rm.prefill

    def prefill_step(params, batch, caches):
        return model_lib.prefill(params, batch, caches, cfg)
    return prefill_step


def make_decode_step(cfg: ModelConfig, scfg: ServeConfig, *, group=None,
                     batch: Optional[int] = None,
                     rank: Optional[parallel.RankModel] = None):
    """decode(params, tokens (B, 1), caches, cache_index, gen) ->
    (next tokens (B, 1) int64, logits (B, 1, V), caches); with `group` or
    `rank`, as `make_prefill_step`."""
    rm = _rank(cfg, scfg, group, batch, rank)

    def decode(params, tokens, caches, cache_index: int,
               gen: Optional[torch.Generator] = None):
        if rm is not None:
            logits, caches = rm.decode_step(params, tokens, caches,
                                            cache_index)
            nxt = (rm.sample(logits, scfg.temperature, gen)
                   if scfg.temperature > 0 else rm.greedy(logits))
            return nxt, logits, caches
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
             scfg: ServeConfig, num_tokens: int, *, group=None,
             gen: Optional[torch.Generator] = None,
             extra_batch: Optional[Dict[str, torch.Tensor]] = None,
             timings: Optional[Dict[str, List[float]]] = None,
             logits: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """Prefill `prompt` (B, S) (with `extra_batch`, e.g. a VLM's patches)
    once, then decode: -> (B, num_tokens) int64 new tokens, the first the
    prefill's argmax. With `timings`, the device is synchronised after the
    prefill and after every decode step, and their wall seconds are put
    under "prefill" and "decode" (one entry a step); with `group`, also
    the decode steps' collective calls and bytes a step (with `logits`,
    their gathers included). With `logits`, each
    step's last-position (B, V) logits are appended to it. With `group`
    (module docstring), `params` are this rank's blocks and `prompt` and
    `extra_batch` the global batch."""
    dev = prompt.device
    b = prompt.shape[0]
    batch = {"tokens": prompt, **(extra_batch or {})}
    dtype = getattr(torch, scfg.cache_dtype)
    if group is None:
        rm = None
        caches = model_lib.init_caches(cfg, b, scfg.max_seq, dtype,
                                       device=dev)
    else:
        rm = rank_model(cfg, scfg, group, b)
        batch = {k: rm.rows(v) for k, v in batch.items()}
        caches = rm.init_caches(dtype, dev)
    prefill = make_prefill_step(cfg, scfg, rank=rm)
    decode = make_decode_step(cfg, scfg, rank=rm)
    t0 = time.perf_counter()
    lg, caches = prefill(params, batch, caches)
    tok = (torch.argmax(lg[:, -1], dim=-1, keepdim=True) if rm is None
           else rm.greedy(lg))
    if logits is not None:
        logits.append(lg[:, -1] if rm is None else rm.full_logits(lg))
    if timings is not None:
        _sync(dev)
        timings["prefill"] = [time.perf_counter() - t0]
        timings["decode"] = []
        before = None if rm is None else dict(rm.collectives)
    pos = prompt.shape[1] + (batch["patches"].shape[1]
                             if cfg.frontend.kind == "vision" else 0)
    out = [tok]
    for i in range(num_tokens - 1):
        t0 = time.perf_counter()
        tok, lg, caches = decode(params, tok, caches, pos + i, gen)
        out.append(tok)
        if logits is not None:
            logits.append(lg[:, -1] if rm is None else rm.full_logits(lg))
        if timings is not None:
            _sync(dev)
            timings["decode"].append(time.perf_counter() - t0)
    if timings is not None and rm is not None and num_tokens > 1:
        for key in ("calls", "bytes"):
            timings["decode_collective_" + key] = [
                (rm.collectives[key] - before.get(key, 0))
                / (num_tokens - 1)]
    toks = torch.cat(out, dim=1)
    return toks if rm is None else rm.join_rows(toks)
