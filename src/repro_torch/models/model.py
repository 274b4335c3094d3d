"""Config-driven model assembly for all ten architectures.

Counterpart of `repro.models.model`. A stack is a repeating `period` of
layer kinds: 'attn' and 'attn_local' (attention + MLP), 'moe' (attention +
mixture of experts), 'mamba' (the Mamba2 block) and 'mamba_shared_attn'
(zamba2: a Mamba2 block, then ONE attention + MLP block whose weights all
such layers share, with norms of their own). Parameters are a plain dict:

    {"embed": {"tok": (V, d)}            (absent for the audio frontend),
     "frontend": {"proj": (F, d)}        (vision and audio only),
     "head": {"w": (V, d)}               (untied, or audio),
     "final_norm": {"scale": (d,)},
     "shared_attn": {"attn", "mlp"}      (zamba2 only),
     "blocks": [layer 0, layer 1, ...]}

Layer l is slot l % len(period) of period group l // len(period): the JAX
package stacks the same leaves per slot over the groups (`models/convert.py`
maps one layout onto the other). The layers run in a Python loop; with
`remat='full'` each layer is a `torch.utils.checkpoint` region when a
gradient is taken.

Serving caches are a list with one dict a layer: {"kv": KVCache} for the
attention kinds, {"ssm": SSMState} for 'mamba', and both for
'mamba_shared_attn'. `prefill` and `decode_step` update the KV caches in
place and return the list with the new SSM states.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, frontends, layers, moe, ssm

KINDS = ("attn", "attn_local", "mamba", "mamba_shared_attn", "moe")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ValueError for a layer kind or remat setting no code runs."""
    for kind in cfg.period:
        if kind not in KINDS:
            raise ValueError(f"unknown layer kind {kind!r}")
    if cfg.remat not in ("none", "full"):
        raise ValueError(f"unknown remat {cfg.remat!r}")


def named_leaves(tree, prefix: Tuple = ()
                 ) -> Iterator[Tuple[Tuple, torch.Tensor]]:
    """(path, tensor) for every leaf of a parameter-shaped tree, in a fixed
    order; a path is a tuple of dict keys and list indices."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from named_leaves(tree[key], prefix + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from named_leaves(sub, prefix + (i,))
    else:
        yield prefix, tree


def map_leaves(fn, tree):
    """The same tree with every leaf replaced by fn(leaf), visited in the
    order of `named_leaves`."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [map_leaves(fn, v) for v in tree]
    return fn(tree)


# --- Parameters --------------------------------------------------------------

def _init_slot(gen: torch.Generator, kind: str, cfg: ModelConfig,
               device) -> Dict:
    d = cfg.d_model
    if kind in ("attn", "attn_local", "moe"):
        p = {"ln1": layers.init_rmsnorm(d, device),
             "attn": attention.init_attention(gen, cfg, device),
             "ln2": layers.init_rmsnorm(d, device)}
        if kind == "moe":
            p["moe"] = moe.init_moe(gen, cfg, device)
        else:
            p["mlp"] = layers.init_mlp(gen, d, cfg.d_ff, device)
        return p
    p = {"ln": layers.init_rmsnorm(d, device),
         "mamba": ssm.init_mamba(gen, cfg, device)}
    if kind == "mamba_shared_attn":
        # The attention and MLP weights are shared (zamba2); only the norms
        # before them are the layer's own.
        p["ln_sa"] = layers.init_rmsnorm(d, device)
        p["ln_sm"] = layers.init_rmsnorm(d, device)
    return p


def init_params(cfg: ModelConfig, *, seed: int, device) -> Dict:
    """Seeded init from one `torch.Generator` on `device`, with the JAX
    package's distributions (truncated normals, zero norms and biases, the
    Mamba2 dt and A rules). The numbers differ from `jax.random`'s: parity
    runs carry the JAX package's own parameters across
    (`convert.params_from_jax`)."""
    check_supported(cfg)
    device = torch.device(device)
    # On `meta` (the dry-run's abstract init) there are no numbers to draw.
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(seed))
    d, kind = cfg.d_model, cfg.frontend.kind
    params: Dict = {}
    if kind != "audio":
        params["embed"] = layers.init_embed(gen, cfg.vocab_size, d, device)
    if kind != "none":
        params["frontend"] = frontends.init_frontend(gen, cfg, device)
    if not cfg.tie_embeddings or kind == "audio":
        params["head"] = layers.init_head(gen, cfg.vocab_size, d, device)
    params["final_norm"] = layers.init_rmsnorm(d, device)
    if "mamba_shared_attn" in cfg.period:
        params["shared_attn"] = {
            "attn": attention.init_attention(gen, cfg, device),
            "mlp": layers.init_mlp(gen, d, cfg.d_ff, device)}
    params["blocks"] = [_init_slot(gen, cfg.period[i % len(cfg.period)], cfg,
                                   device)
                        for i in range(cfg.num_layers)]
    return params


def abstract_params(cfg: ModelConfig) -> Dict:
    """The tree of `init_params` on `meta`: every leaf's shape and dtype,
    no storage (the counterpart of `jax.eval_shape(init_params)`)."""
    return init_params(cfg, seed=0, device="meta")


# --- One layer ---------------------------------------------------------------

class Blocks:
    """The blocks a layer is made of, on one process: attention, the gated
    MLP, the MoE block and the Mamba2 block. `models/parallel.py`'s
    `RankModel` gives the same methods for one rank's share of a mesh, so
    `_layer` wires the layer kinds once for both."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def layer_params(self, p, i):
        """Layer i's parameters as its blocks read them."""
        return p

    def attention(self, p, x, *, window, positions, cache, cache_index):
        return attention.attention(p, x, cfg=self.cfg, window=window,
                                   positions=positions, cache=cache,
                                   cache_index=cache_index)

    def mlp(self, p, x):
        return layers.mlp(p, x, getattr(torch, self.cfg.compute_dtype))

    def moe(self, p, x):
        return moe.moe_block(p, x, cfg=self.cfg)

    def mamba(self, p, x, state):
        return ssm.mamba_block(p, x, cfg=self.cfg, state=state)


def _layer(p: Dict, x: torch.Tensor, *, kind: str, cfg: ModelConfig,
           shared: Optional[Dict], positions: torch.Tensor,
           cache: Optional[Dict], cache_index: int,
           blocks: Optional[Blocks] = None):
    """One layer -> (x, new cache or None, aux loss term), its blocks from
    `blocks` (`Blocks(cfg)` by default)."""
    ops = Blocks(cfg) if blocks is None else blocks
    eps = cfg.rms_eps
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new = None if cache is None else {}
    kv = None if cache is None else cache.get("kv")
    if kind in ("attn", "attn_local", "moe"):
        window = cfg.sliding_window if kind == "attn_local" else None
        h, kv = ops.attention(p["attn"], layers.rmsnorm(p["ln1"], x, eps),
                              window=window, positions=positions, cache=kv,
                              cache_index=cache_index)
        x = x + h
        if kind == "moe":
            h, moe_aux = ops.moe(p["moe"], layers.rmsnorm(p["ln2"], x, eps))
            aux = aux + cfg.moe.router_aux_weight * moe_aux.load_balance_loss
            x = x + h
        else:
            x = x + ops.mlp(p["mlp"], layers.rmsnorm(p["ln2"], x, eps))
        if new is not None:
            new["kv"] = kv
        return x, new, aux
    h, state = ops.mamba(p["mamba"], layers.rmsnorm(p["ln"], x, eps),
                         None if cache is None else cache["ssm"])
    x = x + h
    if new is not None:
        new["ssm"] = state
    if kind == "mamba_shared_attn":
        # The shared block (zamba2): shared weights, this layer's norms and
        # KV cache, windowed.
        h, kv = ops.attention(shared["attn"],
                              layers.rmsnorm(p["ln_sa"], x, eps),
                              window=cfg.sliding_window, positions=positions,
                              cache=kv, cache_index=cache_index)
        x = x + h
        x = x + ops.mlp(shared["mlp"], layers.rmsnorm(p["ln_sm"], x, eps))
        if new is not None:
            new["kv"] = kv
    return x, new, aux


def _block_layer(blocks: Blocks, p: Dict, i: int, x: torch.Tensor, **kw):
    return _layer(blocks.layer_params(p, i), x, blocks=blocks, **kw)


def _run_stack(params: Dict, x: torch.Tensor, *, cfg: ModelConfig,
               positions: torch.Tensor, caches: Optional[List[Dict]],
               cache_index: int, blocks: Optional[Blocks] = None,
               shared: Optional[Dict] = None):
    """x (B, T, D) -> (x, new caches or None, summed aux loss). `blocks`
    and `shared` (the zamba2 block, `params['shared_attn']` by default)
    are `_layer`'s."""
    blocks = Blocks(cfg) if blocks is None else blocks
    shared = params.get("shared_attn") if shared is None else shared
    remat = (cfg.remat == "full" and caches is None
             and torch.is_grad_enabled())
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = None if caches is None else []
    for i, p in enumerate(params["blocks"]):
        kw = dict(kind=cfg.period[i % len(cfg.period)], cfg=cfg,
                  shared=shared, positions=positions,
                  cache=None if caches is None else caches[i],
                  cache_index=cache_index)
        if remat:
            x, c, a = checkpoint(_block_layer, blocks, p, i, x,
                                 use_reentrant=False, **kw)
        else:
            x, c, a = _block_layer(blocks, p, i, x, **kw)
        aux = aux + a
        if new_caches is not None:
            new_caches.append(c)
    return x, new_caches, aux


# --- Public passes -----------------------------------------------------------

def embed_inputs(params: Dict, batch: Dict[str, torch.Tensor],
                 cfg: ModelConfig) -> torch.Tensor:
    """Token and frontend embedding -> (B, T, D) in the compute dtype:
    audio frames projected; tokens embedded, with projected vision patches
    before them."""
    cdt = getattr(torch, cfg.compute_dtype)
    if cfg.frontend.kind == "audio":
        return frontends.project(params["frontend"], batch["frames"], cfg)
    x = layers.embed(params["embed"], batch["tokens"], cdt)
    if cfg.frontend.kind == "vision":
        patches = frontends.project(params["frontend"], batch["patches"],
                                    cfg)
        x = torch.cat([patches, x], dim=1)
    return x


def hidden(params: Dict, batch: Dict[str, torch.Tensor], cfg: ModelConfig
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the final-normed residual stream (B, T, D) before the LM head, the
    summed MoE aux loss)."""
    check_supported(cfg)
    x = embed_inputs(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _, aux = _run_stack(params, x, cfg=cfg, positions=positions,
                           caches=None, cache_index=0)
    return layers.rmsnorm(params["final_norm"], x, cfg.rms_eps), aux


def head(params: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(..., D) -> (..., V) f32 logits."""
    return layers.logits(params.get("embed", {}), x, params.get("head"),
                         cfg.final_logit_softcap)


def forward(params: Dict, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (logits (B, T, V) f32, aux loss)."""
    x, aux = hidden(params, batch, cfg)
    return head(params, x, cfg), aux


def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                dtype=torch.bfloat16, *, device) -> List[Dict]:
    """Zeroed serving caches, one dict a layer (module docstring)."""
    out = []
    for i in range(cfg.num_layers):
        kind = cfg.period[i % len(cfg.period)]
        c = {}
        if kind in ("mamba", "mamba_shared_attn"):
            c["ssm"] = ssm.init_ssm_state(cfg, batch, dtype, device=device)
        if kind != "mamba":
            c["kv"] = attention.init_cache(cfg, batch, max_seq, dtype,
                                           device=device)
        out.append(c)
    return out


def prefill(params: Dict, batch: Dict[str, torch.Tensor],
            caches: List[Dict], cfg: ModelConfig
            ) -> Tuple[torch.Tensor, List[Dict]]:
    """The prompt pass, filling the caches from position 0 -> (last
    position's logits (B, 1, V) f32, caches)."""
    check_supported(cfg)
    x = embed_inputs(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    x, caches, _ = _run_stack(params, x, cfg=cfg, positions=positions,
                              caches=caches, cache_index=0)
    x = layers.rmsnorm(params["final_norm"], x[:, -1:], cfg.rms_eps)
    return head(params, x, cfg), caches


def decode_step(params: Dict, tokens: torch.Tensor, caches: List[Dict],
                cache_index: int, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, List[Dict]]:
    """One token a sequence at position `cache_index`: tokens (B, 1) ->
    (logits (B, 1, V) f32, caches)."""
    cdt = getattr(torch, cfg.compute_dtype)
    x = layers.embed(params["embed"], tokens, cdt)
    positions = torch.arange(cache_index, cache_index + 1, device=x.device)
    x, caches, _ = _run_stack(params, x, cfg=cfg, positions=positions,
                              caches=caches, cache_index=cache_index)
    x = layers.rmsnorm(params["final_norm"], x, cfg.rms_eps)
    return head(params, x, cfg), caches
