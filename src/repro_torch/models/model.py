"""Config-driven model assembly for the dense decoder stacks.

Counterpart of `repro.models.model` for the layer kinds 'attn' and
'attn_local' with no frontend: qwen1.5-0.5b, gemma2-9b, minitron-8b and
h2o-danube-3-4b. Parameters are a plain dict:

    {"embed": {"tok": (V, d)}, "head": {"w": (V, d)} (untied only),
     "final_norm": {"scale": (d,)},
     "blocks": [layer 0, layer 1, ...]}   # {"ln1", "attn", "ln2", "mlp"}

Layer l is slot l % len(period) of period group l // len(period): the JAX
package stacks the same leaves per slot over the groups (`models/convert.py`
maps one layout onto the other). The forward runs the layers in a Python
loop; with `remat='full'` each layer is a `torch.utils.checkpoint` region,
so its activations are recomputed in the backward pass.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers

KINDS = ("attn", "attn_local")


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for what this
    port does not run yet."""
    for kind in cfg.period:
        if kind == "moe":
            raise NotImplementedError(
                "MoE blocks are not ported yet: ROADMAP.md section 1, item "
                "12 (the MoE family)")
        if kind in ("mamba", "mamba_shared_attn"):
            raise NotImplementedError(
                f"'{kind}' blocks are not ported yet: ROADMAP.md section 1, "
                "item 12 (the SSM and hybrid families)")
        if kind not in KINDS:
            raise ValueError(f"unknown layer kind {kind!r}")
    if cfg.frontend.kind != "none":
        raise NotImplementedError(
            f"the {cfg.frontend.kind} frontend is not ported yet: ROADMAP.md "
            "section 1, item 12 (the VLM and audio families)")
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


def init_params(cfg: ModelConfig, *, seed: int, device) -> Dict:
    """Seeded init from one `torch.Generator` on `device`, with the JAX
    package's distributions (truncated normals, zero norms and biases). The
    numbers differ from `jax.random`'s: parity runs carry the JAX package's
    own parameters across (`convert.params_from_jax`)."""
    check_supported(cfg)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    d = cfg.d_model
    params: Dict = {"embed": layers.init_embed(gen, cfg.vocab_size, d,
                                               device)}
    if not cfg.tie_embeddings:
        params["head"] = layers.init_head(gen, cfg.vocab_size, d, device)
    params["final_norm"] = layers.init_rmsnorm(d, device)
    params["blocks"] = [
        {"ln1": layers.init_rmsnorm(d, device),
         "attn": attention.init_attention(gen, cfg, device),
         "ln2": layers.init_rmsnorm(d, device),
         "mlp": layers.init_mlp(gen, d, cfg.d_ff, device)}
        for _ in range(cfg.num_layers)]
    return params


def _layer(p: Dict, x: torch.Tensor, *, cfg: ModelConfig, window,
           positions: torch.Tensor) -> torch.Tensor:
    cdt = getattr(torch, cfg.compute_dtype)
    x = x + attention.attention(p["attn"], layers.rmsnorm(p["ln1"], x,
                                                          cfg.rms_eps),
                                cfg=cfg, window=window, positions=positions)
    return x + layers.mlp(p["mlp"], layers.rmsnorm(p["ln2"], x, cfg.rms_eps),
                          cdt)


def embed_inputs(params: Dict, batch: Dict[str, torch.Tensor],
                 cfg: ModelConfig) -> torch.Tensor:
    """Token embedding -> (B, T, D) activations in the compute dtype."""
    check_supported(cfg)
    return layers.embed(params["embed"], batch["tokens"],
                        getattr(torch, cfg.compute_dtype))


def hidden(params: Dict, batch: Dict[str, torch.Tensor],
           cfg: ModelConfig) -> torch.Tensor:
    """The final-normed residual stream (B, T, D), before the LM head."""
    x = embed_inputs(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    for i, p in enumerate(params["blocks"]):
        kind = cfg.period[i % len(cfg.period)]
        window = cfg.sliding_window if kind == "attn_local" else None
        if remat:
            x = checkpoint(_layer, p, x, cfg=cfg, window=window,
                           positions=positions, use_reentrant=False)
        else:
            x = _layer(p, x, cfg=cfg, window=window, positions=positions)
    return layers.rmsnorm(params["final_norm"], x, cfg.rms_eps)


def head(params: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """(..., D) -> (..., V) f32 logits."""
    return layers.logits(params["embed"], x, params.get("head"),
                         cfg.final_logit_softcap)


def forward(params: Dict, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward -> (logits (B, T, V) f32, aux loss 0)."""
    lg = head(params, hidden(params, batch, cfg), cfg)
    return lg, torch.zeros((), dtype=torch.float32, device=lg.device)
