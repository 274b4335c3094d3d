"""Carry parameters, optimizer moments and serving caches across between
the JAX package's layout and the port's.

The JAX model stacks each period slot's leaves over the `num_periods`
groups: `blocks` is a tuple over slots of dicts with (num_periods, ...)
leaves, and so are its caches (a tuple over slots of {"kv": KVCache,
"ssm": SSMState} with stacked fields). The port keeps one dict per layer;
layer g * len(period) + slot is group g of slot `slot`. Every other leaf
(`embed`, `head`, `frontend`, `shared_attn`, ...) and every weight layout
(wq (d, h, hd), wo (h, hd, d), the experts' (E, d, f), ...) is the same on
both sides. Trees here hold numpy arrays, so no JAX is needed to read
them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import KVCache
from repro_torch.models.model import check_supported, map_leaves
from repro_torch.models.ssm import SSMState
from repro_torch.train.optimizer import OptState

_CACHE_TYPES = {"kv": KVCache, "ssm": SSMState}


def params_from_jax(tree: Dict, cfg: ModelConfig, device) -> Dict:
    """The JAX package's parameter tree (numpy leaves) -> the port's, f32
    tensors on `device`."""
    def leaf(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=device)

    return unstack_blocks(tree, cfg, leaf,
                          lambda a, g: leaf(np.asarray(a)[g]))


def moe_expert_slice(moe_params: Dict, rank: int, world: int) -> Dict:
    """One rank's share of an MoE layer's parameters for `moe_block(...,
    group=)`: the experts' wi, wg and wo of the contiguous block
    [rank * E / world, (rank + 1) * E / world) (the experts of its EP
    shards), the router and shared experts whole. Views, no copies."""
    e = moe_params["wi"].shape[0]
    if e % world:
        raise ValueError(f"{e} experts do not split over {world} ranks")
    lo, hi = rank * e // world, (rank + 1) * e // world
    out = dict(moe_params)
    for name in ("wi", "wg", "wo"):
        out[name] = moe_params[name][lo:hi]
    return out


def unstack_blocks(tree: Dict, cfg: ModelConfig, leaf, layer_leaf) -> Dict:
    """A tree in the JAX package's parameter layout -> the port's: `leaf`
    maps every leaf outside the blocks, `layer_leaf(a, g)` gives group g
    of a stacked block leaf `a` (a numpy array, or a shape alone)."""
    check_supported(cfg)
    out = {k: map_leaves(leaf, v) for k, v in tree.items() if k != "blocks"}
    slots = tree["blocks"]
    if len(slots) != len(cfg.period):
        raise ValueError(f"{len(slots)} slots, period {cfg.period}")
    out["blocks"] = [map_leaves(lambda a, g=g: layer_leaf(a, g), slots[slot])
                     for g in range(cfg.num_periods)
                     for slot in range(len(cfg.period))]
    return out


def params_to_numpy(params: Dict, cfg: ModelConfig) -> Dict:
    """The port's parameter-shaped tree -> the JAX package's layout, numpy
    leaves (blocks restacked per slot over the groups)."""
    def leaf(t):
        return t.detach().cpu().numpy()

    return _to_jax_layout(params, cfg, leaf,
                          lambda ts: np.stack([leaf(t) for t in ts]))


def checkpoint_trees(params: Dict, state: OptState,
                     cfg: ModelConfig) -> Dict:
    """A training checkpoint's trees in the JAX package's layout, leaves
    still tensors: {"params", "opt": OptState(step, mu, nu)}, each slot's
    block leaves stacked on their device (one copy to host a leaf for the
    saver) and the AdamW step a 0-d int32, as the JAX package's."""
    def layout(tree):
        return _to_jax_layout(tree, cfg, lambda t: t.detach(),
                              lambda ts: torch.stack([t.detach()
                                                      for t in ts]))
    return {"params": layout(params),
            "opt": OptState(step=np.asarray(state.step, dtype=np.int32),
                            mu=layout(state.mu), nu=layout(state.nu))}


def jax_template(params: Dict, cfg: ModelConfig) -> Dict:
    """The structure of `params_to_numpy(params, cfg)` with a 0 at every
    leaf, no copy made: a template for `checkpoint.restore`."""
    return _to_jax_layout(params, cfg, lambda t: 0, lambda ts: 0)


def opt_state_to_numpy(state: OptState, cfg: ModelConfig) -> Dict:
    """AdamW state -> {"step", "mu", "nu"} in the JAX package's layout;
    the step a 0-d int32 array, as the JAX package's `OptState.step`."""
    return {"step": np.asarray(state.step, dtype=np.int32),
            "mu": params_to_numpy(state.mu, cfg),
            "nu": params_to_numpy(state.nu, cfg)}


def opt_state_from_jax(state, cfg: ModelConfig, device) -> OptState:
    """The JAX package's AdamW state (its `OptState`, or the port's
    holding numpy leaves in that layout, as `checkpoint.restore` gives
    it) -> the port's, f32 moments on `device` and the step a host
    int."""
    step, mu, nu = state
    return OptState(step=int(np.asarray(step)),
                    mu=params_from_jax(mu, cfg, device),
                    nu=params_from_jax(nu, cfg, device))


def caches_from_jax(caches: Sequence[Dict], cfg: ModelConfig,
                    device) -> List[Dict]:
    """The JAX package's stacked cache tuple (numpy fields, dtypes kept) ->
    the port's per-layer list on `device`."""
    per = len(cfg.period)
    if len(caches) != per:
        raise ValueError(f"{len(caches)} cache slots, period {cfg.period}")

    def field(a):
        a = np.array(a)     # a copy: the port updates KV caches in place
        if a.dtype.name == "bfloat16":      # ml_dtypes' bf16: via f32
            return torch.from_numpy(a.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        return torch.from_numpy(a).to(device)

    def layer(g, slot):
        return {name: _CACHE_TYPES[name](*(field(np.asarray(f)[g])
                                           for f in nt))
                for name, nt in caches[slot].items()}
    return [layer(g, slot) for g in range(cfg.num_periods)
            for slot in range(per)]


def caches_to_numpy(caches: List[Dict], cfg: ModelConfig) -> tuple:
    """The port's per-layer caches -> the JAX package's layout: a tuple
    over slots of {"kv": KVCache, "ssm": SSMState} whose fields are numpy
    arrays stacked over the groups, in the caches' own dtypes (bf16 as
    f32, which holds every bf16 value)."""
    def arr(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    per = len(cfg.period)
    out = []
    for slot in range(per):
        group = [caches[g * per + slot] for g in range(cfg.num_periods)]
        out.append({name: _CACHE_TYPES[name](*(
            np.stack([arr(c[name][f]) for c in group])
            for f in range(len(_CACHE_TYPES[name]._fields))))
            for name in sorted(group[0])})
    return tuple(out)


def _to_jax_layout(params: Dict, cfg: ModelConfig, leaf, stack) -> Dict:
    """`params` in the JAX package's layout: `leaf` maps every leaf but the
    blocks', `stack` each slot's list of per-group block leaves."""
    out = {k: map_leaves(leaf, v) for k, v in params.items() if k != "blocks"}
    per = len(cfg.period)
    out["blocks"] = tuple(
        _stack([params["blocks"][g * per + slot]
                for g in range(cfg.num_periods)], stack)
        for slot in range(per))
    return out


def _stack(trees, stack):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees], stack) for k in trees[0]}
    return stack(trees)
