"""Carry parameters (and optimizer moments) across between the JAX
package's layout and the port's.

The JAX model stacks each period slot's leaves over the `num_periods`
groups: `blocks` is a tuple over slots of dicts with (num_periods, ...)
leaves. The port keeps one dict per layer; layer g * len(period) + slot is
group g of slot `slot`. Every other leaf and every weight layout (wq
(d, h, hd), wo (h, hd, d), ...) is the same on both sides. Trees here hold
numpy arrays, so no JAX is needed to read them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import check_supported, map_leaves
from repro_torch.train.optimizer import OptState


def params_from_jax(tree: Dict, cfg: ModelConfig, device) -> Dict:
    """The JAX package's parameter tree (numpy leaves) -> the port's, f32
    tensors on `device`."""
    check_supported(cfg)

    def leaf(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=device)

    out = {k: map_leaves(leaf, v) for k, v in tree.items() if k != "blocks"}
    slots = tree["blocks"]
    if len(slots) != len(cfg.period):
        raise ValueError(f"{len(slots)} slots, period {cfg.period}")
    out["blocks"] = [map_leaves(lambda a, g=g: leaf(np.asarray(a)[g]),
                                slots[slot])
                     for g in range(cfg.num_periods)
                     for slot in range(len(cfg.period))]
    return out


def params_to_numpy(params: Dict, cfg: ModelConfig) -> Dict:
    """The port's parameter-shaped tree -> the JAX package's layout, numpy
    leaves (blocks restacked per slot over the groups)."""
    def leaf(t):
        return t.detach().cpu().numpy()

    out = {k: map_leaves(leaf, v) for k, v in params.items() if k != "blocks"}
    per = len(cfg.period)
    layers = [map_leaves(leaf, b) for b in params["blocks"]]
    out["blocks"] = tuple(
        _stack([layers[g * per + slot] for g in range(cfg.num_periods)])
        for slot in range(per))
    return out


def opt_state_to_numpy(state: OptState, cfg: ModelConfig) -> Dict:
    """AdamW state -> {"step", "mu", "nu"} in the JAX package's layout."""
    return {"step": int(state.step),
            "mu": params_to_numpy(state.mu, cfg),
            "nu": params_to_numpy(state.nu, cfg)}


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)
