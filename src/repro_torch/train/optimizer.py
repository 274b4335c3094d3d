"""AdamW with a warmup-cosine schedule and global-norm clipping.

Counterpart of `repro.train.optimizer`. The port updates the parameters and
the moments in place (the JAX package returns new trees), so one step holds
one copy of each.

Weight decay follows the JAX package's rule, decay of every leaf with
ndim >= 2 of ITS tree, where the blocks' leaves carry a leading
`num_periods` axis. So every block leaf is decayed (the norm scales and the
QKV biases too), and of the rest the embedding and a separate head, but not
`final_norm`. The port's per-layer leaves get the same set from `decays`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.model import map_leaves, named_leaves


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: int
    mu: Dict
    nu: Dict


def init(params: Dict) -> OptState:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return OptState(step=0, mu=map_leaves(zeros, params),
                    nu=map_leaves(zeros, params))


def schedule(cfg: OptimizerConfig, step: int) -> float:
    """Linear warmup to `peak_lr`, then cosine down to min_lr_frac of it."""
    if step < cfg.warmup_steps:
        return cfg.peak_lr * min(1.0, (step + 1) / cfg.warmup_steps)
    t = min(max((step - cfg.warmup_steps)
                / max(1, cfg.total_steps - cfg.warmup_steps), 0.0), 1.0)
    return cfg.peak_lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5
                          * (1 + math.cos(math.pi * t)))


def decays(path: Tuple, p: torch.Tensor) -> bool:
    """The JAX package's decay set on the port's layout (module docstring)."""
    return path[0] == "blocks" or p.dim() >= 2


def global_norm(grads, counts=None, reduce=None) -> torch.Tensor:
    """sqrt of the sum of squares of `grads`. Over shards (the sharded
    step), `counts[i]` says whether this rank counts leaf i (each element
    once across the ranks) and `reduce` sums the square sum over them."""
    sq = [g.float().square().sum() for i, g in enumerate(grads)
          if counts is None or counts[i]]
    total = (torch.stack(sq).sum() if sq
             else torch.zeros((), device=grads[0].device))
    if reduce is not None:
        total = reduce(total.reshape(1))[0]
    return torch.sqrt(total)


@torch.no_grad()
def apply(cfg: OptimizerConfig, params: Dict, grads: Dict,
          state: OptState, *, grad_norm: Optional[torch.Tensor] = None
          ) -> Tuple[Dict, OptState, Dict]:
    """One AdamW update IN PLACE. `grads` is parameter-shaped. Returns
    (params, state, metrics) with metrics grad_norm (before clipping, a
    0-d tensor) and lr. `grad_norm` is given where the gradients are
    shards (the sharded step's global norm)."""
    flat = list(named_leaves(params))
    g_leaves = [g for _, g in named_leaves(grads)]
    m_leaves = [m for _, m in named_leaves(state.mu)]
    v_leaves = [v for _, v in named_leaves(state.nu)]
    gnorm = global_norm(g_leaves) if grad_norm is None else grad_norm
    clip = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, state.step)
    step = state.step + 1
    bc1, bc2 = 1 - cfg.b1 ** step, 1 - cfg.b2 ** step
    for (path, p), g, m, v in zip(flat, g_leaves, m_leaves, v_leaves):
        g = g.float() * clip
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        delta = (m / bc1) / ((v / bc2).sqrt_() + cfg.eps)
        if decays(path, p):
            delta.add_(p.float(), alpha=cfg.weight_decay)
        p.sub_((lr * delta).to(p.dtype))
    return params, OptState(step=step, mu=state.mu, nu=state.nu), \
        {"grad_norm": gnorm, "lr": lr}
