"""Heavy-hitter gradient compression with error feedback (counterpart of
`repro.train.compression`).

Most of a gradient's norm sits in few coordinates: each leaf sends only
its top-|g + e| fraction as {index, value} pairs and carries the rest
forward as the error-feedback residual e, so over steps nothing is lost
(EF-SGD). The reduction scatters the kept pairs into a zero dense buffer
and averages the buffers over the shards.

The JAX package reduces over a named mesh axis with `psum / n` inside
`shard_map`. The port holds the shard axis as a leading dimension on one
device (`sharded=True`): each shard picks its own top-k, the kept values
are summed over that dimension and divided by the shard count, and each
shard keeps its own residual. With `group=` (a `core.dist.Group`) each
rank is one shard: its scattered buffer goes through one
`all_reduce(SUM)` over the group and is divided by the world size, the
JAX `psum / n`. Without either the compression round-trips locally, as
the JAX function does without `axis_name`.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.core import dist
from repro_torch.models.model import map_leaves, named_leaves


def init_error_feedback(grads):
    """Zero f32 residuals shaped like `grads` (a tree of tensors)."""
    return map_leaves(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                            device=g.device), grads)


def _compress_leaf(g: torch.Tensor, e: torch.Tensor, frac: float,
                   sharded: bool, group=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    n = g.shape[0] if sharded else 1
    acc = g.float().reshape(n, -1) + e.reshape(n, -1)
    k = max(1, int(acc.shape[1] * frac))
    idx = torch.topk(acc.abs(), k, dim=1, sorted=False).indices
    sparse = torch.zeros_like(acc).scatter_(1, idx, acc.gather(1, idx))
    new_e = (acc - sparse).reshape(e.shape)
    if sharded:
        out = (sparse.sum(0) / n).reshape(g.shape[1:])
    elif group is not None:
        out = (dist.all_sum(sparse, group) / group.world).reshape(g.shape)
    else:
        out = sparse.reshape(g.shape)
    return out.to(g.dtype), new_e


def compress_psum(grads, error, *, frac: float = 0.01,
                  sharded: bool = False, group=None):
    """Top-k sparsified, error-fed gradient reduction. Returns
    (compressed grads, new error), trees shaped like `grads` and `error`.

    With `sharded`, every leaf of `grads` and `error` has a leading shard
    dimension n; the compressed grads are the mean over it of each
    shard's scattered pairs (the leaf's shape without that dimension, what
    every shard holds after the JAX all-reduce), and the error keeps one
    residual per shard. With `group`, this rank's leaves are its shard and
    the compressed grads the mean over the group's ranks."""
    if sharded and group is not None:
        raise ValueError("sharded=True stacks the shards on one device; a "
                         "group holds one shard a rank")
    g_leaves = [g for _, g in named_leaves(grads)]
    e_leaves = [e for _, e in named_leaves(error)]
    outs = [_compress_leaf(g, e, frac, sharded, group)
            for g, e in zip(g_leaves, e_leaves)]
    it_g, it_e = iter([o[0] for o in outs]), iter([o[1] for o in outs])
    return (map_leaves(lambda _: next(it_g), grads),
            map_leaves(lambda _: next(it_e), error))


def compression_ratio(grads, frac: float) -> float:
    """Wire bytes against a dense f32 all-reduce ({idx, val} = 8 B an
    entry)."""
    sizes = [math.prod(g.shape) for _, g in named_leaves(grads)]
    kept = sum(max(1, int(s * frac)) for s in sizes)
    return (kept * 8) / (sum(sizes) * 4)
