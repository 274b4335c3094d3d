"""GPipe pipeline schedule over a stage axis (counterpart of
`repro.train.pipeline`).

The JAX package runs one stage per device of a `stage` mesh axis under
`shard_map`: at tick t stage s processes microbatch t - s and
`lax.ppermute` hands its activation to stage s + 1, so S + M - 1 ticks
stream M microbatches and (S - 1) / (S + M - 1) of the stage slots idle.
The port holds the stage axis as a leading dimension on one device, as it
holds PEs and EP shards: every leaf of `params` has a leading `num_stages`
dimension, the activations on the wire are one stacked (S, mb, ...) buffer,
the ppermute is a roll of it along that dimension, and the closing masked
psum is a read of the last stage's output buffer. Every stage runs its body
at every tick, active or not, and the inactive results are masked, as in
the JAX schedule: (S + M - 1) * S body calls.

body_fn contract: body_fn(stage_params, x_mb) -> y_mb of x_mb's shape,
applied by every stage to its slice of `params`.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.model import map_leaves, named_leaves


def _num_stages(params) -> int:
    return next(named_leaves(params))[1].shape[0]


def pipeline_forward(body_fn: Callable, params, x: torch.Tensor, *,
                     num_microbatches: int) -> torch.Tensor:
    """y = stage_{S-1}( ... stage_0(x)) through the GPipe schedule.

    params: a tree whose leaves have a leading num_stages dim. x: (M * mb,
    ...); the result has x's shape."""
    num_stages = _num_stages(params)
    m = num_microbatches
    if x.shape[0] % m != 0:
        raise ValueError(f"batch {x.shape[0]} % microbatches {m} != 0")
    mb = x.shape[0] // m
    x_mbs = x.reshape(m, mb, *x.shape[1:])
    stage_params = [map_leaves(lambda v, s=s: v[s], params)
                    for s in range(num_stages)]
    buf = x.new_zeros((num_stages,) + x_mbs.shape[1:])   # the wire
    outbuf = torch.zeros_like(x_mbs)                      # the last stage's
    for t in range(num_stages + m - 1):
        ys = []
        for s in range(num_stages):
            mb_idx = t - s                  # the microbatch at stage s now
            active = 0 <= mb_idx < m
            # stage 0 injects fresh microbatch t; the others read the wire
            inp = x_mbs[min(max(t, 0), m - 1)] if s == 0 else buf[s]
            y = body_fn(stage_params[s], inp)
            y = y if active else buf[s]
            if s == num_stages - 1 and active:
                outbuf[mb_idx] = y
            ys.append(y)
        buf = torch.roll(torch.stack(ys), 1, dims=0)   # stage s -> s + 1
    return outbuf.reshape(x.shape)


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    """GPipe idle fraction: (S-1)/(S+M-1)."""
    return (num_stages - 1) / (num_stages + num_microbatches - 1)


def sequential_oracle(body_fn: Callable, params,
                      x: torch.Tensor) -> torch.Tensor:
    """The stages one after another on the whole batch (tests)."""
    for s in range(_num_stages(params)):
        x = body_fn(map_leaves(lambda v: v[s], params), x)
    return x
