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

Across ranks (`group=`, a `core.dist.Group`): the S stages spread over
the group's ranks, S / world a rank, as PEs do (stage s on rank
s // (S / world)); each rank passes the leading-dim slice of its own
stages. Inside a rank the wire still rolls; between ranks each tick is
one `all_to_all_single` whose only non-empty splits carry the rank's last
stage's output to the next rank (the last rank's wraps to rank 0, whose
first stage reads fresh microbatches, as the ppermute's ring does). The
last stage's outputs then reach every rank in one sum over the group
(the JAX package's masked psum). Forward only, as in JAX.

body_fn contract: body_fn(stage_params, x_mb) -> y_mb of x_mb's shape,
applied by every stage to its slice of `params`.
"""

from __future__ import annotations

from typing import Callable

import torch

import torch.distributed as tdist

from repro_torch.core import dist
from repro_torch.models.model import map_leaves, named_leaves


def _num_stages(params) -> int:
    return next(named_leaves(params))[1].shape[0]


def _pass_on(last: torch.Tensor, group) -> torch.Tensor:
    """The previous rank's last-stage output, for this rank's first stage:
    one all_to_all_single, sending `last` to rank + 1 (mod world)."""
    dist.check_tensor(last, group)
    w, r = group.world, group.rank
    send = last.contiguous().reshape(1, -1)
    recv = torch.empty_like(send)
    out_splits = [1 if q == (r - 1) % w else 0 for q in range(w)]
    in_splits = [1 if q == (r + 1) % w else 0 for q in range(w)]
    tdist.all_to_all_single(recv, send, out_splits, in_splits,
                            group=group.pg)
    return recv.reshape(last.shape)


def pipeline_forward(body_fn: Callable, params, x: torch.Tensor, *,
                     num_microbatches: int, group=None) -> torch.Tensor:
    """y = stage_{S-1}( ... stage_0(x)) through the GPipe schedule.

    params: a tree whose leaves have a leading num_stages dim (this rank's
    stages under a `group`, S / world of them). x: (M * mb, ...), the same
    on every rank; the result has x's shape, on every rank."""
    local = _num_stages(params)
    world = 1 if group is None else group.world
    first = 0 if group is None else group.rank * local
    num_stages = local * world
    m = num_microbatches
    if x.shape[0] % m != 0:
        raise ValueError(f"batch {x.shape[0]} % microbatches {m} != 0")
    mb = x.shape[0] // m
    x_mbs = x.reshape(m, mb, *x.shape[1:])
    stage_params = [map_leaves(lambda v, j=j: v[j], params)
                    for j in range(local)]
    buf = x.new_zeros((local,) + x_mbs.shape[1:])         # the wire
    outbuf = torch.zeros_like(x_mbs)                      # the last stage's
    for t in range(num_stages + m - 1):
        ys = []
        for j in range(local):
            s = first + j
            mb_idx = t - s                  # the microbatch at stage s now
            active = 0 <= mb_idx < m
            # stage 0 injects fresh microbatch t; the others read the wire
            inp = x_mbs[min(max(t, 0), m - 1)] if s == 0 else buf[j]
            y = body_fn(stage_params[j], inp)
            y = y if active else buf[j]
            if s == num_stages - 1 and active:
                outbuf[mb_idx] = y
            ys.append(y)
        buf = torch.roll(torch.stack(ys), 1, dims=0)   # stage s -> s + 1
        if group is not None:   # the first stage's wire comes from rank - 1
            buf[0] = _pass_on(ys[-1], group)
    if group is not None:       # the last rank's outputs, on every rank
        if group.rank != world - 1:
            outbuf.zero_()
        outbuf = dist.all_sum(outbuf, group)
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
