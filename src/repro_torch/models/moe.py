"""Mixture of experts with the paper's owner routing as its dispatch.

Counterpart of `repro.models.moe`. Routing a (token, choice) pair to its
expert is the k-mer counter's owner routing with owner = the router's
top-k choice: experts live on EP shards, and the exchange is a
fixed-capacity, destination-major packed tile per shard pair. Two dispatch
paths compute the same function:

- GShard (`ep_shards=None`, the JAX package's mesh=None path): every pair
  gets its rank within its expert; pairs whose rank reaches the capacity
  are dropped. The JAX package multiplies by an (NK, E, C) one-hot; the
  port scatters and gathers by index into the (E, C, D) tiles, which gives
  the same values, as a one-hot product adds one term.
- DAKC (`ep_shards=S`, the JAX package's shard_map engine): the tokens are
  split into S stacked shards, each bucketing its pairs into an (E, cap, D)
  tile with its own capacity, as the counter holds its PEs as a leading
  dimension. The all_to_all is the transpose of the stacked
  (S, S, E_local * cap, D) tiles, the return trip the inverse transpose,
  and the JAX package's pmean a mean over the shard axis. Token counts
  that do not split into S shards of at least one token (tiny decode
  batches) take the GShard path, as the JAX rule does.
- DAKC over a process group (`ep_shards=S, group=`, a `core.dist.Group`
  of `world` ranks): each rank holds S / world shards' token rows and
  their experts' weights (`convert.moe_expert_slice`); the exchange and
  its inverse are `dist.exchange` calls, and the aux loss and dropped
  share are summed over the ranks before the mean. The JAX mesh's 'data'
  axis is not modelled.

Shared experts are one always-on MLP of width num_shared * expert_d_ff.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import dist
from repro_torch.models import layers


class MoEAux(NamedTuple):
    load_balance_loss: torch.Tensor   # scalar
    dropped_frac: torch.Tensor        # share of (token, k) pairs dropped


def init_moe(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    m, d = cfg.moe, cfg.d_model
    e, f = m.num_experts, m.expert_d_ff
    tn = layers.truncated_normal
    return {"router": tn(gen, (d, e), d ** -0.5, device),
            "wi": tn(gen, (e, d, f), d ** -0.5, device),
            "wg": tn(gen, (e, d, f), d ** -0.5, device),
            "wo": tn(gen, (e, f, d), f ** -0.5, device),
            "shared": layers.init_mlp(gen, d, m.num_shared_experts * f,
                                      device)}


def _router(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """x (..., N, D) -> (expert ids (..., N, K) int64, weights (..., N, K)
    f32, aux (...)): an f32 softmax, its top k (sorted, the lower index
    first on a tie), the weights renormalised, and the GShard load-balance
    term E * sum_e mean_prob_e * share_routed_e over each group of N."""
    m = cfg.moe
    probs = torch.softmax(x.float() @ params["router"].float(), dim=-1)
    weights, ids = torch.topk(probs, m.top_k, dim=-1, sorted=True)
    weights = weights / weights.sum(-1, keepdim=True)
    # A one-hot sum, not bincount: on the card bincount reads its input's
    # maximum back to the host, a sync in every MoE layer.
    frac = F.one_hot(ids.flatten(-2), m.num_experts).sum(-2).float() \
        / (ids.shape[-2] * m.top_k)
    aux = m.num_experts * torch.sum(probs.mean(-2) * frac, -1)
    return ids, weights, aux


def _expert_ffn(wi, wg, wo, x: torch.Tensor, cdt) -> torch.Tensor:
    """The gated MLP of every expert at once: x (E, C, D) -> (E, C, D)."""
    h = torch.bmm(x, wi.to(cdt))
    g = torch.bmm(x, wg.to(cdt))
    h = F.silu(g.float()).to(cdt) * h
    return torch.bmm(h, wo.to(cdt))


def _capacity(nk: int, e: int, factor: float, align: int = 8) -> int:
    cap = int(nk / e * factor) + 1
    return max(align, ((cap + align - 1) // align) * align)


def _combine(gathered: torch.Tensor, weights: torch.Tensor, n: int, k: int,
             cdt) -> torch.Tensor:
    """Each pair's expert output (NK, D), weighted and summed over its
    token's k choices -> (N, D)."""
    return (gathered * weights.reshape(-1).to(cdt)[:, None]).reshape(
        n, k, -1).sum(1)


def _gshard_dispatch(params: dict, x2d: torch.Tensor, ids: torch.Tensor,
                     weights: torch.Tensor, cfg: ModelConfig, capacity: int):
    """Rank within expert in pair order; pairs at rank >= capacity drop.
    Returns (y (N, D), dropped share)."""
    m = cfg.moe
    cdt = getattr(torch, cfg.compute_dtype)
    n, d = x2d.shape
    e = m.num_experts
    flat_ids = ids.reshape(-1)
    onehot = F.one_hot(flat_ids, e)
    rank = (torch.cumsum(onehot, 0) - onehot).gather(
        1, flat_ids[:, None])[:, 0]
    keep = rank < capacity
    dropped = 1.0 - keep.float().mean()
    rows = torch.where(keep, flat_ids, e)         # row e: the dropped pairs
    cols = torch.where(keep, rank, 0)
    tiles = torch.zeros((e + 1, capacity, d), dtype=cdt, device=x2d.device)
    tiles[rows, cols] = x2d.to(cdt).repeat_interleave(m.top_k, 0)
    out = _expert_ffn(params["wi"], params["wg"], params["wo"], tiles[:e],
                      cdt)
    gathered = torch.where(keep[:, None],
                           out[torch.where(keep, flat_ids, 0), cols], 0)
    return _combine(gathered, weights, n, m.top_k, cdt), dropped


def _dakc_dispatch(params: dict, x2d: torch.Tensor, cfg: ModelConfig,
                   shards: int, capacity: int, group=None):
    """The packed-tile engine over `shards` stacked EP shards, or over this
    rank's shards of a `dist.PEGroup` (x2d and the experts then this
    rank's). Returns (y (N, D), aux, dropped share), aux and dropped
    averaged over all the shards."""
    m = cfg.moe
    cdt = getattr(torch, cfg.compute_dtype)
    n, d = x2d.shape
    e, k = m.num_experts, m.top_k
    s_here = shards if group is None else group.local_pes
    e_loc, n_loc = e // shards, n // s_here
    xs = x2d.reshape(s_here, n_loc, d)
    ids, weights, aux = _router(params, xs, cfg)         # (S, n_loc, K)
    # Bucketing, destination-major: each shard's pairs sorted stably by
    # expert, the rank within the expert read off the sorted order.
    flat_ids = ids.reshape(s_here, n_loc * k)
    order = torch.argsort(flat_ids, dim=1, stable=True)
    s_ids = flat_ids.gather(1, order)
    hist = F.one_hot(flat_ids, e).sum(1)                 # (S, E)
    offsets = torch.cumsum(hist, 1) - hist
    within = (torch.arange(n_loc * k, device=x2d.device)[None, :]
              - offsets.gather(1, s_ids))
    ok = within < capacity
    dropped = 1.0 - ok.float().mean(1)
    if group is None:
        aux, dropped = aux.mean(), dropped.mean()
    else:
        aux, dropped = dist.all_sum(torch.stack([aux.sum(), dropped.sum()]),
                                    group) / shards
    rows = torch.where(ok, s_ids, e)
    cols = torch.where(ok, within, 0)
    src = torch.arange(s_here, device=x2d.device)[:, None].expand_as(rows)
    xk = xs.to(cdt).repeat_interleave(k, 1)              # (S, n_loc K, D)
    tiles = torch.zeros((s_here, e + 1, capacity, d), dtype=cdt,
                        device=x2d.device)
    tiles[src, rows, cols] = xk.gather(1, order[..., None].expand(-1, -1, d))

    def swap(t):
        """[this shard, other shard] tiles -> [other, this]: the
        all_to_all, a transpose of the stacked shards or one exchange."""
        return t.transpose(0, 1) if group is None else dist.exchange(t, group)

    # The exchange: tile [src, dst] goes to shard dst, which groups its
    # experts' tokens from every source shard.
    recv = swap(tiles[:, :e].reshape(s_here, shards, e_loc * capacity, d))
    grouped = recv.reshape(s_here, shards, e_loc, capacity, d).transpose(
        1, 2).reshape(s_here * e_loc, shards * capacity, d)
    y = _expert_ffn(params["wi"], params["wg"], params["wo"], grouped, cdt)
    # The return trip restores each source shard's (E, cap, D) layout.
    back = swap(y.reshape(s_here, e_loc, shards, capacity, d).transpose(
        1, 2)).reshape(s_here, e, capacity, d)
    gathered = back[src, torch.where(ok, s_ids, 0), cols]
    gathered = torch.where(ok[..., None], gathered, 0)
    unsort = torch.zeros_like(gathered).scatter_(
        1, order[..., None].expand(-1, -1, d), gathered)
    return _combine(unsort.reshape(n * k, d), weights, n, k, cdt), aux, \
        dropped


def moe_block(params: dict, x: torch.Tensor, *, cfg: ModelConfig,
              ep_shards: Optional[int] = None, group=None
              ) -> Tuple[torch.Tensor, MoEAux]:
    """x (B, S, D) -> (y, aux): the routed experts plus the shared ones.
    `ep_shards` picks the DAKC engine over that many stacked EP shards
    (module docstring); None is the GShard path. With `group` (a
    `core.dist.Group` whose world divides ep_shards), x is this rank's
    token rows, `params` holds this rank's experts
    (`convert.moe_expert_slice`), and the engine must apply: the GShard
    path needs every expert, so a batch it would take raises."""
    m = cfg.moe
    cdt = getattr(torch, cfg.compute_dtype)
    b, s_len, d = x.shape
    n = b * s_len
    x2d = x.reshape(n, d)
    if ep_shards is not None and m.num_experts % ep_shards:
        raise ValueError(f"{m.num_experts} experts do not split over "
                         f"{ep_shards} EP shards")
    n_shards = ep_shards
    if group is not None:
        if ep_shards is None:
            raise ValueError("a group runs the DAKC engine: pass ep_shards")
        group = group.pes(ep_shards)
        n_shards = group.local_pes     # the shards this rank's tokens fill
    use_dakc = (ep_shards is not None and m.dispatch == "dakc"
                and n % n_shards == 0 and n >= n_shards)
    if group is not None and not use_dakc:
        raise ValueError(
            f"{n} tokens a rank do not fill {n_shards} EP shards of the "
            f"DAKC engine (dispatch {m.dispatch!r}); the GShard path needs "
            f"every expert on one rank")
    if use_dakc:
        capacity = _capacity(n // n_shards * m.top_k, m.num_experts,
                             m.capacity_factor)
        y2d, aux, dropped = _dakc_dispatch(params, x2d, cfg, ep_shards,
                                           capacity, group)
    else:
        ids, weights, aux = _router(params, x2d, cfg)
        capacity = _capacity(n * m.top_k, m.num_experts, m.capacity_factor)
        y2d, dropped = _gshard_dispatch(params, x2d, ids, weights, cfg,
                                        capacity)
    shared = layers.mlp(params["shared"], x2d.to(cdt), cdt)
    return (y2d + shared).reshape(b, s_len, d), MoEAux(
        load_balance_loss=aux, dropped_frac=dropped)
