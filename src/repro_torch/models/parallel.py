"""One rank's share of the model on a (data, model) mesh of ranks.

The JAX package runs its model under GSPMD with `mesh=`: the parameters
laid out by `models/sharding.py`'s specs, the MoE block's shard_map
engine and the decode constraints of `models/attention.py`. The port
writes each rank's share out. `RankModel` gives `model.Blocks`' methods
on one rank's blocks (`sharding.shard_params`) and config
(`sharding.local_config`), so `model._layer` and `model._run_stack` wire
the layer kinds once for one process and for a rank; the sharded train
step (`train/sharded.py`) and sharded serving (`train/serve_step.py`)
both run it, with or without caches.

- FSDP over `data`: before a layer, one flat all-gather over the rank's
  `data` line brings its data-sharded leaves whole along `data`; the
  backward is one reduce-scatter of their gradients (`_Gather`). The
  top-level leaves (embedding, head, zamba2's shared block) are gathered
  once a pass. Under remat the gather is part of the recomputed layer.
- Tensor parallelism over `model` (Megatron): `wq/wk/wv`, `mlp/wi/wg`
  and the MoE's shared experts are column-parallel, `attn/wo` and the
  `wo`s of the MLPs row-parallel; `_Copy` (identity forward, all-reduce
  backward) stands before the column-parallel products and `_Reduce`
  (all-reduce forward, identity backward) after the row-parallel ones.
  Where the KV heads do not divide `model` their projections are
  replicated and each rank projects the KV heads its query heads read
  (`sharding.kv_head_range`); their gradients are partial over `model`.
- The embedding and the head are vocab-parallel where the vocabulary
  divides `model` (a rank looks up its rows, the others give 0, and the
  sum goes over `model`), else whole on every `model` rank.
- MoE (the JAX `moe_block` under a mesh): each rank takes its
  n / (data * model) token rows (`_Rows`; the backward all-gathers their
  gradients), runs the DAKC engine over the `model` axis with its
  experts (`_AllToAll`, whose backward is the same exchange of the
  gradients) and gathers the rows back. The capacity comes from the
  rank's row count, as JAX computes it. Where JAX's rule takes GShard
  (the global token count does not split into the shards), every rank
  runs it over all the rows with its experts, summed over `model`. The
  load-balance term and the dropped share are means over the shards
  (JAX's pmean): each rank returns its share, x / (data * model), so a
  sum over the group gives the mean; the router's gradient is partial
  over `model`.
- Mamba2 width over `model`: the rank's heads' z, x and dt and all of B
  and C. `in_proj`, `conv_w` and `conv_b` are cut across those by the
  JAX specs, so they are gathered whole over `model` in one flat gather
  whose backward (a reduce-scatter) also sums B's and C's gradients;
  `a_log`, `dt_bias`, `d_skip` and `out_proj`'s rows follow the heads
  (`out_proj` row-parallel). The gated norm's square sum is summed over
  `model` (`_Sum`). The decode state's `conv` holds the rank's channels
  (its x block, then B and C), not `sharding.cache_specs`' contiguous
  block.
- Frontends: `frontend/proj` is gathered whole over `model` with the
  top-level leaves (its backward keeps the rank's block of a gradient
  every `model` rank holds whole), so the residual stays replicated over
  `model`; patches and frames split over `data` with their rows.
- Serving (`serve_batch=`): the batch rows split over `data` where they
  divide, else every `data` rank holds every row. Decode is
  head-parallel where the KV heads divide `model` and the rows split.
  Otherwise the cache sequence is sharded over `model` (KV heads that do
  not divide), over `data` (rows that do not split) or over both: a rank
  holds the positions of its block, the KV projections give every rank
  the new positions' keys and values (only the block's owner writes
  them), decode all-gathers the step's query heads over `model` where
  the KV heads do not divide, takes the partial softmax over the block
  (`ref.mha_partial`) and combines with one max and one sum all-reduce
  over the cache's axis (`flash_decode_combine`), then keeps its heads
  for `wo`. A prefill at
  position 0 attends over the prompt's own keys and values (rounded
  through the cache's dtype, as the cache path reads them) and writes
  each rank's block.

Every collective is counted in `collectives`: calls, the bytes this rank
moved, and calls a kind.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as tdist
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ref
from repro_torch.launch.mesh import MeshGroup
from repro_torch.models import attention, frontends, layers, moe, ssm
from repro_torch.models import model as model_lib
from repro_torch.models import sharding as shd

# `reduce_scatter_single` replaces `reduce_scatter_tensor` in newer torch
_reduce_scatter = getattr(tdist, "reduce_scatter_single", None) \
    or tdist.reduce_scatter_tensor


# --- counted collectives -----------------------------------------------------

def _count(counts, kind: str, t: torch.Tensor) -> None:
    counts["calls"] += 1
    counts[kind] += 1
    counts["bytes"] += t.numel() * t.element_size()


def all_reduce(t: torch.Tensor, g, counts,
               op=tdist.ReduceOp.SUM) -> torch.Tensor:
    """`t` summed (or `op`) over the group, in place, counted in
    `counts`; returns `t`."""
    _count(counts, "all_reduce", t)
    tdist.all_reduce(t, op=op, group=g.pg)
    return t


def all_gather(t: torch.Tensor, g, counts, dim: int = 0) -> torch.Tensor:
    """Every rank's `t` concatenated along `dim` in rank order."""
    out = torch.empty(g.world * t.numel(), dtype=t.dtype, device=t.device)
    _count(counts, "all_gather", out)
    tdist.all_gather_into_tensor(out, t.reshape(-1).contiguous(),
                                 group=g.pg)
    shape = list(t.shape)
    shape[dim] *= g.world
    return out.view(g.world, *t.shape).movedim(0, dim).reshape(shape)


def _all_to_all(t: torch.Tensor, g, counts) -> torch.Tensor:
    t = t.contiguous()
    out = torch.empty_like(t)
    _count(counts, "all_to_all", t)
    tdist.all_to_all_single(out, t, group=g.pg)
    return out


# --- the distributed decode's arithmetic -------------------------------------

def flash_decode_combine(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                         reduce_max=None, reduce_sum=None) -> torch.Tensor:
    """Attention from blocks' partials: m, l (N, ...) and o (N, ..., D),
    the `ref.mha_partial` of N blocks of the keys -> (..., D) f32, the
    sum_b exp(m_b - M) o_b / sum_b exp(m_b - M) l_b with M = max_b m_b. A
    block whose row saw no key (m = -inf) adds 0. `reduce_max` and
    `reduce_sum` take this process's max and sums on to the other ranks'
    blocks (an all-reduce over the cache's axis; none in one process)."""
    top = m.amax(0)
    if reduce_max is not None:
        top = reduce_max(top)
    scale = torch.where(torch.isinf(m), 0.0, torch.exp(m - top))
    both = torch.cat([(l * scale).sum(0).reshape(-1),
                      (o * scale[..., None]).sum(0).reshape(-1)])
    if reduce_sum is not None:
        both = reduce_sum(both)
    n = top.numel()
    return both[n:].view(o.shape[1:]) / both[:n].view(top.shape)[..., None]


def pick_lowest(pairs: torch.Tensor) -> torch.Tensor:
    """(N, B, 2) candidates (value, global index), N of them a row -> (B,)
    int64: the index of the largest value, the lowest index of those that
    tie (as torch.argmax over the whole row)."""
    best = pairs[..., 0].max(0).values
    cand = torch.where(pairs[..., 0] == best, pairs[..., 1], float("inf"))
    return cand.min(0).values.long()


class _Copy(torch.autograd.Function):
    """Identity forward, all-reduce backward: the input of a
    column-parallel product."""

    @staticmethod
    def forward(ctx, x, g, counts):
        ctx.g, ctx.counts = g, counts
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return (all_reduce(dy.contiguous().clone(), ctx.g, ctx.counts),
                None, None)


class _Reduce(torch.autograd.Function):
    """All-reduce forward, identity backward: the output of a row-parallel
    product."""

    @staticmethod
    def forward(ctx, x, g, counts):
        return all_reduce(x.contiguous().clone(), g, counts)

    @staticmethod
    def backward(ctx, dy):
        return dy, None, None


class _Sum(torch.autograd.Function):
    """All-reduce forward and backward: a sum every rank reads, of parts
    each rank made from its own share (a norm's squares over a sharded
    width)."""

    @staticmethod
    def forward(ctx, x, g, counts):
        ctx.g, ctx.counts = g, counts
        return all_reduce(x.contiguous().clone(), g, counts)

    @staticmethod
    def backward(ctx, dy):
        return (all_reduce(dy.contiguous().clone(), ctx.g, ctx.counts),
                None, None)


class _AllToAll(torch.autograd.Function):
    """(world, ...) tiles, tile j for rank j -> (world, ...) tiles, tile j
    from rank j; the backward is the same exchange of the gradients."""

    @staticmethod
    def forward(ctx, t, g, counts):
        ctx.g, ctx.counts = g, counts
        return _all_to_all(t, g, counts)

    @staticmethod
    def backward(ctx, dy):
        return _all_to_all(dy, ctx.g, ctx.counts), None, None


class _Rows(torch.autograd.Function):
    """Block `rank` of `world` along dim 0 of a tensor every rank of the
    group holds whole; the backward all-gathers the blocks' gradients."""

    @staticmethod
    def forward(ctx, x, g, counts):
        ctx.g, ctx.counts = g, counts
        n = x.shape[0] // g.world
        return x[g.rank * n:(g.rank + 1) * n].clone()

    @staticmethod
    def backward(ctx, dy):
        return all_gather(dy, ctx.g, ctx.counts), None, None


class _Gather(torch.autograd.Function):
    """Leaves whole along one mesh axis: one flat all-gather forward;
    `dims[i]` is the dim leaf i is split on. The backward is one
    reduce-scatter of the gradients (`sum_back`: each rank's gradient is
    its part of the sum) or keeps the rank's block of each (every rank
    holds the whole gradient)."""

    @staticmethod
    def forward(ctx, g, counts, dims, sum_back, *shards):
        ctx.g, ctx.counts, ctx.dims, ctx.sum_back = g, counts, dims, sum_back
        ctx.shapes = [s.shape for s in shards]
        ctx.dtypes = [s.dtype for s in shards]
        d = g.world
        flat = torch.cat([s.reshape(-1) for s in shards])
        out = torch.empty(d * flat.numel(), dtype=flat.dtype,
                          device=flat.device)
        _count(counts, "all_gather", out)
        tdist.all_gather_into_tensor(out, flat, group=g.pg)
        out = out.view(d, -1)
        full, off = [], 0
        for s, dim in zip(shards, dims):
            n = s.numel()
            piece = out[:, off:off + n].reshape(d, *s.shape).movedim(0, dim)
            shape = list(s.shape)
            shape[dim] *= d
            full.append(piece.reshape(shape))
            off += n
        return tuple(full)

    @staticmethod
    def backward(ctx, *grads):
        g, d = ctx.g, ctx.g.world
        head = (None, None, None, None)
        if not ctx.sum_back:
            return head + tuple(
                None if gr is None else gr.narrow(
                    dim, g.rank * shape[dim], shape[dim]).contiguous()
                for gr, shape, dim in zip(grads, ctx.shapes, ctx.dims))
        parts = []
        for gr, shape, dim, dt in zip(grads, ctx.shapes, ctx.dims,
                                      ctx.dtypes):
            full = list(shape)
            full[dim] *= d
            if gr is None:
                gr = torch.zeros(full, dtype=dt, device=g.device)
            split = list(shape)
            split[dim:dim + 1] = [d, shape[dim]]
            parts.append(gr.reshape(split).movedim(dim, 0).reshape(d, -1))
        flat = torch.cat(parts, 1).contiguous()
        out = torch.empty(flat.shape[1], dtype=flat.dtype,
                          device=flat.device)
        _count(ctx.counts, "reduce_scatter", flat)
        _reduce_scatter(out, flat.reshape(-1), group=g.pg)
        res, off = [], 0
        for shape in ctx.shapes:
            n = shape.numel()
            res.append(out[off:off + n].view(shape))
            off += n
        return head + tuple(res)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _nest(flat: Dict[Tuple, torch.Tensor]) -> Dict:
    """{path: tensor} -> the nested dict of those paths."""
    out: Dict = {}
    for path, t in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def _spec_dim(spec, axis: str) -> int:
    return [i for i, e in enumerate(spec)
            if e == axis or (isinstance(e, tuple) and axis in e)][0]


# --- the rank's model --------------------------------------------------------

class RankModel(model_lib.Blocks):
    """One rank's share of `cfg` on the mesh of `mg` (module docstring).
    `shapes` is a parameter-shaped tree of the full leaves (tensors or
    meta tensors; `model.abstract_params(cfg)` by default). With
    `serve_batch` (the global batch) and `max_seq`, the rank serves:
    `rows_split`, the cache's axis and its block come from them."""

    def __init__(self, cfg: ModelConfig, mg: MeshGroup, shapes=None, *,
                 serve_batch: Optional[int] = None,
                 max_seq: Optional[int] = None):
        model_lib.check_supported(cfg)
        super().__init__(cfg)
        self.mg = mg
        self.collectives: Dict[str, int] = collections.Counter()
        mesh = mg.mesh
        self.lcfg = shd.local_config(cfg, mesh)
        self.D, self.M = mesh.shape["data"], mesh.shape["model"]
        self.gd, self.gm = mg.axis["data"], mg.axis["model"]
        mi = self.mi = mg.coord["model"]
        self.tp_attn = cfg.num_heads % self.M == 0
        self.tp_mlp = bool(cfg.d_ff) and cfg.d_ff % self.M == 0
        self.tp_vocab = cfg.vocab_size % self.M == 0
        self.heads_div = cfg.num_kv_heads % self.M == 0
        self.kv_split = self.tp_attn and not self.heads_div
        self.kv_range = (shd.kv_head_range(cfg, mesh, mi) if self.kv_split
                         else None)
        self.vocab_lo = mi * self.lcfg.vocab_size if self.tp_vocab else 0
        if cfg.moe is not None:
            e = cfg.moe.num_experts
            if e % self.M:
                raise ValueError(f"{e} experts do not split over a model "
                                 f"axis of {self.M}")
            self.experts = (mi * e // self.M, (mi + 1) * e // self.M)
            self.tp_shared = (cfg.moe.num_shared_experts
                              * cfg.moe.expert_d_ff) % self.M == 0
        if cfg.ssm is not None:
            self._ssm_plan()
        shapes = model_lib.abstract_params(cfg) if shapes is None else shapes
        self.shardings = shardings = shd.param_shardings(shapes, mesh)
        # path -> dim of the FSDP leaves (gathered over `data`) and of the
        # leaves gathered whole over `model`
        self.fsdp_dim: Dict[Tuple, int] = {}
        self.model_dim: Dict[Tuple, int] = {}
        # paths whose gradient each `model` rank holds a part of
        self.partial_model: List[Tuple] = []
        for path, _ in model_lib.named_leaves(shapes):
            sh = _leaf(shardings, path)
            axes = sh.axes()
            if "data" in axes:
                self.fsdp_dim[path] = _spec_dim(sh.spec, "data")
            name = path[-1]
            if "mamba" in path and name in ("in_proj", "conv_w", "conv_b"):
                if "model" in axes:
                    self.model_dim[path] = _spec_dim(sh.spec, "model")
                else:
                    self.partial_model.append(path)
            elif "mamba" in path and "norm" in path:
                self.partial_model.append(path)
            elif path == ("frontend", "proj") and "model" in axes:
                self.model_dim[path] = _spec_dim(sh.spec, "model")
            elif "moe" in path and name == "router":
                self.partial_model.append(path)
            elif (self.kv_split and "attn" in path
                  and name in ("wk", "wv", "bk", "bv")):
                self.partial_model.append(path)
        if self.M == 1:
            self.partial_model = []
        # serving: where the rows and the caches lie
        self.serve_batch = serve_batch
        self.rows_split = serve_batch is None or serve_batch % self.D == 0
        self.seq_group = None
        if serve_batch is not None:
            d_i, rank = mg.coord["data"], mg.group.rank
            if not self.heads_div and not self.rows_split:
                self.seq_group, self.seq_index = mg.group, rank
            elif not self.heads_div:
                self.seq_group, self.seq_index = self.gm, mi
            elif not self.rows_split:
                self.seq_group, self.seq_index = self.gd, d_i
            shards = 1 if self.seq_group is None else self.seq_group.world
            self.s_loc = -(-max_seq // shards)

    # --- parameters ------------------------------------------------------

    def _gather(self, tree, prefix: Tuple, names: List[Tuple]
                ) -> Dict[Tuple, torch.Tensor]:
        """{path: tensor} of `names` under `tree`: the FSDP leaves whole
        along `data` (one all-gather), then those gathered over `model`
        whole along it (one more)."""
        out = {n: _leaf(tree, n) for n in names}
        for axis, dims in (("data", self.fsdp_dim),
                           ("model", self.model_dim)):
            picked = [n for n in names if prefix + n in dims]
            if not picked:
                continue
            # the frontend's projection: every `model` rank holds its whole
            # gradient; the Mamba2 columns: each holds a part of the sum
            sum_back = axis == "data" or prefix + picked[0] != (
                "frontend", "proj")
            full = _Gather.apply(self.mg.axis[axis], self.collectives,
                                 tuple(dims[prefix + n] for n in picked),
                                 sum_back, *(out[n] for n in picked))
            out.update(zip(picked, full))
        return out

    def layer_params(self, p, i):
        names = [path for path, _ in model_lib.named_leaves(p)]
        return _nest(self._gather(p, ("blocks", i), names))

    def top(self, params: Dict) -> Dict:
        """The top-level leaves (embedding, head, frontend, shared block,
        final norm), gathered."""
        names = [path for path, _ in model_lib.named_leaves(params)
                 if path[0] != "blocks"]
        return _nest(self._gather(params, (), names))

    # --- the blocks --------------------------------------------------------

    def _mlp(self, p, x, tp: bool):
        """The gated MLP, column- then row-parallel over `model` where
        `tp`."""
        c, gm = self.collectives, self.gm
        cdt = getattr(torch, self.cfg.compute_dtype)
        y = layers.mlp(p, _Copy.apply(x, gm, c) if tp else x, cdt)
        return _Reduce.apply(y, gm, c) if tp else y

    def mlp(self, p, x):
        return self._mlp(p, x, self.tp_mlp)

    def attention(self, p, x, *, window, positions, cache, cache_index):
        if cache is not None and self.seq_group is not None:
            return self._seq_attention(p, x, window=window,
                                       positions=positions, cache=cache,
                                       cache_index=cache_index)
        if self.kv_split:
            p = self._kv_heads(p)
        c, gm = self.collectives, self.gm
        h = _Copy.apply(x, gm, c) if self.tp_attn else x
        y, cache = attention.attention(p, h, cfg=self.lcfg, window=window,
                                       positions=positions, cache=cache,
                                       cache_index=cache_index)
        return (_Reduce.apply(y, gm, c) if self.tp_attn else y), cache

    def _kv_heads(self, p):
        """The KV projections cut to the heads this rank's queries read."""
        lo, hi = self.kv_range
        p = dict(p)
        for n in ("wk", "wv"):
            p[n] = p[n][:, lo:hi]
        for n in ("bk", "bv"):
            if n in p:
                p[n] = p[n][lo:hi]
        return p

    def _seq_attention(self, p, x, *, window, positions, cache,
                       cache_index):
        """Attention over a sequence-sharded cache (module docstring)."""
        cfg, c = self.cfg, self.collectives
        cdt = getattr(torch, cfg.compute_dtype)
        t = x.shape[1]
        q = attention._project(x, p["wq"], cdt)
        k = attention._project(x, p["wk"], cdt)
        v = attention._project(x, p["wv"], cdt)
        if cfg.qkv_bias:
            q = q + p["bq"].to(cdt)
            k = k + p["bk"].to(cdt)
            v = v + p["bv"].to(cdt)
        q = layers.rope(q, positions, cfg.rope_theta)
        k = layers.rope(k, positions, cfg.rope_theta)
        q, k, v = (u.transpose(1, 2) for u in (q, k, v))  # (B, H, T, hd)
        band = dict(causal=cfg.causal, window=window,
                    softcap=cfg.attn_logit_softcap)
        lo = self.seq_index * self.s_loc
        a = max(cache_index, lo)
        b = min(cache_index + t, lo + self.s_loc)
        if a < b:
            src = slice(a - cache_index, b - cache_index)
            cache.k[:, :, a - lo:b - lo] = k[:, :, src].to(cache.k.dtype)
            cache.v[:, :, a - lo:b - lo] = v[:, :, src].to(cache.v.dtype)
        if t > 1:
            if cache_index != 0:
                raise ValueError("a sequence-sharded cache takes its prompt "
                                 "at position 0")
            kk, vv = (u.to(cache.k.dtype).to(q.dtype) for u in (k, v))
            if self.kv_split:
                kv_lo, kv_hi = self.kv_range
                kk, vv = kk[:, kv_lo:kv_hi], vv[:, kv_lo:kv_hi]
            out = ref.mha_ref(q, kk, vv, **band)
        else:
            gather = self.tp_attn and not self.heads_div
            qa = all_gather(q, self.gm, c, 1) if gather else q
            m, l, o = ref.mha_partial(qa, cache.k.to(q.dtype),
                                      cache.v.to(q.dtype),
                                      q_offset=cache_index, k_offset=lo,
                                      **band)
            out = flash_decode_combine(
                m[None], l[None], o[None],
                lambda t: all_reduce(t, self.seq_group, c,
                                     tdist.ReduceOp.MAX),
                lambda t: all_reduce(t, self.seq_group, c)).to(q.dtype)
            if gather:
                h = q.shape[1]
                out = out[:, self.mi * h:(self.mi + 1) * h]
        h, hd = out.shape[1], out.shape[3]
        out = out.transpose(1, 2).reshape(*x.shape[:2], h * hd)
        y = out @ p["wo"].to(cdt).reshape(h * hd, -1)
        if self.tp_attn:
            y = _Reduce.apply(y, self.gm, c)
        return y, cache

    def moe(self, p, x):
        cfg, c, gm = self.cfg, self.collectives, self.gm
        mo = cfg.moe
        cdt = getattr(torch, cfg.compute_dtype)
        b, s_len, d = x.shape
        n = b * s_len
        x2d = x.reshape(n, d)
        shards = self.D * self.M
        n_total = n * self.D if self.rows_split else n
        rows_g = gm if self.rows_split else self.mg.group
        if (mo.dispatch == "dakc" and n_total % shards == 0
                and n_total >= shards):
            xs = _Rows.apply(x2d, rows_g, c)
            capacity = moe._capacity(xs.shape[0] * mo.top_k, mo.num_experts,
                                     mo.capacity_factor)
            y, aux, dropped = moe._dakc_dispatch(
                p, xs, cfg, self.M, capacity, 1,
                lambda t: _AllToAll.apply(t[0], gm, c)[None])
            y = _Gather.apply(rows_g, c, (0,), False, y)[0]
            aux, dropped = aux.sum(), dropped.sum()
        else:
            gather = self.rows_split and self.D > 1
            xg = _Copy.apply(x2d, gm, c)
            if gather:
                xg = _Gather.apply(self.gd, c, (0,), True, xg)[0]
            ids, weights, aux = moe._router(p, xg, cfg)
            capacity = moe._capacity(n_total * mo.top_k, mo.num_experts,
                                     mo.capacity_factor)
            y, dropped = moe._gshard_dispatch(p, xg, ids, weights, cfg,
                                              capacity, self.experts)
            y = _Reduce.apply(y, gm, c)
            if gather:
                r = self.mg.coord["data"]
                y = y[r * n:(r + 1) * n]
        shared = self._mlp(p["shared"], x2d.to(cdt), self.tp_shared)
        # the load-balance term and the dropped share: this rank's share
        # of the mean over shards, so a sum over the group gives the mean
        return (y + shared).reshape(b, s_len, d), moe.MoEAux(
            load_balance_loss=aux / shards, dropped_frac=dropped / shards)

    def _ssm_plan(self) -> None:
        """The rank's columns of `in_proj` (z, x, B, C, dt) and channels of
        the conv (x, B, C)."""
        s, m, mi = self.cfg.ssm, self.M, self.mi
        d_in = s.d_inner(self.cfg.d_model)
        heads = d_in // s.headdim
        if heads % m:
            raise ValueError(f"{heads} Mamba2 heads do not split over a "
                             f"model axis of {m}")
        ng = s.n_groups * s.d_state
        dl, hl = d_in // m, heads // m
        mine = lambda base, n: list(range(base + mi * n, base + (mi + 1) * n))
        self.ssm_width, self.ssm_lo, self.ssm_dl = d_in, mi * dl, dl
        self.ssm_cols = (mine(0, dl) + mine(d_in, dl)
                         + list(range(2 * d_in, 2 * d_in + 2 * ng))
                         + mine(2 * d_in + 2 * ng, hl))
        self.ssm_chans = mine(0, dl) + list(range(d_in, d_in + 2 * ng))
        self._ssm_idx: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}

    def _ssm_index(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The rank's columns and channels on `device`, made once (a host
        list copied to the card waits for the stream)."""
        if device not in self._ssm_idx:
            self._ssm_idx[device] = tuple(
                torch.tensor(v, device=device)
                for v in (self.ssm_cols, self.ssm_chans))
        return self._ssm_idx[device]

    def mamba(self, p, x, state):
        c, gm = self.collectives, self.gm
        cols, chans = self._ssm_index(x.device)
        lo = self.ssm_lo
        q = dict(p)
        q["in_proj"] = p["in_proj"].index_select(1, cols)
        q["conv_w"] = p["conv_w"].index_select(1, chans)
        q["conv_b"] = p["conv_b"].index_select(0, chans)
        q["norm"] = {"scale": p["norm"]["scale"][lo:lo + self.ssm_dl]}

        def mean(sq):
            return _Sum.apply(sq.sum(-1, keepdim=True), gm, c) \
                / self.ssm_width
        y, state = ssm.mamba_block(q, _Copy.apply(x, gm, c), cfg=self.lcfg,
                                   state=state, norm_mean=mean)
        return _Reduce.apply(y, gm, c), state

    # --- whole passes ------------------------------------------------------

    def embed_tokens(self, top: Dict, tokens: torch.Tensor
                     ) -> torch.Tensor:
        """(B, T) tokens -> (B, T, D), replicated over `model`:
        vocab-parallel where the vocabulary divides."""
        cdt = getattr(torch, self.cfg.compute_dtype)
        table = top["embed"]["tok"]
        if not self.tp_vocab:
            return layers.embed(top["embed"], tokens, cdt)
        v = table.shape[0]
        mine = (tokens >= self.vocab_lo) & (tokens < self.vocab_lo + v)
        rows = F.embedding(torch.where(mine, tokens - self.vocab_lo, 0),
                           table)
        return _Reduce.apply(rows * mine[..., None], self.gm,
                             self.collectives).to(cdt)

    def embed(self, top: Dict, batch: Dict[str, torch.Tensor]
              ) -> torch.Tensor:
        """This rank's rows of the batch -> (B, T, D), replicated over
        `model`, as `model.embed_inputs`: an encoder's projected frames;
        tokens, with a VLM's projected patches before them."""
        cfg = self.cfg
        if cfg.frontend.kind == "audio":
            return frontends.project(top["frontend"], batch["frames"], cfg)
        x = self.embed_tokens(top, batch["tokens"])
        if cfg.frontend.kind == "vision":
            patches = frontends.project(top["frontend"], batch["patches"],
                                        cfg)
            x = torch.cat([patches, x], dim=1)
        return x

    def logits(self, top: Dict, x: torch.Tensor) -> torch.Tensor:
        """(..., D) -> (..., V_local) f32 logits: this rank's vocabulary
        columns where the vocabulary divides `model`, else all."""
        if self.tp_vocab:
            x = _Copy.apply(x, self.gm, self.collectives)
        return layers.logits(top.get("embed", {}), x, top.get("head"),
                             self.cfg.final_logit_softcap)

    def stack(self, params: Dict, top: Dict, x: torch.Tensor,
              positions: torch.Tensor, caches=None, cache_index: int = 0):
        return model_lib._run_stack(params, x, cfg=self.cfg,
                                    positions=positions, caches=caches,
                                    cache_index=cache_index, blocks=self,
                                    shared=top.get("shared_attn"))

    # --- serving -----------------------------------------------------------

    def init_caches(self, dtype, device) -> List[Dict]:
        """This rank's zeroed caches: its rows, its KV heads (all of them
        on a sequence-sharded cache) and positions, its SSM heads and
        conv channels."""
        b = (self.serve_batch // self.D if self.rows_split
             else self.serve_batch)
        kv_cfg = self.lcfg if self.heads_div else dataclasses.replace(
            self.lcfg, num_kv_heads=self.cfg.num_kv_heads)
        return model_lib.init_caches(kv_cfg, b, self.s_loc, dtype,
                                     device=device)

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """A global batch tensor -> this rank's rows."""
        if not self.rows_split or self.D == 1:
            return t
        n = t.shape[0] // self.D
        r = self.mg.coord["data"]
        return t[r * n:(r + 1) * n]

    def join_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows -> every row, on every rank."""
        if not self.rows_split or self.D == 1:
            return t
        return all_gather(t, self.gd, self.collectives)

    def prefill(self, params: Dict, batch: Dict[str, torch.Tensor],
                caches: List[Dict]):
        """The prompt pass from position 0 -> (last position's logits
        (B, 1, V_local), caches)."""
        top = self.top(params)
        x = self.embed(top, batch)
        positions = torch.arange(x.shape[1], device=x.device)
        x, caches, _ = self.stack(params, top, x, positions, caches, 0)
        x = layers.rmsnorm(top["final_norm"], x[:, -1:], self.cfg.rms_eps)
        return self.logits(top, x), caches

    def decode_step(self, params: Dict, tokens: torch.Tensor,
                    caches: List[Dict], cache_index: int):
        """One token a row at `cache_index` -> (logits (B, 1, V_local),
        caches)."""
        top = self.top(params)
        x = self.embed_tokens(top, tokens)
        positions = torch.arange(cache_index, cache_index + 1,
                                 device=x.device)
        x, caches, _ = self.stack(params, top, x, positions, caches,
                                  cache_index)
        x = layers.rmsnorm(top["final_norm"], x, self.cfg.rms_eps)
        return self.logits(top, x), caches

    def greedy(self, logits: torch.Tensor) -> torch.Tensor:
        """(B, 1, V_local) -> (B, 1) int64 argmax over the whole
        vocabulary, the lowest index on a tie (as torch.argmax): one
        all-gather of each rank's (max, index) over `model`."""
        last = logits[:, -1]
        idx = torch.argmax(last, dim=-1)
        if not self.tp_vocab:
            return idx[:, None]
        val = last.gather(-1, idx[:, None])[:, 0]
        pair = torch.stack([val.double(), (idx + self.vocab_lo).double()],
                           -1)
        every = all_gather(pair[None], self.gm, self.collectives)
        return pick_lowest(every)[:, None]

    def full_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """(B_local, 1, V_local) -> the last position's (B, V) logits of
        every row and the whole vocabulary, on every rank."""
        last = logits[:, -1]
        if self.tp_vocab:
            last = all_gather(last, self.gm, self.collectives, 1)
        return self.join_rows(last)

    def sample(self, logits: torch.Tensor, temperature: float,
               gen: Optional[torch.Generator]) -> torch.Tensor:
        """A draw from softmax(logits / temperature) over the whole
        vocabulary; every `model` rank draws the same token when their
        generators are seeded alike."""
        last = logits[:, -1]
        if self.tp_vocab:
            last = all_gather(last, self.gm, self.collectives, 1)
        probs = torch.softmax(last / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)
