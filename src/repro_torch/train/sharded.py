"""The sharded train step: one rank's share of a dense decoder's step on a
(data, model) mesh of ranks (`launch.mesh.MeshGroup`), written out the
way GSPMD partitions the JAX package's step under `models/sharding.py`'s
specs.

Each rank holds the block of every parameter and AdamW moment that its
mesh coordinate picks (`sharding.shard_params`) and runs the model of
`sharding.local_config`: its heads, MLP hidden and vocabulary.

- FSDP over `data`: before a layer, one flat all-gather over the rank's
  `data` line brings the layer's data-sharded leaves whole along `data`
  (`_GatherLayer`); its backward is one reduce-scatter of their
  gradients. Under remat the gather is part of the recomputed layer.
- Tensor parallelism over `model` (Megatron): `wq/wk/wv` and `mlp/wi/wg`
  are column-parallel, `attn/wo` and `mlp/wo` row-parallel; `_Copy`
  (identity forward, all-reduce backward) stands before the
  column-parallel products and `_Reduce` (all-reduce forward, identity
  backward) after the row-parallel ones. Where the KV heads do not
  divide the `model` axis their projections are replicated, and each
  rank projects the KV heads its query heads read
  (`sharding.kv_head_range`); their gradients are then partial and are
  summed over `model`.
- The embedding and the head are vocab-parallel where the vocabulary
  divides `model`: a rank looks up its rows (the others give 0) and the
  sum goes over `model`; the cross-entropy takes a vocab-parallel
  logsumexp (the maximum, then the sum of exponentials and the gold
  logit, over `model`) and keeps the z-loss. Where the vocabulary does
  not divide, the table is whole on every `model` rank (FSDP over
  `d_model`) and the loss is the plain one.
- Gradients: the leaves `data` does not shard are summed over `data` in
  one flat all-reduce a step, the partial KV projections over `model`
  in another. The loss is each rank's mean over its rows divided by the
  `data` size, so the sums are the global mean's gradients.
  `optimizer.global_norm` counts each element once: a leaf counts on the
  ranks at index 0 of every axis it is replicated on, and the square sum
  is summed over the whole group.

Every collective is counted in the step's `collectives` (calls and bytes
moved by this rank), so a caller can read the number a step makes.
Dense decoders only (period of 'attn' / 'attn_local', no frontend):
other families on more than one rank raise NotImplementedError
(`core.dist.SLICE18`).
"""

from __future__ import annotations

import collections
from typing import Dict, List, Tuple

import torch
import torch.distributed as tdist

from repro_torch.configs.base import ModelConfig
from repro_torch.core import dist
from repro_torch.launch.mesh import MeshGroup
from repro_torch.models import attention, layers
from repro_torch.models import model as model_lib
from repro_torch.models import sharding as shd
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.train_step import TrainConfig, _CrossEntropy

# `reduce_scatter_single` replaces `reduce_scatter_tensor` in newer torch
_reduce_scatter = getattr(tdist, "reduce_scatter_single", None) \
    or tdist.reduce_scatter_tensor

_DENSE_KINDS = ("attn", "attn_local")


def is_dense_decoder(cfg: ModelConfig) -> bool:
    """Whether the sharded step runs `cfg`: a causal stack of 'attn' /
    'attn_local' layers with no frontend."""
    return (cfg.causal and cfg.frontend.kind == "none" and cfg.moe is None
            and all(k in _DENSE_KINDS for k in cfg.period))


def check_shardable(cfg: ModelConfig, mesh_size: int) -> None:
    """Raise NotImplementedError for a family the sharded step does not
    run on a mesh of more than one rank."""
    if mesh_size > 1 and not is_dense_decoder(cfg):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}, period {cfg.period}) on a mesh of "
            f"{mesh_size} ranks: the sharded step runs the dense decoders; "
            f"the other families under a mesh wait for {dist.SLICE18}")


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


class _Copy(torch.autograd.Function):
    """Identity forward, all-reduce over `model` backward: the input of a
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
    """All-reduce over `model` forward, identity backward: the output of a
    row-parallel product."""

    @staticmethod
    def forward(ctx, x, g, counts):
        return all_reduce(x.contiguous().clone(), g, counts)

    @staticmethod
    def backward(ctx, dy):
        return dy, None, None


class _GatherLayer(torch.autograd.Function):
    """One layer's FSDP leaves whole along `data`: one flat all-gather
    forward, one reduce-scatter of their gradients backward. `dims[i]` is
    the dim leaf i is sharded on."""

    @staticmethod
    def forward(ctx, g, counts, dims, *shards):
        ctx.g, ctx.counts, ctx.dims = g, counts, dims
        ctx.shapes = [s.shape for s in shards]
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
        parts = []
        for gr, shape, dim in zip(grads, ctx.shapes, ctx.dims):
            full = list(shape)
            full[dim] *= d
            if gr is None:
                gr = torch.zeros(full, dtype=torch.float32,
                                 device=g.device)
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
        return (None, None, None, *res)


class _VocabParallelCE(torch.autograd.Function):
    """Per-position (ce, lse) of vocab-sharded (N, V_local) f32 logits
    whose first column is vocabulary entry `lo`: the logsumexp's maximum,
    then the exponentials' sum and the gold logit, over `model`;
    ce = lse - gold + z * lse^2, as `train_step._CrossEntropy`."""

    @staticmethod
    def forward(ctx, logits, labels, z_loss, lo, g, counts):
        v = logits.shape[-1]
        lmax = all_reduce(logits.max(-1).values.contiguous(), g, counts,
                          tdist.ReduceOp.MAX)
        mine = (labels >= lo) & (labels < lo + v)
        idx = torch.where(mine, labels - lo, 0)
        gold = logits.gather(-1, idx[:, None])[:, 0] * mine
        both = torch.stack([torch.sub(logits, lmax[:, None]).exp_().sum(-1),
                            gold])
        all_reduce(both, g, counts)
        lse = lmax + torch.log(both[0])
        ctx.save_for_backward(logits, idx, mine, lse)
        ctx.z_loss = z_loss
        return lse - both[1] + z_loss * lse.square(), lse

    @staticmethod
    def backward(ctx, g_ce, g_lse):
        logits, idx, mine, lse = ctx.saved_tensors
        coef = g_ce * (1.0 + 2.0 * ctx.z_loss * lse) + g_lse
        grad = torch.sub(logits, lse[:, None]).exp_().mul_(coef[:, None])
        grad.scatter_add_(-1, idx[:, None], (-g_ce * mine)[:, None])
        return grad, None, None, None, None, None


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


class ShardedStep:
    """The sharded step's plan: which leaves are FSDP-sharded (and on
    which dim), which gradients are summed over `data` or `model`, and
    which leaves count toward the global norm on this rank."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, mg: MeshGroup,
                 full_params):
        check_shardable(cfg, mg.mesh.size)
        if not is_dense_decoder(cfg):
            raise ValueError(f"the sharded step runs dense decoders, not "
                             f"{cfg.name}")
        model_lib.check_supported(cfg)
        self.cfg, self.tcfg, self.mg = cfg, tcfg, mg
        # every collective this step has made: calls, bytes, calls a kind
        self.collectives: Dict[str, int] = collections.Counter()
        mesh = mg.mesh
        self.lcfg = shd.local_config(cfg, mesh)
        m = mesh.shape["model"]
        self.tp_attn = cfg.num_heads % m == 0
        self.tp_mlp = cfg.d_ff % m == 0
        self.tp_vocab = cfg.vocab_size % m == 0
        self.kv_split = self.tp_attn and cfg.num_kv_heads % m != 0
        self.kv_range = (shd.kv_head_range(cfg, mesh, mg.coord["model"])
                         if self.kv_split else None)
        self.vocab_lo = (mg.coord["model"] * self.lcfg.vocab_size
                         if self.tp_vocab else 0)
        shardings = shd.param_shardings(full_params, mesh)
        self.paths: List[Tuple] = []
        self.fsdp_dim: Dict[Tuple, int] = {}
        self.sum_data: List[Tuple] = []
        self.sum_model: List[Tuple] = []
        self.counts: List[bool] = []
        for path, _ in model_lib.named_leaves(full_params):
            spec = _leaf(shardings, path).spec
            self.paths.append(path)
            axes = _leaf(shardings, path).axes()
            if "data" in axes:
                self.fsdp_dim[path] = [
                    i for i, e in enumerate(spec)
                    if e == "data" or (isinstance(e, tuple) and "data" in e)
                ][0]
            else:
                self.sum_data.append(path)
            if (self.kv_split and path[0] == "blocks"
                    and path[-1] in ("wk", "wv", "bk", "bv")):
                self.sum_model.append(path)
            self.counts.append(all(mg.coord[a] == 0
                                   for a in mesh.axis_names
                                   if a not in axes))

    # --- the local forward -------------------------------------------------

    def _gather(self, tree, prefix: Tuple, names: List[Tuple]) -> Dict:
        """{path: tensor} of `names` under `tree`, the FSDP ones whole
        along `data` (one all-gather for all of them)."""
        out = {n: _leaf(tree, n) for n in names}
        fsdp = [n for n in names if prefix + n in self.fsdp_dim]
        if fsdp:
            full = _GatherLayer.apply(
                self.mg.axis["data"], self.collectives,
                tuple(self.fsdp_dim[prefix + n] for n in fsdp),
                *(out[n] for n in fsdp))
            out.update(zip(fsdp, full))
        return out

    def _layer(self, p_local: Dict, x: torch.Tensor, i: int,
               positions: torch.Tensor) -> torch.Tensor:
        cfg, lcfg, c = self.cfg, self.lcfg, self.collectives
        gm = self.mg.axis["model"]
        cdt = getattr(torch, cfg.compute_dtype)
        names = [path for path, _ in model_lib.named_leaves(p_local)]
        flat = self._gather(p_local, ("blocks", i), names)
        p: Dict = {}
        for path, t in flat.items():
            node = p
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = t
        if self.kv_split:
            lo, hi = self.kv_range
            for n in ("wk", "wv"):
                p["attn"][n] = p["attn"][n][:, lo:hi]
            for n in ("bk", "bv"):
                if n in p["attn"]:
                    p["attn"][n] = p["attn"][n][lo:hi]
        kind = cfg.period[i % len(cfg.period)]
        window = cfg.sliding_window if kind == "attn_local" else None
        h = layers.rmsnorm(p["ln1"], x, cfg.rms_eps)
        if self.tp_attn:
            h = _Copy.apply(h, gm, c)
        h, _ = attention.attention(p["attn"], h, cfg=lcfg, window=window,
                                   positions=positions)
        x = x + (_Reduce.apply(h, gm, c) if self.tp_attn else h)
        h = layers.rmsnorm(p["ln2"], x, cfg.rms_eps)
        if self.tp_mlp:
            h = _Copy.apply(h, gm, c)
        h = layers.mlp(p["mlp"], h, cdt)
        return x + (_Reduce.apply(h, gm, c) if self.tp_mlp else h)

    def loss(self, params: Dict, tokens: torch.Tensor):
        """(this rank's loss / data size, (global loss, global mean lse))
        of its rows `tokens` (B_local, S)."""
        cfg, c = self.cfg, self.collectives
        gm, gd = self.mg.axis["model"], self.mg.axis["data"]
        cdt = getattr(torch, cfg.compute_dtype)
        top = [("embed", "tok")] + ([("head", "w")] if "head" in params
                                    else [])
        tabs = self._gather(params, (), top)
        table = tabs[("embed", "tok")]
        if self.tp_vocab:
            v = table.shape[0]
            mine = (tokens >= self.vocab_lo) & (tokens < self.vocab_lo + v)
            rows = torch.nn.functional.embedding(
                torch.where(mine, tokens - self.vocab_lo, 0), table)
            x = _Reduce.apply(rows * mine[..., None], gm, c).to(cdt)
        else:
            x = torch.nn.functional.embedding(tokens, table).to(cdt)
        positions = torch.arange(x.shape[1], device=x.device)
        remat = cfg.remat == "full" and torch.is_grad_enabled()
        for i, p in enumerate(params["blocks"]):
            if remat:
                x = torch.utils.checkpoint.checkpoint(
                    self._layer, p, x, i, positions, use_reentrant=False)
            else:
                x = self._layer(p, x, i, positions)
        x = layers.rmsnorm(params["final_norm"], x, cfg.rms_eps)
        x = x[:, :-1]
        labels = tokens[:, 1:].reshape(-1).long()
        head = {"w": tabs[("head", "w")]} if "head" in params else None
        if self.tp_vocab:
            logits = layers.logits({"tok": table}, _Copy.apply(x, gm, c),
                                   head, cfg.final_logit_softcap)
            ce, lse = _VocabParallelCE.apply(
                logits.reshape(-1, logits.shape[-1]), labels,
                self.tcfg.z_loss, self.vocab_lo, gm, c)
        else:
            logits = layers.logits({"tok": table}, x, head,
                                   cfg.final_logit_softcap)
            ce, lse = _CrossEntropy.apply(
                logits.reshape(-1, logits.shape[-1]), labels,
                self.tcfg.z_loss)
        loss, lse = ce.mean(), lse.mean()
        metrics = all_reduce(torch.stack([loss, lse]).detach() / gd.world,
                             gd, c)
        return loss / gd.world, metrics

    # --- the step ----------------------------------------------------------

    def __call__(self, params: Dict, opt_state, batch: Dict):
        """train_step(params, opt_state, batch) on this rank's blocks and
        its rows of the batch (`batch['tokens']` (B_local, S)); the
        parameters and moments update in place. Metrics are the global
        step's."""
        nm = self.tcfg.num_microbatches
        leaves = [p for _, p in model_lib.named_leaves(params)]
        for p in leaves:
            p.requires_grad_(True)
        grads, metrics = None, None
        for tok in torch.chunk(batch["tokens"], nm):
            loss, m = self.loss(params, tok)
            gs = torch.autograd.grad(loss, leaves, allow_unused=True)
            gs = [torch.zeros_like(p) if g is None else g.float()
                  for p, g in zip(leaves, gs)]
            if grads is None:
                grads, metrics = gs, m
            else:
                for acc, x in zip(grads, gs):
                    acc.add_(x)
                metrics = metrics + m
        for p in leaves:
            p.requires_grad_(False)
        if nm > 1:
            grads = [g / nm for g in grads]
            metrics = metrics / nm
        index = {path: i for i, path in enumerate(self.paths)}
        for axis, paths in (("data", self.sum_data),
                            ("model", self.sum_model)):
            if not paths:
                continue
            flat = torch.cat([grads[index[q]].reshape(-1) for q in paths])
            all_reduce(flat, self.mg.axis[axis], self.collectives)
            off = 0
            for q in paths:
                g = grads[index[q]]
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()
        gnorm = opt_lib.global_norm(grads, counts=self.counts,
                                    reduce=lambda t: all_reduce(
                                        t, self.mg.group, self.collectives))
        it = iter(grads)
        grad_tree = model_lib.map_leaves(lambda _: next(it), params)
        params, opt_state, om = opt_lib.apply(
            self.tcfg.optimizer, params, grad_tree, opt_state,
            grad_norm=gnorm)
        out = {"loss": metrics[0], "lse_mean": metrics[1],
               "aux_loss": torch.zeros((), device=metrics.device)}
        out.update(om)
        return params, opt_state, out
