"""The sharded train step: one rank's share of the step on a (data, model)
mesh of ranks (`launch.mesh.MeshGroup`), written out the way GSPMD
partitions the JAX package's step under `models/sharding.py`'s specs.

Each rank holds the block of every parameter and AdamW moment that its
mesh coordinate picks (`sharding.shard_params`) and runs the rank's model
of `models/parallel.py` (`RankModel`): FSDP over `data`, tensor
parallelism over `model`, the MoE's experts over `model`, the Mamba2
width over `model`, the frontends' projection gathered; every family of
the registry.

- The loss: a causal model's next-token cross-entropy over its text, an
  encoder's frame-target one (with its mask, whose count is summed over
  `data`), each rank's sum over its rows divided by the global count, so
  the sums over ranks are the global mean's gradients. Where the
  vocabulary divides `model` it takes a vocab-parallel logsumexp (the
  maximum, then the sum of exponentials and the gold logit, over
  `model`) and keeps the z-loss. The MoE's load-balance term is each
  rank's share of the mean over the shards.
- Gradients: the leaves `data` does not shard are summed over `data` in
  one flat all-reduce a step, and those each `model` rank holds a part
  of (`RankModel.partial_model`: the replicated KV projections, the
  router, the Mamba2 norm and any Mamba2 column leaf `model` does not
  cut) over `model` in another. `optimizer.global_norm` counts each
  element once: a leaf counts on the ranks at index 0 of every axis it
  is replicated on, and the square sum is summed over the whole group.

Every collective is counted in the step's `collectives` (calls and bytes
moved by this rank), so a caller can read the number a step makes.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import MeshGroup
from repro_torch.models import layers
from repro_torch.models import model as model_lib
from repro_torch.models import parallel
from repro_torch.models.parallel import all_reduce
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.train_step import TrainConfig, _CrossEntropy

_MAX = torch.distributed.ReduceOp.MAX


class _VocabParallelCE(torch.autograd.Function):
    """Per-position (ce, lse) of vocab-sharded (N, V_local) f32 logits
    whose first column is vocabulary entry `lo`: the logsumexp's maximum,
    then the exponentials' sum and the gold logit, over `model`;
    ce = lse - gold + z * lse^2, as `train_step._CrossEntropy`."""

    @staticmethod
    def forward(ctx, logits, labels, z_loss, lo, g, counts):
        v = logits.shape[-1]
        lmax = all_reduce(logits.max(-1).values.contiguous(), g, counts,
                          _MAX)
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


class ShardedStep:
    """The sharded step's plan: which gradients are summed over `data` or
    `model`, and which leaves count toward the global norm on this rank."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, mg: MeshGroup,
                 full_params):
        self.cfg, self.tcfg, self.mg = cfg, tcfg, mg
        self.model = parallel.RankModel(cfg, mg, full_params)
        # every collective this step has made: calls, bytes, calls a kind
        self.collectives = self.model.collectives
        mesh = mg.mesh
        self.paths: List[Tuple] = []
        self.sum_data: List[Tuple] = []
        self.counts: List[bool] = []
        for path, _ in model_lib.named_leaves(full_params):
            axes = parallel._leaf(self.model.shardings, path).axes()
            self.paths.append(path)
            if "data" not in axes:
                self.sum_data.append(path)
            self.counts.append(all(mg.coord[a] == 0
                                   for a in mesh.axis_names
                                   if a not in axes))
        self.sum_model = self.model.partial_model

    def loss(self, params: Dict, batch: Dict[str, torch.Tensor]):
        """(this rank's part of the loss, (global loss, global mean lse,
        global aux)) of its rows of `batch`."""
        cfg, rm, c = self.cfg, self.model, self.collectives
        top = rm.top(params)
        x = rm.embed(top, batch)
        positions = torch.arange(x.shape[1], device=x.device)
        x, _, aux = rm.stack(params, top, x, positions)
        x = layers.rmsnorm(top["final_norm"], x, cfg.rms_eps)
        if cfg.causal:
            tokens = batch["tokens"]
            x = x[:, -tokens.shape[1]:-1]
            labels = tokens[:, 1:]
        else:
            labels = batch["labels"]
        labels = labels.reshape(-1).long()
        logits = rm.logits(top, x)
        logits = logits.reshape(-1, logits.shape[-1])
        if rm.tp_vocab:
            ce, lse = _VocabParallelCE.apply(logits, labels,
                                             self.tcfg.z_loss, rm.vocab_lo,
                                             rm.gm, c)
        else:
            ce, lse = _CrossEntropy.apply(logits, labels, self.tcfg.z_loss)
        mask = batch.get("mask")
        if mask is None:
            count = ce.numel() * rm.D
        else:
            m = mask.reshape(-1).float()
            ce, lse = ce * m, lse * m
            count = torch.clamp(all_reduce(m.sum(), rm.gd, c), min=1.0)
        loss, lse = ce.sum() / count, lse.sum() / count
        metrics = all_reduce(torch.stack([loss / rm.M, lse / rm.M,
                                          aux]).detach(), self.mg.group, c)
        return loss + aux, metrics

    # --- the step ----------------------------------------------------------

    def __call__(self, params: Dict, opt_state, batch: Dict):
        """train_step(params, opt_state, batch) on this rank's blocks and
        its rows of the batch (each value's leading dim its rows); the
        parameters and moments update in place. Metrics are the global
        step's."""
        nm = self.tcfg.num_microbatches
        leaves = [p for _, p in model_lib.named_leaves(params)]
        for p in leaves:
            p.requires_grad_(True)
        grads, metrics = None, None
        for mb in zip(*(torch.chunk(v, nm) for v in batch.values())):
            loss, m = self.loss(params, dict(zip(batch, mb)))
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
               "aux_loss": metrics[2]}
        out.update(om)
        return params, opt_state, out
