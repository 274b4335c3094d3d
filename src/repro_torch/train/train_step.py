"""Loss and train step: cross-entropy with z-loss, microbatched gradient
accumulation, AdamW.

Counterpart of `repro.train.train_step` for decoder batches ({"tokens":
(B, S)}; labels are the tokens shifted left). PyTorch runs eagerly, so the
step is a Python function; microbatches are a loop that sums the f32
gradients and divides by their count, as the JAX scan does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib
from repro_torch.train import optimizer as opt_lib


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    num_microbatches: int = 1
    z_loss: float = 1e-4
    optimizer: opt_lib.OptimizerConfig = opt_lib.OptimizerConfig()


class _CrossEntropy(torch.autograd.Function):
    """Per-position (ce, lse) from (N, V) f32 logits and (N,) labels, with
    ce = lse - logit[label] + z * lse^2. The gold logit is a gather (a
    one-hot of the vocab would cost another logits-sized tensor), and the
    backward writes the one gradient tensor it returns:
    dlogits = softmax * (g_ce (1 + 2 z lse) + g_lse) - onehot * g_ce."""

    @staticmethod
    def forward(ctx, logits, labels, z_loss):
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels[:, None])[:, 0]
        ctx.save_for_backward(logits, labels, lse)
        ctx.z_loss = z_loss
        return lse - gold + z_loss * lse.square(), lse

    @staticmethod
    def backward(ctx, g_ce, g_lse):
        logits, labels, lse = ctx.saved_tensors
        coef = g_ce * (1.0 + 2.0 * ctx.z_loss * lse) + g_lse
        grad = torch.sub(logits, lse[:, None]).exp_().mul_(coef[:, None])
        grad.scatter_add_(-1, labels[:, None], -g_ce[:, None])
        return grad, None, None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE (+ z-loss) and the mean logsumexp over every position.
    logits (..., V) f32, labels (...). (The JAX package's optional mask
    has no caller: token batches carry none.)"""
    v = logits.shape[-1]
    ce, lse = _CrossEntropy.apply(logits.reshape(-1, v),
                                  labels.reshape(-1).long(), z_loss)
    return ce.mean(), lse.mean()


def loss_fn(params: Dict, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            *, z_loss: float = 1e-4
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token loss of a decoder batch. The LM head runs on the
    positions that have a label only (all but the last): the same logits
    as `model.forward`'s, without a gradient the size of the dropped
    row."""
    if not cfg.causal:
        raise NotImplementedError(
            "encoder (frame-target) losses are not ported yet: ROADMAP.md "
            "section 1, item 12 (the VLM and audio families)")
    tokens = batch["tokens"]
    x = model_lib.hidden(params, batch, cfg)[:, -tokens.shape[1]:-1]
    logits = model_lib.head(params, x, cfg)
    loss, lse = cross_entropy(logits, tokens[:, 1:], z_loss)
    aux = torch.zeros((), dtype=torch.float32, device=loss.device)
    return loss, {"loss": loss.detach(), "aux_loss": aux,
                  "lse_mean": lse.detach()}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics); the batch's leading dim must divide by num_microbatches. The
    parameters are updated in place."""
    model_lib.check_supported(cfg)

    def grads_of(params, mb):
        leaves = [p for _, p in model_lib.named_leaves(params)]
        for p in leaves:
            p.requires_grad_(True)
        loss, metrics = loss_fn(params, mb, cfg, z_loss=tcfg.z_loss)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g.float()
                 for p, g in zip(leaves, grads)]
        return metrics, grads

    def train_step(params, opt_state, batch):
        nm = tcfg.num_microbatches
        if nm == 1:
            metrics, grads = grads_of(params, batch)
        else:
            grads, metrics = None, None
            for mb in zip(*(torch.chunk(v, nm) for v in batch.values())):
                m, g = grads_of(params, dict(zip(batch, mb)))
                if grads is None:
                    grads, metrics = g, m
                else:
                    for acc, x in zip(grads, g):
                        acc.add_(x)
                    metrics = {k: metrics[k] + m[k] for k in metrics}
            grads = [g / nm for g in grads]
            metrics = {k: v / nm for k, v in metrics.items()}
        it = iter(grads)
        grad_tree = model_lib.map_leaves(lambda _: next(it), params)
        params, opt_state, om = opt_lib.apply(tcfg.optimizer, params,
                                              grad_tree, opt_state)
        metrics.update(om)
        return params, opt_state, metrics

    return train_step
