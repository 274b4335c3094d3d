"""Loss and train step: cross-entropy with z-loss, microbatched gradient
accumulation, AdamW.

Counterpart of `repro.train.train_step`. Decoder batches carry `tokens`
(B, S), whose labels are the tokens shifted left (a VLM's patches come
first, so its text block is the last S positions); encoder batches carry
`frames` and frame-target `labels` (B, S), with an optional `mask`. The
loss adds the MoE load-balance term. PyTorch runs eagerly, so the step is
a Python function; microbatches are a loop that sums the f32 gradients
and divides by their count, as the JAX scan does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

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
                  z_loss: float, mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE (+ z-loss) and mean logsumexp over the positions, or over
    the positions where `mask` is set. logits (..., V) f32, labels and
    mask (...)."""
    v = logits.shape[-1]
    ce, lse = _CrossEntropy.apply(logits.reshape(-1, v),
                                  labels.reshape(-1).long(), z_loss)
    if mask is None:
        return ce.mean(), lse.mean()
    m = mask.reshape(-1).float()
    denom = torch.clamp(m.sum(), min=1.0)
    return (ce * m).sum() / denom, (lse * m).sum() / denom


def loss_fn(params: Dict, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            *, z_loss: float = 1e-4
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(CE + aux, metrics): next-token loss of a decoder batch, or the
    frame-target loss of an encoder batch. A decoder's LM head runs on the
    positions that have a label only (all but the last of the text): the
    same logits as `model.forward`'s, without a gradient the size of the
    dropped rows."""
    x, aux = model_lib.hidden(params, batch, cfg)
    if not cfg.causal:
        logits = model_lib.head(params, x, cfg)
        loss, lse = cross_entropy(logits, batch["labels"], z_loss,
                                  batch.get("mask"))
    else:
        tokens = batch["tokens"]
        logits = model_lib.head(params, x[:, -tokens.shape[1]:-1], cfg)
        loss, lse = cross_entropy(logits, tokens[:, 1:], z_loss,
                                  batch.get("mask"))
    return loss + aux, {"loss": loss.detach(), "aux_loss": aux.detach(),
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
