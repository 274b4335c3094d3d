"""Every architecture of the port against the JAX package, on the CPU:
reduced, at compute float32, from the JAX package's own parameters
(`convert.params_from_jax`), the logits and MoE aux of `forward`, and the
loss and every gradient leaf of `loss_fn`: hubert through the frame-target
loss with a mask, the MoE archs with their aux term, llava with its
patches. (The blocks and three AdamW steps: test_torch_families.py.)

Tolerances are test_torch_lm.py's: logits within 1e-6 of the largest
logit's magnitude, the loss 1e-5 relative, every gradient leaf within 1e-4
of its largest magnitude; the aux loss 1e-6 relative (a mean of f32
probabilities, summed in another order).
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from _lm_parity import batch_for, close, setup, torch_batch, tree_close
from repro.configs import ARCH_IDS
from repro.models import model as jmodel
from repro.train import train_step as jts
from repro_torch.models import convert
from repro_torch.models import model as tmodel
from repro_torch.train import train_step as tts


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_loss_and_every_gradient_match_jax(arch):
    jcfg, tcfg, jparams, params = setup(arch)
    batch = batch_for(jcfg, 3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        total, m = jts.loss_fn(p, jb, jcfg)
        return total, (m["loss"], m["aux_loss"], jmodel.forward(p, jb, jcfg))

    (jtotal, (jl, jaux, (jlogits, jfaux))), jg = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jparams)

    with torch.no_grad():
        tlogits, tfaux = tmodel.forward(params, torch_batch(batch), tcfg)
    close(tlogits.numpy(), jlogits, 1e-6, "logits")
    assert float(tfaux) == pytest.approx(float(jfaux), rel=1e-6, abs=1e-12)
    leaves = [t.requires_grad_(True) for _, t in tmodel.named_leaves(params)]
    total, m = tts.loss_fn(params, torch_batch(batch), tcfg)
    grads = torch.autograd.grad(total, leaves)
    assert float(m["loss"]) == pytest.approx(float(jl), rel=1e-5)
    assert float(total.detach()) == pytest.approx(float(jtotal), rel=1e-5)
    assert float(m["aux_loss"]) == pytest.approx(float(jaux), rel=1e-6,
                                                 abs=1e-12)
    if jcfg.moe is not None:
        assert float(jaux) > 0
    it = iter(grads)
    tree_close(convert.params_to_numpy(
        tmodel.map_leaves(lambda _: next(it), params), tcfg), jg, "grad")
