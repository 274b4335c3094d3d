"""The port's MoE, SSM/hybrid, VLM and audio blocks against the JAX
package, on the CPU, and three AdamW steps of two new families.

The blocks on numpy inputs: `ssd_chunked` with and without an initial
state, `mamba_block` in its chunked view (with and without a state to
seed it, over a padded last chunk) and its recurrent step, and `moe_block`
on the GShard path (the JAX package's mesh=None path) with and without
drops. Then three AdamW steps of deepseek-moe-16b and zamba2-1.2b,
reduced, at compute float32, from the JAX package's own parameters
(`convert.params_from_jax`). Every architecture's logits, loss and
gradients: test_torch_families_grads.py.

Tolerances: the blocks within 1e-5 of the output's largest magnitude;
expert ids and the dropped share equal; the aux loss 1e-6 relative (a mean
of f32 probabilities, summed in another order). The AdamW steps:
test_torch_lm.py's, every parameter and moment leaf within 1e-4 of its
largest magnitude.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import (B, STEPS, batch_for, close, opt_kwargs, setup,
                        to_torch, torch_batch, tree_close)
from repro.configs import reduced_config as jreduced
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.configs import reduced_config
from repro_torch.models import convert
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

BLOCK_TOL = 1e-5


# --- SSM ---------------------------------------------------------------------

def _ssd_inputs(rng, bsz=2, length=48, h=4, p=8, g=2, n=6):
    x = rng.normal(size=(bsz, length, h, p)).astype(np.float32)
    a_dt = -np.abs(rng.normal(size=(bsz, length, h))).astype(np.float32) * 0.3
    b = rng.normal(size=(bsz, length, g, n)).astype(np.float32)
    c = rng.normal(size=(bsz, length, g, n)).astype(np.float32)
    s0 = rng.normal(size=(bsz, h, p, n)).astype(np.float32)
    return x, a_dt, b, c, s0


@pytest.mark.parametrize("seeded", [False, True], ids=["zero", "initial"])
def test_ssd_chunked_matches_jax(seeded):
    x, a_dt, b, c, s0 = _ssd_inputs(np.random.default_rng(0))
    init = s0 if seeded else None
    jy, jf = jssm.ssd_chunked(*(jnp.asarray(v) for v in (x, a_dt, b, c)), 16,
                              initial_state=None if init is None
                              else jnp.asarray(init))
    ty, tf = tssm.ssd_chunked(*(to_torch(v) for v in (x, a_dt, b, c)), 16,
                              initial_state=None if init is None
                              else to_torch(init))
    close(ty.numpy(), jy, BLOCK_TOL, "y")
    close(tf.numpy(), jf, BLOCK_TOL, "final state")
    assert tf.dtype == torch.float32


def _mamba_setup(arch="mamba2-370m"):
    kw = dict(compute_dtype="float32")
    jcfg, tcfg = jreduced(arch, **kw), reduced_config(arch, **kw)
    jp = jssm.init_mamba(jax.random.PRNGKey(4), jcfg)
    tp = tmodel.map_leaves(to_torch, jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("view", ["chunked", "chunked_seeded", "decode"])
def test_mamba_block_matches_jax(view):
    """The chunked view over 40 steps (chunk 16: a padded last chunk),
    from zero or from a given state; the recurrent step from a state."""
    jcfg, tcfg, jp, tp = _mamba_setup()
    rng = np.random.default_rng(1)
    length = 1 if view == "decode" else 40
    x = rng.normal(size=(B, length, jcfg.d_model)).astype(np.float32)
    state = None
    if view != "chunked":
        ref = jssm.init_ssm_state(jcfg, B, jnp.float32)
        state = [rng.normal(size=f.shape).astype(np.float32) for f in ref]
    jy, js = jssm.mamba_block(jp, jnp.asarray(x), cfg=jcfg, state=None
                              if state is None else jssm.SSMState(
                                  *map(jnp.asarray, state)))
    ty, ts_ = tssm.mamba_block(tp, to_torch(x), cfg=tcfg, state=None
                               if state is None else tssm.SSMState(
                                   *map(to_torch, state)))
    close(ty.numpy(), jy, BLOCK_TOL, "y")
    for f in ("conv", "ssm"):
        close(getattr(ts_, f).numpy(), getattr(js, f), BLOCK_TOL, f)


# --- MoE ---------------------------------------------------------------------

@pytest.mark.parametrize("factor", [0.5, 8.0], ids=["drops", "no_drops"])
def test_moe_block_gshard_matches_jax(factor):
    kw = dict(compute_dtype="float32")
    jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=factor)) for c in (
        jreduced("deepseek-moe-16b", **kw), reduced_config("deepseek-moe-16b",
                                                          **kw)))
    np_p = jax.tree.map(np.asarray,
                        jmoe.init_moe(jax.random.PRNGKey(5), jcfg))
    tp = tmodel.map_leaves(to_torch, np_p)
    x = np.random.default_rng(2).normal(size=(4, 24, jcfg.d_model)).astype(
        np.float32)
    jx = jnp.asarray(x).reshape(-1, jcfg.d_model)
    jids, jw, jaux = jmoe._router(np_p, jx, jcfg)
    tids, tw, taux = tmoe._router(tp, to_torch(x).reshape(-1, tcfg.d_model),
                                  tcfg)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    close(tw.numpy(), jw, BLOCK_TOL, "router weights")
    jy, jaux = jmoe.moe_block(jax.tree.map(jnp.asarray, np_p),
                              jnp.asarray(x), cfg=jcfg)
    ty, taux = tmoe.moe_block(tp, to_torch(x), cfg=tcfg)
    close(ty.numpy(), jy, BLOCK_TOL, "y")
    assert float(taux.dropped_frac) == float(jaux.dropped_frac)
    assert (float(jaux.dropped_frac) > 0) == (factor < 2)
    assert float(taux.load_balance_loss) == pytest.approx(
        float(jaux.load_balance_loss), rel=1e-6)


# --- Three AdamW steps -------------------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "zamba2-1.2b"])
def test_three_adamw_steps_match_jax(arch):
    jcfg, tcfg, jparams, params = setup(arch, seed=1)
    batches = [batch_for(jcfg, 10 + s) for s in range(STEPS)]
    jtc = jts.TrainConfig(optimizer=jopt.OptimizerConfig(**opt_kwargs()))
    jstep = jax.jit(jts.make_train_step(jcfg, jtc))
    jstate, p = jopt.init(jparams), jparams
    for b in batches:
        p, jstate, _ = jstep(p, jstate, {k: jnp.asarray(v)
                                         for k, v in b.items()})
    step = tts.make_train_step(tcfg, tts.TrainConfig(
        optimizer=topt.OptimizerConfig(**opt_kwargs())))
    state = topt.init(params)
    for b in batches:
        params, state, _ = step(params, state, torch_batch(b))
    tree_close(convert.params_to_numpy(params, tcfg), p, "params")
    st = convert.opt_state_to_numpy(state, tcfg)
    assert st["step"] == STEPS == int(jstate.step)
    tree_close(st["mu"], jstate.mu, "mu")
    tree_close(st["nu"], jstate.nu, "nu")
