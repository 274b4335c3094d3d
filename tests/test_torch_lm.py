"""The port's LM training path against the JAX package, on the CPU.

Layers on numpy inputs; then reduced qwen1.5-0.5b (QKV bias, tied head),
gemma2-9b (local/global layers, window, attention and final softcaps) and
h2o-danube-3-4b (GQA 32/8 -> 4/1 heads, window, separate head) at compute
float32, under attn_impl 'ref' and 'flash_train', from the JAX package's
own initial parameters carried across by `convert.params_from_jax`:
logits, loss, every gradient leaf, and params and AdamW moments after three
steps with weight decay on. Then microbatching, the token pipeline, the
forward-only 'flash' impl, and a bf16 loss.

Tolerances (f32 on both sides; sums run in different orders): logits
within 1e-6 of the largest logit's magnitude (they reach 40 and are sums of
products of that size, so their rounding is absolute, about 1e-5); loss
1e-5 relative; every gradient, parameter and moment leaf within 1e-4 of
that leaf's largest magnitude ("relative 1e-4").
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced
from repro.data import tokens as jtokens
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.configs import reduced_config
from repro_torch.data import tokens
from repro_torch.models import convert, layers
from repro_torch.models import model as tmodel
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts

ARCHS = ("qwen1.5-0.5b", "gemma2-9b", "h2o-danube-3-4b")
IMPLS = ("ref", "flash_train")
B, S, STEPS = 2, 32, 3
REL = 1e-4


def _pipe_cfg(vocab, batch=B, seq=S):
    return dict(vocab_size=vocab, batch_size=batch, seq_len=seq, seed=0)


def _opt():
    # eps 1e-3 instead of 1e-8: an Adam step divides each gradient element
    # by its own magnitude, and some key-bias elements have a gradient at
    # the f32 rounding level (on RoPE's slow dims a key bias shifts a whole
    # score row, which softmax ignores), so with eps 1e-8 rounding would
    # set the direction of their step. With eps 1e-3 they move by g / eps,
    # linear in g; every other setting is the default, weight decay on.
    return dict(warmup_steps=2, total_steps=STEPS, eps=1e-3)


def _leaf_close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    bound = REL * max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= bound, f"{what}: max err {err:.3e} > {bound:.3e}"


def _logits_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= 1e-6 * np.abs(want).max(), f"logits: max err {err:.3e}"


def _tree_close(got, want, what):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_leaves(got)
    assert len(flat_g) == len(flat_w), what
    for (path, w), g in zip(flat_w, flat_g):
        _leaf_close(g, w, f"{what} {jax.tree_util.keystr(path)}")


def _run_pair(arch, impl, **over):
    """The same three steps through both packages. Returns a dict of numpy
    results, JAX side 'j_*' and port side 't_*'."""
    kw = dict(compute_dtype="float32", attn_impl=impl, **over)
    jcfg, tcfg = jreduced(arch, **kw), reduced_config(arch, **kw)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    pcfg = jtokens.TokenPipelineConfig(**_pipe_cfg(jcfg.vocab_size))
    batches = [jtokens.batch_for_step(pcfg, s) for s in range(STEPS)]
    out = {}

    jb = {"tokens": jnp.asarray(batches[0])}

    def jloss(p):
        loss, metrics = jts.loss_fn(p, jb, jcfg)
        return loss, (metrics["loss"], jmodel.forward(p, jb, jcfg)[0])

    (_, (jl, jlogits)), jg = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jparams)
    out["j_loss"], out["j_grads"] = float(jl), jg
    out["j_logits"] = np.asarray(jlogits)
    jtc = jts.TrainConfig(optimizer=jopt.OptimizerConfig(**_opt()))
    jstep = jax.jit(jts.make_train_step(jcfg, jtc))
    jstate = jopt.init(jparams)
    p = jparams
    for b in batches:
        p, jstate, _ = jstep(p, jstate, {"tokens": jnp.asarray(b)})
    out["j_params"], out["j_mu"], out["j_nu"] = p, jstate.mu, jstate.nu

    params = convert.params_from_jax(np_params, tcfg, "cpu")
    tb = {"tokens": torch.from_numpy(batches[0]).long()}
    with torch.no_grad():
        out["t_logits"] = tmodel.forward(params, tb, tcfg)[0].numpy()
    leaves = [t.requires_grad_(True) for _, t in tmodel.named_leaves(params)]
    loss, tm = tts.loss_fn(params, tb, tcfg)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    out["t_loss"] = float(tm["loss"])
    out["t_grads"] = convert.params_to_numpy(
        tmodel.map_leaves(lambda _: next(it), params), tcfg)
    ttc = tts.TrainConfig(optimizer=topt.OptimizerConfig(**_opt()))
    step = tts.make_train_step(tcfg, ttc)
    state = topt.init(params)
    for b in batches:
        params, state, _ = step(params, state,
                                {"tokens": torch.from_numpy(b).long()})
    out["t_params"] = convert.params_to_numpy(params, tcfg)
    st = convert.opt_state_to_numpy(state, tcfg)
    assert st["step"] == STEPS == int(jstate.step)
    out["t_mu"], out["t_nu"] = st["mu"], st["nu"]
    return out


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(arch, impl):
        if (arch, impl) not in cache:
            cache[(arch, impl)] = _run_pair(arch, impl)
        return cache[(arch, impl)]
    return get


PAIRS = [(a, i) for a in ARCHS for i in IMPLS]


@pytest.mark.parametrize("arch,impl", PAIRS)
def test_logits_match_jax(runs, arch, impl):
    r = runs(arch, impl)
    _logits_close(r["t_logits"], r["j_logits"])


@pytest.mark.parametrize("arch,impl", PAIRS)
def test_loss_and_every_gradient_match_jax(runs, arch, impl):
    r = runs(arch, impl)
    assert r["t_loss"] == pytest.approx(r["j_loss"], rel=1e-5)
    _tree_close(r["t_grads"], r["j_grads"], "grad")


@pytest.mark.parametrize("arch,impl", PAIRS)
def test_three_adamw_steps_match_jax(runs, arch, impl):
    """Weight decay shows from step 2 on (norm scales and biases start at
    0), so three steps check the decay set as well as the update."""
    r = runs(arch, impl)
    _tree_close(r["t_params"], r["j_params"], "params")
    _tree_close(r["t_mu"], r["j_mu"], "mu")
    _tree_close(r["t_nu"], r["j_nu"], "nu")


def test_weight_decay_set_matches_jax_rule():
    """The JAX rule (ndim >= 2 on the stacked tree) and the port's
    `decays` on the per-layer tree pick the same leaves."""
    for arch in ARCHS:
        cfg = reduced_config(arch)
        params = tmodel.init_params(cfg, seed=0, device="cpu")
        stacked = convert.params_to_numpy(params, cfg)
        want = [np.ndim(x) >= 2 for x in jax.tree.leaves(stacked)]
        got = {}
        for path, p in tmodel.named_leaves(params):
            key = tuple(k for k in path if not isinstance(k, int))
            if path[0] == "blocks":
                key = ("blocks", path[1] % len(cfg.period)) + key[1:]
            got[key] = topt.decays(path, p)
        flat = jax.tree_util.tree_flatten_with_path(stacked)[0]
        for (jpath, _), w in zip(flat, want):
            key = tuple(getattr(e, "key", getattr(e, "idx", None))
                        for e in jpath)
            assert got[key] == w, key


def test_microbatches_match_jax():
    """num_microbatches=2: the summed, halved f32 gradients and the step
    after them equal the JAX scan's."""
    arch = "qwen1.5-0.5b"
    kw = dict(compute_dtype="float32", attn_impl="flash_train")
    jcfg, tcfg = jreduced(arch, **kw), reduced_config(arch, **kw)
    jparams = jmodel.init_params(jax.random.PRNGKey(1), jcfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                     "cpu")
    b = jtokens.batch_for_step(jtokens.TokenPipelineConfig(
        **_pipe_cfg(jcfg.vocab_size, batch=4)), 0)
    jtc = jts.TrainConfig(num_microbatches=2,
                          optimizer=jopt.OptimizerConfig(**_opt()))
    jp, js, jm = jax.jit(jts.make_train_step(jcfg, jtc))(
        jparams, jopt.init(jparams), {"tokens": jnp.asarray(b)})
    ttc = tts.TrainConfig(num_microbatches=2,
                          optimizer=topt.OptimizerConfig(**_opt()))
    tp, ts_, tm = tts.make_train_step(tcfg, ttc)(
        params, topt.init(params), {"tokens": torch.from_numpy(b).long()})
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-4)
    _tree_close(convert.params_to_numpy(tp, tcfg), jp, "params")
    _tree_close(convert.opt_state_to_numpy(ts_, tcfg)["mu"], js.mu, "mu")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_only_flash_logits_match_jax(arch):
    """attn_impl='flash': the forward kernel's plain version in the model
    against the JAX model running its interpreted kernel."""
    kw = dict(compute_dtype="float32", attn_impl="flash")
    jcfg, tcfg = jreduced(arch, **kw), reduced_config(arch, **kw)
    jparams = jmodel.init_params(jax.random.PRNGKey(2), jcfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                     "cpu")
    tok = np.random.default_rng(3).integers(0, jcfg.vocab_size, (B, S))
    want = jmodel.forward(jparams, {"tokens": jnp.asarray(tok, jnp.int32)},
                          jcfg)[0]
    with torch.no_grad():
        got = tmodel.forward(params, {"tokens": torch.from_numpy(tok)},
                             tcfg)[0]
    _logits_close(got.numpy(), want)
    with pytest.raises(RuntimeError, match="forward only"):
        for _, t in tmodel.named_leaves(params):
            t.requires_grad_(True)
        tts.loss_fn(params, {"tokens": torch.from_numpy(tok)}, tcfg)


@pytest.mark.parametrize("impl", IMPLS)
def test_bf16_loss_near_jax(impl):
    """Compute bf16, as on the card: the two packages round at other places
    (the port sums the embedding gradient in f32, and its P stays f32 under
    'flash_train' where mha_ref rounds it), so the loss is held to 1e-2
    relative, and to the f32 loss within 2e-2 relative."""
    arch = "qwen1.5-0.5b"
    rng = np.random.default_rng(4)
    tok = rng.integers(0, 512, (B, S))
    losses = {}
    for dt in ("bfloat16", "float32"):
        jcfg = jreduced(arch, compute_dtype=dt, attn_impl=impl)
        tcfg = reduced_config(arch, compute_dtype=dt, attn_impl=impl)
        jparams = jmodel.init_params(jax.random.PRNGKey(3), jcfg)
        params = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                         tcfg, "cpu")
        jl = jts.loss_fn(jparams, {"tokens": jnp.asarray(tok, jnp.int32)},
                         jcfg)[1]["loss"]
        with torch.no_grad():
            tl = tts.loss_fn(params, {"tokens": torch.from_numpy(tok)},
                             tcfg)[1]["loss"]
        losses[dt] = (float(tl), float(jl))
    tl, jl = losses["bfloat16"]
    assert tl == pytest.approx(jl, rel=1e-2)
    assert tl == pytest.approx(losses["float32"][0], rel=2e-2)


@pytest.mark.parametrize("vocab,batch,seq", [(512, 2, 32),
                                             (151_936, 4, 64)])
def test_token_batches_bit_equal(vocab, batch, seq):
    """`batch_for_step` and the prefetching pipeline give the JAX
    package's batches bit for bit."""
    kw = _pipe_cfg(vocab, batch, seq)
    jcfg = jtokens.TokenPipelineConfig(**kw)
    tcfg = tokens.TokenPipelineConfig(**kw)
    pipe = tokens.TokenPipeline(tcfg)
    try:
        for s in range(3):
            want = jtokens.batch_for_step(jcfg, s)
            np.testing.assert_array_equal(tokens.batch_for_step(tcfg, s),
                                          want)
            step, got = pipe.next_batch()
            assert step == s
            np.testing.assert_array_equal(got, want)
    finally:
        pipe.close()


@pytest.mark.parametrize("name", ["rmsnorm", "rope", "mlp", "embed",
                                  "logits"])
def test_layers_match_jax(name):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 8, 32)).astype(np.float32)
    tx = torch.from_numpy(x)
    if name == "rmsnorm":
        p = {"scale": rng.normal(size=(32,)).astype(np.float32)}
        want = jlayers.rmsnorm(p, jnp.asarray(x))
        got = layers.rmsnorm({"scale": torch.from_numpy(p["scale"])}, tx)
    elif name == "rope":
        xr = x.reshape(2, 8, 2, 16)
        pos = np.arange(8) + 3
        want = jlayers.rope(jnp.asarray(xr), jnp.asarray(pos), 1e6)
        got = layers.rope(torch.from_numpy(xr), torch.from_numpy(pos), 1e6)
    elif name == "mlp":
        p = {k: rng.normal(size=s).astype(np.float32) * 0.2
             for k, s in (("wi", (32, 48)), ("wg", (32, 48)),
                          ("wo", (48, 32)))}
        want = jlayers.mlp(p, jnp.asarray(x), jnp.float32)
        got = layers.mlp({k: torch.from_numpy(v) for k, v in p.items()}, tx,
                         torch.float32)
    elif name == "embed":
        tab = rng.normal(size=(50, 32)).astype(np.float32)
        tok = rng.integers(0, 50, (2, 8))
        want = jlayers.embed({"tok": jnp.asarray(tab)}, jnp.asarray(tok),
                             jnp.bfloat16).astype(jnp.float32)
        got = layers.embed({"tok": torch.from_numpy(tab)},
                           torch.from_numpy(tok), torch.bfloat16).float()
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    else:
        tab = rng.normal(size=(50, 32)).astype(np.float32)
        want = jlayers.logits({"tok": jnp.asarray(tab)}, jnp.asarray(x),
                              None, 30.0)
        got = layers.logits({"tok": torch.from_numpy(tab)}, tx, None, 30.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_reduced_configs_match_jax():
    """The port's config copy: every field of every reduced and full
    config equals the JAX package's."""
    from repro.configs import ARCH_IDS, get_config as jget
    from repro_torch.configs import ARCH_IDS as TIDS, get_config
    assert TIDS == ARCH_IDS
    for arch in ARCH_IDS:
        for j, t in ((jget(arch), get_config(arch)),
                     (jreduced(arch), reduced_config(arch))):
            assert dataclasses.asdict(j) == dataclasses.asdict(t), arch
