"""The flash attention rows of the port against the JAX package, in f32 on
the CPU: the plain versions `ref.flash_fwd` / `ref.flash_bwd` against the
Pallas kernels in interpret mode, the autograd path
`ops.flash_attention_trainable` against `jax.grad` of the JAX one, and
`ref.mha_ref` / `ref.flash_ref` against their JAX twins.

Tolerances: 1e-5 on outputs and logsumexp, 5e-5 on gradients (the JAX
package's own gradient bound, tests/test_flash_bwd.py). Both sides sum in
f32 in different orders; nothing else differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import flash_attention_bwd as jfab
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

FWD_TOL, GRAD_TOL = 1e-5, 5e-5
D = 16

# name: (hq, hkv, sq, skv, causal, window, softcap, q_offset). The first
# five are tests/test_flash_bwd.py's cases.
CASES = {
    "mha": (2, 2, 64, 64, True, None, None, 0),
    "gqa": (4, 2, 96, 96, True, None, None, 0),
    "window": (2, 1, 64, 64, True, 24, None, 0),
    "softcap": (2, 2, 64, 64, True, None, 15.0, 0),
    "encoder": (2, 2, 64, 64, False, None, None, 0),
    "nonmultiple": (2, 2, 50, 50, True, None, None, 0),
    "q_offset": (4, 2, 40, 72, True, 48, None, 32),
    # rows 30..45 against keys 0..31 under a window of 8: rows 39 on see no
    # key at all (o = 0, lse = -1e30)
    "masked_rows": (2, 2, 16, 32, False, 8, 5.0, 30),
}
TRAIN_CASES = ("mha", "gqa", "window", "softcap", "encoder", "nonmultiple")


def _inputs(name, seed=0):
    hq, hkv, sq, skv, *_ = CASES[name]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(1, hq, sq, D)).astype(np.float32)
    k = rng.normal(size=(1, hkv, skv, D)).astype(np.float32)
    v = rng.normal(size=(1, hkv, skv, D)).astype(np.float32)
    do = rng.normal(size=(1, hq, sq, D)).astype(np.float32)
    return q, k, v, do


def _band(name):
    _, _, _, _, causal, window, softcap, q_offset = CASES[name]
    return dict(causal=causal, window=window, softcap=softcap,
                q_offset=q_offset)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol, err_msg=what)


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_fwd_matches_pallas_kernels(name):
    """Rows 11 and 12: o (GQA by index, q_offset) and o + lse (full
    heads, as the JAX wrapper expands them) against the interpreted
    kernels with 32-row blocks, so that tiles, padding and masks all
    show."""
    q, k, v, _ = _inputs(name)
    band = _band(name)
    scale = D ** -0.5
    group = q.shape[1] // k.shape[1]
    kq, vq = np.repeat(k, group, 1), np.repeat(v, group, 1)
    jo = jfa.flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), block_q=32, block_k=32,
                                    interpret=True, **band)
    got = ops.flash_attention(_t(q), _t(k), _t(v), **band)
    _close(got, jo, FWD_TOL, "o (row 11)")
    jo2, jlse = jfa.flash_attention_fwd_lse(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), scale=scale,
        block_q=32, block_k=32, interpret=True, **band)
    o, lse = ops.flash_attention_fwd_lse(_t(q), _t(kq), _t(vq), scale=scale,
                                         **band)
    _close(o, jo2, FWD_TOL, "o (row 12)")
    _close(lse, jlse, FWD_TOL, "lse")
    # the unexpanded kv reads the same heads by index
    _close(ref.flash_fwd(_t(q), _t(k), _t(v), scale=scale, with_lse=True,
                         **band)[1], jlse, FWD_TOL, "lse, GQA by index")
    if name == "masked_rows":
        assert float(jlse.min()) == pytest.approx(-1e30)
        assert float(torch.abs(o[:, :, 9:]).max()) == 0.0


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_bwd_matches_pallas_kernels(name):
    """Row 13 on the JAX forward's own o and lse: dq, dk and dv."""
    q, k, v, do = _inputs(name, seed=1)
    band = _band(name)
    group = q.shape[1] // k.shape[1]
    kq, vq = np.repeat(k, group, 1), np.repeat(v, group, 1)
    scale = D ** -0.5
    jo, jlse = jfa.flash_attention_fwd_lse(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), scale=scale,
        block_q=32, block_k=32, interpret=True, **band)
    want = jfab.flash_attention_bwd_pallas(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jo, jlse,
        jnp.asarray(do), scale=scale, block_q=32, block_k=32,
        interpret=True, **band)
    got = ops.flash_attention_bwd(_t(q), _t(kq), _t(vq), _t(jo), _t(jlse),
                                  _t(do), scale=scale, **band)
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        _close(g, w, GRAD_TOL, what)


@pytest.mark.parametrize("name", TRAIN_CASES)
def test_flash_trainable_matches_jax_grad(name):
    """The autograd path (kernel 12 forward, kernel 13 backward, GQA group
    sums) against jax.grad of `repro.kernels.ops.flash_attention_trainable`
    and against the plain reference attention."""
    q, k, v, t = _inputs(name, seed=2)
    band = {k_: v_ for k_, v_ in _band(name).items() if k_ != "q_offset"}

    def jloss(q, k, v):
        o = jops.flash_attention_trainable(q, k, v, block_q=32, block_k=32,
                                           **band)
        return jnp.sum(o * jnp.asarray(t))

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    loss = (ops.flash_attention_trainable(tq, tk, tv, **band) * _t(t)).sum()
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), abs=1e-4)
    for g, w, what in zip((tq.grad, tk.grad, tv.grad), jg,
                          ("dq", "dk", "dv")):
        _close(g, w, GRAD_TOL, what)
    rq, rk, rv = (_t(a).requires_grad_(True) for a in (q, k, v))
    (ref.mha_ref(rq, rk, rv, **band) * _t(t)).sum().backward()
    for g, w, what in zip((tq.grad, tk.grad, tv.grad),
                          (rq.grad, rk.grad, rv.grad), ("dq", "dk", "dv")):
        _close(g, w, GRAD_TOL, f"{what} against mha_ref")


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_attention_matches_jax(name):
    """`mha_ref` and the blockwise `flash_ref` (with 32-wide blocks, so the
    band skip runs) against their JAX twins, forward and gradients."""
    q, k, v, t = _inputs(name, seed=3)
    band = _band(name)
    for what, jfn, tfn in (
            ("mha_ref", jref.mha_ref, ref.mha_ref),
            ("flash_ref",
             lambda *a, **kw: jref.flash_ref(*a, block_q=32, block_k=32,
                                             **kw),
             lambda *a, **kw: ref.flash_ref(*a, block_q=32, block_k=32,
                                            **kw))):
        def jloss(q, k, v):
            o = jfn(q, k, v, **band)
            return jnp.sum(o * jnp.asarray(t)), o

        (_, jo), jg = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1, 2), has_aux=True))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
        o = tfn(tq, tk, tv, **band)
        (o * _t(t)).sum().backward()
        _close(o.detach(), jo, FWD_TOL, what)
        for g, w, gname in zip((tq.grad, tk.grad, tv.grad), jg,
                               ("dq", "dk", "dv")):
            _close(g, w, GRAD_TOL, f"{what} {gname}")


def test_flash_forward_only_refuses_a_gradient():
    """Kernel 11 has no backward, as a pallas_call has no VJP."""
    q, k, v, _ = _inputs("mha")
    with pytest.raises(RuntimeError, match="forward only"):
        ops.flash_attention(_t(q).requires_grad_(True), _t(k), _t(v))
    with torch.no_grad():
        ops.flash_attention(_t(q).requires_grad_(True), _t(k), _t(v))


def test_bf16_plain_versions_stay_near_f32():
    """In bf16 the plain forward rounds only its inputs and output (P stays
    f32), while mha_ref also rounds P to bf16: both stay within 2e-2 of the
    f32 result, the bound the card's bf16 checks use."""
    q, k, v, _ = _inputs("gqa", seed=4)
    o32 = ref.flash_fwd(_t(q), _t(k), _t(v))
    b = [_t(a).to(torch.bfloat16) for a in (q, k, v)]
    for o in (ref.flash_fwd(*b), ref.mha_ref(*b)):
        assert o.dtype == torch.bfloat16
        assert float((o.float() - o32).abs().max()) < 2e-2
