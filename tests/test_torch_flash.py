"""The flash attention rows of the port against the JAX package, in f32 on
the CPU: the plain versions `ref.flash_fwd` / `ref.flash_bwd` against the
Pallas kernels in interpret mode, the autograd path
`ops.flash_attention_trainable` against `jax.grad` of the JAX one, and
`ref.mha_ref` / `ref.flash_ref` against their JAX twins.

Tolerances: 1e-5 on outputs and logsumexp, 5e-5 on gradients (the JAX
package's own gradient bound, tests/test_flash_bwd.py). Both sides sum in
f32 in different orders; nothing else differs.

In bf16 the plain versions round p (and in the backward ds) to bf16 where
the card's tensor-core kernels do; they are held to an f32 computation
written out here in numpy that rounds at the same places.
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
    """In bf16 both the plain forward and mha_ref round their inputs, P
    (flash_fwd the unnormalised p, mha_ref the probabilities) and their
    output to bf16: both stay within 2e-2 of the f32 result."""
    q, k, v, _ = _inputs("gqa", seed=4)
    o32 = ref.flash_fwd(_t(q), _t(k), _t(v))
    b = [_t(a).to(torch.bfloat16) for a in (q, k, v)]
    for o in (ref.flash_fwd(*b), ref.mha_ref(*b)):
        assert o.dtype == torch.bfloat16
        assert float((o.float() - o32).abs().max()) < 2e-2


def _round_bf16(x):
    """Round f32 values to the nearest bf16 (ties to even), kept as f32."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    b = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return b.view(np.float32)


def _keep(name):
    _, _, sq, skv, causal, window, _, q_offset = CASES[name]
    rows = q_offset + np.arange(sq)[:, None]
    cols = np.arange(skv)[None, :]
    keep = np.ones((sq, skv), bool)
    if causal:
        keep &= rows >= cols
    if window is not None:
        keep &= rows - cols < window
    return keep


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("name", ["mha", "window", "softcap", "masked_rows"])
def test_bf16_plain_versions_round_where_the_kernels_round(name, direction):
    """ref.flash_fwd and ref.flash_bwd on bf16 inputs against attention in
    f32 written out here, which rounds p to bf16 before P V (forward) and
    before dV (backward), and ds before dQ and dK; the row sum and ds come
    from the f32 p. Bound: half a bf16 step of each value (the output's
    own rounding, 2**-8 of it) plus 1e-5 of the largest, for f32 sums
    taken in another order. Without the rounding of p and ds the plain
    versions miss it by 3e-4 to 2e-3 of the largest value."""
    hq, hkv, _, _, _, _, softcap, _ = CASES[name]
    band = _band(name)
    scale = np.float32(D ** -0.5)
    q, k, v, do = (_round_bf16(a) for a in _inputs(name, seed=5))
    kq, vq = np.repeat(k, hq // hkv, 1), np.repeat(v, hq // hkv, 1)
    keep = _keep(name)
    x = np.einsum("bhqd,bhkd->bhqk", q, kq) * scale
    if softcap is not None:
        x = np.float32(softcap) * np.tanh(x / np.float32(softcap))
    s = np.where(keep, x, np.float32(-1e30))
    m = s.max(-1, keepdims=True)
    p = np.where(keep, np.exp(s - m), np.float32(0))
    l = p.sum(-1, keepdims=True)
    l = np.where(l == 0, np.float32(1), l)
    want_o = np.einsum("bhqk,bhkd->bhqd", _round_bf16(p), vq) / l

    def bf(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)

    o, lse = ref.flash_fwd(bf(q), bf(k), bf(v), scale=float(scale),
                           with_lse=True, **band)
    if direction == "fwd":
        pairs = [(o, want_o, "o")]
        _close(lse, (m + np.log(l))[..., 0], FWD_TOL, "lse")
    else:
        p = np.where(keep, np.exp(s - lse.numpy()[..., None]), np.float32(0))
        dsum = (do * o.float().numpy()).sum(-1, keepdims=True)
        ds = p * (np.einsum("bhqd,bhkd->bhqk", do, vq) - dsum)
        if softcap is not None:
            ds = ds * np.where(keep, 1 - (x / np.float32(softcap)) ** 2, 0)
        ds = _round_bf16(ds)
        want = (np.einsum("bhqk,bhkd->bhqd", ds, kq) * scale,
                np.einsum("bhqk,bhqd->bhkd", ds, q) * scale,
                np.einsum("bhqk,bhqd->bhkd", _round_bf16(p), do))
        got = ref.flash_bwd(bf(q), bf(kq), bf(vq), o, lse, bf(do),
                            scale=float(scale), **band)
        pairs = list(zip(got, want, ("dq", "dk", "dv")))
    for g, w, what in pairs:
        assert g.dtype == torch.bfloat16
        err = np.abs(g.float().numpy() - w)
        bound = 2.0 ** -8 * np.abs(w) + 1e-5 * np.abs(w).max()
        assert (err <= bound).all(), (what, float((err - bound).max()))


def _bf16_case(name, d, seed):
    hq, hkv, sq, skv, *_ = CASES[name]
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.normal(size=(1, hq, sq, d)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(1, hkv, skv, d)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    return q, k, v, do


@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("name", ["gqa", "softcap", "q_offset",
                                  "masked_rows"])
def test_bf16_term_bound_holds_across_sum_orders(name, d):
    """The card's bf16 bound on rows 11-13 -- one bf16 step of the value
    and of each rounded term (ref.flash_rounded_terms), plus 1e-4 of the
    largest -- holds between the plain versions and themselves with the
    head dimension permuted, the same products summed in another f32
    order (scripts/flash_bf16_sum_order.py prints the ratios)."""
    band = _band(name)
    band["scale"] = d ** -0.5
    hq, hkv = CASES[name][:2]
    q, k, v, do = _bf16_case(name, d, seed=6)
    perm = torch.from_numpy(np.random.default_rng(7).permutation(d))
    inv = torch.argsort(perm)
    o, lse = ref.flash_fwd(q, k, v, with_lse=True, **band)
    kq, vq = k.repeat_interleave(hq // hkv, 1), v.repeat_interleave(
        hq // hkv, 1)
    terms = ref.flash_rounded_terms(q, kq, vq, o, lse, do, **band)
    pairs = [(ref.flash_fwd(q[..., perm], k[..., perm], v, **band), o,
              terms[0])]
    for g2, g, t in zip(
            ref.flash_bwd(q[..., perm], kq[..., perm], vq[..., perm],
                          o[..., perm], lse, do[..., perm], **band),
            ref.flash_bwd(q, kq, vq, o, lse, do, **band), terms[1:]):
        pairs.append((g2[..., inv], g, t))
    for got, want, t in pairs:
        w = want.float()
        bound = 2.0 ** -7 * (w.abs() + t) + 1e-4 * float(w.abs().max())
        assert bool(((got.float() - w).abs() <= bound).all())


@pytest.mark.parametrize("name", ["softcap", "masked_rows"])
def test_flash_rounded_terms_match_numpy(name):
    """ref.flash_rounded_terms against the sums of |term| written out in
    numpy: |P| |V| / l, scale |dS| |K|, scale |dS^T| |Q|, |P^T| |dO|."""
    hq, hkv, _, _, _, _, softcap, _ = CASES[name]
    band = _band(name)
    scale = D ** -0.5
    q, k, v, do = _inputs(name, seed=8)
    kq, vq = np.repeat(k, hq // hkv, 1), np.repeat(v, hq // hkv, 1)
    o, lse = ref.flash_fwd(_t(q), _t(kq), _t(vq), scale=scale,
                           with_lse=True, **band)
    got = ref.flash_rounded_terms(_t(q), _t(kq), _t(vq), o, lse, _t(do),
                                  scale=scale, **band)
    keep = _keep(name)
    x = np.einsum("bhqd,bhkd->bhqk", q, kq) * np.float32(scale)
    if softcap is not None:
        x = np.float32(softcap) * np.tanh(x / np.float32(softcap))
    p = np.exp(np.where(keep, x - lse.numpy()[..., None], -np.inf))
    dsum = (do * o.numpy()).sum(-1, keepdims=True)
    ds = p * (np.einsum("bhqd,bhkd->bhqk", do, vq) - dsum)
    if softcap is not None:
        ds = ds * (1 - (x / np.float32(softcap)) ** 2)
    ds = np.abs(ds)
    want = (np.einsum("bhqk,bhkd->bhqd", p, np.abs(vq)),
            np.einsum("bhqk,bhkd->bhqd", ds, np.abs(kq)) * scale,
            np.einsum("bhqk,bhqd->bhkd", ds, np.abs(q)) * scale,
            np.einsum("bhqk,bhqd->bhkd", p, np.abs(do)))
    for g, w, what in zip(got, want, ("o", "dq", "dk", "dv")):
        _close(g, w, FWD_TOL * max(1.0, float(np.abs(w).max())), what)
