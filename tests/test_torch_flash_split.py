"""The f32 flash kernels' split on the CPU: every f32 operand split into
three bf16 parts (`ref.split_bf16x3`) and every product taken as six bf16
products summed in f32 (`ref.matmul_bf16x3`), as the tensor-core kernels
in csrc/flash_attention.cu and csrc/flash_attention_bwd.cu split them.
These tests hold the split's accuracy, not the kernels' order of
rounding: the kernels sum each reduction chunk of at most 64 in one wgmma
accumulation and add the chunk sums in f32, where `ref.matmul_bf16x3`
takes each product over the whole reduction. chip_smoke.py's phase 3
holds the kernels themselves to the plain versions on the card.

The split must give x back: exactly where no part falls below bf16's
normal range (|x| >= 2**-110), and within half of bf16's smallest
subnormal step (2**-134) below that, down to f32's smallest normal. With
every product of `ref.flash_fwd` / `ref.flash_bwd` routed through the
six-term product, the plain versions must stay within the card's f32
bounds of themselves (chip_smoke.FLASH_F32_TOL: 1e-5 on o and lse, 5e-5 on
dq, dk, dv) on phase 3's band cases at head dims 16, 64 and 256, and the
forward within 1e-5 of the JAX package's reference attention. One bf16
product alone (no split) misses those bounds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref

FWD_TOL, GRAD_TOL = 1e-5, 5e-5
BF16_MAX = float(torch.finfo(torch.bfloat16).max)
F32_TINY = float(torch.finfo(torch.float32).tiny)    # 2**-126

# Phase 3's band cases at small sizes: name -> (hq, hkv, sq, skv, causal,
# window, softcap, q_offset).
CASES = {
    "gqa": (4, 2, 70, 70, True, None, None, 0),
    "window_softcap": (2, 2, 66, 66, True, 24, 20.0, 0),
    "not_causal": (2, 1, 40, 75, False, None, None, 0),
    "q_offset": (4, 2, 37, 90, True, 48, None, 50),
    # rows 30..45 against keys 0..31 under a window of 8: rows 39 on see
    # no key (o = 0, lse = -1e30)
    "masked_rows": (2, 2, 16, 32, False, 8, 5.0, 30),
}


def _magnitudes(rng, n, lo_exp, hi_exp):
    """n f32 values of random sign and mantissa with exponents in
    [lo_exp, hi_exp)."""
    m = rng.uniform(1.0, 2.0, n)
    e = rng.integers(lo_exp, hi_exp, n)
    s = rng.choice([-1.0, 1.0], n)
    return (s * np.ldexp(m, e)).astype(np.float32)


def _reconstruct(x: np.ndarray) -> np.ndarray:
    hi, mid, lo = ref.split_bf16x3(torch.from_numpy(x))
    for part in (hi, mid, lo):   # each part is a bf16 value
        assert torch.equal(part, part.to(torch.bfloat16).float())
    return (hi.double() + mid.double() + lo.double()).numpy()


@pytest.mark.parametrize("lo_exp,hi_exp", [(-30, 30), (-110, -60),
                                           (60, 127)])
def test_split_gives_x_back_exactly(lo_exp, hi_exp):
    """Across f32's exponents where every part stays a normal bf16
    value, hi + mid + lo == x exactly (so within 2**-24 |x|)."""
    rng = np.random.default_rng(lo_exp & 0xFF)
    x = _magnitudes(rng, 20000, lo_exp, hi_exp)
    np.testing.assert_array_equal(_reconstruct(x), x.astype(np.float64))


def test_split_near_bf16_largest_normal():
    """Values up to bf16's largest finite value (just under f32's: above
    it bf16(x) is infinite) split and come back exactly."""
    rng = np.random.default_rng(1)
    x = (rng.uniform(0.5, 1.0, 20000) * BF16_MAX).astype(np.float32)
    x = np.concatenate([x, -x, np.float32([BF16_MAX, -BF16_MAX])])
    back = _reconstruct(x)
    assert np.isfinite(back).all()
    np.testing.assert_array_equal(back, x.astype(np.float64))


def test_split_near_f32_smallest_normal():
    """Down at f32's smallest normals mid and lo fall into bf16's
    subnormal range, whose step is 2**-133: the parts then give x back
    within 2**-24 |x| plus half that step, and exactly for bf16 values."""
    rng = np.random.default_rng(2)
    x = _magnitudes(rng, 20000, -126, -110)
    err = np.abs(_reconstruct(x) - x.astype(np.float64))
    bound = 2.0 ** -24 * np.abs(x.astype(np.float64)) + 2.0 ** -134
    assert (err <= bound).all(), float((err / bound).max())
    assert float(np.abs(x).min()) >= F32_TINY
    exact = x.astype(np.float32).view(np.uint32) & np.uint32(0xFFFF) == 0
    x_bf = np.where(exact, x, np.float32(F32_TINY))
    np.testing.assert_array_equal(_reconstruct(x_bf), x_bf.astype(np.float64))


@pytest.mark.parametrize("k", [16, 64, 256, 4096])
def test_six_term_product_holds_f32_accuracy(k):
    """The six-term product against float64: within a few f32 roundings
    of the sum of the terms' magnitudes (2**-24 for each dropped term and
    each f32 addition of k terms), and far closer than one bf16 product."""
    rng = np.random.default_rng(k)
    a = rng.normal(size=(48, k)).astype(np.float32)
    b = rng.normal(size=(k, 40)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    mags = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    err = np.abs(ref.matmul_bf16x3(ta, tb).double().numpy() - exact)
    assert (err <= (6 + k) * 2.0 ** -24 * mags).all()
    one = (ta.to(torch.bfloat16).float() @ tb.to(torch.bfloat16).float())
    err_one = np.abs(one.double().numpy() - exact)
    assert err.max() * 1000 < err_one.max()


def _inputs(name, d, seed):
    hq, hkv, sq, skv, causal, window, softcap, q_offset = CASES[name]
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.normal(size=(1, hq, sq, d))
                              .astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(1, hkv, skv, d))
                             .astype(np.float32)) for _ in range(2))
    band = dict(causal=causal, window=window, softcap=softcap,
                q_offset=q_offset, scale=d ** -0.5)
    return q, k, v, do, band


def _err(got, want):
    return float((got - want).abs().max())


@pytest.mark.parametrize("d", [16, 64, 256])
@pytest.mark.parametrize("name", sorted(CASES))
def test_split_forward_within_f32_bounds(name, d):
    """Rows 11 and 12 under the split: o and lse with both products taken
    six-term, against the f32 plain version and against the JAX
    package's reference attention (o)."""
    q, k, v, _, band = _inputs(name, d, seed=d)
    o, lse = ref.flash_fwd(q, k, v, with_lse=True, **band)
    o3, lse3 = ref.flash_fwd(q, k, v, with_lse=True,
                             matmul=ref.matmul_bf16x3, **band)
    assert _err(o3, o) <= FWD_TOL, _err(o3, o)
    assert _err(lse3, lse) <= FWD_TOL, _err(lse3, lse)
    want = jref.mha_ref(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                        jnp.asarray(v.numpy()), **band)
    assert _err(o3, torch.from_numpy(np.array(want))) <= FWD_TOL


@pytest.mark.parametrize("d", [16, 64, 256])
@pytest.mark.parametrize("name", sorted(CASES))
def test_split_backward_within_f32_bounds(name, d):
    """Row 13 under the split: dq, dk and dv with all five products taken
    six-term, against the f32 plain version at the full head count."""
    q, k, v, do, band = _inputs(name, d, seed=100 + d)
    hq, hkv = q.shape[1], k.shape[1]
    kq = k.repeat_interleave(hq // hkv, 1)
    vq = v.repeat_interleave(hq // hkv, 1)
    o, lse = ref.flash_fwd(q, kq, vq, with_lse=True, **band)
    want = ref.flash_bwd(q, kq, vq, o, lse, do, **band)
    got = ref.flash_bwd(q, kq, vq, o, lse, do, matmul=ref.matmul_bf16x3,
                        **band)
    for g, w, n in zip(got, want, ("dq", "dk", "dv")):
        assert _err(g, w) <= GRAD_TOL, (n, _err(g, w))


def _one_bf16_product(a, b):
    return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()


@pytest.mark.parametrize("d", [64, 256])
def test_one_bf16_product_misses_the_f32_bounds(d):
    """Without the split (one bf16 product: 8-bit operands, fewer bits
    than TF32's) the same forward and backward miss the bounds the split
    meets."""
    q, k, v, do, band = _inputs("gqa", d, seed=7)
    kq, vq = k.repeat_interleave(2, 1), v.repeat_interleave(2, 1)
    o, lse = ref.flash_fwd(q, kq, vq, with_lse=True, **band)
    o1 = ref.flash_fwd(q, kq, vq, matmul=_one_bf16_product, **band)
    assert _err(o1, o) > 10 * FWD_TOL
    want = ref.flash_bwd(q, kq, vq, o, lse, do, **band)
    got = ref.flash_bwd(q, kq, vq, o, lse, do, matmul=_one_bf16_product,
                        **band)
    assert max(_err(g, w) for g, w in zip(got, want)) > 10 * GRAD_TOL
