"""The port's heavy-hitter gradient compression against the JAX package's,
on the CPU.

Locally (no shard axis) the error-feedback loop of tests/test_train.py
runs through both packages on the same numpy gradients, and every
compressed leaf and residual is bit-equal: both add g + e in f32 and keep
the same top-k entries. With a shard axis, the port's stacked leading
dimension is held to the JAX package's `shard_map` reduction over 8 forced
host devices in one subprocess, at frac 0.1 and 1.0 over 3 rounds of
error feedback: residuals bit-equal per shard, means within 1e-6 (the two
sum 8 f32 values in their own orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import run_jax
from repro.train import compression as jcomp
from repro_torch.train import compression

# The JAX function subtracts a flat buffer from the leaf-shaped
# accumulator, so it takes 1-d leaves only (ROADMAP.md section 3); the
# port's leaves of any rank are held to its own flat leaves.
SHAPES = {"a": (64,), "b": (128,), "c": (105,)}


def _grads(rng):
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("frac", [0.1, 0.01, 0.5, 1.0])
def test_error_feedback_loop_matches_jax(frac):
    rng = np.random.default_rng(0)
    g0 = _grads(rng)
    err = compression.init_error_feedback(
        {k: torch.from_numpy(v) for k, v in g0.items()})
    jerr = jcomp.init_error_feedback({k: jnp.asarray(v)
                                      for k, v in g0.items()})
    sent = {k: np.zeros(s) for k, s in SHAPES.items()}
    total = {k: np.zeros(s) for k, s in SHAPES.items()}
    for _ in range(5):
        gs = _grads(rng)
        out, err = compression.compress_psum(
            {k: torch.from_numpy(v) for k, v in gs.items()}, err, frac=frac)
        jout, jerr = jcomp.compress_psum(
            {k: jnp.asarray(v) for k, v in gs.items()}, jerr, frac=frac)
        for k in SHAPES:
            assert out[k].dtype == torch.float32
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]))
            np.testing.assert_array_equal(err[k].numpy(), np.asarray(jerr[k]))
            sent[k] += out[k].numpy()
            total[k] += gs[k]
    for k in SHAPES:
        np.testing.assert_allclose(sent[k] + err[k].numpy(), total[k],
                                   atol=1e-5)


@pytest.mark.parametrize("frac", [0.1, 0.01, 0.25, 1.0])
def test_compression_ratio_matches_jax(frac):
    g = _grads(np.random.default_rng(1))
    got = compression.compression_ratio(
        {k: torch.from_numpy(v) for k, v in g.items()}, frac)
    assert got == jcomp.compression_ratio(
        {k: jnp.asarray(v) for k, v in g.items()}, frac)
    assert (got < 0.25) == (frac <= 0.1)


def test_leaves_of_any_rank_compress_as_their_flat_form():
    rng = np.random.default_rng(2)
    shaped = {"b": rng.normal(size=(8, 16)).astype(np.float32),
              "c": rng.normal(size=(3, 5, 7)).astype(np.float32)}
    t = {k: torch.from_numpy(v) for k, v in shaped.items()}
    flat = {k: v.reshape(-1) for k, v in t.items()}
    err_t, err_f = (compression.init_error_feedback(x) for x in (t, flat))
    for _ in range(3):
        out_t, err_t = compression.compress_psum(t, err_t, frac=0.1)
        out_f, err_f = compression.compress_psum(flat, err_f, frac=0.1)
        for k in shaped:
            assert out_t[k].shape == err_t[k].shape == shaped[k].shape
            assert torch.equal(out_t[k].reshape(-1), out_f[k])
            assert torch.equal(err_t[k].reshape(-1), err_f[k])
    g = {"b": jnp.asarray(shaped["b"])}
    with pytest.raises((TypeError, ValueError)):
        jcomp.compress_psum(g, jcomp.init_error_feedback(g), frac=0.1)


def test_bf16_leaf_keeps_its_dtype():
    g = {"w": torch.randn(32, generator=torch.Generator().manual_seed(0)
                          ).bfloat16()}
    out, err = compression.compress_psum(
        g, compression.init_error_feedback(g), frac=0.25)
    assert out["w"].dtype == torch.bfloat16 and err["w"].dtype == \
        torch.float32
    assert int((out["w"] != 0).sum()) == 8


def test_sharded_reduction_matches_jax_shard_map(tmp_path):
    rng = np.random.default_rng(0)
    rounds = [rng.normal(size=(8, 64)).astype(np.float32) for _ in range(3)]
    inp = {f"g{r}": g for r, g in enumerate(rounds)}
    out = run_jax(tmp_path, """
from jax.sharding import Mesh, PartitionSpec as P
from repro.core import compat
from repro.train import compression
mesh = Mesh(np.array(jax.devices()), ("pod",))
for frac in (0.1, 1.0):
    def body(e, g):
        out, e = compression.compress_psum({"w": g}, {"w": e}, frac=frac,
                                           axis_name="pod")
        return out["w"], e["w"]
    fn = jax.jit(compat.shard_map(body, mesh=mesh, in_specs=(P("pod"),
                                                           P("pod")),
                                  out_specs=(P("pod"), P("pod"))))
    e = jnp.zeros((8, 64), jnp.float32)
    for r in range(3):
        o, e = fn(e, jnp.asarray(I[f"g{r}"]))
        O[f"out_{frac}_{r}"], O[f"err_{frac}_{r}"] = o, e
""", inp, devices=8)
    for frac in (0.1, 1.0):
        err = compression.init_error_feedback({"w": torch.zeros(8, 64)})
        for r, g in enumerate(rounds):
            got, err = compression.compress_psum(
                {"w": torch.from_numpy(g)}, err, frac=frac, sharded=True)
            assert got["w"].shape == (64,) and err["w"].shape == (8, 64)
            want = out[f"out_{frac}_{r}"]
            for row in want:        # every shard holds the mean
                np.testing.assert_allclose(got["w"].numpy(), row, rtol=0,
                                           atol=1e-6)
            np.testing.assert_array_equal(err["w"].numpy(),
                                          out[f"err_{frac}_{r}"])
        if frac == 1.0:
            np.testing.assert_allclose(got["w"].numpy(),
                                       rounds[-1].mean(0), rtol=0, atol=1e-6)
