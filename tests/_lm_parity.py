"""Shared by the LM families' parity files (test_torch_families.py and
test_torch_families_grads.py): the closeness checks, a batch for every
frontend, and the JAX package's parameters carried across.

Tolerances are test_torch_lm.py's (f32 on both sides, sums in other
orders): every gradient, parameter and moment leaf within 1e-4 of its
largest magnitude (REL)."""

import jax
import numpy as np
import torch

from repro.configs import reduced_config as jreduced
from repro.models import model as jmodel
from repro_torch.configs import reduced_config
from repro_torch.models import convert

B, S, STEPS = 2, 32, 3
REL = 1e-4


def close(got, want, tol, what):
    """max |got - want| <= tol * max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    bound = tol * max(np.abs(want).max(), 1e-30)
    assert err <= bound, f"{what}: max err {err:.3e} > {bound:.3e}"


def tree_close(got, want, what):
    """Leaf by leaf, in the JAX tree's order, each within REL."""
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_leaves(got)
    assert len(flat_g) == len(flat_w), what
    for (path, w), g in zip(flat_w, flat_g):
        close(g, w, REL, f"{what} {jax.tree_util.keystr(path)}")


def to_torch(a):
    return torch.from_numpy(np.array(a))


def batch_for(cfg, seed):
    """A numpy batch of S positions for cfg's inputs: tokens; llava's
    patches before its text; hubert's frames, frame labels and a mask."""
    rng = np.random.default_rng(seed)
    f = cfg.frontend
    if f.kind == "audio":
        return {"frames": rng.normal(size=(B, S, f.frontend_dim))
                .astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (B, S))
                .astype(np.int32),
                "mask": (rng.random((B, S)) < 0.7).astype(np.float32)}
    n_patch = f.num_patches if f.kind == "vision" else 0
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S - n_patch))
           .astype(np.int32)}
    if n_patch:
        out["patches"] = rng.normal(size=(B, n_patch, f.frontend_dim)
                                    ).astype(np.float32)
    return out


def torch_batch(batch):
    return {k: (to_torch(v).long() if v.dtype == np.int32 else to_torch(v))
            for k, v in batch.items()}


def opt_kwargs():
    # As test_torch_lm.py: eps 1e-3, so elements whose gradient is at the
    # f32 rounding level do not set their step's direction.
    return dict(warmup_steps=2, total_steps=STEPS, eps=1e-3)


def setup(arch, seed=0):
    """(JAX cfg, port cfg, JAX params, the same params in the port), the
    reduced arch at compute float32."""
    kw = dict(compute_dtype="float32")
    jcfg, tcfg = jreduced(arch, **kw), reduced_config(arch, **kw)
    jparams = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                     "cpu")
    return jcfg, tcfg, jparams, params
