"""The port's GPipe schedule against the JAX package's, on the CPU.

The port's `pipeline_forward` holds the stage axis as a leading
dimension on one device; it is held to its own `sequential_oracle`, to the
JAX package's `sequential_oracle` on the same numpy parameters, and, in
one subprocess with 4 forced host devices, to the JAX package's
`shard_map` schedule (S, M, MB and D as in tests/test_pipeline.py).
Across ranks (`group=`), one launcher (this file run as a script) per
world, 2 and 4, spawns that many gloo ranks over a `file://` store, each
holding S / world of S = 4 stages; every rank's output is held to the
stacked schedule and to the JAX package's `sequential_oracle`.
Tolerance: 1e-5 absolute on tanh outputs (f32; the pipeline multiplies
microbatches where the oracle multiplies the whole batch, so sums may
round differently).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import run_jax
from repro.train import pipeline as jpipe
from repro_torch.train import pipeline

TOL = 1e-5


def _inputs(s, m, mb, d, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(s, d, d)) * 0.3).astype(np.float32),
            "b": (rng.normal(size=(s, d)) * 0.1).astype(np.float32),
            "x": rng.normal(size=(m * mb, d)).astype(np.float32)}


def _body(sp, x):
    return torch.tanh(x @ sp["w"] + sp["b"])


def _jbody(sp, x):
    return jnp.tanh(x @ sp["w"] + sp["b"])


def _port(inp, m):
    params = {"w": torch.from_numpy(inp["w"]), "b": torch.from_numpy(inp["b"])}
    x = torch.from_numpy(inp["x"])
    return (pipeline.pipeline_forward(_body, params, x, num_microbatches=m),
            pipeline.sequential_oracle(_body, params, x))


@pytest.mark.parametrize("s,m,mb,d", [(4, 8, 2, 16), (1, 4, 3, 8),
                                      (3, 5, 1, 8), (4, 2, 4, 16),
                                      (2, 1, 6, 8)])
def test_pipeline_matches_oracles(s, m, mb, d):
    inp = _inputs(s, m, mb, d)
    y, oracle = _port(inp, m)
    assert y.shape == oracle.shape == (m * mb, d)
    np.testing.assert_allclose(y.numpy(), oracle.numpy(), rtol=0, atol=TOL)
    want = jpipe.sequential_oracle(
        _jbody, {"w": jnp.asarray(inp["w"]), "b": jnp.asarray(inp["b"])},
        jnp.asarray(inp["x"]))
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_pipeline_calls_every_stage_every_tick():
    """(S + M - 1) * S body calls, as the shard_map schedule makes."""
    inp = _inputs(4, 8, 2, 16)
    calls = []

    def body(sp, x):
        calls.append(x.shape)
        return _body(sp, x)

    params = {"w": torch.from_numpy(inp["w"]), "b": torch.from_numpy(inp["b"])}
    pipeline.pipeline_forward(body, params, torch.from_numpy(inp["x"]),
                              num_microbatches=8)
    assert len(calls) == (4 + 8 - 1) * 4 and set(calls) == {(2, 16)}


def test_pipeline_matches_jax_shard_map(tmp_path):
    s, m, mb, d = 4, 8, 2, 16
    inp = _inputs(s, m, mb, d, seed=1)
    out = run_jax(tmp_path, """
from jax.sharding import Mesh
from repro.train.pipeline import pipeline_forward
params = {"w": jnp.asarray(I["w"]), "b": jnp.asarray(I["b"])}
mesh = Mesh(np.array(jax.devices()), ("stage",))
O["y"] = pipeline_forward(lambda sp, x: jnp.tanh(x @ sp["w"] + sp["b"]),
                          params, jnp.asarray(I["x"]), mesh=mesh,
                          num_microbatches=%d)
""" % m, inp, devices=4)
    y, _ = _port(inp, m)
    np.testing.assert_allclose(y.numpy(), out["y"], rtol=0, atol=TOL)


@pytest.mark.parametrize("s,m", [(4, 4), (1, 8), (4, 28), (8, 1), (3, 5)])
def test_bubble_fraction_matches_jax(s, m):
    assert pipeline.bubble_fraction(s, m) == jpipe.bubble_fraction(s, m)


def test_indivisible_batch_raises_in_both():
    inp = _inputs(1, 3, 1, 4)
    params = {"w": torch.from_numpy(inp["w"]), "b": torch.from_numpy(inp["b"])}
    with pytest.raises(ValueError, match="microbatches"):
        pipeline.pipeline_forward(_body, params, torch.zeros(3, 4),
                                  num_microbatches=2)
    from jax.sharding import Mesh
    mesh = Mesh(np.array(jax.devices()[:1]), ("stage",))
    with pytest.raises(ValueError, match="microbatches"):
        jpipe.pipeline_forward(_jbody, {k: jnp.asarray(v) for k, v in
                                        inp.items() if k != "x"},
                               jnp.zeros((3, 4)), mesh=mesh,
                               num_microbatches=2)


# --- across ranks -----------------------------------------------------------

GROUP_CASE = (4, 8, 2, 16)      # S, M, MB, D
WORLDS = (2, 4)


def rank_main(rank: int, world: int, tmp: str) -> None:
    """One rank: its S / world stages of the pipeline over the group."""
    from repro_torch.core import dist
    torch.set_num_threads(1)
    s, m, mb, d = GROUP_CASE
    inp = _inputs(s, m, mb, d, seed=3)
    g = dist.init_group("gloo", "file://" + os.path.join(tmp, "store"),
                        rank, world, "cpu")
    try:
        local = s // world
        lo = rank * local
        params = {k: torch.from_numpy(inp[k][lo:lo + local])
                  for k in ("w", "b")}
        y = pipeline.pipeline_forward(_body, params,
                                      torch.from_numpy(inp["x"]),
                                      num_microbatches=m, group=g)
        np.save(os.path.join(tmp, f"rank{rank}.npy"), y.numpy())
    finally:
        g.destroy()


@pytest.fixture(scope="module")
def group_runs(tmp_path_factory):
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs, dirs = {}, {}
    for world in WORLDS:
        d = str(tmp_path_factory.mktemp(f"pipe{world}"))
        dirs[world] = d
        procs[world] = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(world), d],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    logs = {w: p.communicate(timeout=300)[0] for w, p in procs.items()}
    for world, p in procs.items():
        assert p.returncode == 0, logs[world][-4000:]
    return {w: [np.load(os.path.join(dirs[w], f"rank{r}.npy"))
                for r in range(w)] for w in WORLDS}


@pytest.mark.parametrize("world", WORLDS)
def test_pipeline_across_ranks_matches_stacked_and_jax(group_runs, world):
    s, m, mb, d = GROUP_CASE
    inp = _inputs(s, m, mb, d, seed=3)
    stacked, _ = _port(inp, m)
    want = jpipe.sequential_oracle(
        _jbody, {"w": jnp.asarray(inp["w"]), "b": jnp.asarray(inp["b"])},
        jnp.asarray(inp["x"]))
    for y in group_runs[world]:
        assert y.shape == (m * mb, d)
        np.testing.assert_allclose(y, stacked.numpy(), rtol=0, atol=TOL)
        np.testing.assert_allclose(y, np.asarray(want), rtol=0, atol=TOL)


if __name__ == "__main__":
    torch.multiprocessing.spawn(rank_main, args=(int(sys.argv[1]),
                                                 sys.argv[2]),
                                nprocs=int(sys.argv[1]), join=True)
