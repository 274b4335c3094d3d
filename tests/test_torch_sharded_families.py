"""The sharded train step of the MoE, Mamba2, hybrid, VLM and audio
families over (data, model) meshes of gloo ranks, against the JAX package
and the port's one-process step, on the CPU.

- One launcher per world (2 and 4 ranks, `file://` store, 60 s timeout)
  runs `launch.train.train(group=...)` on reduced deepseek-moe-16b,
  mamba2-370m, zamba2-1.2b, llava-next-mistral-7b (8 patches before its
  text) and hubert-xlarge (frames and frame labels), f32, 3 steps of 2
  microbatches, each from the JAX package's step-0 checkpoint. Losses and
  grad norms are within 3e-4 relative of the JAX single-device step (the
  JAX sharded check's bound) and within 1e-5 of the port's one-process
  step. mamba2 at (1, 4) has an `in_proj` whose 296 columns the 4-way
  `model` axis does not cut, so its gradient is summed over `model`.
- deepseek runs at a capacity factor of 8 (no expert drops a token) with
  the load-balance term off: under a mesh that term is the mean over the
  (data, model) shards, which the one-process step does not compute. The
  term itself, at the reduced config's weight and capacity factor, is
  held to JAX's mesh train step (a 4-device subprocess on the same (2, 2)
  mesh): loss, aux and grad norm within 3e-4 at every step.
- A zamba2 (2, 2) run's step-2 checkpoint resumes on one process, its
  step 3 within 1e-5 of the sharded run's.
"""

import concurrent.futures
import dataclasses
import os
import shutil
import subprocess
import sys
import traceback

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.core import dist
from repro_torch.launch import train as train_lib

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
STEPS, BATCH, SEQ, NM = 3, 8, 32, 2
NO_DROP = dict(capacity_factor=8.0, router_aux_weight=0.0)
# name -> (arch, MoEConfig overrides or None)
MODELS = {
    "deepseek": ("deepseek-moe-16b", NO_DROP),
    "deepseek_aux": ("deepseek-moe-16b", {}),
    "mamba2": ("mamba2-370m", None),
    "zamba2": ("zamba2-1.2b", None),
    "llava": ("llava-next-mistral-7b", None),
    "hubert": ("hubert-xlarge", None),
}
# world -> [(model, (data, model))]
RUNS = {
    2: [("mamba2", (1, 2)), ("hubert", (2, 1)), ("deepseek", (1, 2))],
    4: [("deepseek", (2, 2)), ("deepseek_aux", (2, 2)), ("mamba2", (1, 4)),
        ("zamba2", (2, 2)), ("llava", (2, 2)), ("hubert", (2, 2))],
}
RESUMED = "zamba2_2x2"


def overrides(name, reduced):
    """ModelConfig overrides of `name` for either package's
    `reduced_config` (its own MoEConfig class)."""
    arch, moe = MODELS[name]
    out = dict(compute_dtype="float32")
    if moe is not None:
        out["moe"] = dataclasses.replace(reduced(arch).moe, **moe)
    return out


def _train(name, group, ckpt_dir, model_parallel, ckpt_every=100):
    arch, _ = MODELS[name]
    return train_lib.train(arch, reduced=True, steps=STEPS, batch=BATCH,
                           seq=SEQ, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                           model_parallel=model_parallel, microbatches=NM,
                           log_every=100, group=group,
                           device=None if group else "cpu",
                           **overrides(name, reduced_config))


def _copy_step(src, step, dst):
    name = f"step_{step:08d}"
    shutil.copytree(os.path.join(src, name), os.path.join(dst, name))


def rank_main(rank: int, world: int, tmp: str) -> None:
    """One rank: join the gloo group, run its meshes, write rank 0's."""
    torch.set_num_threads(1)
    g = dist.init_group("gloo", "file://" + os.path.join(tmp, "store"),
                        rank, world, "cpu")
    shared = os.path.join(tmp, "..", "shared")
    out = {}
    try:
        for name, (d, m) in RUNS[world]:
            tag = f"{name}_{d}x{m}"
            ck = os.path.join(tmp, tag)
            if rank == 0:
                _copy_step(os.path.join(shared, "jax_" + name), 0, ck)
            dist.barrier(g)
            res = _train(name, g, ck, m,
                         ckpt_every=2 if tag == RESUMED else 100)
            for key in ("losses", "grad_norms", "aux_losses",
                        "collective_calls"):
                out[f"{tag}_{key}"] = np.array(res[key])
        dist.barrier(g)
    except Exception:
        traceback.print_exc()
        raise
    finally:
        if rank == 0:
            np.savez(os.path.join(tmp, "rank0.npz"), **out)
        g.destroy()


def _launch(world: int, tmp: str) -> None:
    torch.multiprocessing.spawn(rank_main, args=(world, tmp), nprocs=world,
                                join=True)


# --- the pytest side ------------------------------------------------------

def _jax_batch(name, jcfg, step):
    import jax.numpy as jnp
    from repro.data import tokens as jtokens
    tok = jtokens.batch_for_step(jtokens.TokenPipelineConfig(
        vocab_size=jcfg.vocab_size, batch_size=BATCH, seq_len=SEQ, seed=0),
        step)
    return {k: jnp.asarray(v) for k, v in
            train_lib.step_batch(jcfg, tok, step).items()}


def _jax_steps(name, ck_dir):
    """The JAX package's single-device step from checkpoint 0 of `ck_dir`
    to STEPS: (losses, grad norms)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import reduced_config as jreduced
    from repro.models import model as jmodel
    from repro.train import checkpoint as jckpt
    from repro.train import optimizer as jopt
    from repro.train import train_step as jts
    jcfg = jreduced(MODELS[name][0], **overrides(name, jreduced))
    tmpl = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    restored, _ = jckpt.restore(ck_dir, 0, {"params": tmpl,
                                            "opt": jopt.init(tmpl)})
    params = jax.tree.map(jnp.asarray, restored["params"])
    state = jax.tree.map(jnp.asarray, restored["opt"])
    tcfg = jts.TrainConfig(num_microbatches=NM, optimizer=jopt.OptimizerConfig(
        peak_lr=3e-4, warmup_steps=max(2, STEPS // 20), total_steps=STEPS))
    step = jax.jit(jts.make_train_step(jcfg, tcfg))
    losses, gnorms = [], []
    for i in range(STEPS):
        params, state, m = step(params, state, _jax_batch(name, jcfg, i))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return np.array(losses), np.array(gnorms)


# JAX's mesh train step of reduced deepseek on a (2, 2) mesh of 4 devices.
_MESH_BODY = """
import dataclasses
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import reduced_config
from repro.data import tokens as jtokens
from repro.models import model as jmodel, sharding as shd
from repro.train import checkpoint as jckpt, optimizer as jopt
from repro.train import train_step as jts
cfg = reduced_config("deepseek-moe-16b", compute_dtype="float32")
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
tmpl = jmodel.init_params(jax.random.PRNGKey(0), cfg)
restored, _ = jckpt.restore(CK, 0, {"params": tmpl, "opt": jopt.init(tmpl)})
sh = shd.param_shardings(tmpl, mesh)
params = jax.device_put(restored["params"], sh)
state = jax.device_put(restored["opt"], jopt.OptState(
    step=NamedSharding(mesh, P()), mu=sh, nu=sh))
tcfg = jts.TrainConfig(num_microbatches=NM, optimizer=jopt.OptimizerConfig(
    peak_lr=3e-4, warmup_steps=max(2, STEPS // 20), total_steps=STEPS))
step = jax.jit(jts.make_train_step(cfg, tcfg, mesh=mesh))
for key in ("loss", "aux_loss", "grad_norm"):
    O[key] = []
for i in range(STEPS):
    tok = jtokens.batch_for_step(jtokens.TokenPipelineConfig(
        vocab_size=cfg.vocab_size, batch_size=BATCH, seq_len=SEQ, seed=0), i)
    batch = {"tokens": jax.device_put(jnp.asarray(tok),
                                      NamedSharding(mesh, P("data", None)))}
    params, state, m = step(params, state, batch)
    for key in O:
        O[key].append(float(m[key]))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank 0's outputs by world, the one-process runs, the JAX runs, the
    JAX mesh run, the launchers' directories)."""
    import jax
    from _torch_parity import run_jax
    from repro.configs import reduced_config as jreduced
    from repro.models import model as jmodel
    from repro.train import checkpoint as jckpt
    from repro.train import optimizer as jopt
    base = tmp_path_factory.mktemp("families")
    shared = str(base / "shared")
    os.makedirs(shared)
    for name, (arch, _) in MODELS.items():
        jp = jmodel.init_params(jax.random.PRNGKey(0),
                                jreduced(arch, **overrides(name, jreduced)))
        jckpt.save(os.path.join(shared, "jax_" + name), 0,
                   {"params": jp, "opt": jopt.init(jp)},
                   extra={"cursor": 0})
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs, dirs = {}, {}
    for world in RUNS:
        d = str(base / f"world{world}")
        os.makedirs(d)
        dirs[world] = d
        procs[world] = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(world), d],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    os.makedirs(base / "jax_mesh")
    body = (f"CK = {os.path.join(shared, 'jax_deepseek_aux')!r}\n"
            f"STEPS, BATCH, SEQ, NM = {STEPS}, {BATCH}, {SEQ}, {NM}\n"
            + _MESH_BODY)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    try:
        mesh_run = pool.submit(run_jax, base / "jax_mesh", body, devices=4)
        one, jax_runs = {}, {}
        for name in MODELS:
            if name == "deepseek_aux":
                continue
            ck = str(base / f"one_{name}")
            _copy_step(os.path.join(shared, "jax_" + name), 0, ck)
            one[name] = _train(name, None, ck, 1)
            jax_runs[name] = _jax_steps(name, os.path.join(shared,
                                                           "jax_" + name))
        jax_mesh = mesh_run.result()
    finally:
        pool.shutdown()
        logs = {w: p.communicate(timeout=600)[0] for w, p in procs.items()}
    for world, p in procs.items():
        assert p.returncode == 0, logs[world][-6000:]
    ranks = {w: dict(np.load(os.path.join(dirs[w], "rank0.npz")))
             for w in RUNS}
    return ranks, one, jax_runs, jax_mesh, dirs


def _rel(a, b):
    return np.abs(np.asarray(a) - b) / np.maximum(1.0, np.abs(b))


def _parity_runs():
    return [(w, name, dm) for w, rs in sorted(RUNS.items())
            for name, dm in rs if name != "deepseek_aux"]


@pytest.mark.parametrize("world,name,dm", _parity_runs())
def test_sharded_family_step_matches_jax_and_one_process(runs, world, name,
                                                         dm):
    ranks, one, jax_runs, _, _ = runs
    out = ranks[world]
    tag = f"{name}_{dm[0]}x{dm[1]}"
    loss, gnorm = out[tag + "_losses"], out[tag + "_grad_norms"]
    assert len(loss) == STEPS
    j_loss, j_gnorm = jax_runs[name]
    assert (_rel(loss, j_loss) < 3e-4).all(), (loss, j_loss)
    assert (_rel(gnorm, j_gnorm) < 3e-4).all(), (gnorm, j_gnorm)
    np.testing.assert_allclose(loss, one[name]["losses"], rtol=1e-5)
    np.testing.assert_allclose(gnorm, one[name]["grad_norms"], rtol=1e-5)
    # every step makes collectives, the same number each step
    coll = out[tag + "_collective_calls"]
    assert coll[0] > 0 and (coll == coll[0]).all()


def test_moe_aux_is_the_mean_over_shards_as_jax_mesh(runs):
    """deepseek at the reduced config's aux weight (0.01) and capacity
    factor (1.25, so experts drop pairs) on (2, 2): loss, aux and grad
    norm against JAX's mesh train step at every step."""
    out, jm = runs[0][4], runs[3]
    tag = "deepseek_aux_2x2"
    for key, jkey in (("losses", "loss"), ("aux_losses", "aux_loss"),
                      ("grad_norms", "grad_norm")):
        got = out[f"{tag}_{key}"]
        assert (_rel(got, jm[jkey]) < 3e-4).all(), (key, got, jm[jkey])
    assert (jm["aux_loss"] > 0).all()


def test_sharded_checkpoint_resumes_on_one_process(runs, tmp_path):
    out, dirs = runs[0][4], runs[4]
    _copy_step(os.path.join(dirs[4], RESUMED), 2, str(tmp_path))
    res = _train("zamba2", None, str(tmp_path), 1)
    assert res["start_step"] == 2
    np.testing.assert_allclose(res["losses"], out[RESUMED + "_losses"][2:],
                               rtol=1e-5)
    np.testing.assert_allclose(res["grad_norms"],
                               out[RESUMED + "_grad_norms"][2:], rtol=1e-5)


if __name__ == "__main__":
    _launch(int(sys.argv[1]), sys.argv[2])
