"""The LM trainer's sharded step over a (data, model) mesh of gloo ranks,
against the JAX package and the port's one-process step, on the CPU.

- `sharding.param_shardings`: the block each mesh coordinate holds equals
  the JAX `NamedSharding.devices_indices_map` of the JAX package's
  `param_shardings` at the same coordinate, for every architecture's
  reduced config on (2, 2), (4, 2) and (1, 4) meshes (an 8-device JAX
  subprocess; a JAX block leaf's leading `num_periods` dim is whole).
- The step: one launcher per world (2, 4 and 8 ranks, `file://` store, 60
  s timeout) runs `launch.train.train(group=...)` on reduced qwen
  (`check_sharded_train_step`'s config) at (data, model) = (2, 1), (1, 2),
  (2, 2) and (4, 2), and on reduced gemma2 at (1, 4) and (2, 4) with 2 KV
  heads and a vocabulary of 66, which the 4-way `model` axis does not
  divide. Every run resumes the JAX package's step-0 checkpoint, so all
  start from the JAX init. Over 3 steps of 2 microbatches the losses and
  grad norms are within 3e-4 relative of the JAX single-device step (the
  JAX check's bound) and within 1e-5 of the port's one-process step, and
  the gathered parameters within 1e-4 of its parameters (AdamW's
  normalised update amplifies the reduction order's differences in
  near-zero gradients; 99.9 % agree to 1e-6). The runs are at f32, where
  1e-5 is a bound the reduction order alone can meet.
- Checkpoints: a (2, 2) run's step-2 checkpoint resumes on (2, 2) with
  a bit-equal step 3, on one process within 1e-5, and under the JAX
  package's `checkpoint.restore` and train step within 3e-4.
- `python -m repro_torch.launch.train --world 2` trains. The other
  families on a mesh: tests/test_torch_sharded_families.py.
"""

import os
import shutil
import subprocess
import sys
import traceback

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, reduced_config
from repro_torch.core import dist
from repro_torch.launch import train as train_lib
from repro_torch.launch.mesh import Mesh, device_array
from repro_torch.models import convert
from repro_torch.models import model as model_lib
from repro_torch.models import sharding as shd

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
STEPS, BATCH, NM = 3, 8, 2
# name -> (arch, ModelConfig overrides, seq)
MODELS = {
    "qwen": ("qwen1.5-0.5b", dict(num_layers=2, vocab_size=64, d_model=64,
                                  num_heads=4, num_kv_heads=4, head_dim=16,
                                  compute_dtype="float32"), 32),
    "gemma2": ("gemma2-9b", dict(vocab_size=66, compute_dtype="float32"),
               48),
}
# world -> [(model, (data, model))]
RUNS = {
    2: [("qwen", (2, 1)), ("qwen", (1, 2))],
    4: [("qwen", (2, 2)), ("gemma2", (1, 4))],
    8: [("qwen", (4, 2)), ("gemma2", (2, 4))],
}
MESHES = {"2x2": (2, 2), "4x2": (4, 2), "1x4": (1, 4)}


def _cfg(name):
    arch, over, _ = MODELS[name]
    return reduced_config(arch, **over)


def _train(name, group, ckpt_dir, model_parallel, ckpt_every=100):
    arch, over, seq = MODELS[name]
    return train_lib.train(arch, reduced=True, steps=STEPS, batch=BATCH,
                           seq=seq, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                           model_parallel=model_parallel, microbatches=NM,
                           log_every=100, group=group,
                           device=None if group else "cpu", **over)


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
                         ckpt_every=2 if tag == "qwen_2x2" else 100)
            out[tag + "_loss"] = np.array(res["losses"])
            out[tag + "_gnorm"] = np.array(res["grad_norms"])
            out[tag + "_coll"] = np.array(res["collective_calls"])
            mesh = train_lib.build_mesh(m, range(world))
            whole = shd.gather_params(
                res["params"], model_lib.abstract_params(_cfg(name)), mesh,
                g)
            out[tag + "_params"] = np.concatenate(
                [t.reshape(-1).numpy()
                 for _, t in model_lib.named_leaves(whole)])
            if tag == "qwen_2x2":
                # resume step 3 from the step-2 checkpoint on (2, 2)
                again = os.path.join(tmp, "resumed")
                if rank == 0:
                    _copy_step(ck, 2, again)
                dist.barrier(g)
                res = train_lib.train(
                    "qwen1.5-0.5b", reduced=True, steps=STEPS, batch=BATCH,
                    seq=MODELS[name][2], ckpt_dir=again, model_parallel=m,
                    microbatches=NM, log_every=100, group=g,
                    **MODELS[name][1])
                out["resumed_start"] = np.array(res["start_step"])
                out["resumed_loss"] = np.array(res["losses"])
                out["resumed_gnorm"] = np.array(res["grad_norms"])
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

_SHARDINGS_BODY = """
from jax.sharding import Mesh
from repro.configs import reduced_config
from repro.models import model, sharding as shd
for arch in ARCHS:
    cfg = reduced_config(arch)
    params = jax.eval_shape(lambda: model.init_params(jax.random.PRNGKey(0),
                                                      cfg))
    for mname, shape in MESHES.items():
        devs = np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
        mesh = Mesh(devs, ("data", "model"))
        shard = shd.param_shardings(params, mesh)
        flat, _ = jax.tree_util.tree_flatten_with_path(params)
        sflat = jax.tree_util.tree_leaves(shard)
        for (path, leaf), s in zip(flat, sflat):
            key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path)
            m = s.devices_indices_map(leaf.shape)
            rows = []
            for pos in np.ndindex(*shape):
                idx = m[devs[pos]]
                rows.append([[sl.start or 0, leaf.shape[i] if sl.stop is None
                              else sl.stop] for i, sl in enumerate(idx)])
            O[f"{arch}|{mname}|{key}"] = np.array(rows, np.int64)
"""


def _jax_steps(name, ck_dir, start=0):
    """The JAX package's single-device step from checkpoint `start` of
    `ck_dir` to STEPS: (losses, grad norms)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import reduced_config as jreduced
    from repro.data import tokens as jtokens
    from repro.models import model as jmodel
    from repro.train import checkpoint as jckpt
    from repro.train import optimizer as jopt
    from repro.train import train_step as jts
    arch, over, seq = MODELS[name]
    jcfg = jreduced(arch, **over)
    tmpl = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    restored, _ = jckpt.restore(ck_dir, start, {"params": tmpl,
                                                "opt": jopt.init(tmpl)})
    params = jax.tree.map(jnp.asarray, restored["params"])
    state = jax.tree.map(jnp.asarray, restored["opt"])
    tcfg = jts.TrainConfig(num_microbatches=NM, optimizer=jopt.OptimizerConfig(
        peak_lr=3e-4, warmup_steps=max(2, STEPS // 20), total_steps=STEPS))
    step = jax.jit(jts.make_train_step(jcfg, tcfg))
    losses, gnorms = [], []
    for i in range(start, STEPS):
        tok = jtokens.batch_for_step(jtokens.TokenPipelineConfig(
            vocab_size=jcfg.vocab_size, batch_size=BATCH, seq_len=seq,
            seed=0), i)
        params, state, m = step(params, state, {"tokens": jnp.asarray(tok)})
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return np.array(losses), np.array(gnorms)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank 0's outputs by world, the one-process runs, the JAX runs,
    the JAX shardings, the launchers' directories)."""
    import jax
    from _torch_parity import run_jax
    from repro.configs import reduced_config as jreduced
    from repro.models import model as jmodel
    from repro.train import checkpoint as jckpt
    from repro.train import optimizer as jopt
    base = tmp_path_factory.mktemp("sharded")
    shared = str(base / "shared")
    os.makedirs(shared)
    for name, (arch, over, _) in MODELS.items():
        jp = jmodel.init_params(jax.random.PRNGKey(0), jreduced(arch, **over))
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
    try:
        body = (f"ARCHS = {list(ARCH_IDS)!r}\nMESHES = {MESHES!r}\n"
                + _SHARDINGS_BODY)
        os.makedirs(base / "jax_shardings")
        jax_shardings = run_jax(base / "jax_shardings", body, devices=8)
        one, jax_runs = {}, {}
        for name in MODELS:
            ck = str(base / f"one_{name}")
            _copy_step(os.path.join(shared, "jax_" + name), 0, ck)
            one[name] = _train(name, None, ck, 1)
            jax_runs[name] = _jax_steps(name, os.path.join(shared,
                                                           "jax_" + name))
    finally:
        logs = {w: p.communicate(timeout=600)[0] for w, p in procs.items()}
    for world, p in procs.items():
        assert p.returncode == 0, logs[world][-6000:]
    ranks = {w: dict(np.load(os.path.join(dirs[w], "rank0.npz")))
             for w in RUNS}
    return ranks, one, jax_runs, jax_shardings, dirs


@pytest.mark.parametrize("mname", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shardings_match_jax(runs, arch, mname):
    jax_sh = runs[3]
    cfg = reduced_config(arch)
    shape = MESHES[mname]
    mesh = Mesh(device_array(range(shape[0] * shape[1]), shape),
                ("data", "model"))
    params = model_lib.abstract_params(cfg)
    shardings = shd.param_shardings(params, mesh)
    per = len(cfg.period)
    n = 0
    for path, leaf in model_lib.named_leaves(params):
        sh = shardings
        for k in path:
            sh = sh[k]
        jpath = path
        if path[0] == "blocks":
            jpath = ("blocks", path[1] % per) + path[2:]
        want = jax_sh[f"{arch}|{mname}|" + "/".join(map(str, jpath))]
        if path[0] == "blocks":      # the stacked num_periods dim is whole
            assert (want[:, 0, 0] == 0).all()
            want = want[:, 1:]
        got = []
        for pos in np.ndindex(*shape):
            idx = sh.indices(dict(zip(("data", "model"), pos)))
            got.append([[s.start or 0, leaf.shape[i] if s.stop is None
                         else s.stop] for i, s in enumerate(idx)])
        np.testing.assert_array_equal(np.array(got), want, err_msg=str(path))
        n += 1
    assert n == len(list(model_lib.named_leaves(params)))


def _mesh_runs():
    return [(w, name, dm) for w, rs in sorted(RUNS.items())
            for name, dm in rs]


@pytest.mark.parametrize("world,name,dm", _mesh_runs())
def test_sharded_step_matches_jax_and_one_process(runs, world, name, dm):
    ranks, one, jax_runs, _, _ = runs
    out = ranks[world]
    tag = f"{name}_{dm[0]}x{dm[1]}"
    loss, gnorm = out[tag + "_loss"], out[tag + "_gnorm"]
    assert len(loss) == STEPS
    j_loss, j_gnorm = jax_runs[name]
    rel = lambda a, b: np.abs(a - b) / np.maximum(1.0, np.abs(b))
    assert (rel(loss, j_loss) < 3e-4).all(), (loss, j_loss)
    assert (rel(gnorm, j_gnorm) < 3e-4).all(), (gnorm, j_gnorm)
    np.testing.assert_allclose(loss, one[name]["losses"], rtol=1e-5)
    np.testing.assert_allclose(gnorm, one[name]["grad_norms"], rtol=1e-5)
    want = np.concatenate([t.detach().reshape(-1).numpy() for _, t in
                           model_lib.named_leaves(one[name]["params"])])
    # AdamW's normalised update m / (sqrt(v) + eps) turns the reduction
    # order's 1e-7 in a near-zero gradient into up to peak_lr (3e-4) of
    # update: a third of that bounds every element, and nearly all agree
    # to 1e-6
    diff = np.abs(out[tag + "_params"] - want)
    assert diff.max() < 1e-4, diff.max()
    assert (diff < 1e-6).mean() > 0.999, (diff < 1e-6).mean()
    # every step makes collectives, the same number each step
    coll = out[tag + "_coll"]
    assert coll[0] > 0 and (coll == coll[0]).all()


def test_sharded_checkpoint_resumes_bit_equal_on_its_mesh(runs):
    out = runs[0][4]
    assert int(out["resumed_start"]) == 2
    np.testing.assert_array_equal(out["resumed_loss"],
                                  out["qwen_2x2_loss"][2:])
    np.testing.assert_array_equal(out["resumed_gnorm"],
                                  out["qwen_2x2_gnorm"][2:])


def test_sharded_checkpoint_resumes_on_one_process(runs, tmp_path):
    out, dirs = runs[0][4], runs[4]
    _copy_step(os.path.join(dirs[4], "qwen_2x2"), 2, str(tmp_path))
    res = _train("qwen", None, str(tmp_path), 1)
    assert res["start_step"] == 2
    np.testing.assert_allclose(res["losses"], out["qwen_2x2_loss"][2:],
                               rtol=1e-5)


def test_sharded_checkpoint_resumes_under_jax(runs):
    out, dirs = runs[0][4], runs[4]
    loss, gnorm = _jax_steps("qwen", os.path.join(dirs[4], "qwen_2x2"),
                             start=2)
    rel = np.abs(loss - out["qwen_2x2_loss"][2:]) / np.maximum(1.0, loss)
    assert (rel < 3e-4).all(), (loss, out["qwen_2x2_loss"])


def test_one_process_checkpoint_is_unsharded(runs, tmp_path):
    """A one-process run's checkpoint and the (2, 2) run's hold the same
    leaves in the same JAX layout (same names, shapes, dtypes)."""
    from repro_torch.train import checkpoint as ckpt
    dirs = runs[4]
    cfg = _cfg("qwen")
    tmpl = convert.jax_template(model_lib.abstract_params(cfg), cfg)
    from repro_torch.train import optimizer as opt_lib
    tree = {"params": tmpl, "opt": opt_lib.OptState(step=0, mu=tmpl,
                                                    nu=tmpl)}
    got, extra = ckpt.restore(os.path.join(dirs[4], "qwen_2x2"), 3, tree)
    assert extra == {"cursor": 3}
    one_ck = os.path.join(str(tmp_path), "one")
    _copy_step(os.path.join(dirs[4], "qwen_2x2"), 2, one_ck)
    res = _train("qwen", None, one_ck, 1)
    want, _ = ckpt.restore(one_ck, 3, tree)
    for a, b in zip(model_lib.named_leaves(got["params"]),
                    model_lib.named_leaves(want["params"])):
        assert a[1].shape == b[1].shape and a[1].dtype == b[1].dtype
        np.testing.assert_allclose(a[1], b[1], rtol=0, atol=1e-4)
    assert len(res["losses"]) == 1


def test_rank_launch_from_the_command_line():
    """`python -m repro_torch.launch.train --world 2` spawns two gloo
    ranks on a (1, 2) mesh and trains."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen1.5-0.5b", "--reduced", "--steps", "2", "--batch", "2",
         "--seq", "16", "--world", "2", "--model-parallel", "2",
         "--backend", "gloo"], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.count("done: final_loss=") == 1, proc.stdout


if __name__ == "__main__":
    _launch(int(sys.argv[1]), sys.argv[2])
