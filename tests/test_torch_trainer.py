"""The port's trainer infrastructure against the JAX package, on the CPU:
the mesh and `remesh`, `scale_microbatches`, the straggler watchdog, and
`launch.train`'s checkpoints and resume.

The watchdogs are fed one synthetic step-time sequence through a patched
`time.perf_counter`, no sleeps. Resume is exact: the CPU runs the same
operations in the same order from the same restored f32 leaves. A
checkpoint written by either trainer reads under the other: the port's
under `repro.train.checkpoint.restore` with the JAX package's own
templates (every leaf equal, every dtype the template's), and the JAX
package's resumed by the port's `train`, whose first loss is the JAX train
step's within `test_torch_lm.py`'s f32 loss tolerance (1e-5 relative).
"""

import itertools
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced
from repro.data import tokens as jtokens
from repro.launch import mesh as jmesh
from repro.models import model as jmodel
from repro.train import checkpoint as jckpt
from repro.train import elastic as jelastic
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.configs import reduced_config
from repro_torch.launch import mesh
from repro_torch.launch import train as train_lib
from repro_torch.models import convert
from repro_torch.train import elastic

ARCH = "qwen1.5-0.5b"
B, S = 2, 16
F32 = dict(compute_dtype="float32")


# --- the mesh and remesh -----------------------------------------------------

@pytest.mark.parametrize("n,mp,pods", [(48, 16, None), (37, 8, None),
                                       (64, 16, 2), (48, 16, 2), (16, 16, 1),
                                       (37, 1, None)])
def test_remesh_matches_jax(n, mp, pods):
    got = elastic.remesh(list(range(n)), mp, pods=pods)
    want = jelastic.remesh(list(range(n)), mp, pods=pods)
    assert got.shape == want.shape and got.axis_names == want.axis_names
    assert got.size == want.size
    np.testing.assert_array_equal(got.devices.astype(np.int64),
                                  np.asarray(want.devices, np.int64))
    assert mesh.data_axes_of(got) == jmesh.data_axes_of(want)


def test_remesh_with_too_few_devices_raises_in_both():
    for fn in (elastic.remesh, jelastic.remesh):
        with pytest.raises(ValueError, match="cannot host"):
            fn(list(range(3)), 4)


def test_scale_microbatches_matches_jax():
    for old, new, m in itertools.product(range(1, 9), range(1, 9), (1, 3, 8)):
        assert elastic.scale_microbatches(old, new, m) == \
            jelastic.scale_microbatches(old, new, m)


@pytest.mark.parametrize("shape,axes", [((2, 4), ("data", "model")),
                                        ((2, 2, 2), ("pod", "data", "model")),
                                        ((8,), ("stage",))])
def test_make_test_mesh_and_data_axes_match_jax(shape, axes):
    got = mesh.make_test_mesh(shape, axes, devices=list(range(8)))
    want = jmesh.make_test_mesh(shape, axes, devices=list(range(8)))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.devices.astype(np.int64),
                                  np.asarray(want.devices, np.int64))
    assert mesh.data_axes_of(got) == jmesh.data_axes_of(want)


def test_production_mesh_needs_its_devices():
    """Too few devices raise in both packages (the JAX process here has
    one); the port builds the meshes over enough of them."""
    for multi in (False, True):
        with pytest.raises(RuntimeError, match="need"):
            jmesh.make_production_mesh(multi_pod=multi)
        with pytest.raises(RuntimeError, match="need"):
            mesh.make_production_mesh(multi_pod=multi,
                                      devices=list(range(255)))
    m = mesh.make_production_mesh(devices=list(range(300)))
    assert dict(m.shape) == {"data": 16, "model": 16}
    m = mesh.make_production_mesh(multi_pod=True, devices=list(range(512)))
    assert dict(m.shape) == {"pod": 2, "data": 16, "model": 16}


# --- the straggler watchdog --------------------------------------------------

# Step times: a slow first step, steady steps with jitter, one isolated
# slow step, then a sustained straggle.
_DTS = ([2.0, 1.0, 1.1, 0.9, 1.05, 1.0, 0.95, 1.0, 2.5, 1.0, 1.02]
        + [3.0] * 4 + [1.0, 0.98])


def _drive(module, monkeypatch, **kw):
    stamps = [0.0]
    for dt in _DTS:
        stamps += [stamps[-1] + 0.5, stamps[-1] + 0.5 + dt]
    clock = iter(stamps[1:])
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    wd = module.StragglerWatchdog(**kw)
    trips = []
    for step in range(len(_DTS)):
        wd.step_start()
        if wd.step_end(step):
            trips.append(step)
    monkeypatch.undo()
    return wd.events, trips


@pytest.mark.parametrize("kw", [{}, dict(k_sigma=2.0, warmup_steps=3,
                                         trip_after=2),
                                dict(ewma_alpha=0.5, trip_after=1)],
                         ids=["default", "k2", "alpha"])
def test_watchdog_matches_jax(kw, monkeypatch):
    got = _drive(elastic, monkeypatch, **kw)
    want = _drive(jelastic, monkeypatch, **kw)
    assert got == want
    assert got[1], "the sustained straggle must trip the watchdog"


# --- checkpoints and resume --------------------------------------------------

def _train(ckpt_dir, steps, **kw):
    return train_lib.train(ARCH, reduced=True, steps=steps, batch=B, seq=S,
                           ckpt_dir=str(ckpt_dir), device="cpu",
                           log_every=100, **F32, **kw)


@pytest.fixture(scope="module")
def run_a(tmp_path_factory):
    d = tmp_path_factory.mktemp("a")
    return d, _train(d, 8, ckpt_every=3)


def test_resume_is_exact(run_a, tmp_path):
    a_dir, a = run_a
    assert sorted(p.name for p in a_dir.iterdir()) == [
        "step_00000003", "step_00000006", "step_00000008"]
    assert a["start_step"] == 0 and len(a["losses"]) == 8
    assert [s for s, _ in a["save_seconds"]] == [3, 6, 8]
    assert sorted(s for s, _ in a["write_seconds"]) == [3, 6, 8]
    shutil.copytree(a_dir / "step_00000006", tmp_path / "step_00000006")
    b = _train(tmp_path, 8)
    assert b["start_step"] == 6 and b["restore_seconds"] is not None
    assert b["losses"] == a["losses"][6:]
    assert b["grad_norms"] == a["grad_norms"][6:]
    assert b["straggler_events"] == 0


def test_resume_false_starts_over(run_a, tmp_path):
    a_dir, a = run_a
    shutil.copytree(a_dir / "step_00000006", tmp_path / "step_00000006")
    b = _train(tmp_path, 2, resume=False)
    assert b["start_step"] == 0 and len(b["losses"]) == 2
    assert b["losses"][0] == a["losses"][0]


def test_port_checkpoint_reads_under_jax(tmp_path):
    out = _train(tmp_path, 6, ckpt_every=3)
    jcfg = jreduced(ARCH, **F32)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    restored, extra = jckpt.restore(str(tmp_path), 6, {
        "params": jparams, "opt": jopt.init(jparams)})
    assert extra == {"cursor": 6}
    cfg = reduced_config(ARCH, **F32)
    # The run's own state at step 6, read back from the port's returned
    # trees through the checkpoint-free converter.
    want_p = convert.params_to_numpy(out["params"], cfg)
    want_o = convert.opt_state_to_numpy(out["opt_state"], cfg)
    tmpl = {"params": jparams, "opt": jopt.init(jparams)}
    got_l = jax.tree_util.tree_leaves(restored)
    tmpl_l = jax.tree_util.tree_leaves(tmpl)
    want_l = jax.tree_util.tree_leaves(
        {"params": want_p, "opt": jopt.OptState(**want_o)})
    assert len(got_l) == len(tmpl_l) == len(want_l)
    for g, t, w in zip(got_l, tmpl_l, want_l):
        g = np.asarray(g)
        assert g.dtype == t.dtype and g.shape == t.shape
        np.testing.assert_array_equal(g, w)
    assert int(restored["opt"].step) == 6


def test_jax_checkpoint_resumes_under_the_port(tmp_path):
    jcfg = jreduced(ARCH, **F32)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    jstate = jopt.init(jparams)
    jckpt.save(str(tmp_path), 0, {"params": jparams, "opt": jstate},
               extra={"cursor": 0})
    out = _train(tmp_path, 1)
    assert out["start_step"] == 0 and len(out["losses"]) == 1
    tokens = jtokens.batch_for_step(jtokens.TokenPipelineConfig(
        vocab_size=jcfg.vocab_size, batch_size=B, seq_len=S, seed=0), 0)
    step = jax.jit(jts.make_train_step(jcfg, jts.TrainConfig()))
    _, _, m = step(jparams, jstate, {"tokens": jnp.asarray(tokens)})
    assert out["losses"][0] == pytest.approx(float(m["loss"]), rel=1e-5)
