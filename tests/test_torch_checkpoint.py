"""The port's atomic saver (`repro_torch.train.checkpoint`): the JAX
package's own checkpoint tests on the port, and checkpoints read across
packages both ways.

A tree of the JAX package's shape (nested dicts, a tuple, a NamedTuple)
written by either package restores under the other with the same leaf
paths, dtypes and values. A `KmerCounter` checkpoint written by the port
is restored by the JAX package (in place and onto another PE count), one
written by the JAX package by the port, and the two packages' checkpoints
of the same stream have equal manifests and leaf arrays. The JAX counter
runs in a subprocess with 4 host devices; the tree checks run JAX in
this process.
"""

import json
import os
from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch

from _torch_parity import JAX_HELPERS, assert_result, histogram, run_jax
from repro.data import genome as jgenome
from repro.train import checkpoint as jckpt
from repro_torch.core import fabsp
from repro_torch.core.resilience import FaultPlan, InjectedFault
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt_lib


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"blocks": ({"w": torch.randn((4, 8), generator=g)},),
            "embed": {"tok": torch.randn((16, 4), generator=g)}}


def _leaves(tree):
    return [tree["blocks"][0]["w"], tree["embed"]["tok"]]


# --- the JAX package's checkpoint tests, on the port -------------------------

def test_roundtrip(tmp_path):
    params = _tree()
    opt = opt_lib.init(params)
    d = str(tmp_path)
    path = ckpt.save(d, 7, {"params": params, "opt": opt},
                     extra={"cursor": 123, "mesh": [4, 2]})
    assert os.path.basename(path) == "step_00000007"
    assert ckpt.latest_step(d) == 7
    restored, extra = ckpt.restore(d, 7, {"params": params, "opt": opt})
    assert extra == {"cursor": 123, "mesh": [4, 2]}
    for a, b in zip(_leaves(params), _leaves(restored["params"])):
        np.testing.assert_array_equal(a.numpy(), b)
    assert isinstance(restored["opt"], opt_lib.OptState)
    assert int(restored["opt"].step) == 0
    assert restored["opt"].mu["embed"]["tok"].shape == (16, 4)


def test_async_save_and_gc(tmp_path):
    d = str(tmp_path)
    saver = ckpt.AsyncSaver(d, keep=2)
    for s in range(4):
        saver.save(s, {"params": _tree(s)})
    saver.wait()
    steps = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert steps == ["step_00000002", "step_00000003"]   # GC kept 2
    restored, _ = ckpt.restore(d, 3, {"params": _tree()})
    np.testing.assert_array_equal(restored["params"]["embed"]["tok"],
                                  _tree(3)["embed"]["tok"].numpy())


def test_restore_gives_host_numpy_the_caller_places(tmp_path):
    """The port's counterpart of the JAX package's restore with
    shardings: leaves come back as host numpy, whatever device they were
    saved from, and the caller puts them where it wants."""
    d = str(tmp_path)
    ckpt.save(d, 0, {"params": _tree()})
    restored, _ = ckpt.restore(d, 0, {"params": _tree()})
    leaf = restored["params"]["blocks"][0]["w"]
    assert isinstance(leaf, np.ndarray) and leaf.dtype == np.float32
    assert torch.from_numpy(leaf).to("cpu").shape == (4, 8)
    with pytest.raises(TypeError):
        ckpt.restore(d, 0, {"params": _tree()}, shardings=None)


def test_crash_safety_tmp_dir_ignored(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, {"params": _tree()})
    os.makedirs(os.path.join(d, "step_00000002.tmp"))  # a crash mid-save
    assert ckpt.latest_step(d) == 1


def test_async_saver_propagates_write_failure(tmp_path):
    good = str(tmp_path / "good")
    saver = ckpt.AsyncSaver(good)
    saver.save(0, {"params": _tree()})
    saver.wait()
    assert ckpt.latest_step(good) == 0
    blocker = tmp_path / "blocker"
    blocker.write_text("not a directory")
    saver.ckpt_dir = str(blocker / "ckpt")
    saver.save(1, {"params": _tree(1)})
    with pytest.raises(OSError):
        saver.wait()
    saver.wait()                                # raised once, then cleared
    assert ckpt.latest_step(good) == 0


def test_injected_ckpt_write_fault_keeps_latest_intact(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 0, {"params": _tree()})
    with pytest.raises(InjectedFault):
        ckpt.save(d, 1, {"params": _tree(1)},
                  fault=FaultPlan(site="ckpt_write", fail_after=1))
    assert ckpt.latest_step(d) == 0
    assert os.path.isdir(os.path.join(d, "step_00000001.tmp"))
    restored, _ = ckpt.restore(d, 0, {"params": _tree()})
    np.testing.assert_array_equal(restored["params"]["embed"]["tok"],
                                  _tree()["embed"]["tok"].numpy())


def test_async_saver_snapshots_at_the_call(tmp_path):
    t = _tree()
    saver = ckpt.AsyncSaver(str(tmp_path))
    want = t["embed"]["tok"].clone()
    saver.save(0, {"params": t})
    t["embed"]["tok"].add_(1.0)                # updated in place after
    saver.wait()
    restored, _ = ckpt.restore(str(tmp_path), 0, {"params": _tree()})
    np.testing.assert_array_equal(restored["params"]["embed"]["tok"],
                                  want.numpy())


# --- trees across packages (JAX in this process) -----------------------------

class _State(NamedTuple):
    step: np.ndarray
    mu: dict


def _mixed_tree(seed):
    rng = np.random.default_rng(seed)
    return {"z": {"b": rng.integers(0, 1 << 40, 6, dtype=np.uint64),
                  "a": (rng.normal(size=(3, 2)).astype(np.float32),
                        np.arange(5, dtype=np.int32))},
            "state": _State(step=np.int32(3),
                            mu={"w": np.ones((2, 2), np.float32)}),
            "none": None}


def _mixed_leaves(tree):
    return [tree["z"]["b"], tree["z"]["a"][0], tree["z"]["a"][1],
            tree["state"].step, tree["state"].mu["w"]]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_trees_read_across_packages(tmp_path, writer):
    tree = _mixed_tree(1)
    (ckpt if writer == "port" else jckpt).save(str(tmp_path), 2,
                                               {"t": tree}, extra={"x": 1})
    with open(os.path.join(str(tmp_path), "step_00000002",
                           "manifest.json")) as f:
        manifest = json.load(f)
    for reader in (ckpt, jckpt):
        got, extra = reader.restore(str(tmp_path), 2, {"t": _mixed_tree(9)})
        assert extra == {"x": 1}
        for a, b in zip(_mixed_leaves(tree), _mixed_leaves(got["t"])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            assert np.asarray(a).dtype == np.asarray(b).dtype
    # both packages name and order the leaves alike
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert list(manifest["trees"]["t"]) == [
        "##".join(str(getattr(e, "key", getattr(e, "idx", getattr(
            e, "name", e)))) for e in path) for path, _ in flat]


# --- KmerCounter checkpoints across packages ---------------------------------

READS = [jgenome.sample_reads(jgenome.ReadSetSpec(
    genome_bases=2048, n_reads=64, read_len=52, seed=s)) for s in (4, 5)]
CFG = dict(k=13, chunk_reads=8, transport_impl="superkmer",
           minimizer_order="hashed")

_BODY = JAX_HELPERS + """
import os
from repro.core import fabsp
cfg = fabsp.DAKCConfig(**CFG)
kc = fabsp.KmerCounter(mesh_of(4)[0], cfg)
kc.update(jnp.asarray(I["r0"]))
kc.update(jnp.asarray(I["r1"]))
kc.save(os.path.join(ROOT, "jax_ckpt"), step=5)
res_out("own", kc.finalize()[0])
for p in (4, 2):
    kc2 = fabsp.KmerCounter.restore(PORT_CKPT, mesh_of(p)[0], cfg)
    res_out(f"from_port_p{p}", kc2.finalize()[0])
"""


@pytest.fixture(scope="module")
def counter_ckpts(tmp_path_factory):
    """The port's checkpoint first, then the JAX run that writes its own
    and restores the port's."""
    root = tmp_path_factory.mktemp("ckpt_cross")
    kc = fabsp.KmerCounter(fabsp.DAKCConfig(**CFG), num_pes=4, device="cpu")
    for r in READS:
        kc.update(r)
    kc.save(str(root / "port_ckpt"), step=5)
    body = (f"ROOT = {str(root)!r}\nCFG = {CFG!r}\n"
            f"PORT_CKPT = {str(root / 'port_ckpt')!r}\n" + _BODY)
    out = run_jax(tmp_path_factory.mktemp("ckpt_cross_run"), body,
                  {"r0": READS[0], "r1": READS[1]}, devices=4)
    return out, root, kc


def test_counter_checkpoints_equal_across_packages(counter_ckpts):
    out, root, _ = counter_ckpts
    step = "step_00000005"
    manifests = []
    for d in ("port_ckpt", "jax_ckpt"):
        with open(os.path.join(str(root), d, step, "manifest.json")) as f:
            manifests.append(json.load(f))
    assert manifests[0] == manifests[1]
    assert list(manifests[0]["trees"]["store"]) == ["counts", "keys"]
    for leaf in ("counts", "keys"):
        a, b = (np.load(os.path.join(str(root), d, step, "store",
                                     leaf + ".npy"))
                for d in ("port_ckpt", "jax_ckpt"))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_port_checkpoint_restored_by_jax(counter_ckpts):
    """The JAX package restores the port's checkpoint in place into its
    own run's histogram, array for array, and onto 2 PEs into the same
    counts."""
    out, _, kc = counter_ckpts
    assert_result(kc.finalize()[0], 32, out, "own")
    for suffix in ("_u", "_c", "_n"):
        np.testing.assert_array_equal(out["from_port_p4" + suffix],
                                      out["own" + suffix])
    u, c, n = (out["from_port_p2" + s] for s in ("_u", "_c", "_n"))
    width = u.size // 2
    got = {int(u[s * width + i]): int(c[s * width + i])
           for s in range(2) for i in range(int(n[s]))}
    assert got == histogram(kc.finalize()[0], 4)


def test_jax_checkpoint_restored_by_port(counter_ckpts):
    out, root, _ = counter_ckpts
    cfg = fabsp.DAKCConfig(**CFG)
    kc = fabsp.KmerCounter.restore(str(root / "jax_ckpt"), cfg, num_pes=4,
                                   device="cpu")
    assert kc._n_updates == 2
    assert_result(kc.finalize()[0], 32, out, "own")
    kc2 = fabsp.KmerCounter.restore(str(root / "jax_ckpt"), cfg, num_pes=2,
                                    device="cpu")
    assert histogram(kc2.finalize()[0], 2) == histogram(kc.finalize()[0], 4)
