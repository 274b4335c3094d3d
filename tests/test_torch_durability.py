"""`KmerCounter.save` / `restore` and the elastic reshard on the CPU,
against the JAX package.

Each case counts batches on one PE count, saves, restores onto the same
or another PE count (or another ownership family: super-k-mer <-> k-mer
transport), keeps counting and saves again, in both packages. The
checkpoints' manifests (the `extra` of every sticky knob, the round
history's JSON) and leaf arrays, the restored store slot for slot, each
update's DAKCStats and the final histogram must be equal. The refusals
(another fingerprint, a spilled checkpoint without a spill cfg), the
'ckpt_write' drill and the async saver are checked on the port alone.
The JAX runs happen in three subprocesses at once (two for 32-bit words,
one for 64-bit).
"""

import json
import os

import numpy as np
import pytest
import torch

from _torch_parity import (JAX_HELPERS, assert_result, assert_stats,
                           histogram, run_jax_many)
from repro.data import genome as jgenome
from repro_torch import words as W
from repro_torch.core import fabsp, resilience
from repro_torch.core.resilience import FaultPlan
from repro_torch.train import checkpoint as ckpt

R = [jgenome.sample_reads(jgenome.ReadSetSpec(
    genome_bases=2048, n_reads=64, read_len=52, heavy_hitter_frac=0.3,
    seed=s)) for s in (1, 2, 3)]
SK = dict(transport_impl="superkmer", minimizer_len=7)
SKH = dict(SK, minimizer_order="hashed")
DROP = dict(site="store_drop", seed=2, chunk=0, frac=0.25)
ROUTE = dict(site="route_drop", seed=1, chunk=-1, frac=0.3)
# (k, p_save, p_restore, save knobs, restore knobs, fault of the saved run)
CASES = {
    "inplace_p4": (13, 4, 4, {}, {}, None),
    "elastic_4to2": (13, 4, 2, {}, {}, None),
    "elastic_2to4_sk": (13, 2, 4, SKH, SKH, None),
    "family_kmer_to_sk": (13, 4, 4, {}, SK, None),
    "family_sk_to_kmer": (13, 2, 2, SKH, {}, None),
    "rounds_store_drop": (13, 4, 2, dict(store_capacity=256),
                          dict(store_capacity=256), DROP),
    "rounds_route_drop": (13, 2, 4, dict(use_l3=False),
                          dict(use_l3=False), ROUTE),
}
CASES64 = {
    "elastic_4to2_k31_sk": (31, 4, 2, SKH, SKH, None),
    "inplace_k31": (31, 2, 2, dict(store_capacity=300),
                    dict(store_capacity=300), DROP),
}

_BODY = JAX_HELPERS + """
import os
from repro.core import fabsp
from repro.core.resilience import FaultPlan

for name, (k, ps, pr, ks, kr, plan) in CASES.items():
    kc = fabsp.KmerCounter(mesh_of(ps)[0], fabsp.DAKCConfig(
        k=k, chunk_reads=8, **ks,
        faults=None if plan is None else FaultPlan(**plan)))
    put(name + "_u0", kc.update(jnp.asarray(I["r0"])))
    put(name + "_u1", kc.update(jnp.asarray(I["r1"])))
    kc.save(os.path.join(ROOT, name), step=1)
    cfg = fabsp.DAKCConfig(k=k, chunk_reads=8, **kr)
    kc2 = fabsp.KmerCounter.restore(os.path.join(ROOT, name),
                                    mesh_of(pr)[0], cfg)
    O[name + "_skeys"], O[name + "_scounts"] = kc2._skeys, kc2._scounts
    O[name + "_cap"] = np.array(kc2.store_capacity)
    put(name + "_u2", kc2.update(jnp.asarray(I["r2"])))
    res, st = kc2.finalize()
    res_out(name, res)
    put(name + "_st", st)
    kc2.save(os.path.join(ROOT, name + "_again"), step=2)
"""


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    root = tmp_path_factory.mktemp("durability_jax")
    inputs = {f"r{i}": r for i, r in enumerate(R)}
    names = sorted(CASES)
    parts = (("a", {n: CASES[n] for n in names[::2]}, False),
             ("b", {n: CASES[n] for n in names[1::2]}, False),
             ("x64", CASES64, True))
    jobs = {w: (f"ROOT = {str(root)!r}\nCASES = {cases!r}\n" + _BODY, x64)
            for w, cases, x64 in parts}
    out = run_jax_many(tmp_path_factory.mktemp("durability_runs"), jobs,
                       inputs, devices=8)
    return {k: v for part in out.values() for k, v in part.items()}, root


def _manifest(ckpt_dir, step):
    with open(os.path.join(str(ckpt_dir), f"step_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)


def _assert_same_checkpoint(dir_a, dir_b, step):
    """Equal manifests (step, leaf shapes and dtypes, `extra`) and equal
    leaf arrays, file for file."""
    ma, mb = _manifest(dir_a, step), _manifest(dir_b, step)
    assert ma == mb
    for name, leaves in ma["trees"].items():
        for leaf in leaves:
            a = np.load(os.path.join(str(dir_a), f"step_{step:08d}", name,
                                     leaf + ".npy"))
            b = np.load(os.path.join(str(dir_b), f"step_{step:08d}", name,
                                     leaf + ".npy"))
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    return ma


def _run_case(name, case, out, root, tmp_path):
    k, ps, pr, ks, kr, plan = case
    kc = fabsp.KmerCounter(fabsp.DAKCConfig(
        k=k, chunk_reads=8, **ks,
        faults=None if plan is None else FaultPlan(**plan)),
        num_pes=ps, device="cpu")
    assert_stats(kc.update(R[0]), out[name + "_u0"])
    assert_stats(kc.update(R[1]), out[name + "_u1"])
    kc.save(str(tmp_path / name), step=1)
    saved = _assert_same_checkpoint(tmp_path / name, root / name, 1)
    cfg = fabsp.DAKCConfig(k=k, chunk_reads=8, **kr)
    kc2 = fabsp.KmerCounter.restore(str(tmp_path / name), cfg, num_pes=pr,
                                    device="cpu")
    bits = kc2._wb
    np.testing.assert_array_equal(
        W.to_numpy_words(kc2._store.keys, bits).reshape(-1),
        out[name + "_skeys"])
    np.testing.assert_array_equal(kc2._store.counts.reshape(-1).numpy(),
                                  out[name + "_scounts"])
    assert kc2.store_capacity == int(out[name + "_cap"])
    assert_stats(kc2.update(R[2]), out[name + "_u2"])
    res, st = kc2.finalize()
    assert_result(res, bits, out, name)
    assert_stats(st, out[name + "_st"])
    kc2.save(str(tmp_path / (name + "_again")), step=2)
    _assert_same_checkpoint(tmp_path / (name + "_again"),
                            root / (name + "_again"), 2)
    return kc, kc2, saved


@pytest.mark.parametrize("name", sorted(CASES))
def test_save_restore_matches_jax_k13(jax_out, tmp_path, name):
    out, root = jax_out
    kc, kc2, saved = _run_case(name, CASES[name], out, root, tmp_path)
    one = fabsp.KmerCounter(fabsp.DAKCConfig(k=13, chunk_reads=8),
                            num_pes=2, device="cpu")
    for r in R:
        one.update(r)
    assert histogram(kc2.finalize()[0], kc2._num_pes) == \
        histogram(one.finalize()[0], 2)
    if name.startswith("rounds"):
        rounds = resilience.rounds_from_json(saved["extra"]["rounds"])
        assert rounds and rounds == kc._rounds
        assert sum(saved["extra"]["retries"].values()) >= 1


@pytest.mark.parametrize("name", sorted(CASES64))
def test_save_restore_matches_jax_k31(jax_out, tmp_path, name):
    out, root = jax_out
    _run_case(name, CASES64[name], out, root, tmp_path)


def test_restore_rejects_another_fingerprint(tmp_path):
    kc = fabsp.KmerCounter(fabsp.DAKCConfig(k=11, chunk_reads=8),
                           num_pes=2, device="cpu")
    kc.update(R[0])
    kc.save(str(tmp_path), step=0)
    for bad in (dict(k=13), dict(k=11, canonical=True)):
        with pytest.raises(ValueError, match="fingerprint"):
            fabsp.KmerCounter.restore(str(tmp_path), fabsp.DAKCConfig(
                chunk_reads=8, **bad), num_pes=2, device="cpu")
    with pytest.raises(FileNotFoundError):
        fabsp.KmerCounter.restore(str(tmp_path / "none"), fabsp.DAKCConfig(
            k=11), num_pes=2, device="cpu")


def test_spilled_checkpoint_needs_a_spill_cfg(tmp_path):
    cfg = fabsp.DAKCConfig(k=11, chunk_reads=8, spill="always",
                           spill_dir=str(tmp_path / "bins"), spill_bins=4)
    kc = fabsp.KmerCounter(cfg, num_pes=2, device="cpu")
    kc.update(R[0])
    kc.save(str(tmp_path / "ck"), step=0)
    with pytest.raises(ValueError, match="spill"):
        fabsp.KmerCounter.restore(str(tmp_path / "ck"), fabsp.DAKCConfig(
            k=11, chunk_reads=8), num_pes=2, device="cpu")
    with pytest.raises(ValueError, match="repartition"):
        fabsp.KmerCounter.restore(str(tmp_path / "ck"), fabsp.dataclasses
                                  .replace(cfg, spill_bins=8), num_pes=2,
                                  device="cpu")
    kc2 = fabsp.KmerCounter.restore(str(tmp_path / "ck"), cfg, num_pes=2,
                                    device="cpu")
    assert kc2.store_capacity == fabsp.KmerCounter._SPILL_STORE_CAP
    assert histogram(kc2.finalize()[0], 2) == histogram(kc.finalize()[0], 2)


def test_ckpt_write_fault_keeps_the_last_complete_checkpoint(tmp_path):
    cfg = fabsp.DAKCConfig(k=11, chunk_reads=8)
    kc = fabsp.KmerCounter(cfg, num_pes=2, device="cpu")
    kc.update(R[0])
    kc.save(str(tmp_path), step=0)
    kc.update(R[1])
    kc_f = fabsp.KmerCounter(fabsp.dataclasses.replace(
        cfg, faults=FaultPlan(site="ckpt_write", fail_after=1)),
        num_pes=2, device="cpu")
    kc_f.update(R[0])
    kc_f.update(R[1])
    with pytest.raises(resilience.InjectedFault):
        kc_f.save(str(tmp_path), step=1)       # dies mid-file, pre-rename
    assert ckpt.latest_step(str(tmp_path)) == 0
    restored = fabsp.KmerCounter.restore(str(tmp_path), cfg, num_pes=2,
                                         device="cpu")
    assert restored._n_updates == 1            # step 0: replay batch 1
    restored.update(R[1])
    assert histogram(restored.finalize()[0], 2) == \
        histogram(kc.finalize()[0], 2)


def test_save_through_the_async_saver_and_one_destination(tmp_path):
    kc = fabsp.KmerCounter(fabsp.DAKCConfig(k=11, chunk_reads=8),
                           num_pes=2, device="cpu")
    kc.update(R[0])
    with pytest.raises(ValueError):
        kc.save()
    saver = ckpt.AsyncSaver(str(tmp_path))
    with pytest.raises(ValueError):
        kc.save(str(tmp_path), saver=saver)
    assert kc.save(saver=saver, step=4) is None
    kc.update(R[1])                             # the snapshot was taken
    saver.wait()
    kc2 = fabsp.KmerCounter.restore(str(tmp_path), kc._cfg, num_pes=2,
                                    device="cpu")
    assert kc2._n_updates == 1
    one = fabsp.KmerCounter(kc._cfg, num_pes=2, device="cpu")
    one.update(R[0])
    assert histogram(kc2.finalize()[0], 2) == histogram(one.finalize()[0], 2)
    with pytest.raises(RuntimeError, match="before any update"):
        fabsp.KmerCounter(kc._cfg, num_pes=2, device="cpu").save(
            str(tmp_path))


def test_restored_counter_serves_queries_exactly(tmp_path):
    cfg = fabsp.DAKCConfig(k=13, chunk_reads=8, **SKH)
    kc = fabsp.KmerCounter(cfg, num_pes=4, device="cpu")
    kc.update(R[0])
    kc.save(str(tmp_path), step=0)
    q = np.asarray(sorted(histogram(kc.finalize()[0], 4))[:40] + [1, 2, 3],
                   np.uint32)
    want = kc.count(q)
    for p in (4, 2):
        kc2 = fabsp.KmerCounter.restore(str(tmp_path), cfg, num_pes=p,
                                        device="cpu")
        np.testing.assert_array_equal(kc2.count(q), want)
        assert torch.equal(torch.as_tensor(kc2.contains(q)),
                           torch.as_tensor(want > 0))
