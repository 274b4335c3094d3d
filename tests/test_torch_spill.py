"""The spill tier (`repro_torch.core.spill` and `KmerCounter`'s spill path)
on the CPU, against the JAX package.

`bin_of` is held bit-equal to the JAX function for 32- and 64-bit words
(64-bit ones with their top bit set, in an x64 subprocess); the writer,
its abort, checksum, attach-prune and the bounded copier mirror the JAX
package's own tests. The counter's spill path runs the JAX package's
cases on the same P and grid: the pressure spill (a clamped ceiling under
'auto'), 'always', an engage after in-core batches, a kill mid-spill with
restore onto fewer PEs, with every DAKCStats field, the drained
histogram, the manifest's bin, kind, n and bytes and the segments'
arrays equal (the CPU folds in stream order, so its store layout, and
with it the engage-time export, is the JAX package's). A spill directory
and checkpoint the JAX package wrote is attached and drained by the
port. The JAX runs happen in four subprocesses at once.
"""

import os

import numpy as np
import pytest
import torch

from _torch_parity import (JAX_HELPERS, assert_result, assert_same_segments,
                           assert_stats, histogram, run_jax_many)
from repro.core import spill as jspill
from repro.data import genome as jgenome
from repro_torch import words as W
from repro_torch.core import fabsp, serial, spill
from repro_torch.core.resilience import FaultPlan, InjectedFault, RetryPolicy

READS = jgenome.sample_reads(jgenome.ReadSetSpec(
    genome_bases=2048, n_reads=128, read_len=80, seed=11))
READS31 = jgenome.sample_reads(jgenome.ReadSetSpec(
    genome_bases=4096, n_reads=64, read_len=60, seed=3))
rng = np.random.default_rng(5)
BIN_KEYS32 = np.concatenate([np.arange(4096, dtype=np.uint32),
                             rng.integers(0, 1 << 32, 2048, dtype=np.uint64)
                             .astype(np.uint32)])
BIN_KEYS64 = np.concatenate([
    np.arange(2048, dtype=np.uint64),
    rng.integers(0, 1 << 63, 2048, dtype=np.uint64) | np.uint64(1 << 63),
    rng.integers(0, 1 << 62, 2048, dtype=np.uint64)])
BIN_COUNTS = (1, 3, 4, 6, 16, 1000)

BASE = dict(k=11, chunk_reads=16, minimizer_len=7)
SK = dict(transport_impl="superkmer")
PRESS = dict(store_capacity=64, retry=("ceiling", 128), spill="auto",
             spill_bins=4)
G2 = dict(topology="2d", use_l3=False)
# count_kmers under a clamped ceiling: (p, grid, knobs)
PRESSURE = {
    "press_kmer_p1": (1, None, {}),
    "press_sk_p1": (1, None, SK),
    "press_kmer_g22": (4, (2, 2), G2),
    "press_sk_g22": (4, (2, 2), {**G2, **SK}),
}
# KmerCounter: (p, grid, knobs, batches as (lo, hi) of READS)
COUNTERS = {
    "always_sk_p4": (4, None, dict(spill="always", **SK),
                     ((0, 64), (64, 128))),
    "auto_mid_p1": (1, None, dict(PRESS), ((0, 32), (32, 128))),
}
KILL = dict(spill="always", spill_bins=8, chunk_reads=4)

_SETUP = JAX_HELPERS + """
import os
from repro.core import fabsp, spill
from repro.core.resilience import FaultPlan, InjectedFault, RetryPolicy

R = I["reads"]

def cfg_of(knobs, d, **more):
    knobs = dict(BASE, **knobs, **more)
    if "retry" in knobs:
        knobs["retry"] = RetryPolicy(store_cap_ceiling=knobs["retry"][1])
    return fabsp.DAKCConfig(**knobs, spill_dir=os.path.join(ROOT, d))
"""

_PRESSURE_BODY = """
for name, (p, grid, knobs) in PRESSURE.items():
    mesh, axes = mesh_of(p, grid)
    res, st = fabsp.count_kmers(jnp.asarray(R), mesh,
                                cfg_of(dict(knobs, **PRESS), name), axes)
    res_out(name, res)
    put(name + "_st", st)
"""

_COUNTERS_BODY = """
for name, (p, grid, knobs, batches) in COUNTERS.items():
    mesh, axes = mesh_of(p, grid)
    kc = fabsp.KmerCounter(mesh, cfg_of(knobs, name), axes)
    for i, (lo, hi) in enumerate(batches):
        put(f"{name}_u{i}", kc.update(jnp.asarray(R[lo:hi])))
    for tag in ("", "_again"):
        res, st = kc.finalize()
        res_out(name + tag, res)
        put(name + tag + "_st", st)
    O[name + "_cap"] = np.array(kc.store_capacity)
"""

_RESTORE_BODY = """
# killed mid-spill on 8 PEs, restored onto 4
ck = os.path.join(ROOT, "kill_ckpt")
kc = fabsp.KmerCounter(mesh_of(8)[0], cfg_of(KILL, "kill", faults=FaultPlan(
    site="spill_write", fail_after=12)))
put("kill_u0", kc.update(jnp.asarray(R[:64])))
kc.save(ck, step=0)
try:
    kc.update(jnp.asarray(R[64:]))
    raise SystemExit("spill_write did not fire")
except InjectedFault:
    pass
kc2 = fabsp.KmerCounter.restore(ck, mesh_of(4)[0], cfg_of(KILL, "kill"))
put("kill_u1", kc2.update(jnp.asarray(R[64:])))
res, st = kc2.finalize()
res_out("kill", res)
put("kill_st", st)

# a spill directory and checkpoint for the port to attach
kc = fabsp.KmerCounter(mesh_of(4)[0], cfg_of(dict(spill="always", **SK),
                                             "jaxdir"))
kc.update(jnp.asarray(R))
kc.save(os.path.join(ROOT, "jaxdir_ckpt"), step=3)
res_out("jaxdir", kc.finalize()[0])
kc = fabsp.KmerCounter.restore(os.path.join(ROOT, "jaxdir_ckpt"),
                               mesh_of(4)[0],
                               cfg_of(dict(spill="always", **SK), "jaxdir"))
put("jaxdir_st", kc.finalize()[1])    # a restored counter's lifetime stats
"""

_BODY64 = JAX_HELPERS + """
from repro.core import fabsp, spill
for b in BIN_COUNTS:
    O[f"bins64_{b}"] = spill.bin_of(jnp.asarray(I["keys64"]), b)
kc = fabsp.KmerCounter(mesh_of(4)[0], fabsp.DAKCConfig(
    k=31, chunk_reads=8, transport_impl="superkmer", minimizer_len=20,
    spill="always", spill_bins=4, spill_dir=ROOT + "/sk31"))
put("sk31_u0", kc.update(jnp.asarray(I["reads31"])))
res, st = kc.finalize()
res_out("sk31", res)
put("sk31_st", st)
"""


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    root = tmp_path_factory.mktemp("spill_jax")
    head = (f"ROOT = {str(root)!r}\nBASE = {BASE!r}\nSK = {SK!r}\n"
            f"PRESS = {PRESS!r}\nPRESSURE = {PRESSURE!r}\n"
            f"COUNTERS = {COUNTERS!r}\nKILL = {KILL!r}\n"
            f"BIN_COUNTS = {BIN_COUNTS!r}\n")
    jobs = {"pressure": (head + _SETUP + _PRESSURE_BODY, False),
            "counters": (head + _SETUP + _COUNTERS_BODY, False),
            "restore": (head + _SETUP + _RESTORE_BODY, False),
            "x64": (head + _BODY64, True)}
    out = run_jax_many(tmp_path_factory.mktemp("spill_runs"), jobs,
                       {"reads": READS, "reads31": READS31,
                        "keys64": BIN_KEYS64}, devices=8)
    return {k: v for part in out.values() for k, v in part.items()}, root


def _cfg(knobs, spill_dir, **more):
    knobs = dict(BASE, **knobs, **more)
    if "retry" in knobs:
        knobs["retry"] = RetryPolicy(store_cap_ceiling=knobs["retry"][1])
    return fabsp.DAKCConfig(**knobs, spill_dir=str(spill_dir))


def _oracle(reads, k=11):
    ser = serial.count_kmers_serial(torch.from_numpy(reads), k)
    n = int(ser.num_unique[0])
    return dict(zip(ser.unique[0, :n].tolist(), ser.counts[0, :n].tolist()))


# --- bin_of and auto_bins ----------------------------------------------------

@pytest.mark.parametrize("n_bins", BIN_COUNTS)
def test_bin_of_matches_jax_uint32(n_bins):
    import jax.numpy as jnp
    got = spill.bin_of(W.to_torch_words(BIN_KEYS32)[0], n_bins, 32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jspill.bin_of(jnp.asarray(BIN_KEYS32),
                                              n_bins)))


@pytest.mark.parametrize("n_bins", BIN_COUNTS)
def test_bin_of_matches_jax_uint64_top_bit(jax_out, n_bins):
    keys = W.to_torch_words(BIN_KEYS64)[0]
    assert bool((keys < 0).any())           # words with the top bit set
    got = spill.bin_of(keys, n_bins, 64)
    np.testing.assert_array_equal(got.numpy(),
                                  jax_out[0][f"bins64_{n_bins}"])
    assert got.min() >= 0 and got.max() < n_bins


def test_bin_of_spreads_and_is_independent_of_the_owner_hash():
    from repro_torch.core.owner import owner_pe
    keys = torch.arange(8192, dtype=torch.int64)
    bins = spill.bin_of(keys, 8, 64)
    assert torch.bincount(bins.long(), minlength=8).min() > 0
    pes = owner_pe(keys, 8, 64)
    assert torch.unique(bins[pes == 0]).numel() >= 6


@pytest.mark.parametrize("args", [
    (None, 4, 64), (1000, 4, None), (1000, 4, 64), (10 ** 6, 8, 64),
    (10 ** 9, 8, 64), (50, 2, 1000), (4096 * 64 * 4, 4, 64)])
def test_auto_bins_matches_jax(args):
    for slack in (1.0, 1.5):
        assert spill.auto_bins(*args, slack) == jspill.auto_bins(*args,
                                                                 slack)


# --- SpillWriter and the copier ----------------------------------------------

def test_spill_writer_roundtrip(tmp_path):
    w = spill.SpillWriter(str(tmp_path), 4, meta={"k": 11})
    w.begin_batch()
    w.add_pairs(np.array([0, 0, 2, 3, 2], np.int32),
                np.array([10, 11, 12, 13, 14], np.uint64),
                np.array([1, 2, 3, 4, 5], np.int32))
    w.commit()
    assert w.spilled_bins == 3 and w.spilled_bytes > 0
    got = {}
    for b in range(4):
        for kind, arrays in w.read_bin(b):
            assert kind == "pairs" and arrays["keys"].dtype == np.uint64
            for kk, cc in zip(arrays["keys"], arrays["counts"]):
                got[int(kk)] = got.get(int(kk), 0) + int(cc)
    assert got == {10: 1, 11: 2, 12: 3, 13: 4, 14: 5}


def test_abort_discards_pending_segments(tmp_path):
    w = spill.SpillWriter(str(tmp_path), 2)
    w.begin_batch()
    w.add_pairs(np.array([0], np.int32), np.array([1], np.uint64),
                np.array([1], np.int32))
    w.commit()
    committed = w.n_segments
    w.begin_batch()
    w.add_pairs(np.array([1], np.int32), np.array([2], np.uint64),
                np.array([9], np.int32))
    w.abort_batch()
    assert w.n_segments == committed
    assert list(w.read_bin(1)) == []
    import json
    with open(os.path.join(str(tmp_path), spill.MANIFEST)) as f:
        assert len(json.load(f)["segments"]) == committed


def test_checksum_detects_corruption(tmp_path):
    w = spill.SpillWriter(str(tmp_path), 2)
    w.begin_batch()
    w.add_pairs(np.ones(64, np.int32), np.arange(64, dtype=np.uint64),
                np.ones(64, np.int32))
    w.commit()
    (rec,) = [s for s in w.state()["segments"] if s["bin"] == 1]
    path = os.path.join(str(tmp_path), rec["file"])
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    with pytest.raises(spill.SpillCorrupt) as ei:
        list(w.read_bin(1))
    assert ei.value.bin == 1 and ei.value.file == rec["file"]


def test_attach_prunes_unlisted_files(tmp_path):
    w = spill.SpillWriter(str(tmp_path), 2, meta={"k": 11})
    w.begin_batch()
    w.add_pairs(np.array([0], np.int32), np.array([3], np.uint64),
                np.array([2], np.int32))
    w.commit()
    state = w.state()
    for junk in ("bin0001_seq000099_pairs.npz", "x.npz.tmp"):
        open(os.path.join(str(tmp_path), junk), "wb").write(b"torn")
    w2 = spill.SpillWriter.attach(str(tmp_path), state)
    assert sorted(os.listdir(str(tmp_path))) == sorted(
        [spill.MANIFEST] + [s["file"] for s in state["segments"]])
    (kind, arrays), = list(w2.read_bin(0))
    assert int(arrays["keys"][0]) == 3 and int(arrays["counts"][0]) == 2


def test_async_host_copier_bounded():
    cop = spill.AsyncHostCopier(budget_bytes=1)   # every batch over budget
    out = []
    for i in range(4):
        out += cop.submit((torch.full((128,), i, dtype=torch.int64),))
        assert len(cop._pending) == 1          # the newest stays in flight
    out += list(cop.drain())
    assert [int(t[0][0]) for t in out] == [0, 1, 2, 3]
    roomy = spill.AsyncHostCopier(budget_bytes=1 << 20)
    assert roomy.submit((torch.zeros(4),)) == []
    assert roomy.submit((torch.zeros(4),)) == []
    assert len(roomy.submit((torch.zeros(4),))) == 1   # two in flight


def test_copier_takes_a_snapshot():
    src = torch.arange(8)
    cop = spill.AsyncHostCopier()
    cop.submit((src,))
    src += 100                                 # the caller reuses its tile
    (host,), = list(cop.drain())
    assert host.tolist() == list(range(8))


# --- the counter's spill path against the JAX package ------------------------

@pytest.mark.parametrize("name", sorted(PRESSURE))
def test_pressure_spill_matches_unconstrained_and_jax(jax_out, tmp_path,
                                                      name):
    out, root = jax_out
    p, grid, knobs = PRESSURE[name]
    clean, _ = fabsp.count_kmers(READS, fabsp.DAKCConfig(**BASE, **knobs),
                                 num_pes=p, grid=grid, device="cpu")
    res, st = fabsp.count_kmers(READS, _cfg(dict(knobs, **PRESS),
                                            tmp_path / name),
                                num_pes=p, grid=grid, device="cpu")
    assert histogram(res, p) == histogram(clean, p)
    assert st.spilled_bins >= 1 and st.bins_folded >= 1
    assert st.retry_store_rehash >= 1          # the ladder ran first
    assert_result(res, 32, out, name)
    assert_stats(st, out[name + "_st"])
    assert_same_segments(tmp_path / name, root / name)


@pytest.mark.parametrize("name", sorted(COUNTERS))
def test_counter_spill_matches_jax(jax_out, tmp_path, name):
    out, root = jax_out
    p, grid, knobs, batches = COUNTERS[name]
    kc = fabsp.KmerCounter(_cfg(knobs, tmp_path / name), num_pes=p,
                           grid=grid, device="cpu")
    for i, (lo, hi) in enumerate(batches):
        assert_stats(kc.update(READS[lo:hi]), out[f"{name}_u{i}"])
    for tag in ("", "_again"):                 # finalize twice
        res, st = kc.finalize()
        assert_result(res, 32, out, name + tag)
        assert_stats(st, out[name + tag + "_st"])
    assert histogram(res, p) == _oracle(READS)
    assert kc.store_capacity == int(out[name + "_cap"])
    assert_same_segments(tmp_path / name, root / name)
    if knobs["spill"] == "always":
        assert kc.store_capacity == fabsp.KmerCounter._SPILL_STORE_CAP


def test_spill_superkmer_k31_matches_jax(jax_out, tmp_path):
    out, root = jax_out
    kc = fabsp.KmerCounter(fabsp.DAKCConfig(
        k=31, chunk_reads=8, transport_impl="superkmer", minimizer_len=20,
        spill="always", spill_bins=4, spill_dir=str(tmp_path / "sk31")),
        num_pes=4, device="cpu")
    assert_stats(kc.update(READS31), out["sk31_u0"])
    res, st = kc.finalize()
    assert_result(res, 64, out, "sk31")
    assert_stats(st, out["sk31_st"])
    assert_same_segments(tmp_path / "sk31", root / "sk31")
    hist = histogram(res, 4)
    assert hist == _oracle(READS31, 31)
    assert any(w >= 1 << 61 for w in hist)     # the k-mer's top bits set


def test_kill_mid_spill_restore_onto_fewer_pes_matches_jax(jax_out,
                                                           tmp_path):
    out, _ = jax_out
    ck = str(tmp_path / "ckpt")
    kc = fabsp.KmerCounter(_cfg(KILL, tmp_path / "bins", faults=FaultPlan(
        site="spill_write", fail_after=12)), num_pes=8, device="cpu")
    assert_stats(kc.update(READS[:64]), out["kill_u0"])
    kc.save(ck, step=0)
    with pytest.raises(InjectedFault):
        kc.update(READS[64:])                  # dies mid-write, torn file
    torn = set(os.listdir(str(tmp_path / "bins")))
    kc2 = fabsp.KmerCounter.restore(ck, _cfg(KILL, tmp_path / "bins"),
                                    num_pes=4, device="cpu")
    assert kc2._num_pes == 4 and kc2._n_updates == 1
    assert set(os.listdir(str(tmp_path / "bins"))) < torn   # pruned
    assert_stats(kc2.update(READS[64:]), out["kill_u1"])
    res, st = kc2.finalize()
    assert_result(res, 32, out, "kill")
    assert_stats(st, out["kill_st"])
    assert histogram(res, 4) == _oracle(READS)


def test_bin_corrupt_raises_typed_spill_corrupt(tmp_path):
    kc = fabsp.KmerCounter(_cfg(dict(spill="always", spill_bins=4),
                                tmp_path, faults=FaultPlan(site="bin_corrupt",
                                                           bin=2)),
                           num_pes=2, device="cpu")
    kc.update(READS)
    with pytest.raises(spill.SpillCorrupt) as ei:
        kc.finalize()
    assert ei.value.bin == 2 and "bin 2" in str(ei.value)


def test_jax_spill_directory_attached_and_drained(jax_out, tmp_path):
    """The JAX package's checkpoint and bins, restored by the port in place
    and onto 2 PEs: the drain gives the JAX package's histogram."""
    out, root = jax_out
    cfg = _cfg(dict(spill="always", **SK), root / "jaxdir")
    kc = fabsp.KmerCounter.restore(str(root / "jaxdir_ckpt"), cfg,
                                   num_pes=4, device="cpu")
    assert kc._spill.n_bins == 16              # the checkpoint's partition
    res, st = kc.finalize()
    assert_result(res, 32, out, "jaxdir")
    assert_stats(st, out["jaxdir_st"])
    kc2 = fabsp.KmerCounter.restore(str(root / "jaxdir_ckpt"), cfg,
                                    num_pes=2, device="cpu")
    assert histogram(kc2.finalize()[0], 2) == _oracle(READS)


def test_count_kmers_spill_always_is_exact_and_counts_bins(tmp_path):
    cfg = _cfg(dict(spill="always", spill_bins=3), tmp_path)
    res, st = fabsp.count_kmers(READS, cfg, num_pes=2, device="cpu")
    assert histogram(res, 2) == _oracle(READS)
    assert st.bins_folded == 3 == st.spilled_bins and st.spilled_bytes > 0
