"""The counter's checkpoint, restore and spill tier across the ranks of a
`torch.distributed` group, on the CPU with gloo.

One launcher (this file run as a script) is started once per world size,
2 and 4; it spawns that many ranks over a `file://` store (60 s timeout),
each holding 8 / world of the 8 PEs. One JAX subprocess on an 8-device
mesh writes its checkpoint and later restores the ranks' (each side waits
for the other's marker file), beside the stacked runs. The checks:

- the ranks' checkpoint is the stacked path's, leaf for leaf and in every
  sticky knob; restored on the stacked path at 8 and 4 PEs it continues
  bit-equal (unique, counts, num_unique, every DAKCStats field, query
  answers) to the stacked checkpoint's restore;
- a stacked checkpoint restores under the ranks in place (8 PEs), the JAX
  package's onto 4 PEs (elastic), and the ranks' checkpoint under JAX's
  `KmerCounter.restore`, each continuing bit-equal to the package that
  wrote it;
- `spill='always'` and `'auto'` under the ranks (through `count_kmers` and
  `KmerCounter`, with the spilled-bin query tier) give the stacked path's
  and the JAX package's histograms and answers;
- a spilled checkpoint restores onto another world: the ranks' on the
  stacked path, the stacked path's under the ranks, and world 2's under
  world 4;
- `FaultPlan(site='ckpt_write')` fails the save on every rank and leaves
  the latest complete checkpoint; an 'update_fail' and a 'spill_write'
  fault leave the committed manifest as it was on every rank.
"""

import json
import os
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np
import pytest
import torch

from repro_torch import words as W
from repro_torch.core import dist, fabsp, resilience
from repro_torch.data import genome
from repro_torch.train import checkpoint as ckpt

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
WORLDS = (2, 4)
P = 8
HALF = 128
KC = dict(k=13, chunk_reads=16, transport_impl="superkmer",
          minimizer_order="hashed")
ALWAYS = dict(KC, spill="always", spill_bins=4)
AUTO = dict(k=13, chunk_reads=16, store_capacity=64, spill="auto",
            spill_bins=4)
AUTO_CEILING = 128
RESTORE_PES = (8, 4)
# (who wrote the checkpoint, PEs it is restored onto under the ranks): in
# place, and elastic
UNDER_RANKS = (("stacked", 8), ("jax", 4))


def inputs() -> dict:
    spec = genome.ReadSetSpec(genome_bases=8192, n_reads=256, read_len=90,
                              seed=7)
    reads = genome.sample_reads(spec)
    rng = np.random.default_rng(1)
    rows = rng.integers(0, reads.shape[0], 256)
    pos = rng.integers(0, 90 - 13 + 1, 256)
    queries = np.stack([reads[r, s:s + 13] for r, s in zip(rows, pos)])
    queries[::3] = rng.integers(0, 4, (len(queries[::3]), 13))
    return {"reads": reads, "queries": queries.astype(np.uint8)}


def cfg_of(knobs: dict, root: str = "", tag: str = "", **more):
    knobs = dict(knobs, **more)
    if knobs.get("spill", "off") != "off":
        knobs["spill_dir"] = os.path.join(root, tag + "_bins")
    if "store_capacity" in knobs and knobs.get("spill") == "auto":
        knobs["retry"] = resilience.RetryPolicy(
            store_cap_ceiling=AUTO_CEILING)
    return fabsp.DAKCConfig(**knobs)


def _put(out, key, res, stats, kc=None, queries=None):
    out[key + "_u"] = res.unique.cpu().numpy()
    out[key + "_c"] = res.counts.cpu().numpy()
    out[key + "_n"] = res.num_unique.cpu().numpy()
    out[key + "_s"] = np.array([float(x) for x in stats], np.float64)
    if kc is not None:
        out[key + "_q"] = kc.count(queries)


def _error(fn) -> str:
    try:
        fn()
    except Exception as e:    # the test reads the type
        return type(e).__name__
    return "no error"


def _manifest_files(spill_dir):
    with open(os.path.join(spill_dir, "manifest.json")) as f:
        return sorted(s["file"] for s in json.load(f)["segments"])


def _wait_for(path, seconds=500):
    """Poll for a marker file another process writes when it is done."""
    for _ in range(seconds * 10):
        if os.path.exists(path):
            return
        time.sleep(0.1)
    raise TimeoutError(f"{path} did not appear in {seconds} s")


def _continue(kc, reads, queries, out, key):
    kc.update(reads[HALF:])
    res, st = kc.finalize()
    _put(out, key, res, st, kc, queries)


def rank_main(rank: int, world: int, tmp: str) -> None:
    """One rank: join the gloo group, run every case, write its rows."""
    torch.set_num_threads(1)
    inp = dict(np.load(os.path.join(tmp, "inputs.npz")))
    reads, queries = inp["reads"], inp["queries"]
    shared = os.path.join(tmp, "..", "shared")
    g = dist.init_group("gloo", "file://" + os.path.join(tmp, "store"),
                        rank, world, "cpu")
    out = {}
    try:
        # the ranks' checkpoint, sync and through the async saver
        kc = fabsp.KmerCounter(cfg_of(KC), num_pes=P, group=g)
        kc.update(reads[:HALF])
        kc.save(os.path.join(tmp, "ck_ranks"), step=1)
        if rank == 0:     # the JAX package restores it meanwhile
            open(os.path.join(tmp, "ck_ranks.done"), "w").close()
        saver = ckpt.AsyncSaver(os.path.join(tmp, "ck_async"))
        out["async_ret"] = np.array(str(kc.save(saver=saver, step=1)))
        saver.wait()
        _continue(kc, reads, queries, out, "ranks")

        # the stacked path's and the JAX package's checkpoints restored here
        _wait_for(os.path.join(shared, "ck_jax.done"))
        for src, p in UNDER_RANKS:
            kc = fabsp.KmerCounter.restore(
                os.path.join(shared, "ck_" + src), cfg_of(KC), num_pes=p,
                group=g)
            _continue(kc, reads, queries, out, f"from_{src}_p{p}")

        # the spill tier
        for tag, knobs in (("always", ALWAYS), ("auto", AUTO)):
            res, st = fabsp.count_kmers(reads, cfg_of(knobs, tmp, tag),
                                        num_pes=P, group=g)
            _put(out, "spill_" + tag, res, st)
        kc = fabsp.KmerCounter(cfg_of(ALWAYS, tmp, "sk"), num_pes=P,
                               group=g)
        kc.update(reads[:HALF])
        kc.save(os.path.join(tmp, "sck"), step=1)
        _continue(kc, reads, queries, out, "spill_counter")
        # on this world's copy of the bins (a restore prunes them and the
        # run adds its own)
        if rank == 0:
            shutil.copytree(os.path.join(shared, "stacked_sk_bins"),
                            os.path.join(tmp, "stacked_sk_bins"))
        dist.barrier(g)
        kc = fabsp.KmerCounter.restore(
            os.path.join(shared, "sck_stacked"),
            cfg_of(ALWAYS, tmp, "stacked_sk"), num_pes=P, group=g)
        _continue(kc, reads, queries, out, "spill_from_stacked")
        dist.barrier(g)
        if world == 2 and rank == 0:
            open(os.path.join(shared, "w2_spilled.done"), "w").close()
        if world == 4:
            # world 2's spilled checkpoint, on its own copy of the bins
            _wait_for(os.path.join(shared, "w2_spilled.done"))
            w2 = os.path.join(shared, "..", "world2")
            if rank == 0:
                shutil.copytree(os.path.join(w2, "sck"),
                                os.path.join(tmp, "w2_sck"))
                shutil.copytree(os.path.join(w2, "sk_bins"),
                                os.path.join(tmp, "w2_bins"))
            dist.barrier(g)
            kc = fabsp.KmerCounter.restore(
                os.path.join(tmp, "w2_sck"),
                fabsp.dataclasses.replace(
                    cfg_of(ALWAYS), spill_dir=os.path.join(tmp, "w2_bins")),
                num_pes=P, group=g)
            res, st = kc.finalize()     # the drain of world 2's bins alone
            _put(out, "drain_w2", res, st)
            _continue(kc, reads, queries, out, "spill_from_w2")

        # the faults
        fdir = os.path.join(tmp, "ckf")
        kc = fabsp.KmerCounter(cfg_of(KC), num_pes=P, group=g)
        kc.update(reads[:HALF])
        kc.save(fdir, step=0)
        plan = resilience.FaultPlan(site="ckpt_write", fail_after=1)
        kcf = fabsp.KmerCounter(cfg_of(KC, faults=plan), num_pes=P, group=g)
        kcf.update(reads[:HALF])
        out["ckpt_write"] = np.array(_error(lambda: kcf.save(fdir, step=1)))
        # rank 0's background write fails: its directory is a file
        bad = os.path.join(tmp, "not_a_dir")
        open(bad, "w").close()
        saver = ckpt.AsyncSaver(os.path.join(bad, "ck"))
        kc.save(saver=saver, step=2)
        out["ckpt_write_async"] = np.array(_error(saver.wait))
        kc = fabsp.KmerCounter.restore(fdir, cfg_of(KC), num_pes=P, group=g)
        out["ckpt_write_updates"] = np.array(kc._n_updates)
        _continue(kc, reads, queries, out, "after_ckpt_write")

        for site, more in (("update_fail", dict(update_n=1)),
                           ("spill_write", dict(fail_after=4))):
            cfg = cfg_of(ALWAYS, tmp, site,
                         faults=resilience.FaultPlan(site=site, **more))
            kc = fabsp.KmerCounter(cfg, num_pes=P, group=g)
            kc.update(reads[:HALF])
            before = _manifest_files(cfg.spill_dir)
            out[site] = np.array(_error(lambda: kc.update(reads[HALF:])))
            dist.barrier(g)
            out[site + "_same_manifest"] = np.array(
                _manifest_files(cfg.spill_dir) == before
                and kc._spill.state()["segments"] == [
                    s for s in kc._spill.state()["segments"]
                    if s["file"] in before])
        dist.barrier(g)
    except Exception:
        traceback.print_exc()
        raise
    finally:
        np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
        g.destroy()


def _launch(world: int, tmp: str) -> None:
    torch.multiprocessing.spawn(rank_main, args=(world, tmp), nprocs=world,
                                join=True)


# --- the pytest side ------------------------------------------------------

_JAX_BODY = """
import os
import time
from jax.sharding import Mesh
from repro.core import fabsp, resilience
def mesh(p):
    return Mesh(np.array(jax.devices()[:p]), ("pe",))
def put(key, res, st, kc=None):
    O[key + "_u"], O[key + "_c"] = res.unique, res.counts
    O[key + "_n"] = res.num_unique
    O[key + "_s"] = np.array([float(x) for x in st], np.float64)
    if kc is not None:
        O[key + "_q"] = kc.count(I["queries"])
R = I["reads"]
kc = fabsp.KmerCounter(mesh(8), fabsp.DAKCConfig(**KC))
kc.update(jnp.asarray(R[:HALF]))
kc.save(os.path.join(ROOT, "ck_jax"), step=1)
open(os.path.join(ROOT, "ck_jax.done"), "w").close()
for p in RESTORE_PES:
    kc2 = fabsp.KmerCounter.restore(os.path.join(ROOT, "ck_jax"), mesh(p),
                                    fabsp.DAKCConfig(**KC))
    kc2.update(jnp.asarray(R[HALF:]))
    put(f"jax_p{p}", *kc2.finalize(), kc2)
for tag, knobs in (("always", ALWAYS), ("auto", AUTO)):
    knobs = dict(knobs, spill_dir=os.path.join(ROOT, "jax_" + tag))
    if tag == "auto":
        knobs["retry"] = resilience.RetryPolicy(
            store_cap_ceiling=AUTO_CEILING)
    put("spill_" + tag, *fabsp.count_kmers(
        jnp.asarray(R), mesh(8), fabsp.DAKCConfig(**knobs)))
# the ranks' checkpoint, once world 2 has written it
for _ in range(5000):
    if os.path.exists(RANKS_CK + ".done"):
        break
    time.sleep(0.1)
kc2 = fabsp.KmerCounter.restore(RANKS_CK, mesh(8), fabsp.DAKCConfig(**KC))
kc2.update(jnp.asarray(R[HALF:]))
put("jax_from_ranks", *kc2.finalize(), kc2)
"""


def _jax_job(root, ranks_ck):
    return (f"KC = {KC!r}\nALWAYS = {ALWAYS!r}\nAUTO = {AUTO!r}\n"
            f"AUTO_CEILING = {AUTO_CEILING}\nHALF = {HALF}\n"
            f"RESTORE_PES = {RESTORE_PES!r}\n"
            f"ROOT = {root!r}\nRANKS_CK = {ranks_ck!r}\n" + _JAX_BODY,
            False)


def _stacked(inp, shared):
    """The stacked path's checkpoints (plain and spilled, after the first
    half) and its runs: uninterrupted, and restored onto 8 and 4 PEs."""
    reads, queries = inp["reads"], inp["queries"]
    out = {}
    kc = fabsp.KmerCounter(cfg_of(KC), num_pes=P, device="cpu")
    kc.update(reads[:HALF])
    kc.save(os.path.join(shared, "ck_stacked"), step=1)
    _continue(kc, reads, queries, out, "stacked")
    for p in RESTORE_PES:
        kc = fabsp.KmerCounter.restore(os.path.join(shared, "ck_stacked"),
                                       cfg_of(KC), num_pes=p, device="cpu")
        _continue(kc, reads, queries, out, f"stacked_p{p}")
    kc = fabsp.KmerCounter(cfg_of(ALWAYS, shared, "stacked_sk"), num_pes=P,
                           device="cpu")
    kc.update(reads[:HALF])
    kc.save(os.path.join(shared, "sck_stacked"), step=1)
    shutil.copytree(os.path.join(shared, "stacked_sk_bins"),
                    os.path.join(shared, "stacked_sk_copy_bins"))
    _continue(kc, reads, queries, out, "stacked_spill")
    kc = fabsp.KmerCounter.restore(
        os.path.join(shared, "sck_stacked"),
        cfg_of(ALWAYS, shared, "stacked_sk_copy"), num_pes=P, device="cpu")
    _continue(kc, reads, queries, out, "stacked_spill_restored")
    for tag, knobs in (("always", ALWAYS), ("auto", AUTO)):
        res, st = fabsp.count_kmers(reads, cfg_of(knobs, shared, tag),
                                    num_pes=P, device="cpu")
        _put(out, "spill_" + tag, res, st)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, {world: [rank outputs]}, stacked outputs, JAX outputs)."""
    from _torch_parity import run_jax_many
    inp = inputs()
    base = tmp_path_factory.mktemp("durability")
    shared = str(base / "shared")
    os.makedirs(shared)
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    dirs = {w: str(base / f"world{w}") for w in WORLDS}
    import concurrent.futures
    # the JAX package writes its checkpoint, then restores the ranks' (a
    # marker file each way), beside the stacked runs and the launchers
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_fut = pool.submit(run_jax_many, str(base / "jax"), {
            "j": _jax_job(shared, os.path.join(dirs[2], "ck_ranks"))},
            inp, devices=8)
        stacked = _stacked(inp, shared)
        procs = {}
        for world in WORLDS:
            os.makedirs(dirs[world])
            np.savez(os.path.join(dirs[world], "inputs.npz"), **inp)
            procs[world] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(world),
                 dirs[world]], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
        logs = {w: p.communicate(timeout=600)[0] for w, p in procs.items()}
        for world, p in procs.items():
            assert p.returncode == 0, logs[world][-6000:]
        jax_out = dict(jax_fut.result()["j"])
    ranks = {w: [dict(np.load(os.path.join(dirs[w], f"rank{r}.npz")))
                 for r in range(w)] for w in WORLDS}
    return inp, ranks, stacked, jax_out, dirs, shared


def _gathered(rank_outs, key):
    """Every rank's rows, in rank order, and the stats and answers (equal
    on every rank)."""
    for r in rank_outs[1:]:
        np.testing.assert_array_equal(r[key + "_s"], rank_outs[0][key + "_s"])
        if key + "_q" in r:
            np.testing.assert_array_equal(r[key + "_q"],
                                          rank_outs[0][key + "_q"])
    out = {f: np.concatenate([r[key + f] for r in rank_outs])
           for f in ("_u", "_c", "_n")}
    # each rank's rows have its own width under the spill tier's drain
    out["_pe"] = [pe for r in rank_outs for pe in _per_pe(
        _word(r[key + "_u"]), r[key + "_c"], r[key + "_n"],
        len(r[key + "_n"]))]
    out["_s"] = rank_outs[0][key + "_s"]
    if key + "_q" in rank_outs[0]:
        out["_q"] = rank_outs[0][key + "_q"]
    return out


def _histogram(u, c, n, num_pes):
    """{word: count} over PEs whose rows may differ in width."""
    u, c = np.asarray(u), np.asarray(c)
    width = u.size // num_pes
    h = {}
    for pe in range(num_pes):
        m = int(n[pe])
        h.update(zip(u[pe * width:pe * width + m].tolist(),
                     c[pe * width:pe * width + m].tolist()))
    return h


def _per_pe(u, c, n, num_pes):
    """Each PE's (words, counts), cut to its num_unique."""
    u, c = np.asarray(u), np.asarray(c)
    width = u.size // num_pes
    return [(u[pe * width:pe * width + int(n[pe])].tolist(),
             c[pe * width:pe * width + int(n[pe])].tolist())
            for pe in range(num_pes)]


def _word(x):
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


def _assert_same(got, want, num_pes, *, layout=True, stats=True):
    """Two results (dicts of _u/_c/_n/_s/_q): per PE, bit-equal; with
    `layout`, the arrays whole (the same row widths)."""
    if layout:
        np.testing.assert_array_equal(_word(got["_u"]), _word(want["_u"]))
        np.testing.assert_array_equal(got["_c"], want["_c"])
    else:
        assert got["_pe"] == _per_pe(_word(want["_u"]), want["_c"],
                                     want["_n"], num_pes)
    np.testing.assert_array_equal(got["_n"], want["_n"])
    if stats:
        np.testing.assert_array_equal(got["_s"], want["_s"])
    if "_q" in want:
        np.testing.assert_array_equal(got["_q"], want["_q"])


def _keyed(out, key):
    return {f: out[key + f] for f in ("_u", "_c", "_n", "_s", "_q")
            if key + f in out}


def _restored_on_stacked(ck_dir, p, knobs=KC, spill_dir=None):
    inp = inputs()
    cfg = cfg_of(knobs)
    if spill_dir is not None:
        cfg = fabsp.dataclasses.replace(cfg, spill_dir=spill_dir)
    kc = fabsp.KmerCounter.restore(ck_dir, cfg, num_pes=p, device="cpu")
    out = {}
    _continue(kc, inp["reads"], inp["queries"], out, "x")
    return _keyed(out, "x")


def _load_ckpt(d, step):
    wb = 32
    trees, extra = ckpt.restore(d, step, {"store": {
        "keys": np.zeros(0, np.uint32), "counts": np.zeros(0, np.int32)}})
    return trees["store"], extra, wb


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_checkpoint_is_the_stacked_one(runs, world):
    _, _, _, _, dirs, shared = runs
    got, gx, _ = _load_ckpt(os.path.join(dirs[world], "ck_ranks"), 1)
    want, wx, _ = _load_ckpt(os.path.join(shared, "ck_stacked"), 1)
    np.testing.assert_array_equal(got["keys"], want["keys"])
    np.testing.assert_array_equal(got["counts"], want["counts"])
    assert gx == wx
    a, ax, _ = _load_ckpt(os.path.join(dirs[world], "ck_async"), 1)
    np.testing.assert_array_equal(a["keys"], want["keys"])
    assert ax == wx
    assert all(str(r["async_ret"]) == "None" for r in runs[1][world])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("p", RESTORE_PES)
def test_ranks_checkpoint_restores_on_the_stacked_path(runs, world, p):
    _, _, stacked, _, dirs, _ = runs
    got = _restored_on_stacked(os.path.join(dirs[world], "ck_ranks"), p)
    _assert_same(got, _keyed(stacked, f"stacked_p{p}"), p)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("src,p", UNDER_RANKS)
def test_checkpoint_restores_under_the_ranks(runs, world, src, p):
    _, ranks, stacked, jax_out, _, _ = runs
    got = _gathered(ranks[world], f"from_{src}_p{p}")
    want = (_keyed(stacked, f"stacked_p{p}") if src == "stacked"
            else _keyed(jax_out, f"jax_p{p}"))
    _assert_same(got, want, p, layout=src == "stacked")


def test_ranks_checkpoint_restores_under_jax(runs):
    _, ranks, _, jax_out, _, _ = runs
    want = _keyed(jax_out, "jax_p8")
    got = _keyed(jax_out, "jax_from_ranks")
    _assert_same(got, want, P)
    # and the ranks' own uninterrupted run answers the same
    ranks_run = _gathered(ranks[2], "ranks")
    np.testing.assert_array_equal(ranks_run["_q"], want["_q"])
    assert _histogram(_word(ranks_run["_u"]), ranks_run["_c"],
                      ranks_run["_n"], P) == _histogram(
        _word(want["_u"]), want["_c"], want["_n"], P)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("tag", ("always", "auto"))
def test_spill_under_the_ranks(runs, world, tag):
    _, ranks, stacked, jax_out, _, _ = runs
    got = _gathered(ranks[world], "spill_" + tag)
    for want in (_keyed(stacked, "spill_" + tag),
                 _keyed(jax_out, "spill_" + tag)):
        assert got["_pe"] == _per_pe(_word(want["_u"]), want["_c"],
                                     want["_n"], P)
        np.testing.assert_array_equal(got["_s"][LAYOUT_FREE],
                                      want["_s"][LAYOUT_FREE])
    assert got["_s"][fabsp.DAKCStats._fields.index("bins_folded")] > 0


# The segments' framing and order follow the writer (one stacked writer,
# or one a rank): the spilled bytes, and the drain's routing rounds, which
# read the records in segment order, may differ; every other field is equal.
LAYOUT_FREE = [i for i, f in enumerate(fabsp.DAKCStats._fields)
               if f not in ("spilled_bytes", "retry_route_slack")]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", ("spill_counter", "spill_from_stacked"))
def test_spilled_counter_under_the_ranks(runs, world, key):
    _, ranks, stacked, _, _, _ = runs
    got = _gathered(ranks[world], key)
    want = _keyed(stacked, "stacked_spill" if key == "spill_counter"
                  else "stacked_spill_restored")
    fields = LAYOUT_FREE
    assert got["_pe"] == _per_pe(_word(want["_u"]), want["_c"], want["_n"],
                                 P)
    np.testing.assert_array_equal(got["_q"], want["_q"])
    np.testing.assert_array_equal(got["_s"][fields], want["_s"][fields])


@pytest.mark.parametrize("world", WORLDS)
def test_spilled_ranks_checkpoint_restores_on_the_stacked_path(runs, world):
    _, _, stacked, _, dirs, _ = runs
    d = os.path.join(dirs[world], "restore_copy")
    shutil.copytree(os.path.join(dirs[world], "sck"), d + "_ck")
    shutil.copytree(os.path.join(dirs[world], "sk_bins"), d + "_bins")
    got = _restored_on_stacked(d + "_ck", P, ALWAYS, spill_dir=d + "_bins")
    want = _keyed(stacked, "stacked_spill")
    assert _per_pe(_word(got["_u"]), got["_c"], got["_n"], P) == \
        _per_pe(_word(want["_u"]), want["_c"], want["_n"], P)
    np.testing.assert_array_equal(got["_q"], want["_q"])


def test_spilled_checkpoint_of_world2_restores_under_world4(runs):
    _, ranks, stacked, _, dirs, _ = runs
    # the drain of the same bins is the stacked path's, every field
    d = os.path.join(dirs[2], "drain_copy")
    shutil.copytree(os.path.join(dirs[2], "sck"), d + "_ck")
    shutil.copytree(os.path.join(dirs[2], "sk_bins"), d + "_bins")
    kc = fabsp.KmerCounter.restore(d + "_ck", fabsp.dataclasses.replace(
        cfg_of(ALWAYS), spill_dir=d + "_bins"), num_pes=P, device="cpu")
    res, st = kc.finalize()
    want = {}
    _put(want, "d", res, st)
    got = _gathered(ranks[4], "drain_w2")
    _assert_same(got, _keyed(want, "d"), P, layout=False)
    got = _gathered(ranks[4], "spill_from_w2")
    want = _keyed(stacked, "stacked_spill")
    assert got["_pe"] == _per_pe(_word(want["_u"]), want["_c"], want["_n"],
                                 P)
    np.testing.assert_array_equal(got["_q"], want["_q"])


@pytest.mark.parametrize("world", WORLDS)
def test_ckpt_write_fault_fails_every_rank(runs, world):
    _, ranks, stacked, _, _, _ = runs
    outs = ranks[world]
    assert str(outs[0]["ckpt_write"]) == "InjectedFault"
    assert all(str(r["ckpt_write"]) == "PeerFailure" for r in outs[1:])
    assert str(outs[0]["ckpt_write_async"]) not in ("no error",
                                                    "PeerFailure")
    assert all(str(r["ckpt_write_async"]) == "PeerFailure"
               for r in outs[1:])
    # the latest complete checkpoint is step 0, one update in
    assert all(int(r["ckpt_write_updates"]) == 1 for r in outs)
    got = _gathered(outs, "after_ckpt_write")
    _assert_same(got, _keyed(stacked, "stacked"), P, stats=False)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("site", ("update_fail", "spill_write"))
def test_failed_update_commits_no_segment_on_any_rank(runs, world, site):
    outs = runs[1][world]
    kinds = {str(r[site]) for r in outs}
    assert kinds <= {"InjectedFault", "PeerFailure"}, kinds
    assert "InjectedFault" in kinds
    assert all(bool(r[site + "_same_manifest"]) for r in outs)


if __name__ == "__main__":
    _launch(int(sys.argv[1]), sys.argv[2])
