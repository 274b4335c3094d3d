"""The PEs across processes (`repro_torch.core.dist`) on the CPU with gloo.

One launcher (this file run as a script) is started once per world size,
2 and 4; it spawns that many ranks, which join one gloo group through a
`file://` store (60 s timeout) and run every case with 8 PEs, 4 and 2 a
rank. Each rank writes its rows of every result; a rank that raises fails
the launcher at once (`mp.spawn(join=True)`). The cases mirror the JAX
package's `tests/multidevice_checks.py`:

- every count case, BSP and `count_ngrams`, gathered over the ranks, is
  bit-equal (unique, counts, num_unique, every stats field) to the JAX
  package's on an 8-device mesh and to the port's stacked path;
- the 2d one-plan route and 'perhop' move equal sent words and wire
  bytes; the compact hop 2 drops nothing and moves fewer bytes than the
  padded one; the PEs' k-mer sets are disjoint;
- `KmerCounter` over 2 updates gives the stacked path's histogram and
  query answers;
- the MoE engine over the ranks is within 1e-4 of GShard with no drops
  (`check_moe_dakc_multidev`'s bound); `compress_psum(group=)` at frac
  1.0 is the mean within 1e-5 (`check_compression_psum`) and at frac 0.01
  equals `sharded=True` within 1e-6 (the ranks add in another order);
- what waits for slice 17 raises NotImplementedError naming it, and a P
  the world does not divide raises ValueError.
"""

import dataclasses
import functools
import os
import subprocess
import sys
import traceback

import numpy as np
import pytest
import torch

from repro_torch import words as W
from repro_torch.core import bsp, dist, encoding, fabsp, ngram, resilience
from repro_torch.data import genome

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
WORLDS = (2, 4)
P = 8
GRID = (2, 4)

# name -> (DAKCConfig fields, grid, reads)
COUNT = {
    "dual": (dict(k=13, l3_mode="dual"), None, "reads"),
    "nol3": (dict(k=13, use_l3=False), None, "reads"),
    "packed_k21": (dict(k=21, l3_mode="packed"), None, "reads"),
    "k31": (dict(k=31), None, "reads"),
    "2d_oneplan": (dict(k=13, topology="2d"), GRID, "reads"),
    "2d_perhop": (dict(k=13, topology="2d", route2d_impl="perhop"), GRID,
                  "reads"),
    "2d_compact": (dict(k=13, topology="2d", hop2_impl="compact"), GRID,
                   "reads"),
    "canonical_1d": (dict(k=9, canonical=True), None, "reads"),
    "canonical_2d": (dict(k=9, canonical=True, topology="2d"), GRID,
                     "reads"),
    "superkmer_1d": (dict(k=13, transport_impl="superkmer"), None, "reads"),
    "superkmer_2d": (dict(k=13, topology="2d", transport_impl="superkmer"),
                     GRID, "reads"),
    "slack_retry": (dict(k=13, use_l3=False, slack=1.01), None, "all_a"),
    "rehash": (dict(k=13, store_capacity=301), None, "reads"),
    "route_drop": (dict(k=13, topology="2d", hop2_impl="compact",
                        faults=dict(site="route_drop", seed=1,
                                    frac=0.3)), GRID, "reads"),
}
X64 = ("packed_k21", "k31")
CHUNK = 32
BSP_BATCH = 32
NGRAM = dict(vocab_size=50, n=2, chunk_rows=8)
# name -> (DAKCConfig fields, grid) of a KmerCounter fed 2 updates
KC = {
    "kc": (dict(k=13, transport_impl="superkmer", minimizer_order="hashed"),
           None),
    "kc2d": (dict(k=13, topology="2d", hop2_impl="compact",
                  transport_impl="superkmer", minimizer_order="hashed"),
             (4, 2)),
}
N_QUERIES = 1024


def inputs() -> dict:
    spec = genome.ReadSetSpec(genome_bases=8192, n_reads=512, read_len=90,
                              seed=7)
    rng = np.random.default_rng(0)
    reads = genome.sample_reads(spec)
    q_rows = np.random.default_rng(1).integers(0, reads.shape[0], N_QUERIES)
    q_pos = np.random.default_rng(2).integers(0, 90 - 13 + 1, N_QUERIES)
    queries = np.stack([reads[r, s:s + 13] for r, s in zip(q_rows, q_pos)])
    queries[::3] = np.random.default_rng(3).integers(
        0, 4, (len(queries[::3]), 13))
    return {
        "reads": reads,
        "all_a": np.zeros((256, 40), np.uint8),
        "tokens": rng.integers(0, 50, (64, 17), dtype=np.int32),
        "queries": queries.astype(np.uint8),
        "grads": np.random.default_rng(4).normal(size=(8, 64)).astype(
            np.float32),
    }


def dakc_cfg(fields: dict) -> fabsp.DAKCConfig:
    fields = dict(fields)
    if "faults" in fields:
        fields["faults"] = resilience.FaultPlan(**fields.pop("faults"))
    return fabsp.DAKCConfig(chunk_reads=CHUNK, **fields)


def moe_setup():
    """Reduced deepseek-moe-16b at f32, capacity factor 8, its first MoE
    layer's parameters from a seed, and the GShard output."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import moe
    cfg = reduced_config("deepseek-moe-16b", compute_dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    params = moe.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.from_numpy((np.random.default_rng(5).normal(
        size=(8, 16, cfg.d_model)) * 0.3).astype(np.float32))
    return cfg, params, x


def _put_result(out, key, res, stats):
    out[key + "_u"] = res.unique.numpy()
    out[key + "_c"] = res.counts.numpy()
    out[key + "_n"] = res.num_unique.numpy()
    out[key + "_s"] = np.array([float(x) for x in stats], np.float64)


def _refusal(out, key, fn):
    try:
        fn()
    except Exception as e:    # the test reads the type and message
        out[key] = np.array(f"{type(e).__name__}: {e}")
    else:
        out[key] = np.array("no error")


def rank_main(rank: int, world: int, tmp: str) -> None:
    """One rank: join the gloo group, run every case, write its rows."""
    torch.set_num_threads(1)
    inp = dict(np.load(os.path.join(tmp, "inputs.npz")))
    g = dist.init_group("gloo", "file://" + os.path.join(tmp, "store"),
                        rank, world, "cpu")
    out = {}
    try:
        for name, (fields, grid, reads) in COUNT.items():
            res, st = fabsp.count_kmers(inp[reads], dakc_cfg(fields),
                                        num_pes=P, grid=grid, device="cpu",
                                        group=g)
            _put_result(out, name, res, st)
        res, st = bsp.count_kmers(inp["reads"],
                                  bsp.BSPConfig(k=13, batch_reads=BSP_BATCH),
                                  num_pes=P, group=g)
        _put_result(out, "bsp", res, st)
        res, st = ngram.count_ngrams(inp["tokens"], num_pes=P, group=g,
                                     **NGRAM)
        _put_result(out, "ngram", res, st)

        for name, (fields, grid) in KC.items():
            kc = fabsp.KmerCounter(fabsp.DAKCConfig(chunk_reads=CHUNK,
                                                    **fields),
                                   num_pes=P, grid=grid, group=g)
            half = inp["reads"].shape[0] // 2
            u1 = kc.update(inp["reads"][:half])
            u2 = kc.update(inp["reads"][half:])
            res, st = kc.finalize()
            _put_result(out, name, res, st)
            out[name + "_u1"] = np.array([float(x) for x in u1], np.float64)
            out[name + "_u2"] = np.array([float(x) for x in u2], np.float64)
            out[name + "_q"] = kc.count(inp["queries"])
            out[name + "_contains"] = kc.contains(inp["queries"])
            out[name + "_qstats"] = np.array(
                [float(x) for x in kc.last_query_stats], np.float64)
        _refusal(out, "refuse_save",
                 lambda: kc.save(os.path.join(tmp, f"ck{rank}")))

        from repro_torch.models import convert, moe
        cfg, params, x = moe_setup()
        shards = 4
        b_loc = x.shape[0] // world
        y, aux = moe.moe_block(
            convert.moe_expert_slice(params, rank, world),
            x[rank * b_loc:(rank + 1) * b_loc], cfg=cfg, ep_shards=shards,
            group=g)
        out["moe_y"] = y.numpy()
        out["moe_drop"] = np.array(float(aux.dropped_frac))
        out["moe_aux"] = np.array(float(aux.load_balance_loss))

        from repro_torch.train import compression
        grads = torch.from_numpy(inp["grads"])
        rows = grads.shape[0] // world
        mine = {"w": grads[rank * rows:(rank + 1) * rows].reshape(-1)}
        for tag, frac in (("1", 1.0), ("001", 0.01)):
            got, err = compression.compress_psum(
                mine, compression.init_error_feedback(mine), frac=frac,
                group=g)
            out["comp" + tag] = got["w"].numpy()
            out["comp" + tag + "_err"] = err["w"].numpy()

        spill_cfg = fabsp.DAKCConfig(k=13, chunk_reads=CHUNK, spill="auto",
                                     spill_dir=os.path.join(tmp, "spill"))
        _refusal(out, "refuse_spill_count", lambda: fabsp.count_kmers(
            inp["reads"], spill_cfg, num_pes=P, device="cpu", group=g))
        _refusal(out, "refuse_spill_counter", lambda: fabsp.KmerCounter(
            spill_cfg, num_pes=P, group=g))
        _refusal(out, "refuse_restore", lambda: fabsp.KmerCounter.restore(
            os.path.join(tmp, "none"), dakc_cfg({"k": 13}), num_pes=P,
            group=g))
        _refusal(out, "refuse_num_pes", lambda: fabsp.count_kmers(
            inp["reads"], dakc_cfg({"k": 13}), num_pes=2 * world + 1,
            device="cpu", group=g))
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
import dataclasses
from jax.sharding import Mesh
from repro.core import bsp, fabsp, ngram, resilience
devs = np.array(jax.devices())
mesh1 = Mesh(devs, ("pe",))
mesh2 = Mesh(devs.reshape(2, 4), ("row", "col"))
def put(key, res, st):
    O[key + "_u"], O[key + "_c"] = res.unique, res.counts
    O[key + "_n"] = res.num_unique
    O[key + "_s"] = np.array([float(x) for x in st], np.float64)
for name, (fields, grid, reads) in CASES.items():
    fields = dict(fields)
    if "faults" in fields:
        fields["faults"] = resilience.FaultPlan(**fields.pop("faults"))
    cfg = fabsp.DAKCConfig(chunk_reads=CHUNK, **fields)
    if grid is None:
        res, st = fabsp.count_kmers(jnp.asarray(I[reads]), mesh1, cfg)
    else:
        res, st = fabsp.count_kmers(jnp.asarray(I[reads]), mesh2, cfg,
                                    ("row", "col"))
    put(name, res, st)
if EXTRA:
    res, st = bsp.count_kmers(jnp.asarray(I["reads"]), mesh1,
                              bsp.BSPConfig(k=13, batch_reads=BSP_BATCH))
    put("bsp", res, st)
    res, st = ngram.count_ngrams(jnp.asarray(I["tokens"]), mesh=mesh1,
                                 **NGRAM)
    put("ngram", res, st)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, {world: [rank outputs]}, JAX outputs): the two launchers
    and the two JAX subprocesses (32- and 64-bit words) run at once."""
    from _torch_parity import run_jax_many
    inp = inputs()
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = {}
    dirs = {}
    for world in WORLDS:
        d = str(tmp_path_factory.mktemp(f"world{world}"))
        np.savez(os.path.join(d, "inputs.npz"), **inp)
        dirs[world] = d
        procs[world] = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(world), d],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    # the 32-bit cases in two subprocesses (the first with BSP and the
    # n-grams), the 64-bit ones under x64 in a third
    w32 = sorted(n for n in COUNT if n not in X64)
    parts = (("a", w32[::2], False, True), ("b", w32[1::2], False, False),
             ("x64", X64, True, False))
    jobs = {}
    for tag, names, x64, extra in parts:
        cases = {n: COUNT[n] for n in names}
        body = (f"CASES = {cases!r}\nCHUNK = {CHUNK}\n"
                f"BSP_BATCH = {BSP_BATCH}\nNGRAM = {NGRAM!r}\n"
                f"EXTRA = {extra}\n" + _JAX_BODY)
        jobs[tag] = (body, x64)
    try:
        jax_runs = run_jax_many(tmp_path_factory.mktemp("jax"), jobs, inp,
                                devices=8)
    finally:
        logs = {w: p.communicate(timeout=600)[0] for w, p in procs.items()}
    for world, p in procs.items():
        assert p.returncode == 0, logs[world][-6000:]
    jax_out = {k: v for out in jax_runs.values() for k, v in out.items()}
    ranks = {w: [dict(np.load(os.path.join(dirs[w], f"rank{r}.npz")))
                 for r in range(w)] for w in WORLDS}
    return inp, ranks, jax_out


def _gathered(rank_outs, key):
    """Every rank's rows of a per-PE result, in rank order, and the stats
    (equal on every rank)."""
    for r in rank_outs[1:]:
        np.testing.assert_array_equal(r[key + "_s"], rank_outs[0][key + "_s"])
    return tuple(np.concatenate([r[key + f] for r in rank_outs])
                 for f in ("_u", "_c", "_n")) + (rank_outs[0][key + "_s"],)


def _word_bits(name):
    fields = COUNT[name][0] if name in COUNT else {"k": 13}
    if name == "ngram":
        return encoding.word_bits(NGRAM["n"],
                                  ngram.bits_for_vocab(NGRAM["vocab_size"]))
    return encoding.word_bits(fields["k"])


@functools.lru_cache(maxsize=None)
def _inputs():
    return inputs()


@functools.lru_cache(maxsize=None)
def _stacked(name):
    """The port's stacked path on one case (once for both worlds)."""
    inp = _inputs()
    if name == "bsp":
        return bsp.count_kmers(inp["reads"],
                               bsp.BSPConfig(k=13, batch_reads=BSP_BATCH),
                               num_pes=P, device="cpu")
    if name == "ngram":
        return ngram.count_ngrams(inp["tokens"], num_pes=P, device="cpu",
                                  **NGRAM)
    fields, grid, reads = COUNT[name]
    return fabsp.count_kmers(inp[reads], dakc_cfg(fields), num_pes=P,
                             grid=grid, device="cpu")


CASES = sorted(COUNT) + ["bsp", "ngram"]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", CASES)
def test_ranks_match_jax_mesh(runs, world, name):
    ranks, jax_out = runs[1][world], runs[2]
    u, c, n, s = _gathered(ranks, name)
    wb = _word_bits(name)
    np.testing.assert_array_equal(
        W.to_numpy_words(torch.from_numpy(u), wb), jax_out[name + "_u"])
    np.testing.assert_array_equal(c, jax_out[name + "_c"])
    np.testing.assert_array_equal(n, jax_out[name + "_n"])
    np.testing.assert_array_equal(s, jax_out[name + "_s"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", CASES)
def test_ranks_match_stacked_path(runs, world, name):
    u, c, n, s = _gathered(runs[1][world], name)
    res, st = _stacked(name)
    np.testing.assert_array_equal(u, res.unique.numpy())
    np.testing.assert_array_equal(c, res.counts.numpy())
    np.testing.assert_array_equal(n, res.num_unique.numpy())
    np.testing.assert_array_equal(s, [float(x) for x in st])


def _stats(rank_outs, name):
    return fabsp.DAKCStats(*_gathered(rank_outs, name)[3])


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_route_stats_follow_the_jax_checks(runs, world):
    """`check_kc_all_paths`' relations between the routes, across ranks."""
    ranks = runs[1][world]
    one, per = _stats(ranks, "2d_oneplan"), _stats(ranks, "2d_perhop")
    assert one.sent_words == per.sent_words
    assert one.wire_bytes == per.wire_bytes
    comp = _stats(ranks, "2d_compact")
    assert comp.hop2_dropped == 0 and comp.overflow == 0
    assert comp.wire_bytes < one.wire_bytes
    sk = _stats(ranks, "superkmer_2d")
    assert sk.overflow == 0 and sk.store_overflow == 0
    assert sk.wire_bytes < one.wire_bytes
    assert _stats(ranks, "slack_retry").retry_route_slack >= 1
    assert _stats(ranks, "rehash").retry_store_rehash >= 1
    assert _stats(ranks, "route_drop").retry_route_slack >= 1
    bsp_syncs = _gathered(ranks, "bsp")[3][4]
    assert bsp_syncs == (512 // P) // BSP_BATCH + 1


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_own_disjoint_kmer_sets(runs, world):
    u, _, n, _ = _gathered(runs[1][world], "2d_oneplan")
    L = u.shape[0] // P
    seen = set()
    for pe in range(P):
        mine = set(u[pe * L:pe * L + n[pe]].tolist())
        assert not (mine & seen)
        seen |= mine


@functools.lru_cache(maxsize=None)
def _stacked_counter(name):
    """The stacked KmerCounter's two updates' stats, histogram, query
    answers and query stats (once for both worlds)."""
    inp = _inputs()
    fields, grid = KC[name]
    kc = fabsp.KmerCounter(fabsp.DAKCConfig(chunk_reads=CHUNK, **fields),
                           num_pes=P, grid=grid, device="cpu")
    half = inp["reads"].shape[0] // 2
    u1 = kc.update(inp["reads"][:half])
    u2 = kc.update(inp["reads"][half:])
    res, st = kc.finalize()
    q = kc.count(inp["queries"])
    return u1, u2, res, st, q, kc.last_query_stats


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", sorted(KC))
def test_counter_across_ranks_matches_stacked(runs, world, name):
    ranks = runs[1][world]
    u1, u2, res, st, want_q, qstats = _stacked_counter(name)
    u, c, n, s = _gathered(ranks, name)
    np.testing.assert_array_equal(u, res.unique.numpy())
    np.testing.assert_array_equal(c, res.counts.numpy())
    np.testing.assert_array_equal(n, res.num_unique.numpy())
    np.testing.assert_array_equal(s, [float(x) for x in st])
    for r in ranks:
        np.testing.assert_array_equal(r[name + "_u1"], [float(x) for x in u1])
        np.testing.assert_array_equal(r[name + "_u2"], [float(x) for x in u2])
        np.testing.assert_array_equal(r[name + "_q"], want_q)
        np.testing.assert_array_equal(r[name + "_contains"], want_q > 0)
        np.testing.assert_array_equal(r[name + "_qstats"],
                                      [float(x) for x in qstats])
    assert (want_q > 0).sum() > N_QUERIES // 2


@pytest.mark.parametrize("world", WORLDS)
def test_moe_across_ranks_matches_gshard(runs, world):
    inp, ranks = runs[0], runs[1][world]
    from repro_torch.models import moe
    cfg, params, x = moe_setup()
    want, _ = moe.moe_block(params, x, cfg=cfg)
    got = np.concatenate([r["moe_y"] for r in ranks])
    err = float(np.abs(got - want.numpy()).max())
    assert err < 1e-4, err
    for r in ranks:
        assert float(r["moe_drop"]) == 0.0
        assert float(r["moe_aux"]) == float(ranks[0]["moe_aux"])
    # the stacked engine over the same 4 shards gives the same aux loss
    _, aux = moe.moe_block(params, x, cfg=cfg, ep_shards=4)
    assert abs(float(ranks[0]["moe_aux"]) - float(aux.load_balance_loss)) \
        <= 1e-6 * abs(float(aux.load_balance_loss))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("frac", ["1", "001"])
def test_compress_psum_across_ranks(runs, world, frac):
    inp, ranks = runs[0], runs[1][world]
    from repro_torch.train import compression
    grads = torch.from_numpy(inp["grads"])
    shards = grads.reshape(world, -1)
    g = {"w": shards}
    want, want_e = compression.compress_psum(
        g, compression.init_error_feedback(g),
        frac=1.0 if frac == "1" else 0.01, sharded=True)
    for r, out in enumerate(ranks):
        if frac == "1":
            np.testing.assert_allclose(out["comp1"],
                                       shards.mean(0).numpy(), atol=1e-5)
        np.testing.assert_allclose(out["comp" + frac],
                                   want["w"].numpy(), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(out["comp" + frac + "_err"],
                                      want_e["w"][r].numpy())


REFUSALS = {
    "refuse_spill_count": ("NotImplementedError", "slice 17"),
    "refuse_spill_counter": ("NotImplementedError", "slice 17"),
    "refuse_save": ("NotImplementedError", "slice 17"),
    "refuse_restore": ("NotImplementedError", "slice 17"),
    "refuse_num_pes": ("ValueError", "do not split over"),
}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", sorted(REFUSALS))
def test_ranks_refuse_what_waits(runs, world, key):
    kind, words = REFUSALS[key]
    for out in runs[1][world]:
        msg = str(out[key])
        assert msg.startswith(kind + ":"), msg
        assert words in msg, msg


def test_nccl_without_cuda_raises():
    with pytest.raises(RuntimeError, match="needs CUDA"):
        dist.init_group("nccl", "file:///nonexistent/store", 0, 1)


@pytest.mark.parametrize("local_rank,count", [(1, 1), (0, 0), (4, 4),
                                              (-1, 2)])
def test_nccl_device_past_the_cards_raises(local_rank, count):
    with pytest.raises(ValueError, match="NCCL refuses two ranks"):
        dist.nccl_device(local_rank, count)


def test_nccl_device_maps_local_rank():
    assert dist.nccl_device(0, 1) == torch.device("cuda:0")
    assert dist.nccl_device(3, 4) == torch.device("cuda:3")


def test_group_refuses_num_pes_the_world_does_not_divide():
    g = dist.Group(pg=None, backend="gloo", rank=0, world=4,
                   device=torch.device("cpu"))
    assert g.pes(8).local_pes == 2 and g.pes(8).first_pe == 0
    with pytest.raises(ValueError, match="do not split over 4 ranks"):
        g.pes(6)
    with pytest.raises(ValueError, match="do not split"):
        g.pes(0)


@pytest.mark.parametrize("axis", ["col", "row"])
@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_hop_plans_move_every_bucket_once(axis, world):
    """Every rank's send rows, split sizes and receive placement of a 2d
    hop, simulated without a group against the stacked transposes: rank
    r's received rows, placed, equal the stacked hop's rows of its PEs."""
    from repro_torch.core import aggregation
    rows, cols = GRID
    L = P // world
    B = cols if axis == "col" else rows
    tiles = torch.arange(P * B * 3).view(P, B, 3)
    want = aggregation._hop_transpose((tiles,), rows, cols, axis)[0]
    plans = [dist._hop_plan(r, world, L, rows, cols, axis)
             for r in range(world)]
    sent = []    # sent[q][r]: rows rank q sends rank r
    for q, (send, in_splits, _, _) in enumerate(plans):
        flat = tiles[q * L:(q + 1) * L].reshape(L * B, -1)[list(send)]
        sent.append(list(torch.split(flat, list(in_splits))))
    for r, (_, _, inv, out_splits) in enumerate(plans):
        recv = torch.cat([sent[q][r] for q in range(world)])
        assert [sent[q][r].shape[0] for q in range(world)] == list(out_splits)
        got = recv[list(inv)].reshape(L, -1)
        assert torch.equal(got, want[r * L:(r + 1) * L])


if __name__ == "__main__":
    _launch(int(sys.argv[1]), sys.argv[2])
