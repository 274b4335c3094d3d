"""The incremental counter and its query path: `repro_torch`'s KmerCounter
(update / finalize / count / contains) on the CPU against the JAX
package's KmerCounter on a forced-host-device mesh of the same P, through a
rehash round and a slack-doubling round, with every DAKCStats and
QueryStats field bit-equal (the port folds in stream order on the CPU, so
its store layout, and with it every probe length, is the JAX package's).
The query path is also held to the JAX package on the JAX counter's own
committed store. The JAX runs happen in two subprocesses (one per word
width).
"""

import numpy as np
import pytest
import torch

from _torch_parity import run_jax
from repro.data import genome as jgenome
from repro_torch import words as W
from repro_torch.core import countstore, encoding, fabsp, query, resilience
from repro_torch.core import serial


def _reads(n_reads, read_len, seed, genome_bases=2048):
    return jgenome.sample_reads(jgenome.ReadSetSpec(
        genome_bases=genome_bases, n_reads=n_reads, read_len=read_len,
        seed=seed))


def _pack(codes):
    w = np.zeros(codes.shape[0], np.uint64)
    for j in range(codes.shape[1]):
        w = (w << np.uint64(2)) | codes[:, j].astype(np.uint64)
    return w


def _queries(reads, k, n_hit, n_miss, seed, dtype):
    """Windows of the reads (hits, some twice) and random words, shuffled;
    returned as packed words and as (n, k) base codes."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, reads.shape[0], n_hit)
    cols = rng.integers(0, reads.shape[1] - k + 1, n_hit)
    hit = np.stack([reads[r, c:c + k] for r, c in zip(rows, cols)])
    codes = np.concatenate([hit, hit[:n_hit // 4],
                            rng.integers(0, 4, (n_miss, k))]).astype(np.int32)
    codes = codes[rng.permutation(codes.shape[0])]
    return _pack(codes).astype(dtype), codes


R1 = _reads(128, 60, 1)
R2 = _reads(128, 60, 2)
INPUTS = {"r1": R1, "r2": R2, "r_small": _reads(64, 40, 4),
          "all_a": np.zeros((128, 40), np.uint8)}
INPUTS["q13"], INPUTS["q13_codes"] = _queries(np.concatenate([R1, R2]), 13,
                                              300, 150, 7, np.uint32)
INPUTS["q31"], INPUTS["q31_codes"] = _queries(np.concatenate([R1, R2]), 31,
                                              300, 150, 8, np.uint64)
INPUTS["q13_empty"] = np.zeros((0,), np.uint32)
INPUTS["q_all_a"] = np.array([0, 0, 1, 5, 0], np.uint32)

SK = dict(transport_impl="superkmer")
CASES13 = {
    "kmer_p4": dict(k=13, p=4, batches=("r1", "r2"),
                    queries=("q13", "q13_codes", "q13_empty")),
    "sk_hashed_prefix_p8": dict(k=13, p=8, batches=("r1", "r2"),
                                minimizer_order="hashed",
                                compact_impl="prefix",
                                queries=("q13", "q13_codes"), **SK),
    "sk_plain_canonical_p4": dict(k=13, p=4, batches=("r1", "r2"),
                                  canonical=True,
                                  queries=("q13", "q13_codes"), **SK),
    "rehash_p4": dict(k=13, p=4, batches=("r_small", "r1", "r2"),
                      use_l3=False, store_capacity=64, queries=("q13",)),
    "rehash_sk_p8": dict(k=13, p=8, batches=("r1", "r2"),
                         store_capacity=32, queries=("q13",), **SK),
    "slack_p8": dict(k=13, p=8, batches=("all_a", "r1"), use_l3=False,
                     slack=1.01, queries=("q_all_a", "q13")),
}
CASES31 = {
    "sk_hashed_prefix_p8": dict(k=31, p=8, batches=("r1", "r2"),
                                minimizer_order="hashed",
                                compact_impl="prefix",
                                queries=("q31", "q31_codes"), **SK),
    "rehash_kmer_p4": dict(k=31, p=4, batches=("r1", "r2"),
                           store_capacity=301, queries=("q31",)),
    "sk_m20_p4": dict(k=31, p=4, batches=("r1", "r2"), minimizer_len=20,
                      queries=("q31",), **SK),
}

_BODY = """
from jax.sharding import Mesh
from repro.core import fabsp

def put(key, tup):
    O[key] = np.array([float(x) for x in tup], np.float64)

for name, spec in CASES.items():
    spec = dict(spec)
    p, batches = spec.pop("p"), spec.pop("batches")
    queries = spec.pop("queries")
    mesh = Mesh(np.array(jax.devices()[:p]), ("pe",))
    kc = fabsp.KmerCounter(mesh, fabsp.DAKCConfig(chunk_reads=16, **spec))
    for i, b in enumerate(batches):
        put(f"{name}_u{i}", kc.update(jnp.asarray(I[b])))
    res, st = kc.finalize()
    O[name + "_unique"], O[name + "_counts"] = res.unique, res.counts
    O[name + "_n"] = res.num_unique
    put(name + "_stats", st)
    O[name + "_cap"] = kc.store_capacity
    O[name + "_skeys"] = kc._committed.keys
    O[name + "_scounts"] = kc._committed.counts
    for q in queries:
        O[f"{name}_{q}"] = kc.count(I[q])
        put(f"{name}_{q}_stats", kc.last_query_stats)
"""


def _run(tmp_path_factory, cases, x64):
    body = f"CASES = {cases!r}\n" + _BODY
    return run_jax(tmp_path_factory.mktemp("counter"), body, INPUTS,
                   x64=x64, devices=8)


@pytest.fixture(scope="module")
def jax13(tmp_path_factory):
    return _run(tmp_path_factory, CASES13, x64=False)


@pytest.fixture(scope="module")
def jax64(tmp_path_factory):
    return _run(tmp_path_factory, CASES31, x64=True)


def _cfg(spec):
    spec = {k: v for k, v in spec.items()
            if k not in ("p", "batches", "queries")}
    return fabsp.DAKCConfig(chunk_reads=16, **spec)


def _assert_stats(got, want):
    assert len(got) == len(want)
    for field, g, w in zip(got._fields, got, want):
        assert float(g) == w, field


def _check_counter(name, spec, jax_out):
    kc = fabsp.KmerCounter(_cfg(spec), num_pes=spec["p"], device="cpu")
    for i, b in enumerate(spec["batches"]):
        _assert_stats(kc.update(INPUTS[b]), jax_out[f"{name}_u{i}"])
    res, stats = kc.finalize()
    bits = encoding.word_bits(spec["k"])
    np.testing.assert_array_equal(W.to_numpy_words(res.unique, bits),
                                  jax_out[name + "_unique"])
    np.testing.assert_array_equal(res.counts.numpy(),
                                  jax_out[name + "_counts"])
    np.testing.assert_array_equal(res.num_unique.numpy(),
                                  jax_out[name + "_n"])
    _assert_stats(stats, jax_out[name + "_stats"])
    assert kc.store_capacity == int(jax_out[name + "_cap"])
    # the committed store itself, slot for slot
    np.testing.assert_array_equal(
        W.to_numpy_words(kc._committed.keys, bits).reshape(-1),
        jax_out[name + "_skeys"])
    for q in spec["queries"]:
        np.testing.assert_array_equal(kc.count(INPUTS[q]),
                                      jax_out[f"{name}_{q}"])
        _assert_stats(kc.last_query_stats, jax_out[f"{name}_{q}_stats"])
        np.testing.assert_array_equal(kc.contains(INPUTS[q]),
                                      jax_out[f"{name}_{q}"] > 0)
    return stats


def _check_query_on_jax_store(name, spec, jax_out):
    """The port's query path over the JAX counter's committed arrays."""
    snap = countstore.snapshot_from_numpy(
        jax_out[name + "_skeys"], jax_out[name + "_scounts"], spec["p"])
    for q in spec["queries"]:
        counts, stats = query.query_counts(INPUTS[q], _cfg(spec), snap,
                                           num_pes=spec["p"])
        np.testing.assert_array_equal(counts, jax_out[f"{name}_{q}"])
        _assert_stats(stats, jax_out[f"{name}_{q}_stats"])


@pytest.mark.parametrize("name", sorted(CASES13))
def test_counter_matches_jax_k13(jax13, name):
    stats = _check_counter(name, CASES13[name], jax13)
    if name.startswith("rehash"):
        assert stats.retry_store_rehash >= 1
    if name.startswith("slack"):
        assert stats.retry_route_slack >= 1


@pytest.mark.parametrize("name", sorted(CASES31))
def test_counter_matches_jax_k31(jax64, name):
    stats = _check_counter(name, CASES31[name], jax64)
    if name.startswith("rehash"):
        assert stats.retry_store_rehash >= 1


@pytest.mark.parametrize("name", sorted(CASES13))
def test_query_path_on_jax_store_k13(jax13, name):
    _check_query_on_jax_store(name, CASES13[name], jax13)


@pytest.mark.parametrize("name", sorted(CASES31))
def test_query_path_on_jax_store_k31(jax64, name):
    _check_query_on_jax_store(name, CASES31[name], jax64)


# --- the port on its own -----------------------------------------------------

def _oracle(*read_sets, k=13):
    out = {}
    for reads in read_sets:
        ser = serial.count_kmers_serial(torch.from_numpy(reads), k)
        n = int(ser.num_unique[0])
        for u, c in zip(ser.unique[0, :n].tolist(),
                        ser.counts[0, :n].tolist()):
            out[u] = out.get(u, 0) + c
    return out


def _merge(res, p):
    L = res.unique.numel() // p
    live = torch.arange(L)[None, :] < res.num_unique[:, None]
    return dict(zip(res.unique.view(p, L)[live].tolist(),
                    res.counts.view(p, L)[live].tolist()))


def _answers(oracle, q):
    return np.array([oracle.get(int(x), 0) for x in q], np.int32)


@pytest.mark.parametrize("transport", ["kmer", "superkmer"])
def test_two_updates_equal_one_count_kmers(transport):
    cfg = fabsp.DAKCConfig(k=13, chunk_reads=16, transport_impl=transport)
    kc = fabsp.KmerCounter(cfg, num_pes=4, device="cpu")
    kc.update(R1)
    kc.update(R2)
    res, agg = kc.finalize()
    one, st_one = fabsp.count_kmers(np.concatenate([R1, R2]), cfg,
                                    num_pes=4, device="cpu")
    assert _merge(res, 4) == _merge(one, 4) == _oracle(R1, R2)
    assert agg.raw_kmers == st_one.raw_kmers
    assert agg.sent_words == st_one.sent_words
    assert int(agg.wire_bytes) == int(st_one.wire_bytes)


def test_finalize_twice_with_updates_between():
    kc = fabsp.KmerCounter(fabsp.DAKCConfig(k=13, chunk_reads=16),
                           num_pes=2, device="cpu")
    with pytest.raises(RuntimeError, match="before any update"):
        kc.finalize()
    kc.update(R1)
    assert _merge(kc.finalize()[0], 2) == _oracle(R1)
    assert _merge(kc.finalize()[0], 2) == _oracle(R1)
    kc.update(R2)
    res, st = kc.finalize()
    assert _merge(res, 2) == _oracle(R1, R2)
    assert st.raw_kmers == 2 * 128 * (60 - 13 + 1)


def test_snapshot_isolated_from_rehash_replay_and_grow():
    """count() serves the last commit exactly: a snapshot taken before an
    update that rehashed and replayed still answers the old histogram, a
    regrown but uncommitted store changes no answer, and an update that
    gives up after failed rounds leaves the committed histogram as it was."""
    cfg = fabsp.DAKCConfig(k=13, chunk_reads=16, use_l3=False,
                           store_capacity=64,
                           retry=resilience.RetryPolicy(max_slack=2.0))
    kc = fabsp.KmerCounter(cfg, num_pes=4, device="cpu")
    small = INPUTS["r_small"]
    q = INPUTS["q13"]
    kc.update(small)
    snap1 = kc._committed
    want1 = _answers(_oracle(small), q)
    np.testing.assert_array_equal(kc.count(q), want1)

    st = kc.update(R1)                      # rehash rounds, then a replay
    assert st.retry_store_rehash >= 1
    want2 = _answers(_oracle(small, R1), q)
    np.testing.assert_array_equal(kc.count(q), want2)
    old, _ = query.query_counts(q, cfg, snap1, num_pes=4)
    np.testing.assert_array_equal(old, want1)   # the old commit, unchanged

    cap = kc.store_capacity
    kc._grow(2 * cap)                       # a rehash in flight, no commit
    assert kc._committed.store_cap == cap
    np.testing.assert_array_equal(kc.count(q), want2)

    # one owner gets every poly-A k-mer: the routing slack passes its cap
    with pytest.raises(resilience.CapacityExhausted):
        kc.update(INPUTS["all_a"])
    np.testing.assert_array_equal(kc.count(q), want2)
    assert _merge(kc.finalize()[0], 4) == _oracle(small, R1)


def test_count_hits_misses_duplicates_and_order():
    kc = fabsp.KmerCounter(fabsp.DAKCConfig(k=13, chunk_reads=16),
                           num_pes=4, device="cpu")
    with pytest.raises(RuntimeError, match="before any update"):
        kc.count(INPUTS["q13"])
    kc.update(R1)
    oracle = _oracle(R1)
    q = INPUTS["q13"]
    want = _answers(oracle, q)
    assert (want > 0).any() and (want == 0).any()
    np.testing.assert_array_equal(kc.count(q), want)
    np.testing.assert_array_equal(kc.count(INPUTS["q13_codes"]), want)
    perm = np.random.default_rng(0).permutation(q.size)
    np.testing.assert_array_equal(kc.count(q[perm]), want[perm])
    st = kc.last_query_stats
    assert st.n_queries == q.size and st.n_hits == int((want > 0).sum())
    assert st.n_local == 256 and st.batch_fill == q.size / 1024
    assert kc.count(INPUTS["q13_empty"]).shape == (0,)


def test_pack_queries_shape_errors():
    cfg = fabsp.DAKCConfig(k=13, chunk_reads=64)
    with pytest.raises(ValueError, match=r"\(n, k=13\)"):
        query.pack_queries(np.zeros((4, 9), np.int32), cfg)
    with pytest.raises(ValueError, match="words or"):
        query.pack_queries(np.zeros((2, 2, 2), np.int32), cfg)


def test_pack_queries_masks_and_canonicalizes():
    from repro.core import fabsp as jfabsp
    from repro.core import query as jquery

    w = np.asarray([0b1111_11111111, 0, 0x3FF], np.uint32)  # junk above 2k
    got = query.pack_queries(w, fabsp.DAKCConfig(k=5, canonical=True))
    want = jquery.pack_queries(w, jfabsp.DAKCConfig(k=5, canonical=True))
    np.testing.assert_array_equal(W.to_numpy_words(got, 32),
                                  np.asarray(want))
    codes = np.array([[0, 1, 2, 3, 3], [3, 3, 3, 3, 3]], np.int32)
    rc = (3 - codes)[:, ::-1]
    cfg = fabsp.DAKCConfig(k=5, canonical=True)
    np.testing.assert_array_equal(query.pack_queries(codes, cfg).numpy(),
                                  query.pack_queries(rc.copy(), cfg).numpy())
