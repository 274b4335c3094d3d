"""The query service (`repro_torch.launch.kc_serve`) and the spilled-bin
query tier on the CPU, against the JAX package.

The JAX package's serving tests run on the port: intake refuses an
unknown tenant, `flush` keeps a refusing tenant's failure to its own
requests, an empty request never reaches the device, and a k=31 store
coalesces its batch in uint64. The spilled-bin tier's counts and
`QueryStats` (cold, then warm from the bin cache) equal the JAX
package's on both transports and topologies, as do the LRU's counters
under a one-byte budget and under a budget of two bins, and a
`QueryService.flush` over an in-core, a spilled and a refusing tenant
(every `RequestStats` field but `seconds`).
`run_demo` runs on the CPU. The JAX runs happen in two subprocesses at
once, with 4 host devices each.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import JAX_HELPERS, assert_stats, histogram, run_jax_many
from repro.data import genome as jgenome
from repro_torch.core import fabsp, query, serial
from repro_torch.core.resilience import FaultPlan, InjectedFault
from repro_torch.launch import kc_serve
from repro_torch.launch.kc_serve import (QueryService, StoreRegistry,
                                         UnknownStore)

READS = jgenome.sample_reads(jgenome.ReadSetSpec(
    genome_bases=4096, n_reads=128, read_len=80, heavy_hitter_frac=0.3,
    seed=17))
K = 13


def _oracle(reads, k=K):
    ser = serial.count_kmers_serial(torch.from_numpy(reads), k)
    n = int(ser.num_unique[0])
    return dict(zip(ser.unique[0, :n].tolist(), ser.counts[0, :n].tolist()))


ORACLE = _oracle(READS)
_rng = np.random.default_rng(3)
_uniq = np.asarray(sorted(ORACLE), np.uint32)
QUERIES = np.concatenate([_uniq[::3], _uniq[:40],
                          _rng.integers(0, 1 << 26, 300).astype(np.uint32)])
_rng.shuffle(QUERIES)
WANT = np.asarray([ORACLE.get(int(x), 0) for x in QUERIES], np.int32)

# the spilled tier: (p, grid, knobs)
SPILLED = {
    "kmer_p4": (4, None, {}),
    "kmer_g22": (4, (2, 2), dict(topology="2d")),
    "sk_p4": (4, None, dict(transport_impl="superkmer", minimizer_len=7)),
    "sk_g22": (4, (2, 2), dict(topology="2d", transport_impl="superkmer",
                               minimizer_len=7, minimizer_order="hashed")),
}
SPLITS = (0, 100, 101, 250, 400)     # request boundaries in QUERIES

_BODY = JAX_HELPERS + """
from repro.core import fabsp, query
from repro.launch.kc_serve import QueryService, StoreRegistry
R, Q = jnp.asarray(I["reads"]), I["queries"]

def spilled_cfg(name, **knobs):
    return fabsp.DAKCConfig(k=13, chunk_reads=16, spill="always",
                            spill_bins=6, spill_dir=ROOT + "/" + name,
                            **knobs)

"""

_GRID_BODY = """
for name, (p, grid, knobs) in SPILLED.items():
    mesh, axes = mesh_of(p, grid)
    kc = fabsp.KmerCounter(mesh, spilled_cfg(name, **knobs), axes)
    kc.update(R)
    for tag in ("cold", "warm"):
        O[f"{name}_{tag}"] = kc.count(Q)
        put(f"{name}_{tag}_st", kc.last_query_stats)
"""

_SERVICE_BODY = """
kc = fabsp.KmerCounter(mesh_of(2)[0], spilled_cfg(
    "lru", query_bin_cache_bytes=1))
kc.update(R)
for tag in ("a", "b"):
    O["lru_" + tag] = kc.count(Q)
    put(f"lru_{tag}_st", kc.last_query_stats)
c = kc._bin_cache
O["lru_counters"] = np.array([c.hits, c.misses, c.evictions])
mid = int(2.5 * max(e[3] for e in c._entries.values()))   # 2 of 6 bins
kc = fabsp.KmerCounter(mesh_of(2)[0], spilled_cfg(
    "lru_mid", query_bin_cache_bytes=mid))
kc.update(R)
for tag in ("a", "b"):
    O["lru_mid_" + tag] = kc.count(Q)
    put(f"lru_mid_{tag}_st", kc.last_query_stats)
c = kc._bin_cache
O["lru_mid"] = np.array([mid, c.hits, c.misses, c.evictions,
                         len(c._entries)])

mesh4 = mesh_of(4)[0]
registry = StoreRegistry(mesh4)
incore = fabsp.KmerCounter(mesh4, fabsp.DAKCConfig(k=13, chunk_reads=16))
incore.update(R)
registry.register("incore", incore)
sp = fabsp.KmerCounter(mesh4, spilled_cfg("tenant"))
sp.update(R)
registry.register("spilled", sp)
strict = fabsp.KmerCounter(mesh4, spilled_cfg("strict", spill_query="refuse"))
strict.update(R)
registry.register("strict", strict)
service = QueryService(registry)
for j, (lo, hi) in enumerate(zip(SPLITS[:-1], SPLITS[1:])):
    service.submit(("incore", "spilled", "strict")[j % 3], Q[lo:hi])
service.submit("spilled", Q[:0])
for j, r in enumerate(service.flush()):
    if isinstance(r, Exception):
        O[f"flush{j}_err"] = np.array(type(r).__name__)
        continue
    O[f"flush{j}"] = r[0]
    st = r[1]
    O[f"flush{j}_st"] = np.array(
        [st.n_queries, st.n_hits, st.batch_queries, st.batch_fill,
         st.n_local, st.probe_avg, st.probe_max, st.wire_bytes], np.float64)
"""


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_jax")
    head = (f"ROOT = {str(root)!r}\nSPILLED = {SPILLED!r}\n"
            f"SPLITS = {SPLITS!r}\n" + _BODY)
    out = run_jax_many(tmp_path_factory.mktemp("serve_run"),
                       {"grid": (head + _GRID_BODY, False),
                        "service": (head + _SERVICE_BODY, False)},
                       {"reads": READS, "queries": QUERIES}, devices=4)
    return {**out["grid"], **out["service"]}


def _spilled_cfg(tmp_path, name, **knobs):
    return fabsp.DAKCConfig(k=K, chunk_reads=16, spill="always",
                            spill_bins=6, spill_dir=str(tmp_path / name),
                            **knobs)


def _serving(reads=READS, **overrides):
    kc = fabsp.KmerCounter(fabsp.DAKCConfig(
        **{"k": K, "chunk_reads": 64, **overrides}), num_pes=1,
        device="cpu")
    kc.update(reads)
    return kc


# --- the JAX package's serving tests, on the port ----------------------------

def test_submit_unknown_tenant_fails_at_intake():
    service = QueryService(StoreRegistry(num_pes=1, device="cpu"))
    with pytest.raises(UnknownStore, match="yeast"):
        service.submit("yeast", np.zeros(4, np.uint32))


def test_flush_isolates_failing_tenant(tmp_path):
    registry = StoreRegistry(num_pes=1, device="cpu")
    registry.register("good", _serving())
    registry.register("strict", _serving(
        spill="always", spill_dir=str(tmp_path), spill_query="refuse"))
    service = QueryService(registry)
    i0 = service.submit("good", _uniq[:32])
    i1 = service.submit("strict", _uniq[:32])
    i2 = service.submit("good", _uniq[32:48])
    i3 = service.submit("good", np.zeros((0,), np.uint32))
    out = service.flush()
    assert len(out) == 4
    assert isinstance(out[i1], query.QueryUnavailable)
    for i, sl in ((i0, _uniq[:32]), (i2, _uniq[32:48])):
        counts, st = out[i]
        np.testing.assert_array_equal(
            counts, np.asarray([ORACLE[int(x)] for x in sl], np.int32))
        assert st.tenant == "good" and st.n_queries == sl.size
        assert st.batch_queries == 48        # both live requests coalesced
    counts, st = out[i3]
    assert counts.size == 0 and st.n_queries == 0
    assert not service.flush()               # the queue drained


def test_flush_empty_request_skips_device():
    """A tenant that never committed a batch (count() would raise) still
    flushes an empty request: no device round trip."""
    registry = StoreRegistry(num_pes=1, device="cpu")
    registry.register("cold", fabsp.KmerCounter(
        fabsp.DAKCConfig(k=K, chunk_reads=64), num_pes=1, device="cpu"))
    service = QueryService(registry)
    i0 = service.submit("cold", np.zeros((0,), np.uint32))
    counts, st = service.flush()[i0]
    assert counts.size == 0
    assert st.n_queries == 0 and st.wire_bytes == 0 and st.seconds == 0.0


def test_flush_batch_dtype_follows_store_word_k31():
    reads = READS[:64]
    kc = fabsp.KmerCounter(fabsp.DAKCConfig(k=31, chunk_reads=64),
                           num_pes=1, device="cpu")
    kc.update(reads)
    assert QueryService._batch_dtype(kc) == np.uint64
    registry = StoreRegistry(num_pes=1, device="cpu")
    registry.register("wide", kc)
    service = QueryService(registry)
    oracle = _oracle(reads, 31)
    uniq = np.asarray(sorted(oracle), np.uint64)
    i0 = service.submit("wide", uniq[:16].astype(np.int64))
    i1 = service.submit("wide", np.zeros((0,), np.uint64))
    i2 = service.submit("wide", uniq[16:40])
    out = service.flush()
    for i, sl in ((i0, uniq[:16]), (i2, uniq[16:40])):
        want = np.asarray([oracle[int(x)] for x in sl], np.int32)
        np.testing.assert_array_equal(out[i][0], want)
    assert out[i1][0].size == 0 and out[i1][1].n_queries == 0


# --- against the JAX package -------------------------------------------------

@pytest.mark.parametrize("name", sorted(SPILLED))
def test_spilled_query_tier_matches_jax(jax_out, tmp_path, name):
    p, grid, knobs = SPILLED[name]
    kc = fabsp.KmerCounter(_spilled_cfg(tmp_path, name, **knobs),
                           num_pes=p, grid=grid, device="cpu")
    kc.update(READS)
    for tag in ("cold", "warm"):
        got = kc.count(QUERIES)
        np.testing.assert_array_equal(got, WANT)
        np.testing.assert_array_equal(got, jax_out[f"{name}_{tag}"])
        assert_stats(kc.last_query_stats, jax_out[f"{name}_{tag}_st"])
    st = kc.last_query_stats
    assert st.bins_probed > 0 and st.bin_folds == 0     # warm: cached


def test_bin_cache_evicts_as_jax_and_stays_exact(jax_out, tmp_path):
    kc = fabsp.KmerCounter(_spilled_cfg(tmp_path, "lru",
                                        query_bin_cache_bytes=1),
                           num_pes=2, device="cpu")
    kc.update(READS)
    for tag in ("a", "b"):
        np.testing.assert_array_equal(kc.count(QUERIES), WANT)
        assert_stats(kc.last_query_stats, jax_out[f"lru_{tag}_st"])
    c = kc._bin_cache
    assert [c.hits, c.misses, c.evictions] == \
        jax_out["lru_counters"].tolist()
    assert c.evictions > 0 and kc.last_query_stats.bin_folds > 0


def test_bin_cache_budget_of_two_bins_evicts_as_jax(jax_out, tmp_path):
    # The budget holds two of the six folded bins at the JAX package's
    # charge (a 4-byte word and a 4-byte count a slot); charged at the
    # int64 carrier's 8 bytes, only one would fit.
    mid, *counters = jax_out["lru_mid"].tolist()
    kc = fabsp.KmerCounter(_spilled_cfg(tmp_path, "lru_mid",
                                        query_bin_cache_bytes=mid),
                           num_pes=2, device="cpu")
    kc.update(READS)
    for tag in ("a", "b"):
        np.testing.assert_array_equal(kc.count(QUERIES), WANT)
        assert_stats(kc.last_query_stats, jax_out[f"lru_mid_{tag}_st"])
    c = kc._bin_cache
    assert [c.hits, c.misses, c.evictions, len(c._entries)] == counters
    assert counters[3] == 2 and kc.last_query_stats.bin_folds > 0


def test_bin_cache_lru_order_and_versions():
    cache = query.BinShardCache(budget_bytes=3 * 12)
    t = lambda: (torch.zeros((1, 1), dtype=torch.int64),
                 torch.zeros((1, 1), dtype=torch.int32))
    for b in range(3):
        cache.put(b, ("v",), *t(), 64)
    assert cache.get(0, ("v",)) is not None    # 0 is now the newest
    cache.put(3, ("v",), *t(), 64)             # evicts 1, the oldest
    assert cache.evictions == 1
    assert cache.get(1, ("v",)) is None
    assert cache.get(0, ("v", "new")) is None  # a later commit misses
    assert (cache.hits, cache.misses) == (1, 2)


def test_flush_over_three_regimes_matches_jax(jax_out, tmp_path):
    registry = StoreRegistry(num_pes=4, device="cpu")
    incore = fabsp.KmerCounter(fabsp.DAKCConfig(k=K, chunk_reads=16),
                               num_pes=4, device="cpu")
    incore.update(READS)
    registry.register("incore", incore)
    for name, knobs in (("spilled", {}), ("strict", dict(
            spill_query="refuse"))):
        kc = fabsp.KmerCounter(_spilled_cfg(tmp_path, name, **knobs),
                               num_pes=4, device="cpu")
        kc.update(READS)
        registry.register(name, kc)
    service = QueryService(registry)
    for j, (lo, hi) in enumerate(zip(SPLITS[:-1], SPLITS[1:])):
        service.submit(("incore", "spilled", "strict")[j % 3],
                       QUERIES[lo:hi])
    service.submit("spilled", QUERIES[:0])
    out = service.flush()
    for j, r in enumerate(out):
        if isinstance(r, Exception):
            assert isinstance(r, query.QueryUnavailable)
            assert str(jax_out[f"flush{j}_err"]) == "QueryUnavailable"
            continue
        counts, st = r
        np.testing.assert_array_equal(counts, jax_out[f"flush{j}"])
        fields = dataclasses.astuple(st)
        assert st.tenant in ("incore", "spilled")
        np.testing.assert_array_equal(
            np.array([st.n_queries, st.n_hits, st.batch_queries,
                      st.batch_fill, st.n_local, st.probe_avg,
                      st.probe_max, st.wire_bytes], np.float64),
            jax_out[f"flush{j}_st"])
        assert fields[-1] >= 0.0                # seconds: wall time


def test_snapshot_survives_a_failed_spill_update(tmp_path):
    """A batch that dies mid-spill leaves the committed generation, and
    its manifest view, serving the last commit exactly."""
    base = dict(k=11, chunk_reads=16, spill="always", spill_bins=4)
    probe = fabsp.KmerCounter(fabsp.DAKCConfig(
        **base, spill_dir=str(tmp_path / "probe")), num_pes=1, device="cpu")
    probe.update(READS[:64])
    n_seg = len(probe._spill.state()["segments"])
    kc = fabsp.KmerCounter(fabsp.DAKCConfig(
        **base, spill_dir=str(tmp_path / "run"), faults=FaultPlan(
            site="spill_write", fail_after=n_seg)), num_pes=1, device="cpu")
    kc.update(READS[:64])
    oracle = _oracle(READS[:64], 11)
    q = np.asarray(sorted(oracle)[:60] + [1, 2], np.uint32)
    want = np.asarray([oracle.get(int(x), 0) for x in q], np.int32)
    np.testing.assert_array_equal(kc.count(q), want)
    with pytest.raises(InjectedFault):
        kc.update(READS[64:])
    np.testing.assert_array_equal(kc.count(q), want)
    assert histogram(probe.finalize()[0], 1) == oracle


def test_registry_load_restores_elastically(tmp_path):
    kc = fabsp.KmerCounter(fabsp.DAKCConfig(k=K, chunk_reads=16),
                           num_pes=4, device="cpu")
    kc.update(READS)
    kc.save(str(tmp_path))
    registry = StoreRegistry(num_pes=2, device="cpu")
    registry.load("two", str(tmp_path), kc._cfg)
    assert registry.names() == ["two"]
    counts, st = QueryService(registry).query("two", QUERIES)
    np.testing.assert_array_equal(counts, WANT)
    assert st.n_hits == int((WANT > 0).sum()) and st.batch_queries == \
        QUERIES.size


def test_run_demo_on_the_cpu(capsys):
    kc_serve.main(["--demo", "--device", "cpu", "--requests", "4"])
    out = capsys.readouterr().out
    assert "kc_serve demo OK" in out and "serving loop: 4 requests" in out


def test_registry_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StoreRegistry(num_pes=1)
