"""The 2d topology: `repro_torch`'s route_lanes (the 'oneplan' and 'perhop'
routes, the compact hop 2), count_kmers and KmerCounter under
topology='2d' on the CPU, against the JAX package on forced-host-device
meshes of the same (rows, cols) shape: (2, 4), (4, 2) and (1, 1). A
non-square grid shows a transposed fold that a square one hides. Received
lanes, per-PE results, the committed store slot for slot, and every
DAKCStats and QueryStats field must be equal. The JAX runs happen in
three subprocesses at once: 32-bit words in two halves, 64-bit in one.
"""

import numpy as np
import pytest
import torch

from _torch_parity import run_jax_many
from repro.data import genome as jgenome
from repro_torch import words as W
from repro_torch.core import aggregation, encoding, fabsp


def _reads(n_reads, read_len, seed, genome_bases=4096):
    return jgenome.sample_reads(jgenome.ReadSetSpec(
        genome_bases=genome_bases, n_reads=n_reads, read_len=read_len,
        seed=seed))


def _route_inputs(seed, p=8, n=64):
    """Per-PE words (some sentinel), their word-derived owners, a validity
    mask and an i32 tag lane, as (p, n) arrays."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 30, (p, n)).astype(np.uint32)
    words[rng.random((p, n)) < 0.1] = np.uint32(0xFFFFFFFF)
    valid = (words != np.uint32(0xFFFFFFFF)) & (rng.random((p, n)) < 0.9)
    tags = rng.integers(1, 1 << 20, (p, n)).astype(np.int32)
    return words, valid, tags


R = _reads(256, 60, 1)
INPUTS = {"reads": R, "b1": R[:128], "b2": R[128:]}
INPUTS["words"], INPUTS["valid"], INPUTS["tags"] = _route_inputs(5)
rng = np.random.default_rng(9)
INPUTS["q13"] = np.concatenate([
    np.array([int("".join(map(str, R[r, c:c + 13])), 4)
              for r, c in zip(rng.integers(0, 256, 300),
                              rng.integers(0, 48, 300))], np.uint32),
    rng.integers(0, 1 << 26, 100).astype(np.uint32)])
INPUTS["q31"] = np.array([int("".join(map(str, R[r, c:c + 31])), 4)
                          for r, c in zip(rng.integers(0, 256, 200),
                                          rng.integers(0, 30, 200))],
                         np.uint64)

# --- route_lanes, directly ---------------------------------------------------

ROUTES = {
    f"{route}_g{r}{c}": dict(grid=(r, c), route2d=route.split("_")[0],
                             hop2=5 if route.endswith("compact") else None)
    for route in ("oneplan", "oneplan_compact", "perhop")
    for r, c in ((2, 4), (4, 2))
}
ROUTES["oneplan_compact_g11"] = dict(grid=(1, 1), route2d="oneplan", hop2=9)
CAPACITY = 12


_ROUTE_BODY = """
from jax.sharding import Mesh, PartitionSpec as P
from repro.core import aggregation, compat
for name, spec in ROUTES.items():
    rows, cols = spec["grid"]
    p = rows * cols
    mesh = Mesh(np.array(jax.devices()[:p]).reshape(rows, cols),
                ("row", "col"))
    def body(w, v, t):
        owners = ((w >> 3) % p).astype(jnp.int32)
        rr = aggregation.route_lanes(
            (w, t), ("word", "i32"), owners, v, num_pes=p,
            capacity=CAPACITY, axis_names=("row", "col"), grid=(rows, cols),
            route2d=spec["route2d"], hop2_capacity=spec["hop2"],
            rederive_owners=lambda x: ((x >> 3) % p).astype(jnp.int32))
        return (rr.lanes[0], rr.lanes[1], rr.sent_valid.reshape(1),
                rr.wire_bytes.reshape(1), rr.overflow.reshape(1),
                rr.hop2_dropped.reshape(1), rr.fill)
    ax = P(("row", "col"))
    fn = jax.jit(compat.shard_map(body, mesh=mesh, in_specs=(ax, ax, ax),
                                  out_specs=(ax,) * 7))
    out = fn(jnp.asarray(I["words"][:p].reshape(-1)),
             jnp.asarray(I["valid"][:p].reshape(-1)),
             jnp.asarray(I["tags"][:p].reshape(-1)))
    for key, val in zip(("w", "t", "sent", "wire", "ovf", "h2", "fill"),
                        out):
        O[f"route_{name}_{key}"] = val
"""

# --- count_kmers and KmerCounter ---------------------------------------------

SK = dict(transport_impl="superkmer")
COMBOS = {
    "oneplan_padded_kmer_stream": {},
    "oneplan_compact_kmer_stream": dict(hop2_impl="compact"),
    "oneplan_padded_kmer_stacked": dict(receiver_impl="stacked"),
    "oneplan_compact_kmer_stacked": dict(hop2_impl="compact",
                                         receiver_impl="stacked"),
    "oneplan_padded_sk_stream": dict(SK),
    "oneplan_compact_sk_stream": dict(hop2_impl="compact", **SK),
    "oneplan_padded_sk_stacked": dict(receiver_impl="stacked", **SK),
    "oneplan_compact_sk_stacked": dict(hop2_impl="compact",
                                       receiver_impl="stacked", **SK),
    "perhop_kmer_stream": dict(route2d_impl="perhop"),
    "perhop_kmer_stacked": dict(route2d_impl="perhop",
                                receiver_impl="stacked"),
}
CASES13 = {f"{c}_g24": dict(k=13, grid=(2, 4), **kw)
           for c, kw in COMBOS.items()}
for c in ("oneplan_compact_sk_stacked", "perhop_kmer_stream"):
    CASES13[f"{c}_g42"] = dict(k=13, grid=(4, 2), **COMBOS[c])
CASES13["oneplan_compact_kmer_stream_g11"] = dict(
    k=13, grid=(1, 1), **COMBOS["oneplan_compact_kmer_stream"])
CASES64 = {
    "oneplan_compact_kmer_stream_g24": dict(k=31, grid=(2, 4),
                                            hop2_impl="compact"),
    "perhop_kmer_stacked_g24": dict(k=31, grid=(2, 4),
                                    route2d_impl="perhop",
                                    receiver_impl="stacked"),
    "packed_compact_k21_g42": dict(k=21, grid=(4, 2), hop2_impl="compact"),
}
COUNTERS13 = {
    "kmer_compact_rehash_g24": dict(k=13, grid=(2, 4), hop2_impl="compact",
                                    store_capacity=64, queries="q13"),
    "sk_hashed_compact_prefix_g42": dict(
        k=13, grid=(4, 2), hop2_impl="compact", compact_impl="prefix",
        minimizer_order="hashed", queries="q13", **SK),
}
COUNTERS64 = {
    "sk_compact_g24": dict(k=31, grid=(2, 4), hop2_impl="compact",
                           queries="q31", **SK),
}

_COUNT_BODY = """
from jax.sharding import Mesh
from repro.core import fabsp

def put(key, tup):
    O[key] = np.array([float(x) for x in tup], np.float64)

def mesh_of(grid):
    rows, cols = grid
    return Mesh(np.array(jax.devices()[:rows * cols]).reshape(rows, cols),
                ("row", "col"))

for name, spec in CASES.items():
    spec = dict(spec)
    grid = spec.pop("grid")
    cfg = fabsp.DAKCConfig(chunk_reads=16, topology="2d", **spec)
    res, st = fabsp.count_kmers(jnp.asarray(I["reads"]), mesh_of(grid), cfg,
                                ("row", "col"))
    O[name + "_unique"] = res.unique
    O[name + "_counts"] = res.counts
    O[name + "_n"] = res.num_unique
    put(name + "_stats", st)

for name, spec in COUNTERS.items():
    spec = dict(spec)
    grid, q = spec.pop("grid"), spec.pop("queries")
    cfg = fabsp.DAKCConfig(chunk_reads=16, topology="2d", **spec)
    kc = fabsp.KmerCounter(mesh_of(grid), cfg, ("row", "col"))
    for i, b in enumerate(("b1", "b2")):
        put(f"kc_{name}_u{i}", kc.update(jnp.asarray(I[b])))
    res, st = kc.finalize()
    O[f"kc_{name}_unique"], O[f"kc_{name}_counts"] = res.unique, res.counts
    O[f"kc_{name}_n"] = res.num_unique
    put(f"kc_{name}_stats", st)
    O[f"kc_{name}_skeys"] = kc._committed.keys
    O[f"kc_{name}_q"] = kc.count(I[q])
    put(f"kc_{name}_qstats", kc.last_query_stats)
"""


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    routes = (f"ROUTES = {ROUTES!r}\nCAPACITY = {CAPACITY}\n" + _ROUTE_BODY
              + f"CASES = {{}}\nCOUNTERS = {COUNTERS13!r}\n" + _COUNT_BODY)
    counts = f"CASES = {CASES13!r}\nCOUNTERS = {{}}\n" + _COUNT_BODY
    body64 = (f"CASES = {CASES64!r}\nCOUNTERS = {COUNTERS64!r}\n"
              + _COUNT_BODY)
    return run_jax_many(tmp_path_factory.mktemp("topo2d"),
                        {"w32a": (routes, False), "w32b": (counts, False),
                         "w64": (body64, True)}, INPUTS, devices=8)


@pytest.fixture(scope="module")
def jax13(jax_out):
    return {**jax_out["w32a"], **jax_out["w32b"]}


@pytest.fixture(scope="module")
def jax64(jax_out):
    return jax_out["w64"]


def _cfg(spec):
    spec = {k: v for k, v in spec.items() if k not in ("grid", "queries")}
    return fabsp.DAKCConfig(chunk_reads=16, topology="2d", **spec)


def _assert_stats(got, want):
    assert len(got) == len(want)
    for field, g, w in zip(got._fields, got, want):
        assert float(g) == w, field


def _assert_result(res, bits, jax_out, prefix):
    np.testing.assert_array_equal(W.to_numpy_words(res.unique, bits),
                                  jax_out[prefix + "_unique"])
    np.testing.assert_array_equal(res.counts.numpy(),
                                  jax_out[prefix + "_counts"])
    np.testing.assert_array_equal(res.num_unique.numpy(),
                                  jax_out[prefix + "_n"])


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_route_lanes_2d_matches_jax(jax13, name):
    spec = ROUTES[name]
    rows, cols = spec["grid"]
    p = rows * cols
    words, _ = W.to_torch_words(INPUTS["words"][:p])
    valid = torch.from_numpy(INPUTS["valid"][:p])
    tags = torch.from_numpy(INPUTS["tags"][:p])

    def owners(x):
        return ((x >> 3) % p).to(torch.int32)

    rr = aggregation.route_lanes(
        (words, tags), ("word", "i32"), owners(words), valid, num_pes=p,
        capacity=CAPACITY, word_bits=32, grid=(rows, cols),
        route2d=spec["route2d"], hop2_capacity=spec["hop2"],
        rederive_owners=owners)
    pre = f"route_{name}_"
    np.testing.assert_array_equal(W.to_numpy_words(rr.lanes[0], 32)
                                  .reshape(-1), jax13[pre + "w"])
    np.testing.assert_array_equal(rr.lanes[1].numpy().reshape(-1),
                                  jax13[pre + "t"])
    np.testing.assert_array_equal(rr.sent_valid.numpy(), jax13[pre + "sent"])
    assert (jax13[pre + "wire"] == rr.wire_bytes).all()
    np.testing.assert_array_equal(rr.overflow.numpy(), jax13[pre + "ovf"])
    np.testing.assert_array_equal(rr.hop2_dropped.numpy(), jax13[pre + "h2"])
    np.testing.assert_array_equal(rr.fill.numpy().reshape(-1),
                                  jax13[pre + "fill"])
    if spec["hop2"] is not None:
        assert rr.lanes[0].shape == (p, p * spec["hop2"])
        assert int(rr.hop2_dropped.sum()) > 0


def _check_count(name, spec, jax_out):
    rows, cols = spec["grid"]
    res, stats = fabsp.count_kmers(R, _cfg(spec), num_pes=rows * cols,
                                   grid=spec["grid"], device="cpu")
    _assert_result(res, encoding.word_bits(spec["k"]), jax_out, name)
    _assert_stats(stats, jax_out[name + "_stats"])
    return stats


@pytest.mark.parametrize("name", sorted(CASES13))
def test_count_kmers_2d_matches_jax_k13(jax13, name):
    _check_count(name, CASES13[name], jax13)


@pytest.mark.parametrize("name", sorted(CASES64))
def test_count_kmers_2d_matches_jax_64bit(jax64, name):
    _check_count(name, CASES64[name], jax64)


def _check_counter(name, spec, jax_out):
    rows, cols = spec["grid"]
    kc = fabsp.KmerCounter(_cfg(spec), num_pes=rows * cols,
                           grid=spec["grid"], device="cpu")
    for i, b in enumerate(("b1", "b2")):
        _assert_stats(kc.update(INPUTS[b]), jax_out[f"kc_{name}_u{i}"])
    res, stats = kc.finalize()
    bits = encoding.word_bits(spec["k"])
    _assert_result(res, bits, jax_out, f"kc_{name}")
    _assert_stats(stats, jax_out[f"kc_{name}_stats"])
    np.testing.assert_array_equal(
        W.to_numpy_words(kc._committed.keys, bits).reshape(-1),
        jax_out[f"kc_{name}_skeys"])
    np.testing.assert_array_equal(kc.count(INPUTS[spec["queries"]]),
                                  jax_out[f"kc_{name}_q"])
    _assert_stats(kc.last_query_stats, jax_out[f"kc_{name}_qstats"])
    return stats


@pytest.mark.parametrize("name", sorted(COUNTERS13))
def test_counter_2d_matches_jax_k13(jax13, name):
    stats = _check_counter(name, COUNTERS13[name], jax13)
    if "rehash" in name:
        assert stats.retry_store_rehash >= 1


@pytest.mark.parametrize("name", sorted(COUNTERS64))
def test_counter_2d_matches_jax_k31(jax64, name):
    _check_counter(name, COUNTERS64[name], jax64)


# --- the port on its own -----------------------------------------------------

def test_compact_hop2_slices_each_bucket_prefix():
    """On a (1, 1) grid the compact hop 2 forwards each bucket's first
    cap2 slots in stream order, lanes zipped, and charges the rest."""
    n, cap, cap2 = 24, 32, 8
    words = torch.arange(100, 100 + n, dtype=torch.int64)[None, :]
    tags = torch.arange(1, n + 1, dtype=torch.int32)[None, :]
    rr = aggregation.route_lanes(
        (words, tags), ("word", "i32"), torch.zeros((1, n), dtype=torch.int32),
        torch.ones((1, n), dtype=torch.bool), num_pes=1, capacity=cap,
        word_bits=32, grid=(1, 1), hop2_capacity=cap2)
    assert rr.lanes[0].tolist() == [list(range(100, 100 + cap2))]
    assert rr.lanes[1].tolist() == [list(range(1, cap2 + 1))]
    assert rr.hop2_dropped.tolist() == [n - cap2]
    assert rr.sent_valid.tolist() == [n + cap2]
    assert rr.wire_bytes == (cap + cap2) * (4 + 4)


def test_route_lanes_2d_refusals():
    w = torch.zeros((4, 8), dtype=torch.int64)
    own = torch.zeros((4, 8), dtype=torch.int32)
    ok = torch.ones((4, 8), dtype=torch.bool)
    kw = dict(num_pes=4, capacity=4, word_bits=32)
    with pytest.raises(ValueError, match="oneplan"):
        aggregation.route_lanes((w,), ("word",), own, ok, grid=(2, 2),
                                route2d="perhop", hop2_capacity=2,
                                rederive_owners=lambda x: own, **kw)
    with pytest.raises(ValueError, match="1d route"):
        aggregation.route_lanes((w,), ("word",), own, ok, hop2_capacity=2,
                                **kw)
    with pytest.raises(ValueError, match="rederive_owners"):
        aggregation.route_lanes((w,), ("word",), own, ok, grid=(2, 2),
                                route2d="perhop", **kw)
    with pytest.raises(ValueError, match="route2d"):
        aggregation.route_lanes((w,), ("word",), own, ok, grid=(2, 2),
                                route2d="threehop", **kw)


def test_owner_pe_2d_is_the_row_major_fold():
    from repro_torch.core import owner

    w, _ = W.to_torch_words(np.arange(1000, dtype=np.uint32))
    row, col = owner.owner_pe_2d(w, 2, 4, 32)
    assert torch.equal(row * 4 + col, owner.owner_pe(w, 8, 32))
    assert int(row.max()) == 1 and int(col.max()) == 3


def test_bucket_key_orders_by_column_then_row():
    owners = torch.arange(8, dtype=torch.int32)
    key = aggregation.oneplan_bucket_key(owners, 2, 4)
    # owner (r, c) = r * 4 + c -> c * 2 + r
    assert key.tolist() == [0, 2, 4, 6, 1, 3, 5, 7]


def test_compact_never_moves_more_bytes_than_padded():
    cfg = dict(k=13, chunk_reads=16, topology="2d")
    for transport in ("kmer", "superkmer"):
        _, padded = fabsp.count_kmers(
            R, fabsp.DAKCConfig(transport_impl=transport, **cfg), num_pes=8,
            grid=(4, 2), device="cpu")
        _, compact = fabsp.count_kmers(
            R, fabsp.DAKCConfig(transport_impl=transport, hop2_impl="compact",
                                **cfg), num_pes=8, grid=(4, 2), device="cpu")
        assert compact.hop2_dropped == 0 and compact.retry_hop2_fallback == 0
        assert int(compact.wire_bytes) <= int(padded.wire_bytes)
        if transport == "kmer":   # dual L3 leaves the tile under-occupied
            assert int(compact.wire_bytes) < int(padded.wire_bytes)
