"""The port's sort, accumulate, L3 and routing against the JAX package,
per PE and bit-equal.

32-bit words run against JAX in this process; 1d `route_lanes` runs against
the JAX route on a real P-device mesh in a subprocess, and 64-bit words
(k=21, k=31) in an x64 subprocess.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import run_jax
from repro.core import aggregation as jagg
from repro.core import fabsp as jfabsp
from repro.core import sort as jsort
from repro_torch import words as W
from repro_torch.core import aggregation, fabsp, sort

SENT32 = 0xFFFFFFFF
SENT64 = np.iinfo(np.uint64).max


def _words(rng, rows, n, k, dtype, sent, distinct=None):
    hi = 1 << (2 * k)
    pool = rng.integers(0, hi, size=distinct or n, dtype=np.uint64)
    w = rng.choice(pool, size=(rows, n)).astype(dtype)
    w[:, ::9] = sent
    return w


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq_words(t, ref, bits):
    np.testing.assert_array_equal(W.to_numpy_words(t, bits), np.asarray(ref))


W13 = _words(np.random.default_rng(1), 3, 1500, 13, np.uint32, SENT32,
             distinct=400)


# --- 32-bit words, JAX in this process ---------------------------------------

def test_radix_sort_matches_jax_k13():
    t = W.to_torch_words(W13)[0]
    wts = np.arange(W13.size, dtype=np.int32).reshape(W13.shape)
    got = sort.radix_sort(t, 26, sentinel_val=SENT32)
    gk, gw = sort.radix_sort_with_weights(t, _t(wts), 26, sentinel_val=SENT32)
    ak, aw = sort.sort_with_weights(t, _t(wts))
    for r in range(3):
        jw = jnp.asarray(W13[r])
        _eq_words(got[r], jsort.radix_sort(jw, 26, sentinel_val=SENT32), 32)
        jk, jwt = jsort.radix_sort_with_weights(jw, jnp.asarray(wts[r]), 26,
                                                sentinel_val=SENT32)
        _eq_words(gk[r], jk, 32)
        np.testing.assert_array_equal(gw[r].numpy(), np.asarray(jwt))
        jk, jwt = jsort.sort_with_weights(jw, jnp.asarray(wts[r]))
        _eq_words(ak[r], jk, 32)
        np.testing.assert_array_equal(aw[r].numpy(), np.asarray(jwt))


@pytest.mark.parametrize("impl", ["fused", "segment_sum"])
def test_accumulate_matches_jax_k13(impl):
    sw = np.sort(W13, axis=1)
    wts = np.random.default_rng(2).integers(1, 9, size=W13.shape,
                                            dtype=np.int32)
    got = sort.accumulate(W.to_torch_words(sw)[0], _t(wts),
                          sentinel_val=SENT32, impl=impl)
    for r in range(3):
        want = jsort.accumulate(jnp.asarray(sw[r]), jnp.asarray(wts[r]),
                                sentinel_val=SENT32, impl=impl)
        _eq_words(got.unique[r], want.unique, 32)
        np.testing.assert_array_equal(got.counts[r].numpy(),
                                      np.asarray(want.counts))
        assert int(got.num_unique[r]) == int(want.num_unique)


@pytest.mark.parametrize("weighted", [True, False])
def test_accumulate_fused_compacts_as_segment_sum_k13(weighted):
    """impl='fused' (the sweep kernel's compacting mode) against the
    two-pass 'segment_sum' and the JAX accumulate, with and without
    weights."""
    sw = np.sort(W13, axis=1)
    wts = np.random.default_rng(9).integers(1, 9, size=W13.shape,
                                            dtype=np.int32)
    keys = W.to_torch_words(sw)[0]
    w = _t(wts) if weighted else None
    got = sort.accumulate(keys, w, sentinel_val=SENT32, impl="fused")
    oracle = sort.accumulate(keys, w, sentinel_val=SENT32,
                             impl="segment_sum")
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(oracle, f))
    for r in range(3):
        want = jsort.accumulate(jnp.asarray(sw[r]),
                                jnp.asarray(wts[r]) if weighted else None,
                                sentinel_val=SENT32)
        _eq_words(got.unique[r], want.unique, 32)
        np.testing.assert_array_equal(got.counts[r].numpy(),
                                      np.asarray(want.counts))
        assert int(got.num_unique[r]) == int(want.num_unique)


@pytest.mark.parametrize("impl", ["radix", "argsort"])
def test_l3_compress_decompress_matches_jax_k13(impl):
    packed, valid = aggregation.l3_compress(W.to_torch_words(W13)[0], 13,
                                            impl=impl)
    km, cnt = aggregation.l3_decompress(packed, 13)
    for r in range(3):
        jp, jv = jagg.l3_compress(jnp.asarray(W13[r]), 13, impl=impl)
        _eq_words(packed[r], jp, 32)
        np.testing.assert_array_equal(valid[r].numpy(), np.asarray(jv))
        jk, jc = jagg.l3_decompress(jp, 13)
        _eq_words(km[r], jk, 32)
        np.testing.assert_array_equal(cnt[r].numpy(), np.asarray(jc))


@pytest.mark.parametrize("impl", ["radix", "argsort"])
def test_l3_split_dual_matches_jax_k13(impl):
    valid = W13 != SENT32
    got = fabsp._l3_split_dual(W.to_torch_words(W13)[0], _t(valid), 13, 2,
                               impl=impl)
    for r in range(3):
        want = jfabsp._l3_split_dual(jnp.asarray(W13[r]),
                                     jnp.asarray(valid[r]), 13, 2, impl=impl)
        for i, (g, w) in enumerate(zip(got, want)):
            if i in (0, 2):
                _eq_words(g[r], w, 32)
            else:
                np.testing.assert_array_equal(g[r].numpy(), np.asarray(w))


@pytest.mark.parametrize("capacity", [64, 600])
@pytest.mark.parametrize("impl", ["radix", "argsort"])
def test_route_tiles_matches_jax_k13(capacity, impl):
    """Tiles, fill and overflow per PE, at a capacity that overflows (64)
    and one that does not."""
    rng = np.random.default_rng(capacity)
    owners = rng.integers(0, 6, size=W13.shape).astype(np.int32)
    valid = W13 != SENT32
    counts = rng.integers(1, 50, size=W13.shape).astype(np.int32)
    tiles, fill, ovf = aggregation.route_tiles(
        (W.to_torch_words(W13)[0], _t(counts)), ("word", "i32"), _t(owners),
        _t(valid), 6, capacity, word_bits=32, impl=impl)
    for r in range(3):
        jt, jf, jo = jagg.route_tiles(
            (jnp.asarray(W13[r]), jnp.asarray(counts[r])), ("word", "i32"),
            jnp.asarray(owners[r]), jnp.asarray(valid[r]), 6, capacity,
            impl=impl)
        _eq_words(tiles[0][r], jt[0], 32)
        np.testing.assert_array_equal(tiles[1][r].numpy(), np.asarray(jt[1]))
        np.testing.assert_array_equal(fill[r].numpy(), np.asarray(jf))
        assert int(ovf[r]) == int(jo)
    assert (int(ovf.sum()) > 0) == (capacity == 64)


def test_lane_wire_bytes_and_plan_capacity():
    assert aggregation.lane_wire_bytes(("word", "i32"), 64) == 12
    assert aggregation.lane_wire_bytes(("word",), 32) == 4
    with pytest.raises(ValueError):
        aggregation.lane_wire_bytes(("float",), 32)
    for args in ((30720 * 2, 8, 1.5), (1120, 6, 1.01), (7, 4, 1.5)):
        assert aggregation.plan_capacity(*args) == jagg.plan_capacity(*args)


# --- 1d route_lanes against a real P-device mesh -----------------------------

ROUTE_CASES = [(4, 40, ("word",)), (8, 32, ("word", "i32")),
               (8, 4, ("word", "i32"))]          # the last one overflows


def _route_inputs():
    rng = np.random.default_rng(9)
    out = {}
    for i, (p, cap, _) in enumerate(ROUTE_CASES):
        n = 100
        w = _words(rng, p, n, 13, np.uint32, SENT32, distinct=300)
        out[f"w{i}"] = w
        out[f"own{i}"] = rng.integers(0, p, size=(p, n)).astype(np.int32)
        out[f"val{i}"] = w != SENT32
        out[f"cnt{i}"] = rng.integers(1, 9, size=(p, n)).astype(np.int32)
    return out


ROUTE_INPUTS = _route_inputs()

_ROUTE_BODY = f"""
import functools
from jax.sharding import Mesh, PartitionSpec as P
from repro.core import aggregation, compat
cases = {ROUTE_CASES!r}
for i, (p, cap, kinds) in enumerate(cases):
    mesh = Mesh(np.array(jax.devices()[:p]), ("pe",))
    def body(w, own, val, cnt, cap=cap, kinds=kinds, p=p):
        lanes = (w, cnt)[:len(kinds)]
        rr = aggregation.route_lanes(lanes, kinds, own, val, num_pes=p,
                                     capacity=cap, axis_names=("pe",))
        return (tuple(rr.lanes), rr.sent_valid[None], rr.wire_bytes[None],
                rr.overflow[None], rr.fill)
    spec = P("pe")
    fn = jax.jit(compat.shard_map(body, mesh=mesh, in_specs=(spec,) * 4,
                                  out_specs=((spec,) * len(kinds),) + (spec,) * 4))
    lanes, sent, wire, ovf, fill = fn(*(jnp.asarray(I[f"{{x}}{{i}}"].reshape(-1))
                                        for x in ("w", "own", "val", "cnt")))
    for j, lane in enumerate(lanes):
        O[f"lane{{i}}_{{j}}"] = lane
    O[f"sent{{i}}"], O[f"wire{{i}}"], O[f"ovf{{i}}"], O[f"fill{{i}}"] = \\
        sent, wire, ovf, fill
"""


@pytest.fixture(scope="module")
def jax_routes(tmp_path_factory):
    return run_jax(tmp_path_factory.mktemp("routes"), _ROUTE_BODY,
                   ROUTE_INPUTS, devices=8)


@pytest.mark.parametrize("case", range(len(ROUTE_CASES)))
def test_route_lanes_1d_matches_jax_mesh(jax_routes, case):
    """Received tiles in source-major order, sent_valid, wire bytes,
    overflow and the fill histogram of every PE."""
    p, cap, kinds = ROUTE_CASES[case]
    g = lambda x: ROUTE_INPUTS[f"{x}{case}"]          # noqa: E731
    lanes = (W.to_torch_words(g("w"))[0], _t(g("cnt")))[:len(kinds)]
    rr = aggregation.route_lanes(lanes, kinds, _t(g("own")), _t(g("val")),
                                 num_pes=p, capacity=cap, word_bits=32)
    for j, lane in enumerate(rr.lanes):
        want = jax_routes[f"lane{case}_{j}"].reshape(p, p * cap)
        if kinds[j] == "word":
            _eq_words(lane, want, 32)
        else:
            np.testing.assert_array_equal(lane.numpy(), want)
    np.testing.assert_array_equal(rr.sent_valid.numpy(),
                                  jax_routes[f"sent{case}"])
    assert set(jax_routes[f"wire{case}"].tolist()) == {rr.wire_bytes}
    np.testing.assert_array_equal(rr.overflow.numpy(),
                                  jax_routes[f"ovf{case}"])
    np.testing.assert_array_equal(rr.fill.numpy().reshape(-1),
                                  jax_routes[f"fill{case}"])
    assert (int(rr.overflow.sum()) > 0) == (cap == 4)


# --- 64-bit words, JAX in an x64 subprocess ----------------------------------

W31 = _words(np.random.default_rng(4), 3, 1200, 31, np.uint64, SENT64,
             distinct=250)
W21 = _words(np.random.default_rng(6), 3, 1200, 21, np.uint64, SENT64,
             distinct=100)

ACC_W31 = np.random.default_rng(8).integers(1, 9, size=W31.shape,
                                            dtype=np.int32)

_BODY64 = """
from repro.core import aggregation, fabsp, sort
sent = int(np.iinfo(np.uint64).max)
for r in range(3):
    w = jnp.asarray(I["w31"][r])
    s = sort.radix_sort(w, 62, sentinel_val=sent)
    O[f"sort{r}"] = s
    acc = sort.accumulate(s, sentinel_val=sent, impl="fused")
    O[f"acc{r}"] = np.stack([np.asarray(acc.unique).view(np.int64),
                             np.asarray(acc.counts, np.int64)])
    acc = sort.accumulate(s, jnp.asarray(I["acc_w31"][r]), sentinel_val=sent)
    O[f"accw{r}"] = np.stack([np.asarray(acc.unique).view(np.int64),
                              np.asarray(acc.counts, np.int64)])
    O[f"accw{r}_n"] = acc.num_unique
    for j, x in enumerate(fabsp._l3_split_dual(w, w != np.uint64(sent), 31, 2)):
        O[f"dual{r}_{j}"] = x
    p, v = aggregation.l3_compress(jnp.asarray(I["w21"][r]), 21)
    O[f"packed{r}"], O[f"pvalid{r}"] = p, v
    k, c = aggregation.l3_decompress(p, 21)
    O[f"unk{r}"], O[f"unc{r}"] = k, c
"""


@pytest.fixture(scope="module")
def jax64(tmp_path_factory):
    return run_jax(tmp_path_factory.mktemp("sort64"), _BODY64,
                   {"w31": W31, "w21": W21, "acc_w31": ACC_W31}, x64=True)


def test_radix_sort_accumulate_matches_jax_k31(jax64):
    t = W.to_torch_words(W31)[0]
    s = sort.radix_sort(t, 62, sentinel_val=-1)
    acc = sort.accumulate(s, sentinel_val=-1, impl="fused")
    for r in range(3):
        _eq_words(s[r], jax64[f"sort{r}"], 64)
        np.testing.assert_array_equal(acc.unique[r].numpy(),
                                      jax64[f"acc{r}"][0])
        np.testing.assert_array_equal(acc.counts[r].numpy(),
                                      jax64[f"acc{r}"][1])


def test_accumulate_fused_weighted_matches_jax_k31(jax64):
    """The compacting sweep with weights on 64-bit words, against
    'segment_sum' and the JAX accumulate."""
    s = sort.radix_sort(W.to_torch_words(W31)[0], 62, sentinel_val=-1)
    got = sort.accumulate(s, _t(ACC_W31), sentinel_val=-1, impl="fused")
    oracle = sort.accumulate(s, _t(ACC_W31), sentinel_val=-1)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(oracle, f))
    for r in range(3):
        np.testing.assert_array_equal(got.unique[r].numpy(),
                                      jax64[f"accw{r}"][0])
        np.testing.assert_array_equal(got.counts[r].numpy(),
                                      jax64[f"accw{r}"][1])
        assert int(got.num_unique[r]) == int(jax64[f"accw{r}_n"])


def test_l3_split_dual_matches_jax_k31(jax64):
    t = W.to_torch_words(W31)[0]
    got = fabsp._l3_split_dual(t, t != -1, 31, 2)
    for r in range(3):
        for j, g in enumerate(got):
            want = jax64[f"dual{r}_{j}"]
            if j in (0, 2):
                _eq_words(g[r], want, 64)
            else:
                np.testing.assert_array_equal(g[r].numpy(), want)


def test_l3_compress_decompress_matches_jax_k21(jax64):
    """Packed k=21 words carry counts in bits 42-63."""
    packed, valid = aggregation.l3_compress(W.to_torch_words(W21)[0], 21)
    km, cnt = aggregation.l3_decompress(packed, 21)
    for r in range(3):
        _eq_words(packed[r], jax64[f"packed{r}"], 64)
        np.testing.assert_array_equal(valid[r].numpy(), jax64[f"pvalid{r}"])
        _eq_words(km[r], jax64[f"unk{r}"], 64)
        np.testing.assert_array_equal(cnt[r].numpy(), jax64[f"unc{r}"])
