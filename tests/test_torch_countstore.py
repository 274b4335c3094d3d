"""The port's count store against the JAX package: insert, grow and
histogram, bit-equal (on the CPU the port folds in stream order, so even
the slot layout equals the JAX store's). A store built by the JAX package
crosses over with `store_from_numpy` and keeps counting in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import run_jax
from repro.core import countstore as jcs
from repro_torch import words as W
from repro_torch.core import countstore

SENT32 = 0xFFFFFFFF


def _batch(seed, n, k, dtype, distinct):
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << (2 * k), size=distinct, dtype=np.uint64)
    words = rng.choice(pool, size=n).astype(dtype)
    words[::7] = np.iinfo(dtype).max
    counts = rng.integers(0, 5, size=n).astype(np.int32)
    return words, counts


A13 = _batch(1, 700, 13, np.uint32, 300)
B13 = _batch(2, 500, 13, np.uint32, 400)


def _port_store(np_keys, np_counts, dropped=0):
    return countstore.store_from_numpy(np_keys, np_counts, 1,
                                       dropped=[dropped])


def _insert(store, batch):
    words, counts = batch
    return countstore.store_insert(store, W.to_torch_words(words[None])[0],
                                   torch.from_numpy(counts[None]))


def _same_store(port, jstore, bits):
    np.testing.assert_array_equal(W.to_numpy_words(port.keys[0], bits),
                                  np.asarray(jstore.keys))
    np.testing.assert_array_equal(port.counts[0].numpy(),
                                  np.asarray(jstore.counts))
    assert int(port.dropped[0]) == int(jstore.dropped)


@pytest.mark.parametrize("cap", [1000, 1024, 300])
def test_store_insert_matches_jax_k13(cap):
    """Two batches into one store; at 300 slots the store fills and drops."""
    js = jcs.empty_store(cap, jnp.uint32)
    ps = countstore.empty_store(1, cap, 32)
    for batch in (A13, B13):
        js = jcs.store_insert(js, jnp.asarray(batch[0]), jnp.asarray(batch[1]))
        ps = _insert(ps, batch)
        _same_store(ps, js, 32)
    assert (int(ps.dropped[0]) > 0) == (cap == 300)


def test_store_insert_default_counts_k13():
    js = jcs.store_insert(jcs.empty_store(512, jnp.uint32),
                          jnp.asarray(A13[0]))
    ps = countstore.store_insert(countstore.empty_store(1, 512, 32),
                                 W.to_torch_words(A13[0][None])[0])
    _same_store(ps, js, 32)


def test_store_grow_matches_jax_k13():
    js = jcs.store_insert(jcs.empty_store(600, jnp.uint32),
                          jnp.asarray(A13[0]), jnp.asarray(A13[1]))
    ps = _insert(countstore.empty_store(1, 600, 32), A13)
    _same_store(countstore.store_grow(ps, 1500), jcs.store_grow(js, 1500), 32)
    with pytest.raises(ValueError):
        countstore.store_grow(ps, 100)


@pytest.mark.parametrize("impl", ["radix", "argsort"])
def test_store_from_numpy_insert_histogram_k13(impl):
    """A JAX-built store carried across, more inserted into both: equal
    stores and equal histograms."""
    js = jcs.store_insert(jcs.empty_store(900, jnp.uint32),
                          jnp.asarray(A13[0]), jnp.asarray(A13[1]))
    ps = _port_store(np.asarray(js.keys), np.asarray(js.counts),
                     int(js.dropped))
    js = jcs.store_insert(js, jnp.asarray(B13[0]), jnp.asarray(B13[1]))
    ps = _insert(ps, B13)
    _same_store(ps, js, 32)
    want = jcs.store_histogram(js, total_bits=26, impl=impl)
    got = countstore.store_histogram(ps, total_bits=26, impl=impl)
    np.testing.assert_array_equal(W.to_numpy_words(got.unique[0], 32),
                                  np.asarray(want.unique))
    np.testing.assert_array_equal(got.counts[0].numpy(),
                                  np.asarray(want.counts))
    assert int(got.num_unique[0]) == int(want.num_unique)


def test_stacked_stores_are_independent_rows():
    """Row p of a stacked store equals PE p's own store."""
    ps = countstore.empty_store(2, 700, 32)
    words = np.stack([A13[0][:500], B13[0]])
    counts = np.stack([A13[1][:500], B13[1]])
    countstore.store_insert(ps, W.to_torch_words(words)[0],
                            torch.from_numpy(counts))
    hist = countstore.store_histogram(ps, total_bits=26)
    for r in range(2):
        js = jcs.store_insert(jcs.empty_store(700, jnp.uint32),
                              jnp.asarray(words[r]), jnp.asarray(counts[r]))
        want = jcs.store_histogram(js, total_bits=26)
        np.testing.assert_array_equal(W.to_numpy_words(hist.unique[r], 32),
                                      np.asarray(want.unique))
        np.testing.assert_array_equal(hist.counts[r].numpy(),
                                      np.asarray(want.counts))


@pytest.mark.parametrize("cap", [1000, 300])
def test_store_lookup_matches_jax_k13(cap):
    """Two batches into one store, then a lookup of their words, words
    the store lacks and sentinels: counts and probe lengths equal the JAX
    package's `store_lookup` (at 300 slots the store dropped, so some of
    its own words miss), and the stats those of the JAX outputs."""
    js = jcs.empty_store(cap, jnp.uint32)
    ps = countstore.empty_store(1, cap, 32)
    for batch in (A13, B13):
        js = jcs.store_insert(js, jnp.asarray(batch[0]), jnp.asarray(batch[1]))
        ps = _insert(ps, batch)
    miss = _batch(5, 300, 13, np.uint32, 300)[0]
    q = np.concatenate([A13[0], B13[0], miss])
    jc, jp = (np.asarray(x) for x in jcs.store_lookup(js, jnp.asarray(q)))
    stats = torch.zeros((1, 3), dtype=torch.int64)
    counts, probes = countstore.store_lookup(
        ps, W.to_torch_words(q[None])[0], stats)
    np.testing.assert_array_equal(counts[0].numpy(), jc)
    np.testing.assert_array_equal(probes[0].numpy(), jp)
    np.testing.assert_array_equal(
        stats[0].numpy(), [(jc > 0).sum(), jp.astype(np.int64).sum(),
                           jp.max()])
    if cap == 300:
        assert int(ps.dropped[0]) > 0
        assert ((jc[:1200] == 0) & (q[:1200] != SENT32)).any()


# --- 64-bit words (k=31), JAX in an x64 subprocess ---------------------------

A31 = _batch(3, 800, 31, np.uint64, 350)
B31 = _batch(4, 600, 31, np.uint64, 500)

_BODY64 = """
from repro.core import countstore
s = countstore.store_insert(countstore.empty_store(200, jnp.uint64),
                            jnp.asarray(I["a_w"]), jnp.asarray(I["a_c"]))
O["a_keys"], O["a_counts"], O["a_dropped"] = s.keys, s.counts, s.dropped
s = countstore.store_grow(s, 1801)
s = countstore.store_insert(s, jnp.asarray(I["b_w"]), jnp.asarray(I["b_c"]))
O["b_keys"], O["b_counts"], O["b_dropped"] = s.keys, s.counts, s.dropped
h = countstore.store_histogram(s, total_bits=62)
O["h_unique"], O["h_counts"], O["h_n"] = h.unique, h.counts, h.num_unique
"""


@pytest.fixture(scope="module")
def jax64(tmp_path_factory):
    return run_jax(tmp_path_factory.mktemp("store64"), _BODY64,
                   {"a_w": A31[0], "a_c": A31[1], "b_w": B31[0],
                    "b_c": B31[1]}, x64=True)


def test_store_from_numpy_grow_insert_histogram_k31(jax64):
    """A JAX-built k=31 store (which dropped at 200 slots) carried across,
    grown to a non-power-of-two capacity, then more inserted."""
    assert int(jax64["a_dropped"]) > 0
    ps = _port_store(jax64["a_keys"], jax64["a_counts"],
                     int(jax64["a_dropped"]))
    ps = _insert(countstore.store_grow(ps, 1801), B31)
    np.testing.assert_array_equal(W.to_numpy_words(ps.keys[0], 64),
                                  jax64["b_keys"])
    np.testing.assert_array_equal(ps.counts[0].numpy(), jax64["b_counts"])
    assert int(ps.dropped[0]) == int(jax64["b_dropped"])
    h = countstore.store_histogram(ps, total_bits=62)
    np.testing.assert_array_equal(W.to_numpy_words(h.unique[0], 64),
                                  jax64["h_unique"])
    np.testing.assert_array_equal(h.counts[0].numpy(), jax64["h_counts"])
    assert int(h.num_unique[0]) == int(jax64["h_n"])
