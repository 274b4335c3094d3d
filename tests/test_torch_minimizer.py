"""The super-k-mer transport's building blocks in the port against the JAX
package, bit-equal on the same numpy inputs: the order hash, the sliding
minimum and its pair (the JAX kernels in interpret mode), minimizers,
segmentation, the receiver's decode, and the pre-route compaction.
64-bit words (m-mers of m >= 16, k = 31) go through one x64 subprocess.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import run_jax
from repro.core import aggregation as jagg
from repro.core import minimizer as jmin
from repro.core import owner as jowner
from repro.data import genome as jgenome
from repro.kernels import ops as jops
from repro_torch import words as W
from repro_torch.core import aggregation, minimizer, owner
from repro_torch.kernels import ops

SENT32 = 0xFFFFFFFF
READS = jgenome.sample_reads(jgenome.ReadSetSpec(
    genome_bases=2048, n_reads=24, read_len=60, heavy_hitter_frac=0.2,
    seed=5))
READS_POLY_A = np.zeros((4, 48), np.uint8)


def _t(a):
    return W.to_torch_words(np.asarray(a))[0]


def _np32(t):
    return W.to_numpy_words(t, 32)


# --- order hash --------------------------------------------------------------

def test_order_key_matches_jax_32bit():
    x = np.random.default_rng(0).integers(0, 1 << 32, 4096, dtype=np.uint64
                                          ).astype(np.uint32)
    x[:3] = [0, 1, SENT32]
    np.testing.assert_array_equal(_np32(owner.order_key(_t(x), 32)),
                                  np.asarray(jowner.order_key(jnp.asarray(x))))


# --- sliding minimum, 32-bit -------------------------------------------------

def _ties(rng, rows, n_pos):
    """Few distinct values, so windows hold ties of key and of value."""
    return rng.integers(0, 6, size=(rows, n_pos)).astype(np.uint32)


@pytest.mark.parametrize("window", [1, 2, 7, 25, 40])
def test_sliding_min_matches_jax(window):
    rng = np.random.default_rng(window)
    vals = rng.integers(0, 1 << 32, size=(9, 40), dtype=np.uint64
                        ).astype(np.uint32)
    vals[::2] = _ties(rng, 5, 40)
    np.testing.assert_array_equal(
        _np32(ops.sliding_min(_t(vals), window)),
        np.asarray(jops.sliding_min(jnp.asarray(vals), window)))


@pytest.mark.parametrize("window", [1, 3, 25, 40])
def test_sliding_min_pair_matches_jax(window):
    rng = np.random.default_rng(100 + window)
    keys = _ties(rng, 6, 40)
    vals = rng.integers(0, 1000, size=(6, 40)).astype(np.uint32)
    got_k, got_v = ops.sliding_min_pair(_t(keys), _t(vals), window)
    want_k, want_v = jops.sliding_min_pair(jnp.asarray(keys),
                                           jnp.asarray(vals), window)
    np.testing.assert_array_equal(_np32(got_k), np.asarray(want_k))
    np.testing.assert_array_equal(_np32(got_v), np.asarray(want_v))


def test_sliding_min_rejects_bad_window():
    vals = torch.zeros((2, 10), dtype=torch.int64)
    for window in (0, 11):
        with pytest.raises(ValueError, match="window"):
            ops.sliding_min(vals, window)
        with pytest.raises(ValueError, match="window"):
            ops.sliding_min_pair(vals, vals, window)


# --- minimizers, segmentation, decode at k=13 --------------------------------

CASES13 = [(reads, m, order, canonical)
           for reads in ("genome", "poly_a") for m in (5, 7)
           for order in ("plain", "hashed") for canonical in (False, True)]


def _reads(name):
    return READS if name == "genome" else READS_POLY_A


@pytest.mark.parametrize("reads,m,order,canonical", CASES13)
def test_segment_superkmers_matches_jax_k13(reads, m, order, canonical):
    codes = _reads(reads)
    kw = dict(canonical=canonical, order=order)
    want = jmin.segment_superkmers(jnp.asarray(codes), 13, m, **kw)
    got = minimizer.segment_superkmers(torch.from_numpy(codes), 13, m, **kw)
    np.testing.assert_array_equal(_np32(got.words), np.asarray(want.words))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    mbits = 32 if m <= 15 else 64
    np.testing.assert_array_equal(W.to_numpy_words(got.minimizers, mbits),
                                  np.asarray(want.minimizers))
    np.testing.assert_array_equal(
        W.to_numpy_words(minimizer.window_minimizers(
            torch.from_numpy(codes), 13, m, **kw), mbits),
        np.asarray(jmin.window_minimizers(jnp.asarray(codes), 13, m, **kw)))


@pytest.mark.parametrize("reads,m,order,canonical", CASES13)
def test_receiver_decode_matches_jax_k13(reads, m, order, canonical):
    codes = _reads(reads)
    sk = jmin.segment_superkmers(jnp.asarray(codes), 13, m,
                                 canonical=canonical, order=order)
    words, lengths = _t(sk.words), torch.from_numpy(np.array(sk.lengths))
    kk, cc = minimizer.superkmer_to_kmers(words, lengths, 13, m,
                                          canonical=canonical)
    jk, jc = jmin.superkmer_to_kmers(sk.words, sk.lengths, 13, m,
                                     canonical=canonical)
    np.testing.assert_array_equal(_np32(kk), np.asarray(jk))
    np.testing.assert_array_equal(cc.numpy(), np.asarray(jc))
    live = np.asarray(sk.lengths) > 0
    mz = minimizer.superkmer_minimizers(words, 13, m, canonical=canonical,
                                        order=order)
    np.testing.assert_array_equal(
        _np32(mz)[live], np.asarray(jmin.superkmer_minimizers(
            sk.words, 13, m, canonical=canonical, order=order))[live])
    # every slot's minimizer is the one the sender grouped it by
    np.testing.assert_array_equal(_np32(mz)[live],
                                  np.asarray(sk.minimizers)[live])


SIZES = ((13, 7), (13, 13), (15, 1), (31, 7), (31, 15), (31, 20), (21, 1))


def _sizes(mod):
    return [(mod.superkmer_words(k, m), mod.slot_bytes(k, m),
             mod.expected_superkmers(256, 150, k, m)) for k, m in SIZES]


# --- pre-route compaction ----------------------------------------------------

@pytest.mark.parametrize("capacity", [64, 150, 400])
@pytest.mark.parametrize("impl", ["radix", "argsort"])
def test_compact_lanes_matches_jax(capacity, impl):
    rng = np.random.default_rng(capacity)
    n = 400
    valid = rng.random((3, n)) < 0.3
    valid[2] = rng.random(n) < 0.9          # this row overflows a small cap
    words = rng.integers(0, 1 << 30, size=(3, n)).astype(np.uint32)
    owners = rng.integers(0, 8, size=(3, n)).astype(np.int32)
    lanes, nv, ovf = aggregation.compact_lanes(
        (_t(words), torch.from_numpy(owners)), ("word", "i32"),
        torch.from_numpy(valid), capacity, word_bits=32, impl=impl)
    for r in range(3):
        (jw, jo), jv, jovf = jagg.compact_lanes(
            (jnp.asarray(words[r]), jnp.asarray(owners[r])),
            ("word", "i32"), jnp.asarray(valid[r]), capacity, impl=impl)
        np.testing.assert_array_equal(_np32(lanes[0][r]), np.asarray(jw))
        np.testing.assert_array_equal(lanes[1][r].numpy(), np.asarray(jo))
        np.testing.assert_array_equal(nv[r].numpy(), np.asarray(jv))
        assert int(ovf[r]) == int(jovf)


# --- 64-bit words: JAX in an x64 subprocess ----------------------------------

def _inputs64():
    rng = np.random.default_rng(64)
    keys = rng.integers(0, 1 << 63, size=(5, 40), dtype=np.uint64)
    keys[:, ::3] |= np.uint64(1 << 63)             # top bit set: unsigned
    keys[0] = rng.integers(0, 4, 40).astype(np.uint64) | np.uint64(1 << 63)
    reads31 = jgenome.sample_reads(jgenome.ReadSetSpec(
        genome_bases=2048, n_reads=12, read_len=64, seed=8))
    return {"keys": keys, "vals": rng.integers(0, 1 << 40, size=(5, 40),
                                               dtype=np.uint64),
            "order_in": rng.integers(0, 1 << 64, 2048, dtype=np.uint64),
            "reads31": reads31}


INPUTS64 = _inputs64()
WINDOWS64 = (1, 4, 40)
CASES31 = [(m, order, canonical) for m in (7, 15, 20)
           for order in ("plain", "hashed") for canonical in (False, True)]

_BODY64 = """
from repro.core import minimizer, owner
from repro.kernels import ops
O["order"] = owner.order_key(jnp.asarray(I["order_in"]))
O["sizes"] = np.array([(minimizer.superkmer_words(k, m),
                        minimizer.slot_bytes(k, m),
                        minimizer.expected_superkmers(256, 150, k, m))
                       for k, m in SIZES])
for w in WINDOWS:
    O[f"min_{w}"] = ops.sliding_min(jnp.asarray(I["keys"]), w)
    k, v = ops.sliding_min_pair(jnp.asarray(I["keys"]), jnp.asarray(I["vals"]),
                                w)
    O[f"pk_{w}"], O[f"pv_{w}"] = k, v
codes = jnp.asarray(I["reads31"])
for m, order, canon in CASES:
    tag = f"{m}_{order}_{int(canon)}"
    sk = minimizer.segment_superkmers(codes, 31, m, canonical=canon,
                                      order=order)
    O["w_" + tag], O["l_" + tag], O["z_" + tag] = sk
    kk, cc = minimizer.superkmer_to_kmers(sk.words, sk.lengths, 31, m,
                                          canonical=canon)
    O["k_" + tag], O["c_" + tag] = kk, cc
    O["r_" + tag] = minimizer.superkmer_minimizers(sk.words, 31, m,
                                                   canonical=canon,
                                                   order=order)
"""


@pytest.fixture(scope="module")
def jax64(tmp_path_factory):
    body = (f"WINDOWS = {WINDOWS64!r}\nCASES = {CASES31!r}\n"
            f"SIZES = {SIZES!r}\n" + _BODY64)
    return run_jax(tmp_path_factory.mktemp("minimizer64"), body, INPUTS64,
                   x64=True)


def _np64(t):
    return W.to_numpy_words(t, 64)


def test_superkmer_sizes_match_jax(jax64):
    np.testing.assert_array_equal(np.array(_sizes(minimizer)),
                                  jax64["sizes"])


def test_order_key_matches_jax_64bit(jax64):
    np.testing.assert_array_equal(
        _np64(owner.order_key(_t(INPUTS64["order_in"]), 64)), jax64["order"])


@pytest.mark.parametrize("window", WINDOWS64)
def test_sliding_min_unsigned_matches_jax_64bit(jax64, window):
    keys, vals = _t(INPUTS64["keys"]), _t(INPUTS64["vals"])
    np.testing.assert_array_equal(_np64(ops.sliding_min(keys, window)),
                                  jax64[f"min_{window}"])
    got_k, got_v = ops.sliding_min_pair(keys, vals, window)
    np.testing.assert_array_equal(_np64(got_k), jax64[f"pk_{window}"])
    np.testing.assert_array_equal(_np64(got_v), jax64[f"pv_{window}"])


@pytest.mark.parametrize("m,order,canonical", CASES31)
def test_superkmers_match_jax_k31(jax64, m, order, canonical):
    tag = f"{m}_{order}_{int(canonical)}"
    codes = torch.from_numpy(INPUTS64["reads31"])
    sk = minimizer.segment_superkmers(codes, 31, m, canonical=canonical,
                                      order=order)
    mbits = 32 if m <= 15 else 64
    np.testing.assert_array_equal(_np64(sk.words), jax64["w_" + tag])
    np.testing.assert_array_equal(sk.lengths.numpy(), jax64["l_" + tag])
    np.testing.assert_array_equal(W.to_numpy_words(sk.minimizers, mbits),
                                  jax64["z_" + tag])
    kk, cc = minimizer.superkmer_to_kmers(sk.words, sk.lengths, 31, m,
                                          canonical=canonical)
    np.testing.assert_array_equal(_np64(kk), jax64["k_" + tag])
    np.testing.assert_array_equal(cc.numpy(), jax64["c_" + tag])
    live = sk.lengths.numpy() > 0
    mz = minimizer.superkmer_minimizers(sk.words, 31, m, canonical=canonical,
                                        order=order)
    np.testing.assert_array_equal(W.to_numpy_words(mz, mbits)[live],
                                  jax64["r_" + tag][live])
