"""The sweep kernels of the port -- k-mer extraction, the radix digit
histogram and the run-start flags -- and the chain that reaches them
(extract -> radix_sort -> accumulate(boundaries_impl='kernel')), against
the JAX package, bit-equal.

32-bit words run against the interpreted Pallas kernels (through
`repro.kernels.ops`) in this process; every 64-bit case (k=21 and k=31,
uint64 keys) goes through one x64 subprocess.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import run_jax
from repro.core import serial as jserial
from repro.core import sort as jsort
from repro.kernels import ops as jops
from repro_torch import words as W
from repro_torch.core import sort
from repro_torch.kernels import ops

SENT32 = 0xFFFFFFFF
SENT64 = np.iinfo(np.uint64).max


def _reads(seed, n_reads, m, bits=2):
    return np.random.default_rng(seed).integers(
        0, 1 << bits, size=(n_reads, m), dtype=np.uint8)


def _eq_words(t, ref, bits):
    np.testing.assert_array_equal(W.to_numpy_words(t, bits), np.asarray(ref))


def _boundary_keys(seed, n, pad_frac, dtype, sent):
    keys = np.sort(np.random.default_rng(seed).integers(0, 300, n)
                   .astype(dtype))
    pad = int(n * pad_frac)
    if pad:
        keys[-pad:] = sent
    return keys


def _revcomp(word, k):
    out = 0
    for _ in range(k):
        out = (out << 2) | (3 - (word & 3))
        word >>= 2
    return out


def _canonical_counts(reads, k):
    """serial.count_kmers_python's forward histogram, folded onto
    canonical k-mers."""
    out = {}
    for w, c in jserial.count_kmers_python(reads, k).items():
        key = min(w, _revcomp(w, k))
        out[key] = out.get(key, 0) + c
    return out


def _port_chain(reads, k, sent, pad_to=1024):
    """reads -> canonical k-mers -> radix_sort -> accumulate with the
    boundary kernel, as one sentinel-padded row."""
    words = ops.kmer_extract(torch.from_numpy(reads), k,
                             canonical=True).reshape(1, -1)
    pad = (-words.shape[1]) % pad_to
    words = torch.cat([words, torch.full((1, pad), sent, dtype=torch.int64)],
                      1)
    srt = sort.radix_sort(words, 2 * k, sentinel_val=sent)
    return sort.accumulate(srt, sentinel_val=sent, boundaries_impl="kernel")


def _chain_dict(acc, bits):
    nu = int(acc.num_unique[0])
    keys = W.to_numpy_words(acc.unique[0, :nu], bits).tolist()
    return dict(zip(keys, acc.counts[0, :nu].tolist()))


# --- kmer_extract, 32-bit words -------------------------------------------------

@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [3, 9, 15])
@pytest.mark.parametrize("n_reads,m", [(8, 64), (32, 100), (16, 151)])
def test_kmer_extract_matches_jax(k, n_reads, m, canonical):
    reads = _reads(k * 1000 + m, n_reads, m)
    got = ops.kmer_extract(torch.from_numpy(reads), k, canonical=canonical)
    want = jops.kmer_extract(jnp.asarray(reads), k, canonical=canonical)
    assert got.shape == (n_reads, m - k + 1)
    _eq_words(got, want, 32)


def test_kmer_extract_three_bits_per_symbol_matches_jax():
    reads = _reads(3, 16, 100, bits=3)
    got = ops.kmer_extract(torch.from_numpy(reads), 10, 3)
    _eq_words(got, jops.kmer_extract(jnp.asarray(reads), 10, 3), 32)


@pytest.mark.parametrize("bad", [
    dict(k=16, bits_per_symbol=4), dict(k=9, canonical=True,
                                        bits_per_symbol=3),
    dict(k=65), dict(k=0), dict(k=3, bits_per_symbol=9)])
def test_kmer_extract_refuses_bad_arguments(bad):
    """Words wider than 62 bits, canonical forms of non-DNA codes, k outside
    [1, m] and symbols wider than 8 bits raise."""
    reads = torch.zeros((8, 64), dtype=torch.uint8)
    with pytest.raises(ValueError):
        ops.kmer_extract(reads, **bad)


# --- radix_hist, 32-bit words ---------------------------------------------------

RH_KEYS = np.random.default_rng(7).integers(0, 1 << 32, 4096).astype(
    np.uint32)
RH_KEYS[::9] = SENT32


@pytest.mark.parametrize("tile", [512, 1024])
@pytest.mark.parametrize("shift", [0, 8, 24])
@pytest.mark.parametrize("digit_bits", [2, 4, 8])
def test_radix_hist_matches_jax(digit_bits, shift, tile):
    got = ops.radix_hist(W.to_torch_words(RH_KEYS)[0], shift, digit_bits,
                         tile)
    want = jops.radix_hist(jnp.asarray(RH_KEYS), shift, digit_bits, tile)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) == RH_KEYS.size


def test_radix_hist_past_the_32_bit_word_is_digit_zero():
    """A 32-bit word shifted by its width or more reads digit 0, in the JAX
    package's uint32 shift and in the port's zero-extended int64."""
    t = W.to_torch_words(RH_KEYS)[0]
    for shift in (32, 40):
        got = ops.radix_hist(t, shift, 4, 1024)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jops.radix_hist(jnp.asarray(RH_KEYS),
                                                    shift, 4, 1024)))
        assert int(got[:, 0].sum()) == RH_KEYS.size


def test_radix_hist_rows_and_refusals():
    """(P, n) rows histogram one by one; a tile that does not divide n
    raises, as in JAX."""
    t = W.to_torch_words(RH_KEYS.reshape(4, 1024))[0]
    got = ops.radix_hist(t, 4, 4, 512)
    assert got.shape == (4, 2, 16)
    for r in range(4):
        assert torch.equal(got[r], ops.radix_hist(t[r], 4, 4, 512))
    with pytest.raises(ValueError):
        ops.radix_hist(t, 0, 4, 1000)
    with pytest.raises(ValueError):
        jops.radix_hist(jnp.asarray(RH_KEYS), 0, 4, 1000)


# --- segment_boundaries and accumulate, 32-bit words ----------------------------

@pytest.mark.parametrize("tile", [128, 1024])
@pytest.mark.parametrize("pad_frac", [0.0, 0.3, 1.0])
def test_segment_boundaries_matches_jax(tile, pad_frac):
    """pad 1.0 is a row that is all sentinel. The port takes no tile: the
    JAX tile only pads, so every tile gives the port's flags."""
    keys = _boundary_keys(int(pad_frac * 10) + tile, 2048, pad_frac,
                          np.uint32, SENT32)
    got = ops.segment_boundaries(W.to_torch_words(keys)[0],
                                 sentinel_val=SENT32)
    want = jops.segment_boundaries(jnp.asarray(keys), sentinel_val=SENT32,
                                   tile=tile)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (not bool(got.any())) == (pad_frac == 1.0)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("n", [64, 1000, 2048])
def test_accumulate_boundary_kernel_matches_jax_pallas(n, weighted):
    rng = np.random.default_rng(n)
    keys = np.sort(rng.integers(0, 97, n).astype(np.uint32))
    keys[-n // 5:] = SENT32
    w = rng.integers(1, 9, n, dtype=np.int32)
    got = sort.accumulate(W.to_torch_words(keys[None])[0],
                          torch.from_numpy(w[None]) if weighted else None,
                          sentinel_val=SENT32, boundaries_impl="kernel")
    want = jsort.accumulate(jnp.asarray(keys),
                            jnp.asarray(w) if weighted else None,
                            sentinel_val=SENT32, boundaries_impl="pallas")
    _eq_words(got.unique[0], want.unique, 32)
    np.testing.assert_array_equal(got.counts[0].numpy(),
                                  np.asarray(want.counts))
    assert int(got.num_unique[0]) == int(want.num_unique)


def test_accumulate_boundaries_impl_knob():
    """'inline' and 'kernel' agree; 'fused' ignores the knob; an unknown
    value raises under 'segment_sum', as in JAX."""
    keys = W.to_torch_words(_boundary_keys(1, 1000, 0.2, np.uint32,
                                           SENT32)[None])[0]
    a = sort.accumulate(keys, sentinel_val=SENT32)
    b = sort.accumulate(keys, sentinel_val=SENT32, boundaries_impl="kernel")
    c = sort.accumulate(keys, sentinel_val=SENT32, impl="fused",
                        boundaries_impl="unknown")
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f))
        assert torch.equal(getattr(a, f), getattr(c, f))
    with pytest.raises(ValueError):
        sort.accumulate(keys, sentinel_val=SENT32, boundaries_impl="jnp")
    with pytest.raises(ValueError):
        jsort.accumulate(jnp.asarray(W.to_numpy_words(keys[0], 32)),
                         sentinel_val=SENT32, boundaries_impl="kernel")


def test_boundary_kernel_counts_no_launch_on_the_cpu():
    ops.reset_launches()
    sort.accumulate(torch.zeros((1, 8), dtype=torch.int64), sentinel_val=-1,
                    boundaries_impl="kernel")
    ops.kmer_extract(torch.zeros((1, 8), dtype=torch.uint8), 3)
    ops.radix_hist(torch.zeros((8,), dtype=torch.int64), 0, 4, 8)
    assert set(ops.launch_counts().values()) == {0}


# --- the slice as a whole, 32-bit words ------------------------------------------

def test_extract_sort_accumulate_chain_matches_jax_k13():
    reads = _reads(13, 32, 100)
    got = _port_chain(reads, 13, SENT32)
    jw = jops.kmer_extract(jnp.asarray(reads), 13, canonical=True).reshape(-1)
    pad = (-jw.shape[0]) % 1024
    jw = jnp.concatenate([jw, jnp.full((pad,), SENT32, jnp.uint32)])
    jsrt = jsort.radix_sort(jw, 26, sentinel_val=SENT32)
    want = jsort.accumulate(jsrt, sentinel_val=SENT32,
                            boundaries_impl="pallas")
    _eq_words(got.unique[0], want.unique, 32)
    np.testing.assert_array_equal(got.counts[0].numpy(),
                                  np.asarray(want.counts))
    assert int(got.num_unique[0]) == int(want.num_unique)
    assert _chain_dict(got, 32) == _canonical_counts(reads, 13)


# --- 64-bit words: JAX in one x64 subprocess --------------------------------------

def _inputs64():
    rng = np.random.default_rng(64)
    keys = rng.integers(0, 1 << 63, size=4096, dtype=np.uint64)
    keys[::3] |= np.uint64(1 << 63)            # the top bit set
    keys[::7] = SENT64
    return {"reads": _reads(31, 16, 151),
            "hist_keys": keys,
            "bound_keys": _boundary_keys(5, 2048, 0.3, np.uint64, SENT64),
            "chain_reads": _reads(131, 16, 100)}


INPUTS64 = _inputs64()
EXTRACT64 = [(k, c) for k in (21, 31) for c in (False, True)]
HIST64 = [(4, 60, 1024), (8, 60, 512), (2, 0, 512), (4, 32, 1024),
          (8, 56, 1024)]

_BODY64 = """
from repro.core import sort
from repro.kernels import ops
sent = int(np.iinfo(np.uint64).max)
for k in (21, 31):
    for c in (False, True):
        O[f"extract_{k}_{c}"] = ops.kmer_extract(jnp.asarray(I["reads"]), k,
                                                 canonical=c)
for d, s, t in %r:
    O[f"hist_{d}_{s}_{t}"] = ops.radix_hist(jnp.asarray(I["hist_keys"]), s,
                                            d, t)
O["bound"] = ops.segment_boundaries(jnp.asarray(I["bound_keys"]),
                                    sentinel_val=sent, tile=1024)
acc = sort.accumulate(jnp.asarray(I["bound_keys"]), sentinel_val=sent,
                      boundaries_impl="pallas")
O["acc_unique"], O["acc_counts"] = acc.unique, acc.counts
w = ops.kmer_extract(jnp.asarray(I["chain_reads"]), 31,
                     canonical=True).reshape(-1)
w = jnp.concatenate([w, jnp.full(((-w.shape[0]) %% 1024,), sent, w.dtype)])
acc = sort.accumulate(sort.radix_sort(w, 62, sentinel_val=sent),
                      sentinel_val=sent, boundaries_impl="pallas")
O["chain_unique"], O["chain_counts"] = acc.unique, acc.counts
""" % (HIST64,)


@pytest.fixture(scope="module")
def jax64(tmp_path_factory):
    return run_jax(tmp_path_factory.mktemp("sweeps64"), _BODY64, INPUTS64,
                   x64=True)


@pytest.mark.parametrize("k,canonical", EXTRACT64)
def test_kmer_extract_matches_jax_64bit(jax64, k, canonical):
    got = ops.kmer_extract(torch.from_numpy(INPUTS64["reads"]), k,
                           canonical=canonical)
    _eq_words(got, jax64[f"extract_{k}_{canonical}"], 64)


@pytest.mark.parametrize("digit_bits,shift,tile", HIST64)
def test_radix_hist_matches_jax_64bit(jax64, digit_bits, shift, tile):
    """Shift 60 reads the top digit of the unsigned word: the sentinel and
    every word with its top bit set land in the upper bins, never in the
    bins an arithmetic shift would give."""
    got = ops.radix_hist(W.to_torch_words(INPUTS64["hist_keys"])[0], shift,
                         digit_bits, tile)
    np.testing.assert_array_equal(got.numpy(),
                                  jax64[f"hist_{digit_bits}_{shift}_{tile}"])
    if shift == 60:
        top = int(got[:, 8:16].sum())
        high = int((INPUTS64["hist_keys"] >> np.uint64(63)).sum())
        assert top == high and int(got[:, 16:].sum()) == 0


def test_segment_boundaries_and_accumulate_match_jax_64bit(jax64):
    keys = W.to_torch_words(INPUTS64["bound_keys"])[0]
    got = ops.segment_boundaries(keys, sentinel_val=-1)
    np.testing.assert_array_equal(got.numpy(), jax64["bound"])
    acc = sort.accumulate(keys[None], sentinel_val=-1,
                          boundaries_impl="kernel")
    _eq_words(acc.unique[0], jax64["acc_unique"], 64)
    np.testing.assert_array_equal(acc.counts[0].numpy(), jax64["acc_counts"])


def test_extract_sort_accumulate_chain_matches_jax_k31(jax64):
    reads = INPUTS64["chain_reads"]
    got = _port_chain(reads, 31, -1)
    _eq_words(got.unique[0], jax64["chain_unique"], 64)
    np.testing.assert_array_equal(got.counts[0].numpy(),
                                  jax64["chain_counts"])
    assert _chain_dict(got, 64) == _canonical_counts(reads, 31)
