"""The port's words, encoding and hashes against the JAX package, bit-equal.

32-bit words (k=13) are held against JAX in this process; 64-bit words
(k=21, k=31) against JAX in one x64 subprocess that runs every case. The
inputs include words with the top bit set.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import run_jax
from repro.core import countstore as jcs
from repro.core import encoding as jenc
from repro.core import owner as jown
from repro_torch import words as W
from repro_torch.core import countstore, encoding, owner

PES = (4, 6, 8)
CAPS = (1000, 4096, 188_743_680)


def _inputs():
    rng = np.random.default_rng(7)
    reads = rng.integers(0, 4, size=(6, 45), dtype=np.uint8)
    reads[0] = 0                                    # poly-A
    reads[1] = 3                                    # poly-T
    w32 = rng.integers(0, 1 << 32, size=600, dtype=np.uint64).astype(np.uint32)
    w64 = rng.integers(0, 1 << 63, size=600, dtype=np.uint64) * 2 \
        + rng.integers(0, 2, size=600, dtype=np.uint64)
    w32[:4] = [0, 1, 0x7FFFFFFF, 0xFFFFFFFE]
    w64[:4] = [0, 1, (1 << 63) - 1, (1 << 64) - 2]
    return {"reads": reads, "w32": w32, "w64": w64}


INPUTS = _inputs()

_BODY64 = """
from repro.core import countstore, encoding, owner
reads = jnp.asarray(I["reads"])
for k in (21, 31):
    fwd = encoding.extract_kmers(reads, k)
    O[f"fwd{k}"] = fwd
    for impl in ("fused", "sweep"):
        O[f"can{k}{impl}"] = encoding.extract_kmers(
            reads, k, canonical=True, canonical_impl=impl)
    O[f"rc{k}"] = encoding.revcomp(fwd, k)
    O[f"canon{k}"] = encoding.canonical(fwd, k)
fwd = encoding.extract_kmers(reads, 21)
cnt = jnp.arange(fwd.shape[0], dtype=jnp.int32) * 4099 + 1
O["pack21"] = encoding.pack_counts(fwd, cnt, 21)
km, c = encoding.unpack_counts(jnp.asarray(I["w64"]), 21)
O["unpk21"], O["unpc21"] = km, c
w = jnp.asarray(I["w64"])
O["hash"] = owner.hash_kmers(w)
O["slot"] = owner.slot_hash(w)
for p in (4, 6, 8):
    O[f"owner{p}"] = owner.owner_pe(w, p)
for cap in (1000, 4096, 188_743_680):
    O[f"slots{cap}"] = countstore.store_slots(w, cap)
"""


@pytest.fixture(scope="module")
def jax64(tmp_path_factory):
    return run_jax(tmp_path_factory.mktemp("words64"), _BODY64, INPUTS,
                   x64=True)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(t, ref, bits):
    np.testing.assert_array_equal(W.to_numpy_words(t, bits), np.asarray(ref))


# --- 32-bit words, JAX in this process --------------------------------------

@pytest.mark.parametrize("canon", [None, "fused", "sweep"])
def test_extract_kmers_k13(canon):
    reads = INPUTS["reads"]
    kw = {} if canon is None else {"canonical": True, "canonical_impl": canon}
    want = jenc.extract_kmers(jnp.asarray(reads), 13, **kw)
    got = encoding.extract_kmers(_t(reads), 13, **kw)
    assert encoding.word_bits(13) == 32
    _eq(got, want, 32)


def test_revcomp_canonical_k13():
    fwd = jenc.extract_kmers(jnp.asarray(INPUTS["reads"]), 13)
    t = W.to_torch_words(np.asarray(fwd))[0]
    _eq(encoding.revcomp(t, 13), jenc.revcomp(fwd, 13), 32)
    _eq(encoding.canonical(t, 13), jenc.canonical(fwd, 13), 32)


def test_pack_unpack_counts_k13():
    fwd = jenc.extract_kmers(jnp.asarray(INPUTS["reads"]), 13)
    cnt = np.arange(fwd.shape[0], dtype=np.int32) % 90 + 1   # some saturate
    t = W.to_torch_words(np.asarray(fwd))[0]
    packed = encoding.pack_counts(t, _t(cnt), 13)
    _eq(packed, jenc.pack_counts(fwd, jnp.asarray(cnt), 13), 32)
    w32 = jnp.asarray(INPUTS["w32"])
    km, c = encoding.unpack_counts(W.to_torch_words(INPUTS["w32"])[0], 13)
    jkm, jc = jenc.unpack_counts(w32, 13)
    _eq(km, jkm, 32)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    assert encoding.count_capacity(13) == jenc.count_capacity(13)


def test_hashes_32bit():
    w = jnp.asarray(INPUTS["w32"])
    t = W.to_torch_words(INPUTS["w32"])[0]
    _eq(owner.hash_kmers(t, 32), jown.hash_kmers(w), 32)
    _eq(owner.slot_hash(t, 32), jown.slot_hash(w), 32)


@pytest.mark.parametrize("p", PES)
def test_owner_pe_32bit(p):
    t = W.to_torch_words(INPUTS["w32"])[0]
    got = owner.owner_pe(t, p, 32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jown.owner_pe(jnp.asarray(INPUTS["w32"]), p)))


@pytest.mark.parametrize("cap", CAPS)
def test_store_slots_32bit(cap):
    t = W.to_torch_words(INPUTS["w32"])[0]
    np.testing.assert_array_equal(
        countstore.store_slots(t, cap, 32).numpy(),
        np.asarray(jcs.store_slots(jnp.asarray(INPUTS["w32"]), cap)))


# --- 64-bit words, JAX in an x64 subprocess ---------------------------------

@pytest.mark.parametrize("k", [21, 31])
def test_extract_revcomp_canonical_64bit(jax64, k):
    reads = _t(INPUTS["reads"])
    assert encoding.word_bits(k) == 64
    fwd = encoding.extract_kmers(reads, k)
    _eq(fwd, jax64[f"fwd{k}"], 64)
    for impl in ("fused", "sweep"):
        _eq(encoding.extract_kmers(reads, k, canonical=True,
                                   canonical_impl=impl),
            jax64[f"can{k}{impl}"], 64)
    _eq(encoding.revcomp(fwd, k), jax64[f"rc{k}"], 64)
    _eq(encoding.canonical(fwd, k), jax64[f"canon{k}"], 64)


def test_pack_unpack_counts_k21(jax64):
    """k=21 packs counts into bits 42-63: the top bit is live, and the
    unpack shift must be logical."""
    fwd = encoding.extract_kmers(_t(INPUTS["reads"]), 21)
    cnt = torch.arange(fwd.shape[0], dtype=torch.int32) * 4099 + 1
    _eq(encoding.pack_counts(fwd, cnt, 21), jax64["pack21"], 64)
    km, c = encoding.unpack_counts(W.to_torch_words(INPUTS["w64"])[0], 21)
    _eq(km, jax64["unpk21"], 64)
    np.testing.assert_array_equal(c.numpy(), jax64["unpc21"])
    assert encoding.count_capacity(31) == 2     # k=31 resolves to 'dual'


def test_hashes_64bit(jax64):
    t = W.to_torch_words(INPUTS["w64"])[0]
    _eq(owner.hash_kmers(t, 64), jax64["hash"], 64)
    _eq(owner.slot_hash(t, 64), jax64["slot"], 64)


@pytest.mark.parametrize("p", PES)
def test_owner_pe_64bit(jax64, p):
    t = W.to_torch_words(INPUTS["w64"])[0]
    np.testing.assert_array_equal(owner.owner_pe(t, p, 64).numpy(),
                                  jax64[f"owner{p}"])


@pytest.mark.parametrize("cap", CAPS)
def test_store_slots_64bit(jax64, cap):
    """`h % capacity` of an unsigned 64-bit hash, for capacities that are
    not powers of two, on hashes with the top bit set."""
    t = W.to_torch_words(INPUTS["w64"])[0]
    np.testing.assert_array_equal(countstore.store_slots(t, cap, 64).numpy(),
                                  jax64[f"slots{cap}"])


# --- the word representation itself -----------------------------------------

def test_int64_multiply_wraps_like_uint64():
    """The 64-bit mixer relies on int64 products wrapping mod 2**64."""
    a = INPUTS["w64"]
    c = np.uint64(0xBF58476D1CE4E5B9)
    with np.errstate(over="ignore"):
        want = a * c
    got = W.to_torch_words(a)[0] * (int(c) - (1 << 64))
    _eq(got, want, 64)


@pytest.mark.parametrize("bits", [32, 64])
def test_words_round_trip_and_sentinel(bits):
    a = INPUTS[f"w{bits}"]
    t, b = W.to_torch_words(a)
    assert b == bits and t.dtype == torch.int64
    np.testing.assert_array_equal(W.to_numpy_words(t, bits), a)
    dt = np.uint32 if bits == 32 else np.uint64
    sent = W.to_numpy_words(torch.tensor([W.sentinel(bits)]), bits)[0]
    assert sent == np.iinfo(dt).max
    shifted = W.to_numpy_words(W.srl(t, 5, bits), bits)
    np.testing.assert_array_equal(shifted, a >> dt(5))
