"""128-bit k-mers (`repro_torch.core.encoding128`) on the CPU, against the
JAX package's `repro.core.encoding128` in an x64 subprocess.

At k=32, 47 and 63, on the same reads: the packed (hi, lo) pairs, their
flat extraction, the unsigned lexicographic sort (with all-ones padding
pairs mixed in, which must sort last), the owners of 3 and 8 PEs, the
accumulate (over the sorted stream with its padding) and the serial count
are bit-equal, the 64-bit lanes compared as uint64. The serial count also
equals a Python Counter over arbitrary-precision words.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from _torch_parity import run_jax
from repro_torch import words as W
from repro_torch.core import encoding128 as e128
from repro_torch.data import genome

KS = (32, 47, 63)
N_PAD = 5
PES = (3, 8)


def _reads(k):
    return genome.sample_reads(genome.ReadSetSpec(
        genome_bases=1024, n_reads=24, read_len=90, heavy_hitter_frac=0.3,
        seed=k))


_BODY = """
from repro.core import encoding128 as e128
ones = np.full((N_PAD,), np.iinfo(np.uint64).max, np.uint64)
for k in KS:
    reads = jnp.asarray(I[f"reads{k}"])
    p = e128.pack_kmers128(reads, k)
    O[f"pack_hi{k}"], O[f"pack_lo{k}"] = p.hi, p.lo
    x = e128.extract_kmers128(reads, k)
    O[f"x_hi{k}"], O[f"x_lo{k}"] = x.hi, x.lo
    padded = e128.Kmer128(hi=jnp.concatenate([ones[:2], x.hi, ones[2:]]),
                          lo=jnp.concatenate([ones[:2], x.lo, ones[2:]]))
    s = e128.sort128(padded)
    O[f"s_hi{k}"], O[f"s_lo{k}"] = s.hi, s.lo
    for p_ in PES:
        O[f"own{k}_{p_}"] = e128.owner_pe128(x, p_)
    a = e128.accumulate128(s)
    O[f"a_hi{k}"], O[f"a_lo{k}"] = a.hi, a.lo
    O[f"a_c{k}"], O[f"a_n{k}"] = a.counts, a.num_unique
    c = e128.count_kmers_serial128(reads, k)
    O[f"c_hi{k}"], O[f"c_lo{k}"] = c.hi, c.lo
    O[f"c_c{k}"], O[f"c_n{k}"] = c.counts, c.num_unique
"""


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    head = f"KS = {KS!r}\nN_PAD = {N_PAD}\nPES = {PES!r}\n"
    return run_jax(tmp_path_factory.mktemp("e128"), head + _BODY,
                   {f"reads{k}": _reads(k) for k in KS}, x64=True)


def _u64(t):
    return W.to_numpy_words(t, 64)


def _assert_pair(pair, jax_out, hi_key, lo_key):
    np.testing.assert_array_equal(_u64(pair[0]), jax_out[hi_key])
    np.testing.assert_array_equal(_u64(pair[1]), jax_out[lo_key])


@pytest.mark.parametrize("k", KS)
def test_pack_and_extract_match_jax(jax_out, k):
    reads = torch.from_numpy(_reads(k))
    p = e128.pack_kmers128(reads, k)
    assert p.hi.shape == (24, 90 - k + 1) and p.hi.dtype == torch.int64
    _assert_pair(p, jax_out, f"pack_hi{k}", f"pack_lo{k}")
    x = e128.extract_kmers128(reads, k)
    _assert_pair(x, jax_out, f"x_hi{k}", f"x_lo{k}")
    # hi holds 2k - 64 bits; lo all 64, its top bit set on some words
    assert int(x.hi.min()) >= 0 and int(x.hi.max()) < (1 << (2 * k - 64))
    assert bool((x.lo < 0).any())


@pytest.mark.parametrize("k", KS)
def test_sort_owner_accumulate_match_jax(jax_out, k):
    x = e128.extract_kmers128(torch.from_numpy(_reads(k)), k)
    ones = torch.full((N_PAD,), -1, dtype=torch.int64)
    padded = e128.Kmer128(hi=torch.cat([ones[:2], x.hi, ones[2:]]),
                          lo=torch.cat([ones[:2], x.lo, ones[2:]]))
    s = e128.sort128(padded)
    _assert_pair(s, jax_out, f"s_hi{k}", f"s_lo{k}")
    assert bool((s.hi[-N_PAD:] == -1).all() and (s.lo[-N_PAD:] == -1).all())
    for p in PES:
        own = e128.owner_pe128(x, p)
        assert own.dtype == torch.int32
        np.testing.assert_array_equal(own.numpy(), jax_out[f"own{k}_{p}"])
    a = e128.accumulate128(s)
    _assert_pair(a, jax_out, f"a_hi{k}", f"a_lo{k}")
    np.testing.assert_array_equal(a.counts.numpy(), jax_out[f"a_c{k}"])
    assert int(a.num_unique) == int(jax_out[f"a_n{k}"])
    assert int(a.counts.sum()) == x.hi.numel()


@pytest.mark.parametrize("k", KS)
def test_serial_count_matches_jax_and_the_python_oracle(jax_out, k):
    reads = _reads(k)
    c = e128.count_kmers_serial128(torch.from_numpy(reads), k)
    _assert_pair(c, jax_out, f"c_hi{k}", f"c_lo{k}")
    np.testing.assert_array_equal(c.counts.numpy(), jax_out[f"c_c{k}"])
    n = int(c.num_unique)
    assert n == int(jax_out[f"c_n{k}"])
    oracle = Counter()
    mask = (1 << (2 * k)) - 1
    for row in reads:
        word = 0
        for j, b in enumerate(row.tolist()):
            word = ((word << 2) | int(b)) & mask
            if j >= k - 1:
                oracle[word] += 1
    got = {e128.kmer128_to_int(h, lo): cnt for h, lo, cnt in zip(
        c.hi[:n].tolist(), c.lo[:n].tolist(), c.counts[:n].tolist())}
    assert got == dict(oracle)
    assert max(oracle.values()) > 1    # the planted repeats give runs


def test_accumulate_of_padding_only_and_empty():
    ones = torch.full((4,), -1, dtype=torch.int64)
    a = e128.accumulate128(e128.Kmer128(hi=ones, lo=ones))
    assert int(a.num_unique) == 0 and not bool(a.counts.any())
    assert bool((a.hi == -1).all() and (a.lo == -1).all())
    empty = torch.zeros((0,), dtype=torch.int64)
    a = e128.accumulate128(e128.Kmer128(hi=empty, lo=empty))
    assert int(a.num_unique) == 0 and a.counts.numel() == 0


@pytest.mark.parametrize("k", [31, 64, 0])
def test_k_outside_the_128_bit_range_raises(k):
    reads = torch.zeros((2, 70), dtype=torch.uint8)
    with pytest.raises(ValueError, match="31 < k <= 63"):
        e128.pack_kmers128(reads, k)


def test_kmer128_to_int_reads_lanes_unsigned():
    from repro.core import encoding128 as je128
    for hi, lo in ((0, 0), (5, 7), ((1 << 62) - 1, (1 << 64) - 1),
                   (3, 1 << 63)):
        signed_lo = lo - (1 << 64) if lo >= (1 << 63) else lo
        assert e128.kmer128_to_int(hi, signed_lo) == \
            je128.kmer128_to_int(hi, lo) == (hi << 64) | lo
