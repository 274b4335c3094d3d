"""The kernel-free helpers of the port on the CPU, against the JAX package
in this process (numpy-only functions and 32-bit JAX ones):

- `encoding.encode_ascii`, `decode_codes_np`, `unpack_kmer_np` (an int64
  word with its top bit set reads as unsigned);
- `serial.count_kmers_python`;
- `sort.sort_words` at 32 bits (against `jnp.sort`) and 64 bits with top
  bits set (against the unsigned order, numpy's, which `jnp.sort` gives
  on uint64 under x64);
- `genome.pad_reads_for_mesh`, `poly_a_reads` and
  `power_law_minimizer_reads` on the same seeds, and the FASTQ/FASTA
  codecs, each file read back by both packages;
- `configs.dakc_kc.KCWorkloadConfig`;
- `analytical_model.predict`, `cache_misses`, `op_intensity` and the
  phase terms on `PHOENIX_INTEL`, equal floats over a grid of workloads;
  `H100_SXM` from its stated derivation;
- the names `repro_torch.core` and `repro_torch.data` expose.
"""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dakc_kc as jdakc_kc
from repro.core import analytical_model as jam
from repro.core import encoding as jencoding
from repro.core import serial as jserial
from repro.core import sort as jsort
from repro.data import genome as jgenome
from repro_torch import words as W
from repro_torch.configs import dakc_kc
from repro_torch.core import analytical_model as am
from repro_torch.core import encoding, serial, sort
from repro_torch.data import genome

RNG = np.random.default_rng(17)


def test_encode_ascii_matches_jax():
    alphabet = np.frombuffer(b"ACGTacgtNnXx-", dtype=np.uint8)
    raw = np.concatenate([alphabet, RNG.integers(0, 256, 500,
                                                 dtype=np.uint8)])
    raw = raw.reshape(3, -1) if raw.size % 3 == 0 else raw
    got = encoding.encode_ascii(raw)
    assert got.dtype == torch.uint8
    want = np.asarray(jencoding.encode_ascii(jnp.asarray(raw)))
    np.testing.assert_array_equal(got.numpy(), want)
    got_t = encoding.encode_ascii(torch.from_numpy(raw))
    assert torch.equal(got_t, got)


def test_decode_and_unpack_match_jax():
    codes = RNG.integers(0, 4, 40, dtype=np.uint8)
    assert encoding.decode_codes_np(codes) == jencoding.decode_codes_np(codes)
    words = encoding.extract_kmers(torch.from_numpy(codes[None, :]), 31)
    for w in words.tolist()[:5]:
        assert encoding.unpack_kmer_np(w, 31) == \
            jencoding.unpack_kmer_np(w, 31)
    # a 64-bit word with its top bit set: -1 is all ones, 32 'T's
    assert encoding.unpack_kmer_np(-1, 32) == \
        jencoding.unpack_kmer_np(np.uint64((1 << 64) - 1), 32) == "T" * 32
    top = -(1 << 63) | 0b01
    assert encoding.unpack_kmer_np(top, 32) == \
        jencoding.unpack_kmer_np((1 << 63) | 0b01, 32) == "G" + "A" * 30 + "C"
    assert encoding.unpack_kmer_np(0b1110, 3, 2) == \
        jencoding.unpack_kmer_np(0b1110, 3, 2) == "ATG"


@pytest.mark.parametrize("k", [1, 5, 13, 31])
def test_count_kmers_python_matches_jax(k):
    reads = RNG.integers(0, 4, (12, 40), dtype=np.uint8)
    reads[:4, :20] = 0         # repeats
    got = serial.count_kmers_python(reads, k)
    assert got == jserial.count_kmers_python(reads, k)
    assert sum(got.values()) == 12 * (40 - k + 1)


def test_sort_words_32_matches_jax():
    w = np.concatenate([RNG.integers(0, 1 << 32, 300, dtype=np.uint64)
                        .astype(np.uint32),
                        np.array([0, (1 << 32) - 1, 1 << 31], np.uint32)])
    t, bits = W.to_torch_words(w)
    got = sort.sort_words(t)
    np.testing.assert_array_equal(W.to_numpy_words(got, bits),
                                  np.asarray(jsort.sort_words(jnp.asarray(w))))


def test_sort_words_64_in_unsigned_order():
    w = np.concatenate([
        RNG.integers(0, 1 << 63, 200, dtype=np.uint64) | np.uint64(1 << 63),
        RNG.integers(0, 1 << 62, 200, dtype=np.uint64),
        np.array([0, (1 << 64) - 1, 1 << 63, (1 << 63) - 1], np.uint64)])
    t, bits = W.to_torch_words(w)
    got = sort.sort_words(t)
    np.testing.assert_array_equal(W.to_numpy_words(got, bits), np.sort(w))
    rows = sort.sort_words(t.reshape(4, -1))
    np.testing.assert_array_equal(W.to_numpy_words(rows, bits),
                                  np.sort(w.reshape(4, -1), axis=-1))


@pytest.mark.parametrize("n,p,c", [(100, 4, 8), (64, 4, 16), (7, 1, 1),
                                   (5, 3, 4)])
def test_pad_reads_for_mesh_matches_jax(n, p, c):
    reads = RNG.integers(0, 4, (n, 20), dtype=np.uint8)
    got, pad = genome.pad_reads_for_mesh(reads, p, c, 11)
    want, wpad = jgenome.pad_reads_for_mesh(reads, p, c, 11)
    assert pad == wpad and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert got.shape[0] % (p * c) == 0


@pytest.mark.parametrize("n,rl,frac,seed", [(256, 48, 0.6, 3),
                                            (33, 17, 0.25, 0),
                                            (8, 5, 1.0, 9)])
def test_poly_a_reads_match_jax(n, rl, frac, seed):
    got = genome.poly_a_reads(n, rl, run_frac=frac, seed=seed)
    want = jgenome.poly_a_reads(n, rl, run_frac=frac, seed=seed)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,rl,m,alpha,pool,seed", [
    (256, 48, 7, 1.5, 64, 4), (40, 30, 3, 1.1, 100, 2), (16, 15, 15, 2.0,
                                                         8, 0)])
def test_power_law_minimizer_reads_match_jax(n, rl, m, alpha, pool, seed):
    got = genome.power_law_minimizer_reads(n, rl, m, alpha=alpha, pool=pool,
                                           seed=seed)
    want = jgenome.power_law_minimizer_reads(n, rl, m, alpha=alpha,
                                             pool=pool, seed=seed)
    np.testing.assert_array_equal(got, want)


def test_power_law_minimizer_reads_refuse_bad_m():
    for m, rl in ((0, 20), (16, 20), (9, 8)):
        with pytest.raises(ValueError):
            genome.power_law_minimizer_reads(4, rl, m)


def test_fastq_round_trip_matches_jax(tmp_path):
    reads = genome.sample_reads(genome.ReadSetSpec(
        genome_bases=512, n_reads=12, read_len=30, seed=5))
    path = str(tmp_path / "r.fq")
    genome.reads_to_fastq(reads, path)
    jpath = str(tmp_path / "j.fq")
    jgenome.reads_to_fastq(reads, jpath)
    assert open(path).read() == open(jpath).read()
    got = genome.fastq_to_reads(path)
    np.testing.assert_array_equal(got, reads)
    np.testing.assert_array_equal(got, jgenome.fastq_to_reads(path))


def test_fasta_to_reads_matches_jax(tmp_path):
    path = str(tmp_path / "g.fa")
    with open(path, "w") as f:
        f.write(">chr1 first\nACGTACGTAC\nGTTTGA\n>chr2\nacgtNacgtacgtaaa\n"
                ">chr3\n\nTTTTGGGGCCCCAAAA\nAC\n")
    for read_len in (4, 5, 8):
        got = genome.fasta_to_reads(path, read_len)
        want = jgenome.fasta_to_reads(path, read_len)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    assert genome.fasta_to_reads(path, 4).shape == (11, 4)   # 4 + 3 + 4


def test_kc_workload_config_matches_jax():
    assert dataclasses.asdict(dakc_kc.config()) == \
        dataclasses.asdict(jdakc_kc.config())
    assert [f.name for f in dataclasses.fields(dakc_kc.KCWorkloadConfig)] == \
        [f.name for f in dataclasses.fields(jdakc_kc.KCWorkloadConfig)]
    with pytest.raises(dataclasses.FrozenInstanceError):
        dakc_kc.config().k = 21


def _workload(n, m, k, p, mod):
    return mod.Workload(n_reads=n, read_len=m, k=k, num_nodes=p)


GRID = list(itertools.product((1000, 2 ** 23, 357_913_900), (100, 150),
                              (15, 21, 31), (1, 8, 256)))


@pytest.mark.parametrize("overlap", ["sum", "max"])
def test_analytical_model_matches_jax(overlap):
    jm = jam.PHOENIX_INTEL
    assert dataclasses.asdict(am.PHOENIX_INTEL) == dataclasses.asdict(jm)
    for n, m, k, p in GRID:
        w, jw = _workload(n, m, k, p, am), _workload(n, m, k, p, jam)
        assert (w.kmers, w.kmer_bytes) == (jw.kmers, jw.kmer_bytes)
        assert am.predict(w, am.PHOENIX_INTEL, overlap) == \
            jam.predict(jw, jm, overlap)
        assert am.cache_misses(w, am.PHOENIX_INTEL) == \
            jam.cache_misses(jw, jm)
        assert am.op_intensity(w) == jam.op_intensity(jw)
    for k in range(1, 64):
        assert am.kmer_word_bits(k) == jam.kmer_word_bits(k)
    with pytest.raises(ValueError):
        am.predict(_workload(8, 150, 31, 1, am), am.PHOENIX_INTEL, "nope")


def test_h100_row_from_its_derivation():
    h = am.H100_SXM
    assert h.c_node == 132 * 64 * 1.98e9 / 2
    assert (h.beta_mem, h.z_cache, h.line, h.beta_link) == (
        3.35e12, 50e6, 128.0, 900e9)
    pred = am.predict(_workload(2 ** 23, 150, 31, 1, am), h, "max")
    # one card: the radix passes over HBM dominate, about 8 streaming
    # passes of 8 GB
    assert pred["phase2_intranode"] == pytest.approx(
        8 * 2 ** 23 * 120 * 8 / 3.35e12, rel=1e-6)
    assert pred["total"] == pred["phase1_total"] + pred["phase2_total"]


def test_packages_expose_the_reference_names():
    import repro.core as jcore
    import repro.data as jdata
    import repro_torch.core as core
    import repro_torch.data as data

    names = ("aggregation", "analytical_model", "countstore", "encoding",
             "owner", "sort", "BSPConfig", "count_kmers_bsp", "CountStore",
             "DAKCConfig", "DAKCStats", "KmerCounter", "count_kmers",
             "count_kmers_serial", "AccumResult", "accumulate")
    for name in names:
        assert hasattr(jcore, name) and hasattr(core, name), name
    for name in ("corpus_stats", "genome", "tokens"):
        assert hasattr(jdata, name) and hasattr(data, name), name
    assert core.count_kmers_bsp is core.bsp.count_kmers
