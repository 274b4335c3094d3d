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
- the names `repro_torch.core` and `repro_torch.data` expose;
- `aggregation.bucket_by_owner` (each row against the JAX function on
  the same words, owners and validity, with and without the count lane,
  under both plans, with overflow; 64-bit words in one x64 subprocess),
  `l3_max_block`, `aggregation_memory_bytes`, `ops.radix_partition_plan`,
  `ops.make_partition_plan_ref` and `serial.KCStats`.
"""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dakc_kc as jdakc_kc
from repro.core import aggregation as jaggregation
from repro.core import analytical_model as jam
from repro.core import encoding as jencoding
from repro.core import serial as jserial
from repro.core import sort as jsort
from repro.data import genome as jgenome
from repro_torch import words as W
from repro_torch.configs import dakc_kc
from repro_torch.core import aggregation
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


def _bucket_rows(word_bits, seed):
    """Three rows of words (the sentinel among them), owners and validity;
    a dense row overflows capacity 48 on its hot owners."""
    rng = np.random.default_rng(seed)
    n, rows = 512, 3
    dt = np.uint64 if word_bits == 64 else np.uint32
    words = rng.integers(0, 1 << (word_bits - 2), (rows, n)).astype(dt)
    words[:, ::97] = np.iinfo(dt).max
    owners = rng.integers(0, 8, (rows, n)).astype(np.int32)
    owners[2, :300] = 3
    valid = rng.random((rows, n)) < 0.9
    counts = rng.integers(1, 1000, (rows, n)).astype(np.int32)
    return words, owners, valid, counts


def _port_buckets(words, owners, valid, counts, word_bits, impl):
    w = W.to_torch_words(words, "cpu")[0]
    return aggregation.bucket_by_owner(
        w, torch.from_numpy(owners), torch.from_numpy(valid), 8, 48,
        None if counts is None else torch.from_numpy(counts),
        word_bits=word_bits, impl=impl)


@pytest.mark.parametrize("impl", ["radix", "argsort"])
@pytest.mark.parametrize("with_counts", [False, True])
def test_bucket_by_owner_32_matches_jax(impl, with_counts):
    words, owners, valid, counts = _bucket_rows(32, 5)
    counts = counts if with_counts else None
    got = _port_buckets(words, owners, valid, counts, 32, impl)
    assert got.overflow[2] > 0
    for r in range(words.shape[0]):
        want = jaggregation.bucket_by_owner(
            jnp.asarray(words[r]), jnp.asarray(owners[r]),
            jnp.asarray(valid[r]), 8, 48,
            None if counts is None else jnp.asarray(counts[r]), impl=impl)
        np.testing.assert_array_equal(
            W.to_numpy_words(got.tile[r], 32), np.asarray(want.tile))
        np.testing.assert_array_equal(got.fill[r].numpy(),
                                      np.asarray(want.fill))
        assert int(got.overflow[r]) == int(want.overflow)
        if counts is None:
            assert got.counts is None and want.counts is None
        else:
            np.testing.assert_array_equal(got.counts[r].numpy(),
                                          np.asarray(want.counts))


L3_BLOCKS = [(5, 2), (13, 2), (15, 2), (21, 2), (31, 2), (3, 18)]


@pytest.fixture(scope="module")
def jax_x64(tmp_path_factory):
    """One x64 subprocess: `bucket_by_owner` of 64-bit words under both
    plans, and `l3_max_block` of the widths that need 64-bit words."""
    from _torch_parity import run_jax
    words, owners, valid, counts = _bucket_rows(64, 6)
    body = f"L3_BLOCKS = {L3_BLOCKS!r}\n" + """
from repro.core.aggregation import bucket_by_owner, l3_max_block
for impl in ("radix", "argsort"):
    for r in range(I["words"].shape[0]):
        res = bucket_by_owner(jnp.asarray(I["words"][r]),
                              jnp.asarray(I["owners"][r]),
                              jnp.asarray(I["valid"][r]), 8, 48,
                              jnp.asarray(I["counts"][r]), impl=impl)
        for f in ("tile", "fill", "overflow", "counts"):
            O[f"{impl}_{r}_{f}"] = getattr(res, f)
for k, bps in L3_BLOCKS:
    O[f"l3_{k}_{bps}"] = l3_max_block(k, bps)
"""
    return run_jax(tmp_path_factory.mktemp("helpers64"), body,
                   dict(words=words, owners=owners, valid=valid,
                        counts=counts), x64=True)


@pytest.mark.parametrize("impl", ["radix", "argsort"])
def test_bucket_by_owner_64_matches_jax_x64(jax_x64, impl):
    words, owners, valid, counts = _bucket_rows(64, 6)
    got = _port_buckets(words, owners, valid, counts, 64, impl)
    assert got.overflow[2] > 0
    for r in range(words.shape[0]):
        np.testing.assert_array_equal(W.to_numpy_words(got.tile[r], 64),
                                      jax_x64[f"{impl}_{r}_tile"])
        np.testing.assert_array_equal(got.fill[r].numpy(),
                                      jax_x64[f"{impl}_{r}_fill"])
        assert int(got.overflow[r]) == int(jax_x64[f"{impl}_{r}_overflow"])
        np.testing.assert_array_equal(got.counts[r].numpy(),
                                      jax_x64[f"{impl}_{r}_counts"])


@pytest.mark.parametrize("k,bps", L3_BLOCKS)
def test_l3_max_block_matches_jax(jax_x64, k, bps):
    assert aggregation.l3_max_block(k, bps) == int(jax_x64[f"l3_{k}_{bps}"])
    if k * bps <= 32 - 2:      # 32-bit words: in this process too
        assert aggregation.l3_max_block(k, bps) == \
            jaggregation.l3_max_block(k, bps)


@pytest.mark.parametrize("protocol", ["1d", "2d", "3d"])
def test_aggregation_memory_bytes_matches_jax(protocol):
    for p in (1, 8, 64, 256, 1024):
        for kw in ({}, dict(c1=512, c2=64, c3=4096, word_bytes=4)):
            assert aggregation.aggregation_memory_bytes(p, protocol, **kw) \
                == jaggregation.aggregation_memory_bytes(p, protocol, **kw)


@pytest.mark.parametrize("num_buckets", [2, 9, 257])
def test_partition_plans_match_jax(num_buckets):
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops
    rng = np.random.default_rng(num_buckets)
    b = rng.integers(0, num_buckets, (2, 700)).astype(np.int32)
    b[1, :500] = num_buckets - 1          # one hot bucket
    pos, totals = ops.radix_partition_plan(torch.from_numpy(b), num_buckets)
    plan = ops.make_partition_plan_ref(torch.from_numpy(b), num_buckets)
    for r in range(b.shape[0]):
        jpos, jtot = jops.radix_partition_plan(jnp.asarray(b[r]),
                                               num_buckets, 1024)
        jplan = jops.make_partition_plan_ref(jnp.asarray(b[r]), num_buckets)
        np.testing.assert_array_equal(pos[r].numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(totals[r].numpy(), np.asarray(jtot))
        np.testing.assert_array_equal(plan.positions[r].numpy(),
                                      np.asarray(jplan.positions))
        np.testing.assert_array_equal(plan.totals[r].numpy(),
                                      np.asarray(jplan.totals))
        np.testing.assert_array_equal(plan.starts[r].numpy(),
                                      np.asarray(jplan.starts))


def test_kc_stats_matches_jax():
    assert serial.KCStats._fields == jserial.KCStats._fields
    assert serial.KCStats(total_kmers=7).total_kmers == 7
