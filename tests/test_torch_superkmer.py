"""`count_kmers` under the super-k-mer transport (both minimizer orders),
pre-route compaction and the 'stacked' receiver oracle, in the port on the
CPU against `repro.core.fabsp.count_kmers` on a forced-host-device mesh of
the same P. Per-PE results and every DAKCStats field must be equal. The
JAX runs happen in two subprocesses (one per word width).
"""

import numpy as np
import pytest

from _torch_parity import run_jax
from repro.data import genome as jgenome
from repro_torch import words as W
from repro_torch.core import encoding, fabsp

SK = dict(transport_impl="superkmer")
CASES13 = {f"sk_{order}_{comp}_p{p}": dict(k=13, p=p, minimizer_order=order,
                                           compact_impl=comp, **SK)
           for p in (1, 4, 8) for order in ("plain", "hashed")
           for comp in ("off", "prefix")}
CASES13.update({
    "sk_canonical_m5_p4": dict(k=13, p=4, minimizer_len=5, canonical=True,
                               **SK),
    "sk_oracles_p4": dict(k=13, p=4, partition_impl="argsort",
                          phase2_impl="argsort", minimizer_order="hashed",
                          compact_impl="prefix", **SK),
    "sk_poly_a_p8": dict(k=13, p=8, reads="all_a", **SK),
    "sk_poly_a_hashed_prefix_p8": dict(k=13, p=8, reads="all_a",
                                       minimizer_order="hashed",
                                       compact_impl="prefix", **SK),
    "dual_prefix_p8": dict(k=13, p=8, compact_impl="prefix"),
    "packed_prefix_p4": dict(k=13, p=4, l3_mode="packed",
                             compact_impl="prefix"),
    "stacked_dual_p4": dict(k=13, p=4, receiver_impl="stacked"),
    "stacked_packed_p4": dict(k=13, p=4, receiver_impl="stacked",
                              l3_mode="packed"),
    "stacked_none_p8": dict(k=13, p=8, receiver_impl="stacked",
                            use_l3=False),
    "stacked_oracles_p4": dict(k=13, p=4, receiver_impl="stacked",
                               partition_impl="argsort",
                               phase2_impl="argsort"),
    "stacked_sk_hashed_p8": dict(k=13, p=8, receiver_impl="stacked",
                                 minimizer_order="hashed", **SK),
})
CASES31 = {f"sk_{order}_{comp}_p{p}": dict(k=31, p=p, minimizer_order=order,
                                           compact_impl=comp, **SK)
           for p in (1, 8) for order in ("plain", "hashed")
           for comp in ("off", "prefix")}
CASES31.update({
    "sk_m20_hashed_p8": dict(k=31, p=8, minimizer_len=20,
                             minimizer_order="hashed", **SK),
    "sk_m20_plain_canonical_p8": dict(k=31, p=8, minimizer_len=20,
                                      canonical=True, **SK),
    "stacked_dual_p8": dict(k=31, p=8, receiver_impl="stacked"),
    "stacked_sk_plain_p8": dict(k=31, p=8, receiver_impl="stacked", **SK),
})

READS = {
    "uniform": jgenome.sample_reads(jgenome.ReadSetSpec(
        genome_bases=4096, n_reads=384, read_len=100, seed=3)),
    "all_a": np.zeros((256, 40), np.uint8),
}

_BODY = """
from jax.sharding import Mesh
from repro.core import fabsp
for name, spec in CASES.items():
    spec = dict(spec)
    p, reads = spec.pop("p"), spec.pop("reads", "uniform")
    mesh = Mesh(np.array(jax.devices()[:p]), ("pe",))
    cfg = fabsp.DAKCConfig(chunk_reads=16, **spec)
    res, st = fabsp.count_kmers(jnp.asarray(I[reads]), mesh, cfg)
    O[name + "_unique"] = res.unique
    O[name + "_counts"] = res.counts
    O[name + "_n"] = res.num_unique
    O[name + "_stats"] = np.array([float(x) for x in st], np.float64)
"""


def _run(tmp_path_factory, cases, x64):
    body = f"CASES = {cases!r}\n" + _BODY
    return run_jax(tmp_path_factory.mktemp("superkmer"), body, READS,
                   x64=x64, devices=8)


@pytest.fixture(scope="module")
def jax13(tmp_path_factory):
    return _run(tmp_path_factory, CASES13, x64=False)


@pytest.fixture(scope="module")
def jax64(tmp_path_factory):
    return _run(tmp_path_factory, CASES31, x64=True)


def _check(name, spec, jax_out):
    spec = dict(spec)
    p, reads = spec.pop("p"), spec.pop("reads", "uniform")
    cfg = fabsp.DAKCConfig(chunk_reads=16, **spec)
    res, stats = fabsp.count_kmers(READS[reads], cfg, num_pes=p,
                                   device="cpu")
    bits = encoding.word_bits(spec["k"])
    np.testing.assert_array_equal(W.to_numpy_words(res.unique, bits),
                                  jax_out[name + "_unique"])
    np.testing.assert_array_equal(res.counts.numpy(),
                                  jax_out[name + "_counts"])
    np.testing.assert_array_equal(res.num_unique.numpy(),
                                  jax_out[name + "_n"])
    want = jax_out[name + "_stats"]
    assert len(stats) == len(want)
    for field, got, w in zip(stats._fields, stats, want):
        assert float(got) == w, field
    return stats


@pytest.mark.parametrize("name", sorted(CASES13))
def test_count_kmers_superkmer_matches_jax_k13(jax13, name):
    stats = _check(name, CASES13[name], jax13)
    assert int(stats.raw_kmers) > 0


@pytest.mark.parametrize("name", sorted(CASES31))
def test_count_kmers_superkmer_matches_jax_k31(jax64, name):
    _check(name, CASES31[name], jax64)


def test_superkmer_moves_fewer_wire_bytes_than_kmers():
    """The point of the transport, at a realistic read length."""
    reads = READS["uniform"]
    wire = {}
    for transport in ("kmer", "superkmer"):
        cfg = fabsp.DAKCConfig(k=13, chunk_reads=16, transport_impl=transport)
        res, st = fabsp.count_kmers(reads, cfg, num_pes=4, device="cpu")
        assert int(res.counts.sum()) == st.raw_kmers
        wire[transport] = int(st.wire_bytes)
    assert wire["superkmer"] < wire["kmer"], wire
