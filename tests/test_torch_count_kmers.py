"""The slice as a whole: `repro_torch.core.fabsp.count_kmers` on the CPU
against `repro.core.fabsp.count_kmers` on a forced-host-device mesh of the
same P. Per-PE results and every DAKCStats field must be equal, through a
rehash round and a slack-retry round too. The JAX runs happen in two
subprocesses (one per word width), each running every case.
"""

import numpy as np
import pytest

from _torch_parity import run_jax
from repro.data import genome as jgenome
from repro_torch import words as W
from repro_torch.core import encoding, fabsp, serial

CASES13 = {f"k13_p{p}": dict(k=13, p=p) for p in (1, 4, 6, 8)}
CASES13["oracles_p4"] = dict(k=13, p=4, partition_impl="argsort",
                             phase2_impl="argsort", canonical=True,
                             canonical_impl="sweep", store_sizing="bound")
CASES13["slack_retry_p8"] = dict(k=13, p=8, use_l3=False, slack=1.01,
                                 reads="all_a")
CASES64 = {f"k{k}_p{p}": dict(k=k, p=p) for k in (21, 31) for p in (1, 8)}
CASES64["rehash_k31_p4"] = dict(k=31, p=4, store_capacity=301)

READS = {
    "uniform": jgenome.sample_reads(jgenome.ReadSetSpec(
        genome_bases=4096, n_reads=384, read_len=100, seed=3)),
    "all_a": np.zeros((128, 40), np.uint8),
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
    return run_jax(tmp_path_factory.mktemp("count"), body, READS, x64=x64,
                   devices=8)


@pytest.fixture(scope="module")
def jax13(tmp_path_factory):
    return _run(tmp_path_factory, CASES13, x64=False)


@pytest.fixture(scope="module")
def jax64(tmp_path_factory):
    return _run(tmp_path_factory, CASES64, x64=True)


def _port(spec):
    spec = dict(spec)
    p, reads = spec.pop("p"), spec.pop("reads", "uniform")
    cfg = fabsp.DAKCConfig(chunk_reads=16, **spec)
    return fabsp.count_kmers(READS[reads], cfg, num_pes=p, device="cpu")


def _check(name, spec, jax_out):
    res, stats = _port(spec)
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
def test_count_kmers_matches_jax_k13(jax13, name):
    stats = _check(name, CASES13[name], jax13)
    if name.startswith("slack_retry"):
        assert stats.retry_route_slack >= 1


@pytest.mark.parametrize("name", sorted(CASES64))
def test_count_kmers_matches_jax_64bit(jax64, name):
    stats = _check(name, CASES64[name], jax64)
    if name.startswith("rehash"):
        assert stats.retry_store_rehash >= 1


@pytest.mark.parametrize("k", [13, 31])
def test_count_kmers_matches_own_serial_oracle(k):
    res, stats = _port(dict(k=k, p=6))
    p = 6
    L = res.unique.numel() // p
    live = (np.arange(L)[None, :] < res.num_unique.numpy()[:, None])
    got = sorted(zip(res.unique.view(p, L).numpy()[live].tolist(),
                     res.counts.view(p, L).numpy()[live].tolist()))
    import torch
    ser = serial.count_kmers_serial(torch.from_numpy(READS["uniform"]), k)
    n = int(ser.num_unique[0])
    want = list(zip(ser.unique[0, :n].tolist(), ser.counts[0, :n].tolist()))
    assert got == want
    assert sum(c for _, c in got) == stats.raw_kmers
