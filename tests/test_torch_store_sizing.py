"""The 'sample' store sizing: the port's `_sampled_distinct_estimate` and
`_resolve_store_capacity` against the JAX package's on the same reads, and
a port `count_kmers` whose store is sized that way. The port counts the
sample's distinct words with `torch.unique` where they were extracted, the
JAX package with the host's `np.unique`: both are exact, so the integers
must be equal.
"""

import numpy as np
import pytest
import torch

from _torch_parity import histogram, run_jax_many
from repro.data import genome as jgenome
from repro_torch.core import fabsp, serial


def _all_distinct_reads(n_reads=64, read_len=24, k=11, chunk=32, seed=23):
    """Random reads whose first `chunk` reads hold no k-mer twice (k-mers
    packed here in numpy, apart from either package's extraction)."""
    rng = np.random.default_rng(seed)
    while True:
        reads = rng.integers(0, 4, (n_reads, read_len), dtype=np.uint8)
        win = np.lib.stride_tricks.sliding_window_view(
            reads[:chunk].astype(np.int64), k, axis=1)
        words = (win << (2 * np.arange(k - 1, -1, -1))).sum(-1).ravel()
        if np.unique(words).size == words.size:
            return reads


def _genome(bases, n_reads, read_len, seed):
    return jgenome.sample_reads(jgenome.ReadSetSpec(
        genome_bases=bases, n_reads=n_reads, read_len=read_len, seed=seed))


# Saturated read sets (deep coverage of a small genome), so the estimate
# inverts a sample with repeats; one sample shorter than a chunk; one whose
# sample is all distinct, which returns None (the shape bound then sizes).
READS = {
    "sat13": _genome(512, 512, 60, 21),
    "short": _genome(256, 20, 60, 24),
    "distinct": _all_distinct_reads(),
    "sat31": _genome(2048, 256, 100, 25),
}
CASES = {
    "saturated_k13_canonical": dict(reads="sat13", p=1, k=13,
                                    chunk_reads=32, canonical=True),
    "saturated_k13_forward_p4": dict(reads="sat13", p=4, k=13,
                                     chunk_reads=32, canonical=False),
    "short_sample": dict(reads="short", p=1, k=13, chunk_reads=32,
                         canonical=True),
    "fully_distinct": dict(reads="distinct", p=1, k=11, chunk_reads=32),
    "saturated_k31_p8": dict(reads="sat31", p=8, k=31, chunk_reads=32),
}
COUNT_CASE = dict(reads="sat13", p=4, k=13, chunk_reads=32)

_BODY = """
from repro.core import fabsp
for name, spec in CASES.items():
    spec = dict(spec)
    reads, p = jnp.asarray(I[spec.pop("reads")]), spec.pop("p")
    cfg = fabsp.DAKCConfig(**spec)
    est = fabsp._sampled_distinct_estimate(reads, cfg, p)
    O[name + "_est"] = np.int64(-1 if est is None else est)
    O[name + "_cap"] = np.int64(fabsp._resolve_store_capacity(reads, cfg, p))
"""


@pytest.fixture(scope="module")
def jax_sizing(tmp_path_factory):
    cases = dict(CASES, count=COUNT_CASE)
    wide = {n: c for n, c in cases.items() if c["k"] > 16}
    narrow = {n: c for n, c in cases.items() if c["k"] <= 16}
    out = run_jax_many(tmp_path_factory.mktemp("sizing"), {
        "narrow": (f"CASES = {narrow!r}\n" + _BODY, False),
        "wide": (f"CASES = {wide!r}\n" + _BODY, True)}, READS)
    return {**out["narrow"], **out["wide"]}


def _cfg(spec):
    spec = dict(spec)
    reads, p = READS[spec.pop("reads")], spec.pop("p")
    return torch.from_numpy(reads), fabsp.DAKCConfig(**spec), p


@pytest.mark.parametrize("name", sorted(CASES))
def test_sampled_store_sizing_matches_jax(jax_sizing, name):
    reads, cfg, p = _cfg(CASES[name])
    est = fabsp._sampled_distinct_estimate(reads, cfg, p)
    cap = fabsp._resolve_store_capacity(reads, cfg, p)
    assert (-1 if est is None else est) == int(jax_sizing[name + "_est"])
    assert cap == int(jax_sizing[name + "_cap"])
    bound = fabsp._default_store_capacity(cfg, tuple(reads.shape), p)
    if name == "fully_distinct":
        assert est is None and cap == bound
    else:
        assert est is not None and cap < bound
        assert cap & (cap - 1) == 0


def test_count_kmers_sample_sized_store_exact(jax_sizing, monkeypatch):
    """count_kmers under the default 'sample' sizing on a saturated read set:
    the store is made at the JAX package's capacity, nothing is dropped and
    the histogram is the serial count's."""
    reads, cfg, p = _cfg(COUNT_CASE)
    assert cfg.store_sizing == "sample"
    made = []
    empty_store = fabsp.countstore.empty_store

    def spy(rows, cap, *a, **kw):
        made.append(cap)
        return empty_store(rows, cap, *a, **kw)

    monkeypatch.setattr(fabsp.countstore, "empty_store", spy)
    res, stats = fabsp.count_kmers(reads, cfg, num_pes=p, device="cpu")
    assert made == [int(jax_sizing["count_cap"])]
    assert int(stats.store_overflow) == 0
    assert stats.retry_store_rehash == 0
    ser = serial.count_kmers_serial(reads, cfg.k)
    n = int(ser.num_unique[0])
    want = dict(zip(ser.unique[0, :n].tolist(), ser.counts[0, :n].tolist()))
    assert histogram(res, p) == want
