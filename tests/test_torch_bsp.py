"""The BSP baseline: `repro_torch.core.bsp.count_kmers` on the CPU against
`repro.core.bsp.count_kmers` on forced-host-device meshes of 1, 4 and 8
PEs, both engines, k=13 and k=31. Per-PE results and every BSPStats field
must be equal, and so must the overflow error. The JAX runs happen in two
subprocesses at once (one per word width), each running every case.
"""

import numpy as np
import pytest

from _torch_parity import run_jax_many
from repro.core import bsp as jbsp
from repro.data import genome as jgenome
from repro_torch import words as W
from repro_torch.core import bsp, encoding

INPUTS = {
    "reads": jgenome.sample_reads(jgenome.ReadSetSpec(
        genome_bases=4096, n_reads=256, read_len=60, seed=11)),
    "all_a": np.zeros((64, 40), np.uint8),
}


def _cases(k):
    out = {f"k{k}_p{p}_{impl}": dict(k=k, p=p, partition_impl=impl,
                                     phase2_impl=impl)
           for p in (1, 4, 8) for impl in ("radix", "argsort")}
    out[f"k{k}_p4_canonical_batch32"] = dict(k=k, p=4, canonical=True,
                                             batch_reads=32)
    return out


CASES13, CASES31 = _cases(13), _cases(31)
# every k-mer of poly-A reads has one owner: a tile at slack 1.5 overflows
OVERFLOW = dict(k=13, p=4, batch_reads=8)

_BODY = """
from jax.sharding import Mesh
from repro.core import bsp
for name, spec in CASES.items():
    spec = dict(spec)
    p = spec.pop("p")
    spec.setdefault("batch_reads", 16)
    mesh = Mesh(np.array(jax.devices()[:p]), ("pe",))
    res, st = bsp.count_kmers(jnp.asarray(I["reads"]), mesh,
                              bsp.BSPConfig(**spec))
    O[name + "_unique"], O[name + "_counts"] = res.unique, res.counts
    O[name + "_n"] = res.num_unique
    O[name + "_stats"] = np.array([float(x) for x in st], np.float64)
if OVERFLOW is not None:
    spec = dict(OVERFLOW)
    p = spec.pop("p")
    mesh = Mesh(np.array(jax.devices()[:p]), ("pe",))
    try:
        bsp.count_kmers(jnp.asarray(I["all_a"]), mesh, bsp.BSPConfig(**spec))
        raise SystemExit("no overflow")
    except RuntimeError as e:
        O["overflow_msg"] = np.array(str(e))
"""


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    jobs = {
        "w32": (f"CASES = {CASES13!r}\nOVERFLOW = {OVERFLOW!r}\n" + _BODY,
                False),
        "w64": (f"CASES = {CASES31!r}\nOVERFLOW = None\n" + _BODY, True),
    }
    out = run_jax_many(tmp_path_factory.mktemp("bsp"), jobs, INPUTS,
                       devices=8)
    return {**out["w32"], **out["w64"]}


def _cfg(spec):
    spec = {k: v for k, v in spec.items() if k != "p"}
    spec.setdefault("batch_reads", 16)
    return bsp.BSPConfig(**spec)


@pytest.mark.parametrize("name", sorted(CASES13) + sorted(CASES31))
def test_bsp_matches_jax(jax_out, name):
    spec = {**CASES13, **CASES31}[name]
    res, stats = bsp.count_kmers(INPUTS["reads"], _cfg(spec),
                                 num_pes=spec["p"], device="cpu")
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
    n_batches = 256 // spec["p"] // _cfg(spec).batch_reads
    assert stats.num_global_syncs == n_batches + 1


def test_bsp_overflow_raises_as_jax(jax_out):
    spec = dict(OVERFLOW)
    p = spec.pop("p")
    with pytest.raises(RuntimeError) as ei:
        bsp.count_kmers(INPUTS["all_a"], bsp.BSPConfig(**spec), num_pes=p,
                        device="cpu")
    assert str(ei.value) == str(jax_out["overflow_msg"])


def test_every_batch_round_ends_with_a_barrier(monkeypatch):
    """One host barrier a batch: the superstep the paper charges BSP for."""
    seen = []
    monkeypatch.setattr(bsp, "_superstep_barrier", seen.append)
    _, stats = bsp.count_kmers(INPUTS["reads"], bsp.BSPConfig(
        k=13, batch_reads=8), num_pes=4, device="cpu")
    assert len(seen) == 256 // 4 // 8 == stats.num_global_syncs - 1
    assert all(str(d) == "cpu" for d in seen)


def test_bsp_config_validation_matches_jax():
    for bad in (dict(partition_impl="sort"), dict(phase2_impl="bitonic")):
        with pytest.raises(ValueError):
            jbsp.BSPConfig(k=13, **bad)
        with pytest.raises(ValueError):
            bsp.BSPConfig(k=13, **bad)
    assert [f.name for f in bsp.dataclasses.fields(bsp.BSPConfig)] == \
        [f.name for f in jbsp.dataclasses.fields(jbsp.BSPConfig)]
    assert bsp.BSPStats._fields == jbsp.BSPStats._fields
    with pytest.raises(ValueError, match="batch_reads"):
        bsp.count_kmers(INPUTS["reads"], bsp.BSPConfig(k=13, batch_reads=48),
                        num_pes=4, device="cpu")
