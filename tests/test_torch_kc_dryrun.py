"""The counter's drills (`repro_torch.launch.kc_dryrun`) on the CPU, each
record held to the JAX package's run of the same scenario on a 4-device
host mesh, as `repro.launch.kc_dryrun`'s drills run it:

- `run_inject`: each site's DAKCStats (retries included) and the
  persistent fault's give-up cause and recorded rounds;
- `run_spill`: each transport's DAKCStats (spilled bins, bytes, folds);
- `run_skew`: each corpus and order's DAKCStats (load_max_over_mean and
  owner_fill_p99 included), with compaction off and 'prefix';
- `run_query`: the live and the spilled-tier batch's QueryStats.

The CLI runs a drill, and refuses the lowering dry-run's flags and a run
without a drill (ROADMAP item 12). The JAX runs happen in four
subprocesses at once.
"""

import numpy as np
import pytest
import torch

from _torch_parity import JAX_HELPERS, run_jax_many
from repro_torch.launch import kc_dryrun

SKEWS = ("polya", "powerlaw", "none")
COMPACTS = ("off", "prefix")

_INJECT = """
from repro.core import fabsp, resilience
from repro.core.fabsp import DAKCConfig
reads = jnp.asarray(I["inject"])
scenarios = [
    ("route_drop", None, dict(k=11, chunk_reads=4),
     resilience.FaultPlan(site="route_drop", seed=1, chunk=0, frac=0.3)),
    ("store_drop", None, dict(k=11, chunk_reads=4, store_capacity=128),
     resilience.FaultPlan(site="store_drop", seed=2, chunk=0, frac=0.25)),
    ("hop2_misfit", (2, 2),
     dict(k=11, chunk_reads=4, topology="2d", hop2_impl="compact",
          use_l3=False),
     resilience.FaultPlan(site="hop2_misfit")),
]
for site, grid, base, plan in scenarios:
    mesh, axes = mesh_of(4, grid)
    _, st = fabsp.count_kmers(reads, mesh, DAKCConfig(**base, faults=plan),
                              axes)
    put(site, st)
cfg = DAKCConfig(
    k=11, chunk_reads=4, retry=resilience.RetryPolicy(max_slack=2.0),
    faults=resilience.FaultPlan(site="route_drop", seed=1, chunk=-1,
                                frac=0.5, rounds=99))
try:
    fabsp.count_kmers(reads, mesh_of(4)[0], cfg)
    raise SystemExit("persistent fault did not raise")
except resilience.CapacityExhausted as e:
    O["persistent_cause"] = np.array(e.cause)
    O["persistent_rounds"] = np.array(len(e.rounds))
"""

_SPILL = """
import tempfile
from repro.core import fabsp, resilience
from repro.core.fabsp import DAKCConfig
reads = jnp.asarray(I["spill"])
for transport in ("kmer", "superkmer"):
    base = dict(k=11, chunk_reads=8, receiver_impl="stream",
                transport_impl=transport, minimizer_len=7)
    with tempfile.TemporaryDirectory() as d:
        cfg = DAKCConfig(**base, store_capacity=64,
                         retry=resilience.RetryPolicy(store_cap_ceiling=128),
                         spill="auto", spill_dir=d, spill_bins=8)
        _, st = fabsp.count_kmers(reads, mesh_of(4)[0], cfg)
    put(transport, st)
"""

_SKEW = """
from repro.core import fabsp
from repro.core.fabsp import DAKCConfig
mesh = mesh_of(4)[0]
for skew in SKEWS:
    reads = jnp.asarray(I["skew_" + skew])
    for compact in COMPACTS:
        for o in ("plain", "hashed"):
            cfg = DAKCConfig(k=13, chunk_reads=64, transport_impl="superkmer",
                             minimizer_len=7, minimizer_order=o,
                             compact_impl=compact)
            _, st = fabsp.count_kmers(reads, mesh, cfg)
            put(f"{skew}_{compact}_{o}", st)
"""

_QUERY = """
import tempfile
from repro.core import fabsp
from repro.core.fabsp import DAKCConfig
reads = jnp.asarray(I["query"])
small = mesh_of(4)[0]
q = I["q"]
kc = fabsp.KmerCounter(small, DAKCConfig(k=13, chunk_reads=32))
kc.update(reads)
O["live_counts"] = kc.count(q)
put("live", kc.last_query_stats)
with tempfile.TemporaryDirectory() as d:
    sp = fabsp.KmerCounter(small, DAKCConfig(
        k=13, chunk_reads=32, spill="always", spill_dir=d, spill_bins=6))
    sp.update(reads)
    O["spilled_counts"] = sp.count(q)
    put("spilled", sp.last_query_stats)
"""


def _query_batch():
    """The query drill's batch: every counted k-mer, then 64 random words
    (its `rng`, seeded 0)."""
    from repro_torch.core import serial
    hist = serial.count_kmers_python(kc_dryrun._small_reads(2048, 128, 52,
                                                            0.3), 13)
    rng = np.random.default_rng(0)
    uniq = np.asarray(sorted(hist), dtype=np.uint32)
    return np.concatenate([uniq, rng.integers(0, 1 << 26, 64,
                                              dtype=np.uint32)])


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    inputs = {"inject": kc_dryrun._small_reads(2048, 64, 52, 0.3),
              "spill": kc_dryrun._small_reads(4096, 128, 80),
              "query": kc_dryrun._small_reads(2048, 128, 52, 0.3),
              "q": _query_batch()}
    for skew in SKEWS:
        inputs["skew_" + skew] = kc_dryrun.skew_reads(skew)
    head = JAX_HELPERS + f"SKEWS = {SKEWS!r}\nCOMPACTS = {COMPACTS!r}\n"
    out = run_jax_many(tmp_path_factory.mktemp("kc_dryrun"), {
        "inject": (head + _INJECT, False), "spill": (head + _SPILL, False),
        "skew": (head + _SKEW, False), "query": (head + _QUERY, False)},
        inputs, devices=4)
    return {k: v for part in out.values() for k, v in part.items()}


def _assert_stats(got, want):
    assert len(got) == len(want)
    for field, g, w in zip(got._fields, got, want):
        assert float(g) == w, field


def test_inject_records_match_jax(jax_out, capsys):
    rec = kc_dryrun.run_inject(device="cpu")
    assert capsys.readouterr().out.rstrip().endswith("inject sweep OK")
    for site in ("route_drop", "store_drop", "hop2_misfit"):
        _assert_stats(rec[site], jax_out[site])
    assert rec["hop2_misfit"].retry_hop2_fallback == 1
    assert rec["persistent"] == (str(jax_out["persistent_cause"]),
                                 int(jax_out["persistent_rounds"]))
    assert rec["persistent"][0] == "route-slack"


def test_spill_records_match_jax(jax_out, tmp_path, capsys):
    rec = kc_dryrun.run_spill(str(tmp_path), device="cpu")
    assert capsys.readouterr().out.rstrip().endswith("spill demo OK")
    for transport in ("kmer", "superkmer"):
        _assert_stats(rec[transport], jax_out[transport])
        assert rec[transport].spilled_bins == rec[transport].bins_folded == 8


@pytest.mark.parametrize("compact", COMPACTS)
@pytest.mark.parametrize("skew", SKEWS)
def test_skew_records_match_jax(jax_out, skew, compact, capsys):
    rec = kc_dryrun.run_skew(skew, "both", compact, device="cpu")
    assert capsys.readouterr().out.rstrip().endswith("skew demo OK")
    assert sorted(rec) == ["hashed", "plain"]
    for o, st in rec.items():
        _assert_stats(st, jax_out[f"{skew}_{compact}_{o}"])
    if skew == "polya":
        # the hashed order spreads the poly-A run the plain order piles up
        assert (rec["hashed"].load_max_over_mean
                < rec["plain"].load_max_over_mean)


def test_skew_single_order():
    rec = kc_dryrun.run_skew("powerlaw", "hashed", "prefix", device="cpu")
    assert list(rec) == ["hashed"]


def test_query_records_match_jax(jax_out, capsys):
    rec = kc_dryrun.run_query(device="cpu")
    out = capsys.readouterr().out
    assert "ROADMAP item 12" in out and out.rstrip().endswith(
        "query dry-run OK")
    _assert_stats(rec["live"], jax_out["live"])
    _assert_stats(rec["spilled"], jax_out["spilled"])
    assert rec["spilled"].bins_probed == 6
    # the JAX counters' answers: every counted k-mer hits
    n = int((jax_out["live_counts"] > 0).sum())
    assert rec["live"].n_hits == rec["spilled"].n_hits == n
    np.testing.assert_array_equal(jax_out["live_counts"],
                                  jax_out["spilled_counts"])


@pytest.mark.parametrize("argv", [
    ["--reads", "1024"], ["--multi-pod"], ["--inject", "--transport=kmer"],
    ["--out", "x.json", "--spill"], []])
def test_cli_refuses_the_lowering(argv, capsys):
    with pytest.raises(SystemExit) as e:
        kc_dryrun.main(argv + ["--device", "cpu"])
    assert e.value.code == 2
    assert "ROADMAP item 12" in capsys.readouterr().err


def test_cli_refuses_an_unknown_flag(capsys):
    with pytest.raises(SystemExit):
        kc_dryrun.main(["--inject", "--bogus"])
    err = capsys.readouterr().err
    assert "unrecognized" in err and "item 12" not in err


def test_cli_runs_a_drill(capsys):
    kc_dryrun.main(["--skew", "none", "--minimizer-order", "plain",
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert "order=plain" in out and out.rstrip().endswith("skew demo OK")


def test_drills_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs on it")
    for drill in (kc_dryrun.run_inject, kc_dryrun.run_spill,
                  kc_dryrun.run_query):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            drill()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kc_dryrun.run_skew("none")
