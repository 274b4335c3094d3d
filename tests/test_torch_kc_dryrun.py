"""The counter's drills (`repro_torch.launch.kc_dryrun`) on the CPU, each
record held to the JAX package's run of the same scenario on a 4-device
host mesh, as `repro.launch.kc_dryrun`'s drills run it:

- `run_inject`: each site's DAKCStats (retries included) and the
  persistent fault's give-up cause and recorded rounds;
- `run_spill`: each transport's DAKCStats (spilled bins, bytes, folds);
- `run_skew`: each corpus and order's DAKCStats (load_max_over_mean and
  owner_fill_p99 included), with compaction off and 'prefix';
- `run_query`: the live and the spilled-tier batch's QueryStats.

The dry-run: `lower_kc`, `lower_kc_incremental` and `lower_kc_query`
traced on meta tensors against the JAX functions compiled on 8 host
devices in an x64 subprocess, at 1024 reads of 150 bp (k=31, 64-read
chunks, 8 PEs: two scan steps): the planner fields (l3_mode, store
capacity, hop-2 and compaction caps) and the argument bytes equal; the
all_to_all bytes equal the HLO's; the all_to_all count is the HLO's ops
(one a lane and hop in the scan body) times the scan steps, as the port
counts executions. The JAX module's one small all-reduce, the stats'
psum, has no counterpart: the port sums its PEs' stats on one device.

The CLI runs a drill or the dry-run, each lowering case checked for its
record's keys. The JAX runs happen in five subprocesses at once.
"""

import concurrent.futures
import json

import numpy as np
import pytest
import torch

from _torch_parity import JAX_HELPERS, run_jax, run_jax_many
from repro_torch.launch import kc_dryrun
from repro_torch.launch.mesh import Mesh, device_array

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


LOWER = dict(n_reads=1024, read_len=150, k=31, chunk_reads=64)
LOWER_RUNS = {
    "1d": {}, "2d_compact": dict(topology="2d", hop2="compact"),
    "2d_occupancy": dict(topology="2d", hop2="compact", hop2_occupancy=0.5),
    "superkmer": dict(transport="superkmer"), "prefix": dict(compact="prefix"),
    "stacked": dict(receiver="stacked"),
}
QUERIES, BATCHES = 300, 3

_LOWERING = """
import json
from jax.sharding import Mesh
from repro.launch import kc_dryrun as jk
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
lo = json.loads(I["lower"].tobytes())
n, rl, k, ch = lo["n_reads"], lo["read_len"], lo["k"], lo["chunk_reads"]
out = {name: jk.lower_kc(n, rl, k, mesh, chunk_reads=ch, **kw)
       for name, kw in json.loads(I["runs"].tobytes()).items()}
out["query"] = jk.lower_kc_query(int(I["queries"]), n, rl, k, mesh,
                                 chunk_reads=ch)
out["incremental"] = jk.lower_kc_incremental(
    n, rl, k, mesh, chunk_reads=ch, n_batches=int(I["batches"]))
O["json"] = np.frombuffer(json.dumps(out).encode(), np.uint8)
"""


def _as_bytes(obj):
    return np.frombuffer(json.dumps(obj).encode(), np.uint8)


@pytest.fixture(scope="module")
def jax_all(tmp_path_factory):
    """The drills' JAX runs (4 devices) and the lowering's (8 devices,
    x64), all at once."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        low = pool.submit(
            run_jax, tmp_path_factory.mktemp("kc_lowering"), _LOWERING,
            {"lower": _as_bytes(LOWER), "runs": _as_bytes(LOWER_RUNS),
             "queries": np.int64(QUERIES), "batches": np.int64(BATCHES)},
            x64=True, devices=8)
        drills = _jax_drills(tmp_path_factory)
        return drills, json.loads(low.result()["json"].tobytes().decode())


@pytest.fixture(scope="module")
def jax_out(jax_all):
    return jax_all[0]


@pytest.fixture(scope="module")
def jax_lowering(jax_all):
    return jax_all[1]


def _jax_drills(tmp_path_factory):
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
    assert out.startswith("  live 4-PE batch") and out.rstrip().endswith(
        "query dry-run OK")
    _assert_stats(rec["live"], jax_out["live"])
    _assert_stats(rec["spilled"], jax_out["spilled"])
    assert rec["spilled"].bins_probed == 6
    # the JAX counters' answers: every counted k-mer hits
    n = int((jax_out["live_counts"] > 0).sum())
    assert rec["live"].n_hits == rec["spilled"].n_hits == n
    np.testing.assert_array_equal(jax_out["live_counts"],
                                  jax_out["spilled_counts"])


def _pes():
    return Mesh(device_array(list(range(8)), (2, 4)), ("data", "model"))


PLAN_FIELDS = ("l3_mode", "store_capacity_per_pe", "hop2_caps",
               "compact_caps", "hop2_impl", "receiver_impl",
               "transport_impl", "topology", "mesh")


@pytest.mark.parametrize("name", list(LOWER_RUNS))
def test_lower_kc_matches_jax(jax_lowering, name):
    lo = LOWER
    rec = kc_dryrun.lower_kc(lo["n_reads"], lo["read_len"], lo["k"], _pes(),
                             chunk_reads=lo["chunk_reads"],
                             **LOWER_RUNS[name])
    want = jax_lowering[name]
    assert set(want) <= set(rec)
    for field in PLAN_FIELDS:
        assert rec[field] == want[field], field
    assert rec["memory"]["args_gb"] == want["memory"]["args_gb"]
    got_a2a, want_a2a = (rec["collectives"]["all-to-all"],
                         want["collectives"]["all-to-all"])
    assert got_a2a["bytes"] == want_a2a["bytes"]
    steps = lo["n_reads"] // (8 * lo["chunk_reads"])
    assert got_a2a["count"] == want_a2a["count"] * steps
    assert set(rec["roofline"]) == set(want["roofline"])
    assert rec["memory"]["temp_gb"] > 0 and rec["cost"]["bytes"] > 0


def test_lower_kc_query_matches_jax(jax_lowering):
    lo = LOWER
    rec = kc_dryrun.lower_kc_query(QUERIES, lo["n_reads"], lo["read_len"],
                                   lo["k"], _pes(),
                                   chunk_reads=lo["chunk_reads"])
    want = jax_lowering["query"]
    assert set(want) == set(rec)
    for field in ("n_local", "num_pes", "store_capacity_per_pe",
                  "route_wire_bytes_per_batch", "n_queries"):
        assert rec[field] == want[field], field
    assert rec["memory"]["args_gb"] == want["memory"]["args_gb"]
    assert rec["collectives"]["all-to-all"] == want["collectives"][
        "all-to-all"]


def test_lower_kc_incremental_matches_jax(jax_lowering):
    lo = LOWER
    rec = kc_dryrun.lower_kc_incremental(
        lo["n_reads"], lo["read_len"], lo["k"], _pes(),
        chunk_reads=lo["chunk_reads"], n_batches=BATCHES)
    want = jax_lowering["incremental"]
    assert set(want) == set(rec)
    assert rec["store_capacity_per_pe"] == want["store_capacity_per_pe"]
    assert rec["memory"]["args_gb"] == want["memory"]["args_gb"]
    steps = lo["n_reads"] // (8 * lo["chunk_reads"])
    got, w = rec["collectives"]["all-to-all"], want["collectives"][
        "all-to-all"]
    assert got["bytes"] == w["bytes"] and got["count"] == w["count"] * steps


SCAN_CASES = {"1d": {}, "2d-compact": dict(topology="2d", hop2="compact"),
              "superkmer": dict(transport="superkmer", minimizer_len=11)}


@pytest.mark.parametrize("receiver", ["stream", "stacked"])
@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_lowering_extrapolates_the_scan_exactly(receiver, case):
    """The streaming receiver's round, traced two and three scan steps
    deep and extrapolated, and the stacked one's, traced in full, count
    over six steps what their full traces count: FLOPs, bytes, the peak
    and the route."""
    pes = _pes()
    runs = {}
    for full in (False, True):
        orig = kc_dryrun._scan_traced

        def scan(run, n, p, stacked, _orig=orig, _full=full):
            if not _full:
                return _orig(run, n, p, stacked)
            m, wire = run(n)
            return dict(
                flops=(m.flops + m.kernels.ops) / p,
                bytes=(m.bytes + m.kernels.bytes) / p, peak=m.peak / p,
                wire=wire, kernels=None)
        kc_dryrun._scan_traced = scan
        try:
            runs[full] = kc_dryrun.lower_kc(
                6 * 8 * 32, 60, 21, pes, chunk_reads=32,
                receiver=receiver, **SCAN_CASES[case])
        finally:
            kc_dryrun._scan_traced = orig
    for key in ("memory", "cost"):
        assert runs[False][key] == pytest.approx(runs[True][key],
                                                 rel=1e-12), key
    assert runs[False]["collectives"] == runs[True]["collectives"]


LOWERING_CLI = [
    (["--receiver", "both"], ("stacked_receiver",
                              "receive_memory_ratio_stacked_over_stream")),
    (["--topology", "2d", "--hop2", "compact"], ("hop2_caps",)),
    (["--transport", "superkmer", "--minimizer-len", "11"], ("l3_mode",)),
    (["--stream-batches", "2", "--receiver", "stream"], ("incremental",)),
    (["--query", "512", "--device", "cpu"], ()),
]


@pytest.mark.parametrize("argv,keys", LOWERING_CLI,
                         ids=["receiver-both", "2d-compact", "superkmer",
                              "stream-batches", "query"])
def test_cli_runs_the_lowering(argv, keys, tmp_path, capsys):
    out_json = tmp_path / "kc.json"
    rec = kc_dryrun.main(["--reads", "16384", "--chunk-reads", "64",
                          "--out", str(out_json)] + argv)
    out = capsys.readouterr().out
    if "--query" in argv:
        assert rec is None and "query executable @ 256 PEs" in out
        assert out.rstrip().endswith("query dry-run OK")
        return
    assert rec == json.loads(out_json.read_text())
    for key in ("workload", "l3_mode", "memory", "cost", "collectives",
                "roofline", "store_capacity_per_pe", "mesh") + keys:
        assert key in rec, key
    assert rec["n_reads"] == 16384 and rec["mesh"] == {"data": 16,
                                                       "model": 16}
    assert rec["roofline"]["kmers_per_sec_per_chip_bound"] > 0
    if "superkmer" in argv:
        assert rec["l3_mode"] == "superkmer"
    if "2d" in argv:
        assert rec["hop2_impl"] == "compact" and rec["topology"] == "2d"
    assert "dominant:" in out


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
