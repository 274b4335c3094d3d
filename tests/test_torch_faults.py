"""Fault injection: `repro_torch.core.resilience.FaultPlan` through the
port's count_kmers and KmerCounter on the CPU, against the JAX package's
runs of the same plans (the non-disk cases of its resilience tests). The
masks, the recovered per-PE results, every DAKCStats field, the retry
counts and the typed give-ups (their cause and round history) must be
equal. The JAX runs happen in two subprocesses at once, with 8 host
devices each.
"""

import numpy as np
import pytest
import torch

from _torch_parity import run_jax_many
from repro.core import resilience as jresilience
from repro.data import genome as jgenome
from repro_torch import words as W
from repro_torch.core import encoding, fabsp, resilience
from repro_torch.core.resilience import FaultPlan, RetryPolicy

READS = jgenome.sample_reads(jgenome.ReadSetSpec(
    genome_bases=2048, n_reads=64, read_len=52, heavy_hitter_frac=0.3,
    seed=7))

# fault_mask: (n, chunk_idx, plan fields)
MASKS = {
    f"s{seed}_n{n}_{site}_f{frac}_c{chunk}at{at}": dict(
        n=n, at=at, site=site, seed=seed, frac=frac, chunk=chunk)
    for seed, n, site, frac, chunk, at in (
        (0, 1, "route_drop", 0.5, 0, 0),
        (5, 512, "route_drop", 0.25, 2, 2),
        (5, 512, "route_drop", 0.25, 2, 1),
        (5, 512, "route_drop", 0.25, -1, 7),
        (7, 4096, "store_drop", 0.5, -1, 3),
        (3, 1000, "store_drop", 1.0, 0, 0),
        ((1 << 31) + 5, 777, "route_drop", 0.9, 1, 1),
        (123456789, 2048, "store_drop", 0.001, 0, 0),
    )
}

# 'bound' store sizing: no rehash round but the ones a fault forces
BASE = dict(k=11, chunk_reads=8, store_sizing="bound")
G11 = dict(topology="2d", hop2_impl="compact", use_l3=False)
# count_kmers: (p, grid, cfg knobs, plan fields or None)
CASES = {
    "route_drop_p1": (1, None, {}, dict(site="route_drop", seed=1,
                                        frac=0.3)),
    "route_drop_superkmer_p4": (4, None, dict(transport_impl="superkmer",
                                              minimizer_len=7),
                                dict(site="route_drop", seed=4, frac=0.3)),
    "store_drop_p1": (1, None, dict(store_capacity=256), dict(
        site="store_drop", seed=2, frac=0.25)),
    "store_drop_fill_p4": (4, None, dict(store_capacity=512), dict(
        site="store_drop", seed=8, chunk=-1, frac=0.5, fill=0.25)),
    "hop2_misfit_g11": (1, (1, 1), G11, dict(site="hop2_misfit")),
    "hop2_misfit_superkmer_g42": (8, (4, 2), dict(
        topology="2d", hop2_impl="compact", transport_impl="superkmer"),
        dict(site="hop2_misfit")),
    "route_drop_nol3_2d_compact_g24": (8, (2, 4), dict(
        topology="2d", hop2_impl="compact", use_l3=False), dict(
            site="route_drop", seed=9, chunk=-1, frac=0.4)),
}
# the give-ups: (p, cfg knobs, retry policy fields, plan fields)
GIVE_UPS = {
    "persistent_route_drop": (1, {}, dict(max_slack=2.0), dict(
        site="route_drop", seed=1, chunk=-1, frac=0.5, rounds=99)),
    "persistent_store_drop": (1, dict(store_capacity=64), dict(
        store_cap_ceiling=128), dict(site="store_drop", seed=2, chunk=-1,
                                     frac=0.5, rounds=99)),
    "retry_budget": (4, {}, dict(max_slack=1e9, max_rounds=2), dict(
        site="route_drop", seed=1, chunk=-1, frac=0.5, rounds=99)),
}

_PRELUDE = """
from jax.sharding import Mesh
from repro.core import fabsp, resilience
from repro.core.resilience import FaultPlan, RetryPolicy

def put(key, tup):
    O[key] = np.array([float(x) for x in tup], np.float64)

def mesh_of(p, grid):
    if grid is None:
        return Mesh(np.array(jax.devices()[:p]), ("pe",)), ("pe",)
    return (Mesh(np.array(jax.devices()[:p]).reshape(grid), ("row", "col")),
            ("row", "col"))
reads = jnp.asarray(I["reads"])
"""

_CASES_BODY = """
for name, (p, grid, knobs, plan) in CASES.items():
    mesh, axes = mesh_of(p, grid)
    cfg = fabsp.DAKCConfig(**{**BASE, **knobs},
                           faults=None if plan is None else FaultPlan(**plan))
    res, st = fabsp.count_kmers(reads, mesh, cfg, axes)
    O[name + "_unique"], O[name + "_counts"] = res.unique, res.counts
    O[name + "_n"] = res.num_unique
    put(name + "_stats", st)
"""

_REST_BODY = """
for name, m in MASKS.items():
    plan = FaultPlan(site=m["site"], seed=m["seed"], chunk=m["chunk"],
                     frac=m["frac"])
    O["mask_" + name] = resilience.fault_mask(m["n"], plan,
                                              jnp.int32(m["at"]))

for name, (p, knobs, policy, plan) in GIVE_UPS.items():
    mesh, axes = mesh_of(p, None)
    cfg = fabsp.DAKCConfig(**{**BASE, **knobs}, retry=RetryPolicy(**policy),
                           faults=FaultPlan(**plan))
    try:
        fabsp.count_kmers(reads, mesh, cfg, axes)
        raise SystemExit("no give-up for " + name)
    except resilience.RetryError as e:
        O[name + "_kind"] = np.array(type(e).__name__)
        O[name + "_cause"] = np.array(getattr(e, "cause", ""))
        O[name + "_rounds"] = np.array(
            [[r.round, r.slack, r.store_cap, r.hop2_padded, r.route_dropped,
              r.store_dropped, r.hop2_dropped] for r in e.rounds], np.float64)
        O[name + "_causes"] = np.array(["|".join(r.causes) for r in e.rounds])

# KmerCounter: store_drop recovery over two batches, then update_fail
mesh, axes = mesh_of(4, None)
base = dict(BASE, store_capacity=256)
kc = fabsp.KmerCounter(mesh, fabsp.DAKCConfig(**base, faults=FaultPlan(
    site="store_drop", seed=2, frac=0.25)), axes)
put("kc_u0", kc.update(reads[:32]))
put("kc_u1", kc.update(reads[32:]))
res, st = kc.finalize()
O["kc_unique"], O["kc_counts"], O["kc_n"] = (res.unique, res.counts,
                                             res.num_unique)
put("kc_stats", st)
kc = fabsp.KmerCounter(mesh, fabsp.DAKCConfig(**BASE, faults=FaultPlan(
    site="update_fail", update_n=1)), axes)
put("fail_u0", kc.update(reads[:32]))
try:
    kc.update(reads[32:])
    raise SystemExit("update_fail did not fire")
except resilience.InjectedFault:
    pass
res, st = kc.finalize()
O["fail_unique"], O["fail_counts"], O["fail_n"] = (res.unique, res.counts,
                                                   res.num_unique)
put("fail_stats", st)
O["fail_n_updates"] = np.array(kc._n_updates)
"""


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    head = (f"MASKS = {MASKS!r}\nCASES = {CASES!r}\nGIVE_UPS = {GIVE_UPS!r}\n"
            f"BASE = {BASE!r}\n" + _PRELUDE)
    out = run_jax_many(tmp_path_factory.mktemp("faults"),
                       {"cases": (head + _CASES_BODY, False),
                        "rest": (head + _REST_BODY, False)},
                       {"reads": READS}, devices=8)
    return {**out["cases"], **out["rest"]}


def _assert_stats(got, want):
    assert len(got) == len(want)
    for field, g, w in zip(got._fields, got, want):
        assert float(g) == w, field


def _assert_result(res, bits, jax_out, prefix):
    np.testing.assert_array_equal(W.to_numpy_words(res.unique, bits),
                                  jax_out[prefix + "_unique"])
    np.testing.assert_array_equal(res.counts.numpy(),
                                  jax_out[prefix + "_counts"])
    np.testing.assert_array_equal(res.num_unique.numpy(),
                                  jax_out[prefix + "_n"])


@pytest.mark.parametrize("name", sorted(MASKS))
def test_fault_mask_matches_jax(jax_out, name):
    m = MASKS[name]
    plan = FaultPlan(site=m["site"], seed=m["seed"], chunk=m["chunk"],
                     frac=m["frac"])
    got = resilience.fault_mask(m["n"], plan, m["at"])
    assert got.dtype == torch.bool and got.shape == (m["n"],)
    np.testing.assert_array_equal(got.numpy(), jax_out["mask_" + name])


def _run(p, grid, knobs, plan):
    cfg = fabsp.DAKCConfig(**{**BASE, **knobs},
                           faults=None if plan is None else FaultPlan(**plan))
    return fabsp.count_kmers(READS, cfg, num_pes=p, grid=grid, device="cpu")


@pytest.mark.parametrize("name", sorted(CASES))
def test_injected_fault_recovers_as_jax(jax_out, name):
    p, grid, knobs, plan = CASES[name]
    res, stats = _run(p, grid, knobs, plan)
    bits = encoding.word_bits({**BASE, **knobs}["k"])
    _assert_result(res, bits, jax_out, name)
    _assert_stats(stats, jax_out[name + "_stats"])
    site = plan["site"]
    assert stats.retry_route_slack >= (site == "route_drop")
    assert stats.retry_store_rehash >= (site == "store_drop")
    assert stats.retry_hop2_fallback == (site == "hop2_misfit")
    assert stats.overflow == stats.store_overflow == stats.hop2_dropped == 0
    # the recovered histogram is the fault-free run's: bit-identical after
    # a routing fault, the same (k-mer, count) set after a rehash
    clean, _ = _run(p, grid, knobs, None)
    if site == "store_drop":
        def pairs(r):
            live = r.counts > 0
            return sorted(zip(r.unique[live].tolist(),
                              r.counts[live].tolist()))
        assert pairs(res) == pairs(clean)
    else:
        assert torch.equal(res.unique, clean.unique)
        assert torch.equal(res.counts, clean.counts)


@pytest.mark.parametrize("name", sorted(GIVE_UPS))
def test_persistent_fault_gives_up_as_jax(jax_out, name):
    p, knobs, policy, plan = GIVE_UPS[name]
    cfg = fabsp.DAKCConfig(**{**BASE, **knobs}, retry=RetryPolicy(**policy),
                           faults=FaultPlan(**plan))
    with pytest.raises(resilience.RetryError) as ei:
        fabsp.count_kmers(READS, cfg, num_pes=p, device="cpu")
    err = ei.value
    assert type(err).__name__ == str(jax_out[name + "_kind"])
    assert getattr(err, "cause", "") == str(jax_out[name + "_cause"])
    got = np.array([[r.round, r.slack, r.store_cap, r.hop2_padded,
                     r.route_dropped, r.store_dropped, r.hop2_dropped]
                    for r in err.rounds], np.float64)
    np.testing.assert_array_equal(got, jax_out[name + "_rounds"])
    assert ["|".join(r.causes) for r in err.rounds] == \
        jax_out[name + "_causes"].tolist()


def test_counter_store_drop_recovery_matches_jax(jax_out):
    cfg = fabsp.DAKCConfig(**BASE, store_capacity=256, faults=FaultPlan(
        site="store_drop", seed=2, frac=0.25))
    kc = fabsp.KmerCounter(cfg, num_pes=4, device="cpu")
    s0 = kc.update(READS[:32])
    s1 = kc.update(READS[32:])
    _assert_stats(s0, jax_out["kc_u0"])
    _assert_stats(s1, jax_out["kc_u1"])
    assert s0.retry_store_rehash >= 1
    res, st = kc.finalize()
    _assert_result(res, 32, jax_out, "kc")
    _assert_stats(st, jax_out["kc_stats"])
    assert st.retry_store_rehash == (s0.retry_store_rehash
                                     + s1.retry_store_rehash)


def test_update_fail_leaves_the_committed_store_untouched(jax_out):
    cfg = fabsp.DAKCConfig(**BASE, faults=FaultPlan(site="update_fail",
                                                    update_n=1))
    kc = fabsp.KmerCounter(cfg, num_pes=4, device="cpu")
    _assert_stats(kc.update(READS[:32]), jax_out["fail_u0"])
    snap = kc._committed
    keys, counts = snap.keys.clone(), snap.counts.clone()
    with pytest.raises(resilience.InjectedFault, match="update #1"):
        kc.update(READS[32:])
    assert kc._n_updates == int(jax_out["fail_n_updates"]) == 1
    assert kc._committed is snap
    assert torch.equal(snap.keys, keys) and torch.equal(snap.counts, counts)
    res, st = kc.finalize()
    _assert_result(res, 32, jax_out, "fail")
    _assert_stats(st, jax_out["fail_stats"])
    clean = fabsp.KmerCounter(fabsp.DAKCConfig(**BASE), num_pes=4,
                              device="cpu")
    clean.update(READS[:32])
    assert torch.equal(res.unique, clean.finalize()[0].unique)


def test_fault_plan_validation_matches_jax():
    for bad in (dict(site="nonsense"), dict(site="route_drop", frac=0.0),
                dict(site="route_drop", frac=1.5),
                dict(site="store_drop", fill=1.0),
                dict(site="route_drop", rounds=0),
                dict(site="update_fail", update_n=-1)):
        with pytest.raises(ValueError):
            jresilience.FaultPlan(**bad)
        with pytest.raises(ValueError):
            FaultPlan(**bad)
    assert resilience.SITES == jresilience.SITES
    assert resilience.TRACE_SITES == jresilience.TRACE_SITES
    assert [f.name for f in resilience.dataclasses.fields(FaultPlan)] == \
        [f.name for f in jresilience.dataclasses.fields(
            jresilience.FaultPlan)]


def test_ckpt_write_plan_counts_as_a_clean_run():
    """'ckpt_write' fires in `save` only, so counting runs as without it."""
    res, st = _run(2, None, {}, dict(site="ckpt_write"))
    clean, cst = _run(2, None, {}, None)
    assert torch.equal(res.unique, clean.unique) and st == cst


def test_fault_plan_is_hashable_and_frozen():
    """A plan rides the frozen DAKCConfig, which stays a usable key."""
    a = FaultPlan(site="route_drop", seed=3)
    assert hash(a) == hash(FaultPlan(site="route_drop", seed=3))
    cfg = fabsp.DAKCConfig(k=11, faults=a)
    assert {cfg: 1}[fabsp.DAKCConfig(k=11, faults=FaultPlan(
        site="route_drop", seed=3))] == 1
    with pytest.raises(Exception):
        a.seed = 4


def test_active_trace_fault_arms_only_in_trace_sites():
    plan = FaultPlan(site="route_drop", rounds=2)
    assert resilience.active_trace_fault(plan, 0) is plan
    assert resilience.active_trace_fault(plan, 1) is plan
    assert resilience.active_trace_fault(plan, 2) is None
    assert resilience.active_trace_fault(None, 0) is None
    assert resilience.active_trace_fault(FaultPlan(site="hop2_misfit"),
                                         0) is None


@pytest.mark.parametrize("bad", [
    dict(receiver_impl="stacked", faults=FaultPlan(site="store_drop")),
    dict(faults=FaultPlan(site="hop2_misfit")),
    dict(topology="2d", route2d_impl="perhop",
         faults=FaultPlan(site="hop2_misfit")),
    dict(faults=FaultPlan(site="spill_write")),
    dict(faults=FaultPlan(site="bin_corrupt")),
], ids=["store_drop_stacked", "hop2_misfit_1d", "hop2_misfit_perhop",
        "spill_write_no_spill", "bin_corrupt_no_spill"])
def test_misplaced_fault_sites_are_refused_as_in_jax(bad):
    from repro.core import fabsp as jfabsp

    jbad = dict(bad)
    jbad["faults"] = jresilience.FaultPlan(site=bad["faults"].site)
    with pytest.raises(ValueError):
        jfabsp.DAKCConfig(k=11, **jbad)
    with pytest.raises(ValueError):
        fabsp.DAKCConfig(k=11, **bad)


def test_sticky_padded_hop2_after_a_misfit():
    """One misfit moves the counter's stream onto the padded tile for good:
    the next batch runs padded from its first round, so it fires no
    fallback and moves the padded tile's bytes."""
    knobs = dict(BASE, topology="2d", hop2_impl="compact")
    kc = fabsp.KmerCounter(fabsp.DAKCConfig(
        **knobs, faults=FaultPlan(site="hop2_misfit", rounds=1)),
        num_pes=4, grid=(2, 2), device="cpu")
    padded = fabsp.KmerCounter(fabsp.DAKCConfig(**BASE, topology="2d"),
                               num_pes=4, grid=(2, 2), device="cpu")
    assert kc.update(READS[:32]).retry_hop2_fallback == 1
    padded.update(READS[:32])
    s1 = kc.update(READS[32:])
    p1 = padded.update(READS[32:])
    assert s1.retry_hop2_fallback == 0 and kc._hop2_padded
    assert int(s1.wire_bytes) == int(p1.wire_bytes)
