"""The counter's dry-run and drills (counterpart of
`repro.launch.kc_dryrun`).

The dry-run. The JAX module lowers and compiles the DAKC counter (k=31,
the paper's Table V read geometry) at Synthetic-30 scale on the (16, 16)
or (2, 16, 16) production mesh and reads XLA's memory and cost analyses
and the partitioned HLO's collectives. The port traces its own round,
`fabsp._local_count`, on `meta` tensors with the mesh's P PEs as the
leading dimension (`launch/dryrun.py`'s `CostMode`: FLOPs, bytes
accessed, peak live bytes; the kernels' work from `kernels/meta.py`) and
divides by P for the per-PE record. Nothing touches a card. The plan's
fields come from the counting path's own shape-only planners
(`_plan_caps`, `_default_store_capacity`, `_resolve_hop2_caps` and
`_resolve_compact` on `_chunk_valid_estimate(None, ...)`): with no reads
to sample, the compact hop 2 and the pre-route compaction degrade as the
JAX module says (the compact hop 2 to the padded tile unless
--hop2-occupancy is given; the compaction to a no-op). The collectives are
the route's all_to_all result bytes (`route_lanes`' wire bytes, per PE)
over the scan steps; `count` is the all_to_alls run, one a lane and hop.

- `lower_kc`: one counting round, the 'stream' or the 'stacked' receiver;
- `lower_kc_incremental`: one `KmerCounter` update round folding a batch
  into a store sized for N batches;
- `lower_kc_query`: one `query.route_queries` batch (forward route, probe,
  return route) against the store the counting dry-run sizes.

The drills count a small read set on 4 PEs held on one device, check the
result exactly, print the JAX drill's lines and raise `SystemExit` on the
same failures; each also returns its records (the `DAKCStats` or
`QueryStats` it prints) for tests and `chip_smoke.py`:

- `run_inject`: the three in-trace `FaultPlan` sites ('route_drop' and
  'store_drop' on 1d, 'hop2_misfit' on a (2, 2) grid) each recover the
  fault-free histogram, and a persistent fault raises
  `resilience.CapacityExhausted`;
- `run_spill`: both transports under a clamped store ceiling spill to
  disk bins and drain to the in-core histogram;
- `run_skew`: an adversarial corpus under the minimizer order(s), each
  run against `serial.count_kmers_python`, with the per-PE imbalance;
- `run_query`: a mixed hit/miss batch against a counter, in core and
  through the spilled-bin tier.

    PYTHONPATH=src python -m repro_torch.launch.kc_dryrun --reads 524288
        # the dry-run on the host: both receivers (Synthetic-30/8 reads
        # without --reads; --full for all of them)
    PYTHONPATH=src python -m repro_torch.launch.kc_dryrun --inject
    PYTHONPATH=src python -m repro_torch.launch.kc_dryrun --spill
    PYTHONPATH=src python -m repro_torch.launch.kc_dryrun --skew polya \\
        --minimizer-order both --compact prefix
    PYTHONPATH=src python -m repro_torch.launch.kc_dryrun --query 1024
        # the query lowering on the host, then the live drill
The drills run on the card; add --device cpu to run them on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time
from typing import Dict, Optional

import numpy as np

NUM_PES = 4
# Synthetic 30 (paper Table V): 357,913,900 reads of 150 nt.
SYNTHETIC30_READS = 357_913_900


def _all_to_alls(cfg, mode: str, topology: str) -> int:
    """The all_to_alls of one scan step's route, one a lane and hop: the
    lane sets of `fabsp._phase1_step` (a super-k-mer's payload words and
    its length; a packed or whole k-mer's word; dual's NORMAL word and
    HEAVY word and count)."""
    from repro_torch.core import minimizer
    lanes = {"superkmer": minimizer.superkmer_words(
        cfg.k, cfg.minimizer_len, cfg.bits_per_symbol) + 1,
        "dual": 3}.get(mode, 1)
    return lanes * (2 if topology == "2d" else 1)


def _collectives(wire_per_pe: float, n_all_to_all: int) -> dict:
    from repro_torch.launch.dryrun import COLLECTIVE_OPS
    out = {op: {"bytes": 0.0, "count": 0} for op in COLLECTIVE_OPS}
    out["all-to-all"] = {"bytes": float(wire_per_pe), "count": n_all_to_all}
    out["total_bytes"] = float(wire_per_pe)
    return out


def _meta_store(num_pes: int, cap: int, word_bits: int):
    import torch

    from repro_torch.core import countstore
    return countstore.empty_store(num_pes, cap, word_bits,
                                  torch.device("meta"))


def _meta_reads(num_pes: int, n_reads: int, read_len: int):
    import torch
    return torch.empty((num_pes, n_reads // num_pes, read_len),
                       dtype=torch.uint8, device="meta")


def _scan_traced(run, n_chunks: int, num_pes: int,
                 stacked: bool) -> dict:
    """`run(c)` traces a round of c scan steps (chunks a PE) and returns
    (CostMode, wire bytes a PE). From the second step on, every scan step
    runs the same ops at the same shapes (the first also does one-time
    work), so the streaming receiver's round is traced two and three
    steps deep and each count extrapolated linearly from those to
    `n_chunks` steps; its peak is the three-step trace's, since a step
    holds nothing of the step before it but the store. The stacked
    receiver keeps every step's tiles, so its peak is a maximum of a
    step's transients and the growing stack, which a shallower trace
    cannot be extrapolated to: its round is traced in full. Returns the
    round's counts a PE: flops, bytes, peak, wire and each kernel's
    calls, ops and bytes."""
    steps = [n_chunks] if stacked or n_chunks <= 3 else [2, 3]
    got = {c: run(c) for c in steps}

    def at(get, grows=True):
        hi = get(got[steps[-1]])
        if len(steps) == 1 or not grows:
            return hi
        return hi + (n_chunks - 3) * (hi - get(got[2]))

    names = sorted({n for m, _ in got.values()
                    for n in m.kernels.by_kernel})
    kern = lambda n, i: at(lambda g: g[0].kernels.by_kernel.get(  # noqa: E731
        n, (0, 0.0, 0.0))[i])
    return dict(
        flops=at(lambda g: g[0].flops + g[0].kernels.ops) / num_pes,
        bytes=at(lambda g: g[0].bytes + g[0].kernels.bytes) / num_pes,
        peak=at(lambda g: g[0].peak, grows=stacked) / num_pes,
        wire=at(lambda g: g[1]),
        kernels={n: {"calls": int(kern(n, 0)), "ops": kern(n, 1) / num_pes,
                     "bytes": kern(n, 2) / num_pes} for n in names})


def lower_kc(n_reads: int, read_len: int, k: int, mesh, *,
             chunk_reads: int, slack: float = 1.5,
             receiver: str = "stream", transport: str = "kmer",
             minimizer_len: int = 15, topology: str = "1d",
             hop2: str = "padded", hop2_occupancy: float = None,
             minimizer_order: str = "plain",
             compact: str = "off") -> dict:
    """One counting round of `n_reads` x `read_len` reads over the mesh's
    PEs, traced on meta: the record of the JAX `lower_kc`, per PE."""
    from repro_torch.core import fabsp
    from repro_torch.core.fabsp import DAKCConfig
    from repro_torch.launch.dryrun import _trace

    num_pes = mesh.size
    grid = None
    if topology == "2d":
        # near-square (row, col) factorization of the PE count: the
        # largest divisor <= sqrt(P)
        rows = max(r for r in range(1, int(num_pes ** 0.5) + 1)
                   if num_pes % r == 0)
        grid = (rows, num_pes // rows)
    cfg = DAKCConfig(k=k, chunk_reads=chunk_reads, slack=slack,
                     receiver_impl=receiver, transport_impl=transport,
                     minimizer_len=minimizer_len, topology=topology,
                     hop2_impl=hop2, minimizer_order=minimizer_order,
                     compact_impl=compact)
    shape = (n_reads, read_len)
    mode, cap_n, cap_h = fabsp._plan_caps(cfg, num_pes, shape, slack)
    store_cap = fabsp._default_store_capacity(cfg, shape, num_pes)
    # no reads to sample: the estimate is the instance bound, its peak the
    # mean over the PEs
    est = fabsp._chunk_valid_estimate(None, cfg, mode, shape, num_pes)
    hop2_caps = None
    if hop2 == "compact" and topology == "2d":
        if hop2_occupancy is not None:
            def p2(c):
                return min(c, fabsp._pow2ceil(max(8, int(c * hop2_occupancy))))
            hop2_caps = (p2(cap_n), p2(cap_h) if cap_h else 0)
        else:
            hop2_caps = fabsp._resolve_hop2_caps(cfg, num_pes, shape, slack,
                                                 est)
    compact_caps = fabsp._resolve_compact(cfg, num_pes, shape, slack, est)

    def run(c):
        reads = _meta_reads(num_pes, c * chunk_reads * num_pes, read_len)
        traced, (_, stats) = _trace(lambda: fabsp._local_count(
            reads, cfg=cfg, num_pes=num_pes, cap_n=cap_n, cap_h=cap_h,
            store_cap=store_cap, mode=mode, grid=grid, hop2_caps=hop2_caps,
            compact_caps=compact_caps))
        # stats[3]: the round's wire bytes summed over the PEs
        return traced, stats[3] / num_pes

    t0 = time.perf_counter()
    n_steps = n_reads // (num_pes * chunk_reads)
    r = _scan_traced(run, n_steps, num_pes, stacked=receiver == "stacked")
    rec = {
        "workload": "dakc-kc", "k": k, "n_reads": n_reads,
        "read_len": read_len, "chunk_reads": chunk_reads,
        "l3_mode": mode, "receiver_impl": receiver,
        "transport_impl": transport, "topology": topology,
        "hop2_impl": hop2 if topology == "2d" else "n/a",
        "hop2_caps": list(hop2_caps) if hop2_caps else None,
        "minimizer_order": minimizer_order,
        "compact_impl": compact,
        "compact_caps": list(compact_caps) if compact_caps else None,
        "store_capacity_per_pe": store_cap if receiver == "stream" else 0,
        "mesh": dict(mesh.shape),
        "compile_seconds": round(time.perf_counter() - t0, 2),
    }
    rec["memory"] = {"temp_gb": r["peak"] / 1e9,
                     "args_gb": n_reads * read_len / num_pes / 1e9}
    rec["cost"] = {"flops": float(r["flops"]), "bytes": float(r["bytes"])}
    rec["collectives"] = _collectives(
        r["wire"], n_steps * _all_to_alls(cfg, mode, topology))
    rec["kernels"] = r["kernels"]
    rec["roofline"] = kc_roofline(rec, n_reads * (read_len - k + 1),
                                  num_pes)
    return rec


def kc_roofline(rec: dict, kmers: int, num_pes: int) -> dict:
    """Roofline terms per PE and counting pass, one H100 a PE: compute is
    the larger of the traced operations and a floor of 9 integer
    operations a k-mer instance (one parse, eight sort passes of the
    word's bytes) at the card's 64-bit integer rate
    (`analytical_model.H100_SXM.c_node`); memory at HBM3's rate; the route
    at NVLink's, a direction (`roofline.H100`)."""
    from repro_torch.core.analytical_model import H100_SXM
    from repro_torch.launch.roofline import H100

    ops_floor = kmers * (1 + 8) / num_pes
    t_comp = max(rec["cost"]["flops"], ops_floor) / H100_SXM.c_node
    t_mem = rec["cost"]["bytes"] / H100.hbm_bw
    t_coll = rec["collectives"]["total_bytes"] / H100.link_bw
    return {
        "t_compute_s": t_comp, "t_memory_s": t_mem,
        "t_collective_s": t_coll,
        "dominant": max(("compute", t_comp), ("memory", t_mem),
                        ("collective", t_coll), key=lambda kv: kv[1])[0],
        "kmers_per_sec_per_chip_bound":
            (kmers / num_pes) / max(t_comp, t_mem, t_coll),
    }


def lower_kc_incremental(batch_reads: int, read_len: int, k: int, mesh, *,
                         chunk_reads: int, n_batches: int) -> dict:
    """One `KmerCounter` update round: a batch folding into the persistent
    store, sized for the whole stream of `n_batches` batches (the
    streaming-ingest scenario). The round inserts into a copy of the
    committed store, as `KmerCounter._incore_update` does."""
    from repro_torch.core import countstore, encoding, fabsp
    from repro_torch.core.fabsp import DAKCConfig
    from repro_torch.launch.dryrun import _trace

    num_pes = mesh.size
    cfg = DAKCConfig(k=k, chunk_reads=chunk_reads)
    store_cap = fabsp._default_store_capacity(
        cfg, (batch_reads * n_batches, read_len), num_pes)
    cfg = dataclasses.replace(cfg, store_capacity=store_cap)
    mode, cap_n, cap_h = fabsp._plan_caps(cfg, num_pes,
                                          (batch_reads, read_len), cfg.slack)
    wb = encoding.word_bits(k, cfg.bits_per_symbol)
    store = _meta_store(num_pes, store_cap, wb)

    def run(c):
        reads = _meta_reads(num_pes, c * chunk_reads * num_pes, read_len)
        def update():
            work, fold = fabsp._stream_fold(
                fabsp._chunked(reads, cfg.chunk_reads),
                countstore.store_copy(store), cfg=cfg, num_pes=num_pes,
                cap_n=cap_n, cap_h=cap_h, mode=mode)
            return work, fabsp._round_stats(num_pes, work.dropped, fold)

        traced, (_, stats) = _trace(update)
        return traced, stats[3] / num_pes

    t0 = time.perf_counter()
    n_steps = batch_reads // (num_pes * chunk_reads)
    r = _scan_traced(run, n_steps, num_pes, stacked=False)
    args = batch_reads * read_len + num_pes * store_cap * (wb // 8 + 4)
    return {
        "workload": "dakc-kc-incremental", "k": k,
        "batch_reads": batch_reads, "n_batches": n_batches,
        "store_capacity_per_pe": store_cap,
        "compile_seconds": round(time.perf_counter() - t0, 2),
        "memory": {"temp_gb": r["peak"] / 1e9,
                   "args_gb": args / num_pes / 1e9},
        "collectives": _collectives(
            r["wire"], n_steps * _all_to_alls(cfg, mode, "1d")),
    }


def lower_kc_query(n_queries: int, n_reads: int, read_len: int, k: int,
                   mesh, *, chunk_reads: int) -> dict:
    """One query batch (`query.route_queries`: forward route, in-place
    probe, return route) of `n_queries` k-mers against the store the
    counting dry-run sizes for this workload."""
    import torch

    from repro_torch.core import countstore, encoding, fabsp, query
    from repro_torch.core.fabsp import DAKCConfig
    from repro_torch.launch.dryrun import _trace

    num_pes = mesh.size
    cfg = DAKCConfig(k=k, chunk_reads=chunk_reads)
    store_cap = fabsp._default_store_capacity(cfg, (n_reads, read_len),
                                              num_pes)
    n_local = fabsp._pow2ceil(max(1, -(-n_queries // num_pes)))
    wb = encoding.word_bits(k, cfg.bits_per_symbol)
    store = _meta_store(num_pes, store_cap, wb)
    snap = countstore.StoreSnapshot(gen=0, keys=store.keys,
                                    counts=store.counts,
                                    store_cap=store_cap, word_bits=wb)
    q = torch.empty((num_pes, n_local), dtype=torch.int64, device="meta")
    t0 = time.perf_counter()
    traced, (_, _, wire) = _trace(
        lambda: query.route_queries(q, cfg, snap, num_pes=num_pes))
    args = n_local * wb // 8 + store_cap * (wb // 8 + 4)
    return {
        "workload": "dakc-kc-query", "k": k, "n_queries": n_queries,
        "n_local": n_local, "num_pes": num_pes,
        "store_capacity_per_pe": store_cap,
        "compile_seconds": round(time.perf_counter() - t0, 2),
        "memory": {"temp_gb": traced.peak / num_pes / 1e9,
                   "args_gb": args / 1e9},
        # every PE's forward (word + qid) and return (qid + count) lanes,
        # both at capacity n_local
        "route_wire_bytes_per_batch": num_pes * wire,
        # two lanes a hop: (word, qid) forward, (qid, count) back
        "collectives": _collectives(wire, 4),
    }


def print_query_lowering(rec: dict) -> None:
    print(f"query executable @ {rec['num_pes']} PEs: "
          f"n_queries={rec['n_queries']} shape bucket n_local="
          f"{rec['n_local']}, store={rec['store_capacity_per_pe']} "
          f"slots/PE, compile={rec['compile_seconds']}s")
    print(f"  temp={rec['memory']['temp_gb']:.3f} GB "
          f"args={rec['memory']['args_gb']:.3f} GB "
          f"route_wire_bytes/batch={rec['route_wire_bytes_per_batch']:,} "
          f"collective_bytes={rec['collectives']['total_bytes']:,}")


def _merged_hist(res) -> dict:
    """{word: count} over every PE of a flat per-PE AccumResult; 64-bit
    words read as unsigned."""
    nsh = res.num_unique.shape[0]
    u = res.unique.reshape(nsh, -1).cpu().numpy()
    c = res.counts.reshape(nsh, -1).cpu().numpy()
    nu = res.num_unique.cpu().numpy()
    mask = (1 << 64) - 1
    return {int(u[s, i]) & mask: int(c[s, i])
            for s in range(nsh) for i in range(int(nu[s]))}


def _small_reads(genome_bases: int, n_reads: int, read_len: int,
                 heavy: float = 0.0) -> np.ndarray:
    from repro_torch.data import genome
    return genome.sample_reads(genome.ReadSetSpec(
        genome_bases=genome_bases, n_reads=n_reads, read_len=read_len,
        heavy_hitter_frac=heavy, seed=7))


def run_inject(device=None) -> Dict[str, object]:
    """Fault-injection sweep: every recoverable fault class reproduces the
    fault-free histogram exactly, with the replays visible in
    `DAKCStats.retry_*`; a persistent fault raises the typed give-up error
    carrying the round history. Returns {site: DAKCStats} and, under
    'persistent', (cause, recorded rounds)."""
    from repro_torch.core import fabsp, resilience
    from repro_torch.core.fabsp import DAKCConfig

    dev = fabsp.resolve_device(device)
    reads = _small_reads(2048, 64, 52, heavy=0.3)

    def show(tag, stats):
        print(f"  {tag:32s} retries: route-slack={stats.retry_route_slack} "
              f"store-rehash={stats.retry_store_rehash} "
              f"hop2-fallback={stats.retry_hop2_fallback}")

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
    records: Dict[str, object] = {}
    print("fault-injection sweep (recovered histogram == fault-free):")
    for site, grid, base, plan in scenarios:
        clean, _ = fabsp.count_kmers(reads, DAKCConfig(**base),
                                     num_pes=NUM_PES, grid=grid, device=dev)
        got, stats = fabsp.count_kmers(reads, DAKCConfig(**base, faults=plan),
                                       num_pes=NUM_PES, grid=grid,
                                       device=dev)
        if _merged_hist(got) != _merged_hist(clean):
            raise SystemExit(f"FAIL: {site} recovery diverged")
        replays = (stats.retry_route_slack + stats.retry_store_rehash
                   + stats.retry_hop2_fallback)
        if replays < 1:
            raise SystemExit(f"FAIL: {site} fault never fired")
        show(site, stats)
        records[site] = stats

    # the give-up path: a persistent fault must exhaust the slack ladder
    cfg = DAKCConfig(
        k=11, chunk_reads=4,
        retry=resilience.RetryPolicy(max_slack=2.0),
        faults=resilience.FaultPlan(site="route_drop", seed=1, chunk=-1,
                                    frac=0.5, rounds=99))
    try:
        fabsp.count_kmers(reads, cfg, num_pes=NUM_PES, device=dev)
        raise SystemExit("FAIL: persistent fault did not raise")
    except resilience.CapacityExhausted as e:
        print(f"  {'route_drop (persistent)':32s} gave up: cause={e.cause} "
              f"after {len(e.rounds)} recorded round(s)")
        records["persistent"] = (e.cause, len(e.rounds))
    print("inject sweep OK")
    return records


def run_spill(spill_dir: str = None, device=None) -> Dict[str, object]:
    """Memory-pressure drill: clamp the store's rehash ceiling below the
    read set's distinct k-mers so the in-core ladder runs out, let the
    spill tier engage, and check the out-of-core histogram equals the
    unconstrained run exactly, on both transports. Returns {transport:
    DAKCStats}."""
    from repro_torch.core import fabsp, resilience
    from repro_torch.core.fabsp import DAKCConfig

    dev = fabsp.resolve_device(device)
    reads = _small_reads(4096, 128, 80)
    records: Dict[str, object] = {}
    print("memory-pressure spill demo (clamped ceiling -> disk bins):")
    for transport in ("kmer", "superkmer"):
        base = dict(k=11, chunk_reads=8, receiver_impl="stream",
                    transport_impl=transport, minimizer_len=7)
        clean, _ = fabsp.count_kmers(reads, DAKCConfig(**base),
                                     num_pes=NUM_PES, device=dev)
        with tempfile.TemporaryDirectory() as tmp:
            cfg = DAKCConfig(
                **base, store_capacity=64,
                retry=resilience.RetryPolicy(store_cap_ceiling=128),
                spill="auto", spill_dir=spill_dir or tmp, spill_bins=8)
            got, stats = fabsp.count_kmers(reads, cfg, num_pes=NUM_PES,
                                           device=dev)
            if _merged_hist(got) != _merged_hist(clean):
                raise SystemExit(f"FAIL: {transport} spill histogram "
                                 f"diverged from the in-core run")
            if stats.spilled_bins < 1:
                raise SystemExit(f"FAIL: {transport} never spilled")
            print(f"  {transport:10s} spilled_bins={stats.spilled_bins} "
                  f"spilled_bytes={stats.spilled_bytes} "
                  f"bins_folded={stats.bins_folded} "
                  f"(rehash rounds before engage: "
                  f"{stats.retry_store_rehash})")
        records[transport] = stats
    print("spill demo OK")
    return records


def skew_reads(skew: str) -> np.ndarray:
    """The skew drill's corpus: 256 reads of 48 bp ('polya', 'powerlaw'
    at m=7, or 'none', a uniform genome's reads)."""
    from repro_torch.data import genome

    n, rl, m = 256, 48, 7
    if skew == "polya":
        return genome.poly_a_reads(n, rl, seed=3)
    if skew == "powerlaw":
        return genome.power_law_minimizer_reads(n, rl, m, alpha=1.5, seed=4)
    if skew != "none":
        raise ValueError(f"unknown skew {skew!r}")
    return genome.sample_reads(genome.ReadSetSpec(
        genome_bases=1 << 14, n_reads=n, read_len=rl, seed=7))


def run_skew(skew: str, order: str = "both", compact: str = "off",
             device=None) -> Dict[str, object]:
    """Skew drill (4 PEs, super-k-mer transport): count an adversarial
    corpus under the selected minimizer order(s) and print the per-PE
    imbalance (`DAKCStats.load_max_over_mean`, `owner_fill_p99`). Every
    run is checked against the serial oracle: the orders move load, never
    counts. Under compact='prefix' no run may burn a route-slack round.
    Returns {order: DAKCStats}."""
    from repro_torch.core import fabsp, serial
    from repro_torch.core.fabsp import DAKCConfig

    dev = fabsp.resolve_device(device)
    k, m = 13, 7
    reads = skew_reads(skew)
    oracle = serial.count_kmers_python(reads, k)
    orders = ("plain", "hashed") if order == "both" else (order,)
    records: Dict[str, object] = {}
    print(f"skew demo: corpus={skew} compact={compact} "
          f"({NUM_PES} PEs, k={k}, m={m}, {reads.shape[0]} reads x "
          f"{reads.shape[1]}bp, superkmer)")
    for o in orders:
        cfg = DAKCConfig(k=k, chunk_reads=64, transport_impl="superkmer",
                         minimizer_len=m, minimizer_order=o,
                         compact_impl=compact)
        res, stats = fabsp.count_kmers(reads, cfg, num_pes=NUM_PES,
                                       device=dev)
        if _merged_hist(res) != oracle:
            raise SystemExit(f"FAIL: order={o} histogram diverged from "
                             f"the serial oracle")
        print(f"  order={o:6s} load_max_over_mean="
              f"{stats.load_max_over_mean:.3f} "
              f"owner_fill_p99={stats.owner_fill_p99} "
              f"wire_bytes={stats.wire_bytes} "
              f"retries(route-slack)={stats.retry_route_slack}")
        # the peak-aware compact route caps fit skewed input in one round
        if compact == "prefix" and stats.retry_route_slack != 0:
            raise SystemExit(f"FAIL: order={o} compact route caps "
                             f"under-fit ({stats.retry_route_slack} "
                             f"route-slack round(s) burnt)")
        records[o] = stats
    print("skew demo OK")
    return records


def run_query(device=None) -> Dict[str, object]:
    """The live half of the query drill: a real mixed hit/miss batch
    against a 4-PE counter, then the same queries against a spill-engaged
    counter, which must answer identically through the spilled-bin tier.
    Returns {'live': QueryStats, 'spilled': QueryStats}."""
    from repro_torch.core import fabsp
    from repro_torch.core.fabsp import DAKCConfig

    dev = fabsp.resolve_device(device)
    reads = _small_reads(2048, 128, 52, heavy=0.3)
    kc = fabsp.KmerCounter(DAKCConfig(k=13, chunk_reads=32),
                           num_pes=NUM_PES, device=dev)
    kc.update(reads)
    hist = _merged_hist(kc.finalize()[0])
    rng = np.random.default_rng(0)
    uniq = np.asarray(sorted(hist), dtype=np.uint32)
    q = np.concatenate([uniq, rng.integers(0, 1 << 26, 64,
                                           dtype=np.uint32)])
    want = np.asarray([hist.get(int(x), 0) for x in q], np.int32)
    if not np.array_equal(kc.count(q), want):
        raise SystemExit("FAIL: live query batch diverged from finalize()")
    st = kc.last_query_stats
    records: Dict[str, object] = {"live": st}
    print(f"  live {NUM_PES}-PE batch: n={st.n_queries} hits={st.n_hits} "
          f"fill={st.batch_fill:.2f} probe_avg={st.probe_avg:.2f} "
          f"probe_max={st.probe_max} wire_bytes={st.wire_bytes}")

    # spilled-tier serve drill: the same queries against a spill-engaged
    # counter answer identically through the on-demand bin folds
    with tempfile.TemporaryDirectory() as d:
        sp = fabsp.KmerCounter(DAKCConfig(
            k=13, chunk_reads=32, spill="always", spill_dir=d,
            spill_bins=6), num_pes=NUM_PES, device=dev)
        sp.update(reads)
        if not np.array_equal(sp.count(q), want):
            raise SystemExit("FAIL: spilled-tier query batch diverged "
                             "from finalize()")
        st = sp.last_query_stats
        records["spilled"] = st
        print(f"  spilled-tier batch: n={st.n_queries} hits={st.n_hits} "
              f"bins_probed={st.bins_probed} bin_folds={st.bin_folds} "
              f"wire_bytes={st.wire_bytes}")
    print("query dry-run OK")
    return records


def main(argv=None) -> Optional[dict]:
    ap = argparse.ArgumentParser(
        description="the counter's dry-run (traced on meta, host only) and "
                    "its drills on small real workloads")
    # Synthetic 30 at 1/8 scale by default, so the receive buffers stay
    # modest; --full for all of it.
    ap.add_argument("--reads", type=int, default=SYNTHETIC30_READS // 8)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--k", type=int, default=31)
    ap.add_argument("--chunk-reads", type=int, default=2048)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--receiver", choices=["stream", "stacked", "both"],
                    default="both")
    ap.add_argument("--transport", choices=["kmer", "superkmer"],
                    default="kmer",
                    help="wire payload: packed k-mer words or "
                         "minimizer-keyed super-k-mers")
    ap.add_argument("--minimizer-len", type=int, default=15,
                    help="minimizer length m for --transport superkmer")
    ap.add_argument("--topology", choices=["1d", "2d"], default="1d",
                    help="'2d' traces the one-plan route over a "
                         "near-square (row, col) PE grid")
    ap.add_argument("--hop2", choices=["padded", "compact"],
                    default="padded",
                    help="hop-2 tile of the 2d route (DAKCConfig.hop2_impl)")
    ap.add_argument("--hop2-occupancy", type=float, default=None,
                    help="assumed valid-slot fraction for sizing the "
                         "compact hop-2 tile (the dry-run has no reads to "
                         "sample; without it compact is the padded tile)")
    ap.add_argument("--stream-batches", type=int, default=0,
                    help="also trace one incremental update round of "
                         "--reads reads into a store sized for N batches")
    ap.add_argument("--inject", action="store_true",
                    help="the fault-injection sweep")
    ap.add_argument("--spill", action="store_true",
                    help="the memory-pressure spill drill (clamped store "
                         "ceiling -> disk bins -> drain)")
    ap.add_argument("--spill-dir", default=None,
                    help="bin directory for --spill (default: a temp dir)")
    ap.add_argument("--skew", choices=["none", "polya", "powerlaw"],
                    default=None,
                    help="the skew drill on an adversarial corpus")
    ap.add_argument("--minimizer-order", choices=["plain", "hashed", "both"],
                    default="both",
                    help="minimizer order(s) of the --skew drill (the "
                         "dry-run takes 'plain' for 'both')")
    ap.add_argument("--compact", choices=["off", "prefix"], default="off",
                    help="pre-route slot compaction (the --skew drill, and "
                         "the dry-run, where the shape-only estimate makes "
                         "'prefix' a no-op)")
    ap.add_argument("--query", type=int, default=0, metavar="N",
                    help="trace an N-query batch on the production mesh, "
                         "then the live query drill (a mixed hit/miss "
                         "batch, in core and spilled)")
    ap.add_argument("--out", default="experiments/dryrun_kc_torch.json")
    ap.add_argument("--device", default=None,
                    help="torch device of the drills (default: the CUDA "
                         "card)")
    args = ap.parse_args(argv)
    from repro_torch.launch.dryrun import abstract_mesh

    n_reads = SYNTHETIC30_READS if args.full else args.reads
    if args.query > 0:
        print_query_lowering(lower_kc_query(
            args.query, n_reads, args.read_len, args.k,
            abstract_mesh(args.multi_pod), chunk_reads=args.chunk_reads))
        run_query(device=args.device)
        return None
    if args.inject:
        run_inject(device=args.device)
        return None
    if args.spill:
        run_spill(args.spill_dir, device=args.device)
        return None
    if args.skew is not None:
        run_skew(args.skew, args.minimizer_order, args.compact,
                 device=args.device)
        return None
    mesh = abstract_mesh(args.multi_pod)
    # whole chunks on every PE
    quantum = mesh.size * args.chunk_reads
    n_reads = (n_reads // quantum) * quantum
    if n_reads == 0:
        ap.error(f"--reads below one chunk on every PE ({quantum})")
    receivers = (["stream", "stacked"] if args.receiver == "both"
                 else [args.receiver])
    order = ("plain" if args.minimizer_order == "both"
             else args.minimizer_order)
    recs = {r: lower_kc(n_reads, args.read_len, args.k, mesh,
                        chunk_reads=args.chunk_reads, receiver=r,
                        transport=args.transport,
                        minimizer_len=args.minimizer_len,
                        topology=args.topology, hop2=args.hop2,
                        hop2_occupancy=args.hop2_occupancy,
                        minimizer_order=order, compact=args.compact)
            for r in receivers}
    rec = recs[receivers[0]]
    if len(recs) > 1:
        rec["stacked_receiver"] = recs["stacked"]
        rec["receive_memory_ratio_stacked_over_stream"] = (
            recs["stacked"]["memory"]["temp_gb"]
            / max(recs["stream"]["memory"]["temp_gb"], 1e-9))
    if args.stream_batches > 0:
        rec["incremental"] = lower_kc_incremental(
            n_reads, args.read_len, args.k, mesh,
            chunk_reads=args.chunk_reads, n_batches=args.stream_batches)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    r = rec["roofline"]
    print(json.dumps(rec, indent=1)[:1200])
    if "receive_memory_ratio_stacked_over_stream" in rec:
        print(f"\nstacked/stream temp memory: "
              f"{rec['receive_memory_ratio_stacked_over_stream']:.2f}x")
    if rec["topology"] == "2d":
        print(f"\n2d route: hop2_impl={rec['hop2_impl']} "
              f"hop2_caps={rec['hop2_caps']} (compact ships the smaller "
              f"power-of-two tile on hop 2; DAKCConfig.hop2_impl)")
    print(f"\ndominant: {r['dominant']}; bound throughput "
          f"{r['kmers_per_sec_per_chip_bound']:.3e} kmers/s/chip "
          f"({r['kmers_per_sec_per_chip_bound'] * mesh.size:.3e} global)")
    return rec


if __name__ == "__main__":
    main()
