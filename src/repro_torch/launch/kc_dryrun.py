"""The counter's drills on small real workloads (counterpart of the drills
of `repro.launch.kc_dryrun`).

Each drill counts a small read set on 4 PEs held on one device, checks the
result exactly, prints the JAX drill's lines and raises `SystemExit` on
the same failures; each also returns its records (the `DAKCStats` or
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

The JAX module's default run lowers the counter to XLA on a production
mesh and reads its memory, cost and collectives; that half, and the
lowering behind `--query`, are not ported (ROADMAP item 12), and asking
for them is refused.

    PYTHONPATH=src python -m repro_torch.launch.kc_dryrun --inject
    PYTHONPATH=src python -m repro_torch.launch.kc_dryrun --spill
    PYTHONPATH=src python -m repro_torch.launch.kc_dryrun --skew polya \\
        --minimizer-order both --compact prefix
    PYTHONPATH=src python -m repro_torch.launch.kc_dryrun --query 1024
        # each on the card; add --device cpu to run on the CPU
"""

from __future__ import annotations

import argparse
import tempfile
from typing import Dict

import numpy as np

NUM_PES = 4
LOWERING = ("the lowering dry-run (the counter lowered to XLA on a "
            "production mesh: memory, cost, collectives) is not ported to "
            "PyTorch; see ROADMAP item 12")
# The JAX CLI's flags of the lowering dry-run, refused with LOWERING.
_LOWERING_FLAGS = ("--reads", "--full", "--read-len", "--k", "--chunk-reads",
                   "--multi-pod", "--receiver", "--transport",
                   "--minimizer-len", "--topology", "--hop2",
                   "--hop2-occupancy", "--stream-batches", "--out")


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
    print(f"query executable lowering: not run ({LOWERING})")
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="the counter's drills on small real workloads")
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
                    help="minimizer order(s) of the --skew drill")
    ap.add_argument("--compact", choices=["off", "prefix"], default="off",
                    help="pre-route slot compaction in the --skew drill")
    ap.add_argument("--query", type=int, default=0, metavar="N",
                    help="the live query drill (a mixed hit/miss batch, in "
                         "core and spilled); N sized the JAX lowering, "
                         "which is not ported")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args, rest = ap.parse_known_args(argv)
    lowering = [a for a in rest if a.split("=")[0] in _LOWERING_FLAGS]
    if lowering:
        ap.error(f"{' '.join(lowering)}: {LOWERING}")
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    if args.query > 0:
        run_query(device=args.device)
    elif args.inject:
        run_inject(device=args.device)
    elif args.spill:
        run_spill(args.spill_dir, device=args.device)
    elif args.skew is not None:
        run_skew(args.skew, args.minimizer_order, args.compact,
                 device=args.device)
    else:
        ap.error(f"give a drill (--inject, --spill, --skew or --query N): "
                 f"{LOWERING}")


if __name__ == "__main__":
    main()
