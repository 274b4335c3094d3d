#!/usr/bin/env python3
"""Rows 1, 2, 3, 5, 6 and 9 (`bucket_hist` / `bucket_prefix`,
`bucket_positions`, `segment_accumulate`, `hash_lookup`, `sliding_min`,
`kmer_extract`) and the call sites of rows 1-3 and 5
(`make_partition_plan`, `sort.accumulate(impl='fused')`,
`countstore.store_lookup`, `query.query_counts`) timed as phase 6 of
chip_smoke.py times them, for the port under any source tree.

Phase 6's two measurements (`chip_smoke.time_ms`: CUDA events around
back-to-back calls; `chip_smoke.device_ms`: torch.profiler's kernel records)
applied to the `repro_torch` found under --src, so two versions of a kernel
(a parent commit's, unpacked with `git archive`, and this one) compare in
one process run after another on one card:

    python3 scripts/kernel_device_times.py --src build/parent/src
    python3 scripts/kernel_device_times.py --src src

Shapes: the histogram at one radix pass of one step, ids (8, 30720) int32
with B=257 (plain counts, and, in trees that have it, the histogram with
the plan's prefix at B=2, 9 and 257); the partition rank at the same ids;
the run sweep at (8, 30720) sorted int64 words, flags mode; the plan at
(8, 30720), B=257, and at (8, 61440), B=9; the L3 compressor's
accumulate at (8, 30720) with weights=None (the call sites: ms, device
ms of every record and device launches a call); the sliding minimum at one scan step's m-mers, (2048, 144)
int64 with w=25, and at the query path's windows, (2**20, 25) with w=25;
the extraction at phase 10's shape, the Synthetic-26 read set's 2**23
reads of 150 bp to canonical k=31 words in one launch, beside the time to
zero its output in PyTorch (`Tensor.zero_`, the same 8 GB written: a
floor for the writes alone, not the same function). Row 5 and the
`lookup` call sites run against a store at the query path's state, (8,
23592960) slots a row holding 8,388,608 random 62-bit keys (phase 8's
distinct k-mers a PE), inserted by the kernel, at phase 6's query batch
(`chip_smoke.lookup_queries`, scattered and tiled): the kernel as the
tree's `countstore.store_lookup` calls it (home slots hashed in the
kernel, or given from `store_slots` in a tree whose lookup cannot hash
them), the kernel given `store_slots`, and `store_slots` itself; then
`store_lookup` and a 2**20-query `query_counts` as whole calls.
`--rows 5,lookup` picks rows (1, 2, 3, 5, 6, 9, plan, acc, lookup).
With --profile, phase 7's profile of `count_kmers` at 2**20 reads and
its launches per scan step. Prints one JSON line per row. Needs a CUDA
card.
"""

import argparse
import inspect
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True,
                    help="the directory that holds repro_torch")
    ap.add_argument("--rows", default="1,2,3,5,6,9,plan,acc,lookup",
                    help="of 1, 2, 3, 5, 6, 9, plan, acc and lookup")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    wanted = set(args.rows.split(","))
    import torch
    if not torch.cuda.is_available():
        print("kernel_device_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, os.path.dirname(HERE))
    import chip_smoke as cs
    from repro_torch.core import encoding, fabsp, sort
    from repro_torch.data import genome
    from repro_torch.kernels import build, ops

    build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    ids = torch.randint(0, 257, (cs.NUM_PES, 30720), generator=gen,
                        dtype=torch.int32).to(dev)
    hist = ops.bucket_hist(ids, 257)
    base = (torch.cumsum(hist, 1) - hist).to(torch.int32)
    keys, w = cs._sorted_runs(torch,
                              torch.Generator(device=dev).manual_seed(1),
                              cs.NUM_PES, 30720, 15000, -1, 64, dev)
    for name, shape, fn in call_sites(torch, cs, ops, sort, wanted, dev,
                                      gen):
        ms, dev_ms, n_launch = cs.whole_call(torch, fn)
        print(json.dumps({"src": args.src, "name": name, "shape": shape,
                          "ms": ms, "device_ms": dev_ms,
                          "device_launches": n_launch}), flush=True)
    spec = genome.ReadSetSpec(genome_bases=1 << 26, n_reads=cs.NUM_PES * 256,
                              read_len=150, seed=4)
    mmers = encoding.pack_kmers(genome.sample_reads_torch(spec, dev), 7)
    queries = torch.randint(0, 1 << 62, (1 << 20, 25), generator=gen).to(dev)
    rows = (
        ("bucket_hist", "ids (8, 30720) int32, B=257",
         lambda: ops.bucket_hist(ids, 257), None),
        ("bucket_positions", "ids (8, 30720) int32, B=257",
         lambda: ops.bucket_positions(ids, base),
         lambda: torch.argsort(ids, dim=1, stable=True)),
        ("sliding_min", "m-mers (2048, 144) int64, w=25",
         lambda: ops.sliding_min(mmers, 25),
         lambda: mmers.unfold(1, 25, 1).amin(2)),
        ("sliding_min", "queries (1048576, 25) int64, w=25",
         lambda: ops.sliding_min(queries, 25),
         lambda: queries.amin(1, keepdim=True)),
    )
    rows = [row for r, row in zip("1266", rows) if r in wanted]
    if "1" in wanted and hasattr(ops, "bucket_prefix"):
        for nb in (2, 9, 257):
            ids_b = torch.randint(0, nb, (cs.NUM_PES, 30720), generator=gen,
                                  dtype=torch.int32).to(dev)
            rows.append(("bucket_prefix", f"ids (8, 30720) int32, B={nb}",
                         lambda ids_b=ids_b, nb=nb: ops.bucket_prefix(ids_b,
                                                                      nb),
                         None))
    if "3" in wanted:
        rows.append(("segment_accumulate", "keys (8, 30720) int64, flags",
                     lambda: ops.segment_accumulate(keys, w, sentinel_val=-1),
                     None))
    if "9" in wanted:
        reads = genome.sample_reads_torch(genome.ReadSetSpec(
            genome_bases=1 << 26, n_reads=1 << 23, read_len=150, seed=0), dev)
        out = torch.empty((reads.shape[0], reads.shape[1] - cs.K + 1),
                          dtype=torch.int64, device=dev)
        rows.append(("kmer_extract", "codes (8388608, 150) uint8 -> "
                     "(8388608, 120) int64, k=31, canonical",
                     lambda: ops.kmer_extract(reads, cs.K, canonical=True),
                     out.zero_))
    for name, shape, fn, library in rows:
        reps = 5 if name == "kmer_extract" else 20
        ms, dev_ms = cs.call_times(torch, fn, reps)
        rec = {"src": args.src, "name": name, "shape": shape, "ms": ms,
               "device_ms": dev_ms}
        if library is not None:
            lib_ms, lib_dev_ms = cs.library_times(torch, library, reps)
            beside = ("zero_of_output" if name == "kmer_extract"
                      else "library")
            rec.update({f"{beside}_ms": lib_ms,
                        f"{beside}_device_ms": lib_dev_ms})
        print(json.dumps(rec), flush=True)
    if wanted & {"5", "lookup"}:
        for rec in lookup_rows(torch, cs, wanted, dev):
            print(json.dumps({"src": args.src, **rec}), flush=True)
    if args.profile:
        per_step = cs.profile_path(torch, fabsp, genome, 1 << 20)
        print(json.dumps({"src": args.src, "name": "count_kmers_profile",
                          "launches_per_step": per_step}), flush=True)
    return 0


def call_sites(torch, cs, ops, sort, wanted, dev, gen):
    """(name, shape, call) of the plan and the L3 accumulate."""
    out = []
    if "plan" in wanted:
        for n, nb in ((30720, 257), (61440, 9)):
            ids = torch.randint(0, nb, (8, n), generator=gen,
                                dtype=torch.int32).to(dev)
            out.append(("make_partition_plan", f"ids (8, {n}) int32, B={nb}",
                        lambda ids=ids, nb=nb: ops.make_partition_plan(ids,
                                                                       nb)))
    if "acc" in wanted:
        keys, _ = cs._sorted_runs(
            torch, torch.Generator(device=dev).manual_seed(3), 8, 30720,
            15000, -1, 64, dev)
        out.append(("accumulate_fused", "keys (8, 30720) int64, weights=None",
                    lambda: sort.accumulate(keys, sentinel_val=-1,
                                            impl="fused")))
    return out


LOOKUP_CAP = 23_592_960        # one PE's store slots on phase 8's path
LOOKUP_FILL = 8_388_608        # its distinct k-mers, about


def lookup_rows(torch, cs, wanted, dev):
    """Row 5 and its call sites against a store at the query path's state;
    yields one record per measurement."""
    from repro_torch.core import countstore, fabsp, query
    from repro_torch.kernels import ops, ref

    st = countstore.empty_store(cs.NUM_PES, LOOKUP_CAP, 64, dev)
    g = torch.Generator(device=dev).manual_seed(21)
    for lo in range(0, LOOKUP_FILL, 1 << 21):
        countstore.store_insert(st, torch.randint(
            0, 1 << 62, (cs.NUM_PES, min(1 << 21, LOOKUP_FILL - lo)),
            generator=g, device=dev))
    if int(st.dropped.sum()):
        raise AssertionError("the lookup store dropped keys on its fill")
    snap = countstore.StoreSnapshot(gen=0, keys=st.keys, counts=st.counts,
                                    store_cap=LOOKUP_CAP, word_bits=64)
    q, tiled = cs.lookup_queries(torch, snap.keys, -1, 6)
    slots = countstore.store_slots(q, LOOKUP_CAP, 64)
    hashed = "word_bits" in inspect.signature(ops.hash_lookup).parameters
    stats = torch.zeros((cs.NUM_PES, 3), dtype=torch.int64, device=dev)

    def path_kernel(batch):
        if hashed:
            return lambda: ops.hash_lookup(snap.keys, snap.counts, batch,
                                           None, sentinel_val=-1,
                                           word_bits=64, stats=stats)
        s = countstore.store_slots(batch, LOOKUP_CAP, 64)
        return lambda: ops.hash_lookup(snap.keys, snap.counts, batch, s,
                                       sentinel_val=-1)

    if "5" in wanted:
        counts, probes = ops.hash_lookup(snap.keys, snap.counts, q, slots,
                                         sentinel_val=-1)
        by_bytes, by_sectors, old_bytes = cs.lookup_bounds(
            torch, ref, q, counts, probes, LOOKUP_CAP, 64, -1)
        live = int((q != -1).sum())
        yield {"name": "hash_lookup_batch", "live": live,
               "hits": int((counts > 0).sum()),
               "mean_walk": int(probes.sum()) / live,
               "bound_ms": by_bytes / cs.HBM_BYTES_PER_S * 1e3,
               "sector_bound_ms": by_sectors / cs.HBM_BYTES_PER_S * 1e3,
               "old_bound_ms": old_bytes / cs.HBM_BYTES_PER_S * 1e3}
        del counts, probes
        timed = [("hash_lookup", f"{layout}, as store_lookup calls it",
                  path_kernel(batch), True)
                 for layout, batch in (("scattered", q), ("tiled", tiled))]
        timed.append(("hash_lookup", "scattered, slots given",
                      lambda: ops.hash_lookup(snap.keys, snap.counts, q,
                                              slots, sentinel_val=-1), True))
        timed.append(("store_slots", "scattered", lambda: countstore.
                      store_slots(q, LOOKUP_CAP, 64), False))
        for name, shape, fn, port in timed:
            ms = cs.time_ms(torch, fn)
            dev_ms = cs.device_ms(torch, fn, port=port)
            yield {"name": name, "shape": shape, "ms": ms,
                   "device_ms": dev_ms}
    if "lookup" in wanted:
        cfg = fabsp.DAKCConfig(k=cs.K, transport_impl="superkmer",
                               minimizer_order="hashed",
                               compact_impl="prefix")
        words = q[q != -1][:1 << 20].contiguous()
        for name, fn in (
                ("store_lookup", lambda: countstore.store_lookup(snap, q)),
                ("query_counts", lambda: query.query_counts(
                    words, cfg, snap, num_pes=cs.NUM_PES))):
            ms, dev_ms, n_launch = cs.whole_call(torch, fn)
            yield {"name": name, "shape": "store (8, 23592960), queries "
                   "(8, 1048576) scattered" if name == "store_lookup"
                   else "2**20 queries, k=31 hashed super-k-mers",
                   "ms": ms, "device_ms": dev_ms, "device_launches": n_launch}


if __name__ == "__main__":
    sys.exit(main())
