#!/usr/bin/env python3
"""What a one-rank NCCL process group costs `count_kmers` at phase 4's
workload (Synthetic 26, 2**23 reads of 150 bp, k=31, chunk_reads 256, 8
PEs) on one card, against the stacked path, in one process:

    python3 scripts/group_overhead.py              # 2 rounds, full size
    python3 scripts/group_overhead.py --reads 1048576 --rounds 1

Each round runs the stacked path and the group path in turns (stacked,
group, group, stacked), each a synchronised call on the host clock, and
holds every group result to the stacked one (unique, counts, num_unique,
every stats field). In each group run it sums the host time spent inside
`dist.exchange` (the all_to_all_single of every lane, enqueue only, no
synchronise) and inside `fabsp._host_stats` (a round's all_reduce and
its read to the host), and counts the exchange calls. Prints the card's
name and power limit, one JSON line per run and a summary line. Needs a
CUDA card; writes its rendezvous file under build/group_overhead/ and
deletes it.
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
STORE_DIR = os.path.join(ROOT, "build", "group_overhead")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reads", type=int, default=1 << 23)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("group_overhead: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core import dist, fabsp
    from repro_torch.data import genome

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    spec = genome.ReadSetSpec(genome_bases=1 << 26, n_reads=args.reads,
                              read_len=150, seed=0)
    reads = genome.sample_reads_torch(spec, "cuda")
    cfg = fabsp.DAKCConfig(k=31, chunk_reads=256)
    shutil.rmtree(STORE_DIR, ignore_errors=True)
    os.makedirs(STORE_DIR)
    g = dist.init_group("nccl", "file://" + os.path.join(STORE_DIR, "store"),
                        0, 1)

    spent = {"exchange_s": 0.0, "exchange_calls": 0, "host_stats_s": 0.0}
    exchange, host_stats = dist.exchange, fabsp._host_stats

    def timed_exchange(*a, **kw):
        t0 = time.perf_counter()
        out = exchange(*a, **kw)
        spent["exchange_s"] += time.perf_counter() - t0
        spent["exchange_calls"] += 1
        return out

    def timed_host_stats(*a, **kw):
        t0 = time.perf_counter()
        out = host_stats(*a, **kw)
        spent["host_stats_s"] += time.perf_counter() - t0
        return out

    dist.exchange, fabsp._host_stats = timed_exchange, timed_host_stats
    walls = {"stacked": [], "group": []}
    want = None
    try:
        for r in range(args.rounds):
            for path in ("stacked", "group", "group", "stacked"):
                for k in spent:
                    spent[k] = type(spent[k])()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res, st = fabsp.count_kmers(
                    reads, cfg, num_pes=8,
                    group=g if path == "group" else None)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                got = (res.unique, res.counts, res.num_unique, tuple(st))
                if want is None:
                    want = got
                if not (all(torch.equal(a, b) for a, b in
                            zip(got[:3], want[:3]))
                        and [float(x) for x in got[3]]
                        == [float(x) for x in want[3]]):
                    raise AssertionError(f"round {r}: the {path} path's "
                                         f"result differs")
                del res, got
                walls[path].append(wall)
                print(json.dumps({"round": r, "path": path, "wall_s": wall,
                                  **dict(spent)}), flush=True)
    finally:
        dist.exchange, fabsp._host_stats = exchange, host_stats
        g.destroy()
        shutil.rmtree(STORE_DIR, ignore_errors=True)
    med = {p: statistics.median(w) for p, w in walls.items()}
    print(json.dumps({"walls_s": walls, "median_s": med,
                      "group_over_stacked": med["group"] / med["stacked"],
                      "results_equal": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
