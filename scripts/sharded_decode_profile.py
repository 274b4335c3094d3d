#!/usr/bin/env python3
"""Where a sharded decode step's time goes, beside the unsharded step, on
one card.

Both paths serve the same weights and prompt: the unsharded
`model.decode_step`, and `serve_step.rank_model(...).decode_step` on a
(1, 1) mesh of a one-rank NCCL group (its `file://` store under
build/sharded_decode_profile/, deleted afterwards), where every
collective is a copy. For each path, in turns (unsharded, sharded,
sharded, unsharded): a prefill, WARM decode steps, TIMED steps on the
host clock (synchronised after each), then PROFILED steps under
torch.profiler: device busy ms (the kernel records' time), device
launches a step, and the host ms a step inside the collectives (the CPU
records of c10d and NCCL calls). Prints one JSON line.

    python3 scripts/sharded_decode_profile.py            # qwen1.5-0.5b, bf16
    python3 scripts/sharded_decode_profile.py --arch mamba2-370m --dtype float32
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(ROOT, "src"))
WORK = os.path.join(ROOT, "build", "sharded_decode_profile")
WARM, TIMED, PROFILED = 2, 16, 4
COLLECTIVE_KEYS = ("c10d::", "nccl:", "all_gather", "all_reduce",
                   "allgather", "allreduce", "reduce_scatter", "alltoall")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=512)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("sharded_decode_profile: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core import dist
    from repro_torch.launch import train as train_lib
    from repro_torch.launch.mesh import mesh_group
    from repro_torch.models import model
    from repro_torch.models import sharding as shd
    from repro_torch.train import serve_step as ss

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(args.arch),
                              compute_dtype=args.dtype)
    params = model.init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt),
                           generator=gen, device=dev)
    steps = WARM + TIMED + PROFILED
    scfg = ss.ServeConfig(max_seq=args.prompt + 2 * steps,
                          cache_dtype=args.dtype)
    dtype = getattr(torch, args.dtype)
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    g = dist.init_group("nccl", "file://" + os.path.join(WORK, "store"),
                        0, 1)
    mg = mesh_group(train_lib.build_mesh(1, range(1)), g)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    out = {"arch": args.arch, "dtype": args.dtype, "batch": args.batch,
           "prompt": args.prompt, "card": smi, "runs": []}
    try:
        for path in ("unsharded", "sharded", "sharded", "unsharded"):
            with torch.no_grad():
                if path == "sharded":
                    rm = ss.rank_model(cfg, scfg, mg, args.batch)
                    mine = shd.shard_params(params, mg.mesh, mg.coord)
                    caches = rm.init_caches(dtype, dev)
                    lg, caches = rm.prefill(mine, {"tokens": prompt},
                                            caches)

                    def step(lg, caches, pos):
                        return rm.decode_step(mine, rm.greedy(lg), caches,
                                              pos)
                else:
                    rm = None
                    caches = model.init_caches(cfg, args.batch,
                                               scfg.max_seq, dtype,
                                               device=dev)
                    lg, caches = model.prefill(params, {"tokens": prompt},
                                               caches, cfg)

                    def step(lg, caches, pos):
                        nxt = lg[:, -1].argmax(-1, keepdim=True)
                        return model.decode_step(params, nxt, caches, pos,
                                                 cfg)
                pos = args.prompt
                for _ in range(WARM):
                    lg, caches = step(lg, caches, pos)
                    pos += 1
                torch.cuda.synchronize()
                ms = []
                for _ in range(TIMED):
                    t0 = time.perf_counter()
                    lg, caches = step(lg, caches, pos)
                    torch.cuda.synchronize()
                    ms.append(1e3 * (time.perf_counter() - t0))
                    pos += 1
                calls0 = 0 if rm is None else rm.collectives["calls"]
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    for _ in range(PROFILED):
                        lg, caches = step(lg, caches, pos)
                        pos += 1
                    torch.cuda.synchronize()
                    wall = 1e3 * (time.perf_counter() - t0)
            cuda = torch.autograd.DeviceType.CUDA
            kern = [e for e in prof.key_averages()
                    if e.device_type == cuda and e.self_device_time_total > 0]
            coll = [e for e in prof.key_averages()
                    if e.device_type != cuda
                    and any(k in e.key.lower() for k in COLLECTIVE_KEYS)]
            # the outermost collective records: c10d's ops hold NCCL's
            host_coll = sum(e.cpu_time_total for e in coll
                            if e.key.startswith("c10d::"))
            run = {"path": path, "ms": sorted(ms)[len(ms) // 2],
                   "ms_all": ms, "profiled_wall_ms": wall / PROFILED,
                   "device_busy_ms": sum(e.self_device_time_total
                                         for e in kern) / 1e3 / PROFILED,
                   "device_launches": sum(e.count for e in kern) / PROFILED,
                   "host_collective_ms": host_coll / 1e3 / PROFILED,
                   "collective_calls": (0 if rm is None else
                                        (rm.collectives["calls"] - calls0)
                                        / PROFILED),
                   "top_kernels": [
                       (e.key[:60], e.count // PROFILED,
                        round(e.self_device_time_total / 1e3 / PROFILED, 4))
                       for e in sorted(kern, key=lambda e:
                                       -e.self_device_time_total)[:8]]}
            out["runs"].append(run)
            print(f"{path}: median {run['ms']:.3f} ms a step (host clock); "
                  f"under the profiler {run['profiled_wall_ms']:.3f} ms, "
                  f"device busy {run['device_busy_ms']:.3f} ms, "
                  f"{run['device_launches']:.0f} launches, "
                  f"{run['collective_calls']:.0f} collective calls, host in "
                  f"them {run['host_collective_ms']:.3f} ms ({smi})",
                  flush=True)
            del caches, lg
            torch.cuda.empty_cache()
    finally:
        mg.destroy()
        g.destroy()
        shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
