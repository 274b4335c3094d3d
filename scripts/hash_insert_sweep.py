#!/usr/bin/env python3
"""Row 4 (`hash_insert`) against table size and hit share, for the port
under any source tree, and the counting path's launches per scan step.

The insert times with the helpers of chip_smoke.py's phase 6 (a census of
phase 4's live share per batch slot, a store pre-filled by the kernel,
fresh batches per call, torch.profiler's kernel records), applied to the
`repro_torch` under --src, so a parent commit's tree (unpacked with
`git archive`) and this one compare on one card:

    python3 scripts/hash_insert_sweep.py --src build/parent/src --profile
    python3 scripts/hash_insert_sweep.py --src src --profile

For every table size (GB of keys and counts over 8 rows; 18 is the
full-size path's 188,743,680 slots a row) and hit share (of live items
already stored), each pre-filled to the path's load (8,388,599 keys per
188,743,680 slots), it times on the device:
- `insert`: `ops.hash_insert` with home slots given (both trees);
- `insert_hashed`: with `slots=None`, hashed in the kernel (trees that
  have it);
- `lookup`: `ops.hash_lookup` of the same batches, a read-only walk: the
  random key reads without atomics or write-backs;
- `store_slots`: the home slots in PyTorch ops, as the old path ran them.
With --profile, phase 7's profile of `count_kmers` at 2**20 reads and its
launches per scan step. Prints one JSON line per measurement. Needs a
CUDA card.
"""

import argparse
import inspect
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
FILL_SHARE = 8_388_599 / 188_743_680   # distinct k-mers a row / slots a row
SIZES = {1: 10_485_760, 4: 41_943_040, 18: 188_743_680}   # GB -> slots


def fill_table(torch, cs, countstore, ops, rows, cap, n_fill, seed):
    """A (rows, cap) store holding `n_fill` random 62-bit keys a row,
    inserted by the kernel from the home slots of `countstore.store_slots`
    (the layout that slots hashed in the kernel give, on a tree whose
    insert cannot hash them too); returns (keys, counts, stored)."""
    g = torch.Generator(device=cs.DEV).manual_seed(seed)
    tk = torch.full((rows, cap), -1, dtype=torch.int64, device=cs.DEV)
    tc = torch.zeros((rows, cap), dtype=torch.int32, device=cs.DEV)
    dd = torch.zeros((rows,), dtype=torch.int32, device=cs.DEV)
    stored = torch.randint(0, 1 << 62, (rows, n_fill), generator=g,
                           device=cs.DEV)
    for lo in range(0, n_fill, 1 << 22):
        part = stored[:, lo:lo + (1 << 22)].contiguous()
        ops.hash_insert(tk, tc, part, torch.ones_like(part, dtype=torch.int32),
                        countstore.store_slots(part, cap, 64),
                        sentinel_val=-1, dropped=dd)
    if int(dd.sum()):
        raise AssertionError("a sweep table dropped keys on its fill")
    return tk, tc, stored


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True,
                    help="the directory that holds repro_torch")
    ap.add_argument("--sizes", default="1,4,18", help="table GB: 1, 4, 18")
    ap.add_argument("--hits", default="0,0.9333")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("hash_insert_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, os.path.dirname(HERE))
    import chip_smoke as cs
    from repro_torch.core import countstore, fabsp
    from repro_torch.data import genome
    from repro_torch.kernels import build, ops

    build.build_all()
    hashed = "word_bits" in inspect.signature(ops.hash_insert).parameters
    share, _ = cs.insert_census(torch, fabsp, genome, 1 << 20)
    rows, width, reps = cs.NUM_PES, share.numel(), 20
    n_batches = cs.insert_batch_count(reps)
    ones = torch.ones((rows, width), dtype=torch.int32, device=cs.DEV)
    dd = torch.zeros((rows,), dtype=torch.int32, device=cs.DEV)

    def emit(**rec):
        print(json.dumps({"src": args.src, **rec}), flush=True)

    for gb in (int(x) for x in args.sizes.split(",")):
        cap = SIZES[gb]
        for hit in (float(x) for x in args.hits.split(",")):
            tk, tc, stored = fill_table(torch, cs, countstore, ops, rows,
                                        cap, round(cap * FILL_SHARE), 12)
            variants = ["insert", "lookup"]
            if hashed:
                variants.insert(1, "insert_hashed")
            for seed, name in enumerate(variants + ["store_slots"], 13):
                # Fresh batches for each variant: an earlier variant's new
                # keys would be hits for the next.
                keys, live, new = cs.insert_batches(torch, n_batches, share,
                                                    hit, stored, seed)
                slots = torch.stack([countstore.store_slots(b, cap, 64)
                                     for b in keys])
                by_bytes, by_sectors = cs.insert_bounds(rows, width, live,
                                                        new)
                next_i = cs.fresh_batches(torch.arange(n_batches))

                def call():
                    i = int(next_i())
                    if name == "insert":
                        ops.hash_insert(tk, tc, keys[i], ones, slots[i],
                                        sentinel_val=-1, dropped=dd)
                    elif name == "insert_hashed":
                        ops.hash_insert(tk, tc, keys[i], ones, None,
                                        sentinel_val=-1, dropped=dd,
                                        word_bits=64)
                    elif name == "lookup":
                        ops.hash_lookup(tk, tc, keys[i], slots[i],
                                        sentinel_val=-1)
                    else:
                        countstore.store_slots(keys[i], cap, 64)

                ms = cs.time_ms(torch, call, reps)
                dev_ms = cs.device_ms(torch, call, reps,
                                      port=name != "store_slots")
                emit(variant=name, table_gb=gb, cap=cap, hit=hit,
                     live_items=live, new_items=new, ms=ms, device_ms=dev_ms,
                     bound_ms=by_bytes / cs.HBM_BYTES_PER_S * 1e3,
                     sector_bound_ms=by_sectors / cs.HBM_BYTES_PER_S * 1e3)
                del keys, slots
            del stored
            if int(dd.sum()):
                raise AssertionError("a sweep table dropped keys")
            del tk, tc
            torch.cuda.empty_cache()
    if args.profile:
        per_step = cs.profile_path(torch, fabsp, genome, 1 << 20)
        emit(variant="count_kmers_profile", launches_per_step=per_step)
    return 0


if __name__ == "__main__":
    sys.exit(main())
