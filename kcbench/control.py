"""The control: the reference with one guarantee broken, which the
comparison has to reject.

The configurations state exact counts of full 2k-bit k-mer words. The
tempting step below that is a store keyed by a 32-bit fingerprint of the
word (half the key bytes): k-mers whose fingerprints collide share one
slot, so one of them goes missing and the survivor's count takes both.
The fingerprint is the word modulo the largest prime under 2**32.

Run on the card at a cell's own size, on several seeds:

    python kcbench/control.py --workload count.synth26 --seeds 11 12 13

It prints, for each seed, the numbers of `reference.compare_histogram`
that the control gives; one at least has to be above its limit of 0.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Tuple

import torch

if __package__ in (None, ""):
    sys.path[0] = str(Path(__file__).resolve().parents[1])

from kcbench import gen, reference, spec  # noqa: E402

PRIME32 = 4294967291


def fingerprint(words: torch.Tensor) -> torch.Tensor:
    return torch.remainder(words, PRIME32)


def fingerprint_histogram(ref: reference.Histogram
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keys, counts) a fingerprint-keyed store would hold: one entry a
    fingerprint, keyed by its smallest k-mer, with the summed count."""
    fp = fingerprint(ref.keys)
    fps, inv = torch.unique(fp, return_inverse=True)
    counts = torch.zeros(fps.shape, dtype=torch.int64,
                         device=fp.device).index_add_(0, inv, ref.counts)
    big = torch.iinfo(torch.int64).max
    keys = torch.full(fps.shape, big, dtype=torch.int64, device=fp.device)
    keys.scatter_reduce_(0, inv, ref.keys, reduce="amin")
    return keys, counts


def control_numbers(cell: dict, seed: int, device) -> dict:
    """The control's numbers for one seed at the cell's own size: the
    first read set the cell's set-up makes, its exact histogram, and the
    fingerprint store's histogram judged against it."""
    cfg, traffic = cell["config"], cell["traffic"]
    k, canonical = cfg["dakc"]["k"], cfg["dakc"].get("canonical", False)
    g = gen.genome(cfg["genome_bases"], seed, device,
                   traffic.get("heavy_frac", 0.0),
                   traffic.get("heavy_motif", "AATGG"))
    reads = gen.reads(g, traffic["job_reads"], cfg["read_len"], seed, "set/0")
    del g
    ref = reference.Histogram(k, canonical, device)
    ref.add_reads(reads)
    keys, counts = fingerprint_histogram(ref)
    return reference.compare_histogram(keys, counts, ref.instances, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        nums = control_numbers(cell, seed, torch.device(args.device))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": nums,
                          "seconds": time.perf_counter() - t0}), flush=True)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
