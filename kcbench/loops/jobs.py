"""The `jobs` loop: whole `fabsp.count_kmers` jobs back to back, on one card.

The mix's parameters: `job_reads` reads a job, over `read_sets` read sets
made in set-up and taken in turn, of a genome with `heavy_frac` of its
bases in planted runs of `heavy_motif`. The read sets are made on the
card from the seed and kept in pinned host memory; each job hands its
set to `count_kmers`, which moves it to the card as a user's job does,
so the card holds one read set at a time. The genome is freed once the
sets are made. Set-up runs one whole job, so every shape and allocation
of the window is warm.

Judged: the histograms of two jobs, one drawn from the seed among the
first `read_sets` and the window's last, each copied to the host when it
is taken: every PE's live (k-mer, count) pairs against the reference's
count of that job's reads.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from kcbench import gen, reference, tracing, window


def run(cell: dict, seed: int, seconds: float, trace: bool, t_start: float,
        device=None) -> window.Run:
    """One run of the cell: set-up, window, judge. `device` None is the
    first card; the CPU tests pass "cpu"."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    return window.drive(Jobs(cell, seed, dev), cell, seconds, trace, dev,
                        t_start)


def _live(res, num_pes: int):
    """Every PE's live (k-mers, counts) of a flat per-PE AccumResult, on
    the host."""
    width = res.unique.numel() // num_pes
    live = (torch.arange(width, device=res.unique.device)[None, :]
            < res.num_unique[:, None].to(torch.int64))
    return (window.to_host(res.unique.view(num_pes, width)[live]),
            window.to_host(res.counts.view(num_pes, width)[live]))


class Jobs:
    def __init__(self, cell: dict, seed: int, dev: torch.device):
        from repro_torch.core import fabsp
        self.fabsp = fabsp
        cfg, mix = cell["config"], cell["traffic"]
        self.dev, self.p = dev, cfg["num_pes"]
        self.cfg = fabsp.DAKCConfig(**cfg["dakc"])
        genome = gen.genome(cfg["genome_bases"], seed, dev,
                            mix.get("heavy_frac", 0.0),
                            mix.get("heavy_motif", "AATGG"))
        self.sets = [window.to_host(gen.reads(genome, mix["job_reads"],
                                              cfg["read_len"], seed,
                                              f"set/{s}"))
                     for s in range(mix["read_sets"])]
        del genome
        self.steps = mix["job_reads"] // (self.p * self.cfg.chunk_reads)
        self.draw = int(np.random.default_rng(gen.stream_seed(
            seed, "judged")).integers(len(self.sets)))
        self.kept: Dict[int, tuple] = {}
        self.last = None
        self.run_unit(-1, None)     # the warm-up job, read set 0

    def run_unit(self, i: int, run: Optional[window.Run]) -> None:
        self.last = None            # the last job's result goes first
        reads = self.sets[max(i, 0) % len(self.sets)]
        with tracing.span("job"):
            t0 = time.perf_counter()
            res, st = self.fabsp.count_kmers(reads, self.cfg,
                                             num_pes=self.p, device=self.dev)
            window.sync(self.dev)
            dt = time.perf_counter() - t0
        if run is not None:
            run.units.append(window.unit_from_stats(dt, st, self.steps))
            if i == self.draw:
                self.kept[i] = _live(res, self.p) + (st.raw_kmers,)
            self.last = (i, res, st)

    def close_window(self, run: window.Run) -> None:
        """The window's last job: keep it for the judge, and its store."""
        i, res, st = self.last
        run.store = (res.unique.numel(), 12, int(res.num_unique.sum()))
        if i not in self.kept:
            self.kept[i] = _live(res, self.p) + (st.raw_kmers,)
        self.last = None

    def judge(self, run: window.Run) -> None:
        self.last = None
        window.free(self.dev)
        k, canonical = self.cfg.k, self.cfg.canonical
        for i in sorted(self.kept):
            keys, counts, raw = self.kept.pop(i)
            ref = reference.Histogram(k, canonical, self.dev)
            ref.add_reads(self.sets[i % len(self.sets)])
            nums = reference.compare_histogram(keys.to(self.dev),
                                               counts.to(self.dev), raw, ref)
            run.failed += int(any(nums.values()))
            window.worst(run.checks, nums)
            del keys, counts, ref
            window.free(self.dev)
