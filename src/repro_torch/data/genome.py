"""Synthetic genome and read sets (counterpart of `repro.data.genome`).

The paper's setup (Sec. VI, Table V): a genome drawn uniformly from
{A, C, G, T} ("Synthetic XY" = 2**XY bases) and fixed-length reads at
random offsets. `synthesize_genome` and `sample_reads` are the JAX
package's numpy functions, copied; `sample_reads_torch` builds the same
reads on a device in blocks, for read sets too large for one index array.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.encoding import BASE_TO_CODE


@dataclasses.dataclass(frozen=True)
class ReadSetSpec:
    genome_bases: int          # genome length (paper: 2^XY)
    n_reads: int
    read_len: int = 150        # paper Table V: 150bp reads
    error_rate: float = 0.0    # per-base substitution probability
    heavy_hitter_frac: float = 0.0   # fraction of genome covered by repeats
    heavy_motif: str = "AATGG"       # the paper's human-genome repeat
    seed: int = 0


def synthesize_genome(spec: ReadSetSpec) -> np.ndarray:
    """Uniform random 2-bit genome, optionally with planted repeat runs."""
    rng = np.random.default_rng(spec.seed)
    genome = rng.integers(0, 4, size=spec.genome_bases, dtype=np.uint8)
    if spec.heavy_hitter_frac > 0:
        motif = np.array([BASE_TO_CODE[b] for b in spec.heavy_motif],
                         dtype=np.uint8)
        run_len = max(len(motif) * 40, 200)
        n_runs = int(spec.genome_bases * spec.heavy_hitter_frac / run_len)
        reps = int(np.ceil(run_len / len(motif)))
        run = np.tile(motif, reps)[:run_len]
        for start in rng.integers(0, spec.genome_bases - run_len,
                                  size=max(n_runs, 1)):
            genome[start:start + run_len] = run
    return genome


def sample_reads(spec: ReadSetSpec,
                 genome: Optional[np.ndarray] = None) -> np.ndarray:
    """(n_reads, read_len) uint8 2-bit codes, random offsets, optional errors."""
    rng = np.random.default_rng(spec.seed + 1)
    if genome is None:
        genome = synthesize_genome(spec)
    if spec.genome_bases < spec.read_len:
        raise ValueError("genome shorter than read length")
    starts = rng.integers(0, spec.genome_bases - spec.read_len + 1,
                          size=spec.n_reads)
    idx = starts[:, None] + np.arange(spec.read_len)[None, :]
    reads = genome[idx]
    if spec.error_rate > 0:
        flips = rng.random(reads.shape) < spec.error_rate
        reads = np.where(flips, (reads + rng.integers(1, 4, reads.shape)) % 4,
                         reads).astype(np.uint8)
    return reads


def sample_reads_torch(spec: ReadSetSpec, device,
                       block_reads: int = 1 << 20) -> torch.Tensor:
    """The reads of `sample_reads(spec)`, gathered on `device` from the
    genome in blocks of `block_reads`, so no (n_reads, read_len) index
    array is ever built. Error-free specs only."""
    if spec.error_rate > 0:
        raise ValueError("sample_reads_torch takes error-free specs")
    if spec.genome_bases < spec.read_len:
        raise ValueError("genome shorter than read length")
    genome = torch.from_numpy(synthesize_genome(spec)).to(device)
    rng = np.random.default_rng(spec.seed + 1)
    starts = torch.from_numpy(rng.integers(
        0, spec.genome_bases - spec.read_len + 1, size=spec.n_reads)).to(device)
    offs = torch.arange(spec.read_len, device=device)
    reads = torch.empty((spec.n_reads, spec.read_len), dtype=torch.uint8,
                        device=device)
    for lo in range(0, spec.n_reads, block_reads):
        hi = min(lo + block_reads, spec.n_reads)
        reads[lo:hi] = genome[starts[lo:hi, None] + offs[None, :]]
    return reads
