"""Synthetic genome and read sets (counterpart of `repro.data.genome`).

The paper's setup (Sec. VI, Table V): a genome drawn uniformly from
{A, C, G, T} ("Synthetic XY" = 2**XY bases) and fixed-length reads at
random offsets. `synthesize_genome` and `sample_reads` are the JAX
package's numpy functions, copied; `sample_reads_torch` builds the same
reads on a device in blocks, for read sets too large for one index array.

Also copied, numpy on the host, so the same seeds give the same reads:
`pad_reads_for_mesh`; the adversarial-skew generators of the minimizer-
order and load-balance drills (`poly_a_reads`, planting the low-complexity
runs of the paper's human genome, Sec. IV-D, and
`power_law_minimizer_reads`); and the FASTA/Q codecs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.encoding import BASE_TO_CODE, CODE_TO_BASE


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


def pad_reads_for_mesh(reads: np.ndarray, num_pes: int, chunk_reads: int,
                       k: int) -> Tuple[np.ndarray, int]:
    """Pad the read set so every PE gets an equal, chunk-divisible share.

    Padding reads are poly-A; the returned pad count lets callers subtract
    the (pad * (m - k + 1)) spurious poly-A k-mer contributions. Returns
    (padded_reads, n_pad).
    """
    n, m = reads.shape
    quantum = num_pes * chunk_reads
    n_pad = (-n) % quantum
    if n_pad == 0:
        return reads, 0
    pad = np.zeros((n_pad, m), dtype=reads.dtype)
    return np.concatenate([reads, pad], axis=0), n_pad


# ---------------------------------------------------------------------------
# Adversarial-skew generators (the minimizer-order / load-balance drills:
# launch/kc_dryrun.py --skew)
# ---------------------------------------------------------------------------


def poly_a_reads(n_reads: int, read_len: int, *, run_frac: float = 0.6,
                 seed: int = 0) -> np.ndarray:
    """Low-complexity adversary: random background with a planted poly-A
    run covering `run_frac` of every read (random offset).

    The lexicographic ('plain') minimizer order is pathological here:
    AAAA... packs to m-mer word 0, so it wins every window it appears in
    and the run's k-mer traffic routes to the one PE owning minimizer 0.
    The hashed order spreads the same k-mers across owners. Not pure
    poly-A: with one distinct m-mer in a window both orders must pick it.
    """
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 4, size=(n_reads, read_len), dtype=np.uint8)
    run_len = max(1, min(read_len, int(read_len * run_frac)))
    starts = rng.integers(0, read_len - run_len + 1, size=n_reads)
    idx = starts[:, None] + np.arange(run_len)[None, :]
    reads[np.arange(n_reads)[:, None], idx] = BASE_TO_CODE["A"]
    return reads


def power_law_minimizer_reads(n_reads: int, read_len: int, m: int, *,
                              alpha: float = 1.5, pool: int = 64,
                              seed: int = 0) -> np.ndarray:
    """Zipf-skew adversary: plant m-mer motifs from the `pool`
    lexicographically smallest m-mers (words 0..pool-1) into random
    background, motif i drawn with probability ~ (i+1)^-alpha.

    Small m-mer words win plain-order windows, so the per-owner minimizer
    load inherits the Zipf tail; under the hashed order the planted motifs
    hold no special rank. Roughly one motif site per 2m bases per read.
    """
    if not 1 <= m <= 15:
        raise ValueError(f"m={m} outside the sane motif range [1, 15]")
    if read_len < m:
        raise ValueError(f"read_len {read_len} shorter than m {m}")
    rng = np.random.default_rng(seed)
    reads = rng.integers(0, 4, size=(n_reads, read_len), dtype=np.uint8)
    pool = min(pool, 4 ** m)
    probs = np.arange(1, pool + 1, dtype=np.float64) ** -alpha
    probs /= probs.sum()
    shifts = 2 * np.arange(m - 1, -1, -1)
    motifs = ((np.arange(pool)[:, None] >> shifts[None, :]) & 3) \
        .astype(np.uint8)
    n_sites = max(1, read_len // (2 * m))
    sites = rng.integers(0, read_len - m + 1, size=(n_reads, n_sites))
    choices = rng.choice(pool, size=(n_reads, n_sites), p=probs)
    idx = sites[:, :, None] + np.arange(m)[None, None, :]
    rows = np.broadcast_to(np.arange(n_reads)[:, None, None], idx.shape)
    reads[rows, idx] = motifs[choices]
    return reads


# ---------------------------------------------------------------------------
# FASTA/Q codecs (host-side; the paper excludes I/O from timing)
# ---------------------------------------------------------------------------


def reads_to_fastq(reads: np.ndarray, path: str) -> None:
    with open(path, "w") as f:
        for i, row in enumerate(reads):
            seq = "".join(CODE_TO_BASE[int(c)] for c in row)
            f.write(f"@synthetic.{i}\n{seq}\n+\n{'I' * len(seq)}\n")


def fastq_to_reads(path: str) -> np.ndarray:
    rows = []
    with open(path) as f:
        lines = f.read().splitlines()
    for i in range(1, len(lines), 4):
        rows.append([BASE_TO_CODE[c] for c in lines[i].strip().upper()])
    return np.asarray(rows, dtype=np.uint8)


def fasta_to_reads(path: str, read_len: int) -> np.ndarray:
    """Chop FASTA contigs into fixed-length windows (for real datasets);
    windows holding a non-ACGT base are skipped."""
    seqs = []
    cur: list = []
    with open(path) as f:
        for line in f:
            if line.startswith(">"):
                if cur:
                    seqs.append("".join(cur))
                    cur = []
            else:
                cur.append(line.strip().upper())
    if cur:
        seqs.append("".join(cur))
    rows = []
    for s in seqs:
        for off in range(0, len(s) - read_len + 1, read_len):
            window = s[off:off + read_len]
            if all(c in BASE_TO_CODE for c in window):
                rows.append([BASE_TO_CODE[c] for c in window])
    return np.asarray(rows, dtype=np.uint8)
