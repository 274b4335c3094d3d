"""Inputs made on the device from the seed: genomes and read sets.

The paper's data (arXiv:2505.04431, Sec. VI, Table V): a genome drawn
uniformly from {A, C, G, T} (A=0, C=1, G=2, T=3) and fixed-length reads
at uniform offsets. Heavy hitters are planted runs of a short motif (Sec.
IV-D: AATGG, the human genome's satellite repeat), each run
max(40 motifs, 200) bases long at a uniform start, `heavy_frac` of the
genome's length in all (runs may overlap). A run's base at position i is
motif[i % len(motif)], so overlapping runs agree and the genome does not
depend on the order of the writes.

Every draw takes a torch.Generator on the device, seeded from the run's
seed and the draw's name (`stream_seed`), so one seed gives the same
inputs in every run and the reference can make any block again.
"""

from __future__ import annotations

import numpy as np
import torch

BASES = "ACGT"


def stream_seed(seed: int, name: str) -> int:
    """A 63-bit seed for the named draw of run `seed` (any int >= 0)."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32] + [ord(c) for c in name]
    return int(np.random.SeedSequence(words).generate_state(
        1, dtype=np.uint64)[0]) >> 1


def generator(seed: int, name: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, name))
    return g


def genome(bases: int, seed: int, device, heavy_frac: float = 0.0,
           motif: str = "AATGG") -> torch.Tensor:
    """(bases,) uint8 codes."""
    g = generator(seed, "genome", device)
    out = torch.randint(0, 4, (bases,), generator=g, device=device,
                        dtype=torch.uint8)
    if heavy_frac > 0:
        code = torch.tensor([BASES.index(b) for b in motif],
                            dtype=torch.uint8, device=device)
        run_len = max(len(motif) * 40, 200)
        n_runs = max(int(bases * heavy_frac / run_len), 1)
        starts = torch.randint(0, bases - run_len, (n_runs,), generator=g,
                               device=device)
        pos = (starts[:, None]
               + torch.arange(run_len, device=device)[None, :]).reshape(-1)
        out[pos] = code[pos % len(motif)]
    return out


def reads(genome_codes: torch.Tensor, n_reads: int, read_len: int,
          seed: int, name: str) -> torch.Tensor:
    """(n_reads, read_len) uint8 reads of the genome at uniform offsets,
    drawn by the named generator."""
    dev = genome_codes.device
    g = generator(seed, name, dev)
    starts = torch.randint(0, genome_codes.numel() - read_len + 1,
                           (n_reads,), generator=g, device=dev)
    return genome_codes.unfold(0, read_len, 1)[starts]

