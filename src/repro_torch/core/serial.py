"""Serial k-mer counting (paper Algorithm 1): the port's own oracle.

Single stream: parse reads into packed k-mers, sort, accumulate. Every
distributed count must produce exactly this histogram.
"""

from __future__ import annotations

import torch

from repro_torch.core import encoding
from repro_torch.core.sort import AccumResult, accumulate, sort_with_weights


def count_kmers_serial(reads: torch.Tensor, k: int, canonical: bool = False,
                       bits_per_symbol: int = 2) -> AccumResult:
    """(n_reads, m) symbol codes -> AccumResult over all k-mers, as one
    row: unique (1, N), counts (1, N), num_unique (1,)."""
    kmers = encoding.extract_kmers(reads, k, bits_per_symbol)[None, :]
    if canonical:
        kmers = encoding.canonical(kmers, k)
    keys, _ = sort_with_weights(kmers, torch.zeros_like(kmers))
    return accumulate(keys, sentinel_val=encoding.sentinel(k, bits_per_symbol))


def count_kmers_python(reads_np, k: int) -> dict:
    """Pure-Python oracle (a Counter over a rolling 2-bit word) for tests
    and drills; (n_reads, m) numpy codes in, {word: count} out."""
    from collections import Counter

    c: Counter = Counter()
    mask = (1 << (2 * k)) - 1
    for row in reads_np:
        word = 0
        for j, base in enumerate(row.tolist()):
            word = ((word << 2) | int(base)) & mask
            if j >= k - 1:
                c[word] += 1
    return dict(c)
