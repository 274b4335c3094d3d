"""The plain reference: exact k-mer counts in PyTorch, and the comparison
that decides `correct`.

It takes the reads (made by `gen`), never anything the program made. A
read's k-mers come from `unfold` and a multiply-add of their 2-bit codes;
the counts from `torch.unique`, block by block, merged into one running
histogram. The program's outputs are read only to be judged.

Every number that `compare_histogram` returns is a count of
disagreements, so each has the limit 0.
"""

from __future__ import annotations

from typing import Dict

import torch

BLOCK_READS = 1 << 20

# Each number compared and its limit: every one counts disagreements with
# the reference, so the limit is 0 (PERF.md gives the readings).
LIMITS = {"kmer_set_diff": 0, "count_diff": 0, "owner_dup": 0,
          "sum_gap": 0, "raw_gap": 0}


def kmer_words(reads: torch.Tensor, k: int,
               canonical: bool = False) -> torch.Tensor:
    """(n * (m - k + 1),) int64 words of every k-mer of (n, m) uint8 reads,
    the first base in the highest bits; with `canonical`, the smaller of
    the word and its reverse complement's."""
    win = reads.unfold(1, k, 1)
    w = torch.zeros(win.shape[:2], dtype=torch.int64, device=reads.device)
    for j in range(k):
        w = w * 4 + win[..., j].to(torch.int64)
    if canonical:
        rc = torch.zeros_like(w)
        for j in range(k - 1, -1, -1):
            rc = rc * 4 + (3 - win[..., j].to(torch.int64))
        w = torch.minimum(w, rc)
    return w.reshape(-1)


class Histogram:
    """The exact (k-mer, count) histogram of every read added so far:
    `keys` ascending, `counts` int64, `instances` the k-mers added."""

    def __init__(self, k: int, canonical: bool, device):
        self.k = k
        self.canonical = canonical
        self.keys = torch.empty((0,), dtype=torch.int64, device=device)
        self.counts = torch.empty((0,), dtype=torch.int64, device=device)
        self.instances = 0

    def add_words(self, words: torch.Tensor) -> None:
        keys, counts = torch.unique(words, return_counts=True)
        self.instances += words.numel()
        if self.keys.numel():
            keys, inv = torch.unique(torch.cat([self.keys, keys]),
                                     return_inverse=True)
            counts = torch.zeros(keys.shape, dtype=torch.int64,
                                 device=keys.device).index_add_(
                0, inv, torch.cat([self.counts, counts]))
        self.keys, self.counts = keys, counts

    def add_reads(self, reads: torch.Tensor) -> None:
        """Add (n, m) uint8 reads, wherever they lie, a block at a time on
        the histogram's device."""
        dev = self.keys.device
        for lo in range(0, reads.shape[0], BLOCK_READS):
            self.add_words(kmer_words(reads[lo:lo + BLOCK_READS].to(dev),
                                      self.k, self.canonical))


def compare_histogram(keys: torch.Tensor, counts: torch.Tensor,
                      raw_kmers: int, ref: Histogram) -> Dict[str, int]:
    """The program's histogram, every PE's live (k-mer, count) entries
    concatenated, against the reference's.

    kmer_set_diff: k-mers in one set and not the other; count_diff: shared
    k-mers whose counts differ; owner_dup: entries of a k-mer that a second
    PE holds too; sum_gap: |sum of the counts - the reads' k-mers|;
    raw_gap: |the program's raw_kmers - the reads' k-mers|."""
    keys = keys.to(torch.int64)
    counts = counts.to(torch.int64)
    order = torch.argsort(keys)
    keys, counts = keys[order], counts[order]
    uk, inv = torch.unique_consecutive(keys, return_inverse=True)
    uc = torch.zeros(uk.shape, dtype=torch.int64,
                     device=uk.device).index_add_(0, inv, counts)
    n_ref = ref.keys.numel()
    if n_ref:
        idx = torch.searchsorted(ref.keys, uk).clamp_(max=n_ref - 1)
        match = ref.keys[idx] == uk
        n_match = int(match.sum())
        count_diff = int((uc[match] != ref.counts[idx[match]]).sum())
    else:
        n_match = count_diff = 0
    return {
        "kmer_set_diff": uk.numel() - n_match + n_ref - n_match,
        "count_diff": count_diff,
        "owner_dup": keys.numel() - uk.numel(),
        "sum_gap": abs(int(counts.sum()) - ref.instances),
        "raw_gap": abs(int(raw_kmers) - ref.instances),
    }


def verdict(checks: Dict[str, int], failed: int) -> bool:
    """`correct`: something was judged, no unit failed, and every number
    is within its limit."""
    return (bool(checks) and failed == 0
            and all(v <= LIMITS[name] for name, v in checks.items()))
