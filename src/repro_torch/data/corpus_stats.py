"""Corpus n-gram statistics through the DAKC counter (counterpart of
`repro.data.corpus_stats`).

Dataset curation needs n-gram histograms over token corpora (dedup,
contamination screens, heavy hitters). A token n-gram is a k-mer over the
vocabulary, so the counter is `core.fabsp` (through `core.ngram`); this
module counts a token stream and returns the top-k heavy hitters and
summary stats. The top-k runs in numpy on the host over the merged per-PE
result, in the JAX package's order, so ties fall the same way.

Token streams are Zipfian: the paper's skewed regime, where the L3 layer
pays for itself (`compression`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch import words as W
from repro_torch.core import encoding, ngram


class CorpusStats(NamedTuple):
    top_ngrams: np.ndarray     # (k, n) int32 token ids, most frequent first
    top_counts: np.ndarray     # (k,) int32
    distinct: int              # number of distinct n-grams
    total: int                 # n-gram instances counted
    compression: float         # raw n-grams / words on the wire (L3 win)


def corpus_ngram_stats(tokens, vocab_size: int, n: int, *, num_pes: int,
                       top_k: int = 16, chunk_rows: int = 64, grid=None,
                       device=None, **kw) -> CorpusStats:
    """tokens: (rows, seq) int32 token ids, split over `num_pes` PEs as
    `ngram.count_ngrams` splits them; `kw` further `DAKCConfig` fields,
    as `count_ngrams` takes them (e.g. store_sizing='bound' where a Zipf
    corpus defeats the sampled store estimate)."""
    res, stats = ngram.count_ngrams(tokens, vocab_size, n, num_pes=num_pes,
                                    chunk_rows=chunk_rows, grid=grid,
                                    device=device, **kw)
    bits = ngram.bits_for_vocab(vocab_size)
    wb = encoding.word_bits(n, bits)
    nsh = res.num_unique.shape[0]
    u = W.to_numpy_words(res.unique, wb).reshape(nsh, -1)
    c = res.counts.cpu().numpy().reshape(nsh, -1)
    nu = res.num_unique.cpu().numpy()
    words = np.concatenate([u[s, :nu[s]] for s in range(nsh)])
    counts = np.concatenate([c[s, :nu[s]] for s in range(nsh)])
    order = np.argsort(-counts)[:top_k]
    mask = (1 << bits) - 1
    top = np.stack([
        np.stack([(words[i] >> ((n - 1 - j) * bits)) & mask
                  for j in range(n)]).astype(np.int32)
        for i in order]) if len(order) else np.zeros((0, n), np.int32)
    return CorpusStats(
        top_ngrams=top, top_counts=counts[order],
        distinct=int(nu.sum()), total=int(stats.raw_kmers),
        compression=float(stats.raw_kmers) / max(float(stats.sent_words),
                                                 1.0))
