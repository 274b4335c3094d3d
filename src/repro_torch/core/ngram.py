"""Token n-gram counting over LM corpora: the paper's technique reused
(counterpart of `repro.core.ngram`).

A token n-gram is a k-mer over the alphabet [0, vocab): n tokens of
ceil(log2 vocab) bits each pack into one word, and the DAKC counter runs
unchanged (`encoding`, `owner`, `sort` and `fabsp` all take
`bits_per_symbol`). Used for corpus dedup and contamination statistics
(`data.corpus_stats`), and, at n=1, as the vocabulary histogram.

Tokens are int32 (a vocabulary of 151,936 needs 18 bits); the counter
reads them as symbol codes of any integer dtype. n * bits must fit the
62 payload bits of a 64-bit word: a 151,936-token vocabulary counts up to
trigrams.
"""

from __future__ import annotations

import math
from typing import Tuple

from repro_torch.core import encoding, fabsp
from repro_torch.core.sort import AccumResult


def bits_for_vocab(vocab_size: int) -> int:
    return max(1, math.ceil(math.log2(vocab_size)))


def ngram_config(vocab_size: int, n: int, **kw) -> fabsp.DAKCConfig:
    """DAKCConfig for counting n-grams of tokens from `vocab_size`.

    Raises where n * bits exceeds the 62 bits of a 64-bit word, as the
    JAX package's `kmer_dtype` does (the port checks at once, the JAX
    package when the counter packs its first word).
    """
    bits = bits_for_vocab(vocab_size)
    encoding.word_bits(n, bits)
    return fabsp.DAKCConfig(k=n, bits_per_symbol=bits, **kw)


def count_ngrams(tokens, vocab_size: int, n: int, *, num_pes: int,
                 chunk_rows: int = 64, grid=None, device=None, group=None,
                 **kw) -> Tuple[AccumResult, fabsp.DAKCStats]:
    """tokens: (rows, seq) int token ids (numpy array or tensor); PE p owns
    rows [p * rows / P, (p + 1) * rows / P), in chunks of `chunk_rows`.

    Returns the distributed n-gram histogram (per-PE segments, disjoint
    owner sets) and its stats, as `fabsp.count_kmers` does; `grid`,
    `device` and `group` as there, `kw` further `DAKCConfig` fields.
    """
    cfg = ngram_config(vocab_size, n, chunk_reads=chunk_rows, **kw)
    return fabsp.count_kmers(tokens, cfg, num_pes=num_pes, grid=grid,
                             device=device, group=group)
