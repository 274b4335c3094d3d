"""Token n-gram counting (`repro_torch.core.ngram`) and corpus statistics
(`repro_torch.data.corpus_stats`) on the CPU, against the JAX package on
a 4-device host mesh.

Each case counts int32 tokens on 4 PEs: per-PE unique n-grams, counts and
num_unique bit-equal, every DAKCStats field equal, and `CorpusStats`
field by field (the top-k runs in numpy over the same merged arrays, so
ties fall alike). Vocab 100 at n=2 packs 14-bit words into 32 bits;
qwen1.5-0.5b's vocabulary (151,936, 18 bits a token) at n=1 packs 32-bit
words and at n=3 54-bit ones (the JAX package in x64). The JAX runs
happen in two subprocesses at once.
"""

import numpy as np
import pytest
import torch

from _torch_parity import JAX_HELPERS, assert_result, assert_stats, run_jax_many
from repro.data.tokens import TokenPipelineConfig, batch_for_step
from repro_torch.core import encoding, ngram
from repro_torch.data import corpus_stats

NUM_PES, CHUNK_ROWS, TOP_K = 4, 8, 8
QWEN_VOCAB = 151_936


def _zipf(vocab, rows, seq, seed):
    return batch_for_step(TokenPipelineConfig(
        vocab_size=vocab, batch_size=rows, seq_len=seq, zipf_a=1.2,
        seed=seed), 0)


# name -> (vocab, n, tokens, x64)
CASES = {
    "v100_n2": (100, 2, np.random.default_rng(3).integers(
        0, 100, (64, 33), dtype=np.int32), False),
    "v100_n2_zipf": (100, 2, _zipf(100, 32, 40, 1), False),
    "qwen_n1": (QWEN_VOCAB, 1, _zipf(QWEN_VOCAB, 64, 48, 2), True),
    "qwen_n3": (QWEN_VOCAB, 3, _zipf(QWEN_VOCAB, 64, 48, 2), True),
}

_BODY = JAX_HELPERS + """
from repro.core import ngram
from repro.data.corpus_stats import corpus_ngram_stats
mesh = Mesh(np.array(jax.devices()[:4]), ("pe",))
for name, (vocab, n) in CASES.items():
    toks = jnp.asarray(I[name])
    res, st = ngram.count_ngrams(toks, vocab, n, mesh, chunk_rows=CHUNK_ROWS)
    res_out(name, res)
    put(name + "_stats", st)
    cs = corpus_ngram_stats(toks, vocab, n, mesh, top_k=TOP_K,
                            chunk_rows=CHUNK_ROWS)
    O[name + "_top"], O[name + "_topc"] = cs.top_ngrams, cs.top_counts
    O[name + "_cs"] = np.array([cs.distinct, cs.total, cs.compression],
                               np.float64)
"""


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    jobs = {}
    for x64 in (False, True):
        cases = {name: (v, n) for name, (v, n, _, x) in CASES.items()
                 if x == x64}
        head = (f"CASES = {cases!r}\nCHUNK_ROWS = {CHUNK_ROWS}\n"
                f"TOP_K = {TOP_K}\n")
        jobs[f"x64_{x64}"] = (head + _BODY, x64)
    out = run_jax_many(tmp_path_factory.mktemp("ngram"), jobs,
                       {name: c[2] for name, c in CASES.items()}, devices=4)
    return {**out["x64_False"], **out["x64_True"]}


@pytest.mark.parametrize("name", sorted(CASES))
def test_count_ngrams_matches_jax(jax_out, name):
    vocab, n, toks, _ = CASES[name]
    # a tensor input for one case, numpy for the rest
    arg = torch.from_numpy(toks) if name == "qwen_n3" else toks
    res, stats = ngram.count_ngrams(arg, vocab, n, num_pes=NUM_PES,
                                    chunk_rows=CHUNK_ROWS, device="cpu")
    bits = ngram.bits_for_vocab(vocab)
    assert_result(res, encoding.word_bits(n, bits), jax_out, name)
    assert_stats(stats, jax_out[name + "_stats"])
    assert stats.overflow == stats.store_overflow == 0
    assert stats.raw_kmers == toks.shape[0] * (toks.shape[1] - n + 1)
    assert int(res.counts.sum()) == stats.raw_kmers


@pytest.mark.parametrize("name", sorted(CASES))
def test_corpus_ngram_stats_matches_jax(jax_out, name):
    vocab, n, toks, _ = CASES[name]
    cs = corpus_stats.corpus_ngram_stats(toks, vocab, n, num_pes=NUM_PES,
                                         top_k=TOP_K, chunk_rows=CHUNK_ROWS,
                                         device="cpu")
    assert cs.top_ngrams.dtype == np.int32 and cs.top_ngrams.shape == (
        TOP_K, n)
    np.testing.assert_array_equal(cs.top_ngrams, jax_out[name + "_top"])
    np.testing.assert_array_equal(cs.top_counts, jax_out[name + "_topc"])
    distinct, total, compression = jax_out[name + "_cs"]
    assert (cs.distinct, cs.total, cs.compression) == (
        distinct, total, compression)
    # the top n-gram's count against a dict over the tokens
    grams = {}
    for row in toks.tolist():
        for i in range(len(row) - n + 1):
            g = tuple(row[i:i + n])
            grams[g] = grams.get(g, 0) + 1
    assert cs.distinct == len(grams)
    assert int(cs.top_counts[0]) == max(grams.values())
    assert grams[tuple(cs.top_ngrams[0].tolist())] == int(cs.top_counts[0])


def test_bits_for_vocab_matches_jax():
    from repro.core import ngram as jngram
    for v in (1, 2, 3, 4, 5, 100, 256, 257, 50_257, QWEN_VOCAB, 1 << 20):
        assert ngram.bits_for_vocab(v) == jngram.bits_for_vocab(v)
    assert ngram.bits_for_vocab(QWEN_VOCAB) == 18
    cfg = ngram.ngram_config(QWEN_VOCAB, 3, chunk_reads=64)
    assert (cfg.k, cfg.bits_per_symbol, cfg.chunk_reads) == (3, 18, 64)


@pytest.mark.parametrize("n", [4, 5])
def test_ngram_past_the_64_bit_word_raises(n):
    """n * 18 bits past 62: refused before any counting, as the JAX
    package's kmer_dtype refuses the word."""
    toks = np.zeros((8, 16), np.int32)
    with pytest.raises(ValueError, match="62"):
        ngram.count_ngrams(toks, QWEN_VOCAB, n, num_pes=1, chunk_rows=8,
                           device="cpu")
    with pytest.raises(ValueError, match="62"):
        corpus_stats.corpus_ngram_stats(toks, QWEN_VOCAB, n, num_pes=1,
                                        chunk_rows=8, device="cpu")


def test_canonical_ngrams_are_refused():
    """Canonical words are defined for 2-bit DNA codes only."""
    toks = np.zeros((8, 16), np.int32)
    with pytest.raises(ValueError, match="canonical"):
        ngram.count_ngrams(toks, 100, 2, num_pes=1, chunk_rows=8,
                           device="cpu", canonical=True)
