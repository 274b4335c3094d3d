"""The plain reference against a brute-force count, the comparison's
numbers, and the control that the comparison has to reject."""

from collections import Counter

import pytest
import torch

from kcbench import control, gen, reference


def brute(reads, k, canonical):
    comp = {0: 3, 1: 2, 2: 1, 3: 0}
    out = Counter()
    for row in reads.tolist():
        for i in range(len(row) - k + 1):
            win = row[i:i + k]
            w = 0
            for c in win:
                w = w * 4 + c
            if canonical:
                r = 0
                for c in reversed(win):
                    r = r * 4 + comp[c]
                w = min(w, r)
            out[w] += 1
    return out


@pytest.mark.parametrize("k,canonical", [(5, False), (5, True), (31, False),
                                         (31, True)])
def test_histogram_matches_brute_force(k, canonical):
    g = gen.genome(1 << 9, 3, "cpu", heavy_frac=0.3)
    reads = gen.reads(g, 40, 50, 3, "set/0")
    ref = reference.Histogram(k, canonical, "cpu")
    for half in (reads[:20], reads[20:]):       # merged across blocks
        ref.add_words(reference.kmer_words(half, k, canonical))
    want = brute(reads, k, canonical)
    assert ref.instances == 40 * (50 - k + 1)
    assert dict(zip(ref.keys.tolist(), ref.counts.tolist())) == dict(want)
    whole = reference.Histogram(k, canonical, "cpu")
    whole.add_reads(reads)
    assert torch.equal(whole.keys, ref.keys)
    assert torch.equal(whole.counts, ref.counts)


def test_compare_histogram_counts_each_disagreement():
    ref = reference.Histogram(31, False, "cpu")
    ref.add_words(torch.tensor([5, 5, 7, 9, 11]))
    # 7 missing, 9 over-counted, 11 on two PEs, 13 never seen
    keys = torch.tensor([5, 9, 11, 11, 13])
    counts = torch.tensor([2, 2, 1, 0, 1])
    assert reference.compare_histogram(keys, counts, 6, ref) == {
        "kmer_set_diff": 2, "count_diff": 1, "owner_dup": 1,
        "sum_gap": 1, "raw_gap": 1}
    exact = reference.compare_histogram(ref.keys, ref.counts, 5, ref)
    assert reference.verdict(exact, 0)
    assert not reference.verdict(exact, 1)
    assert not reference.verdict({}, 0)


def test_control_fails_the_comparison():
    """A fingerprint store over 2**21 distinct 62-bit words merges some
    (about 500 pairs collide mod a 32-bit prime): the comparison sees
    k-mers missing and counts merged."""
    g = torch.Generator().manual_seed(5)
    ref = reference.Histogram(31, False, "cpu")
    ref.add_words(torch.randint(0, 1 << 62, (1 << 21,), generator=g))
    keys, counts = control.fingerprint_histogram(ref)
    nums = reference.compare_histogram(keys, counts, ref.instances, ref)
    assert nums["kmer_set_diff"] > 0 and nums["count_diff"] > 0
    assert not reference.verdict(nums, 0)
