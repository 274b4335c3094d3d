"""The 'split' store sizing (`DAKCConfig(store_sizing='split')`): the
'sample' integer wherever no sampled word is heavy, an estimate of the
right size on skewed reads, and a store that holds planted AATGG runs
without a rehash round, through `count_kmers` and `KmerCounter`."""

import dataclasses

import pytest
import torch

from repro_torch.core import encoding, fabsp, serial, spill
from repro_torch.core.resilience import FaultPlan, RetryPolicy
from repro_torch.data import genome
from test_torch_store_sizing import CASES, _cfg

# A genome with 30 % of its bases in planted AATGG runs (the paper's
# Sec. IV-D heavy hitter), 4096 reads of 100 bp: the sample, the first
# 128-read chunk, is 1/32 of the reads, and about a quarter of its k-mers
# are five heavy words.
AATGG = genome.sample_reads(genome.ReadSetSpec(
    genome_bases=1 << 15, n_reads=4096, read_len=100, heavy_hitter_frac=0.3,
    seed=1))
# The skew drill's corpora (`launch/kc_dryrun.py --skew`): 256 reads of 48
# bp at k=13, chunks of 32 reads.
SKEWED = {
    "aatgg": (AATGG, 31, 128),
    "poly_a": (genome.poly_a_reads(256, 48, seed=3), 13, 32),
    "power_law": (genome.power_law_minimizer_reads(256, 48, 7, alpha=1.5,
                                                   seed=4), 13, 32),
}
COUNT = dict(k=31, chunk_reads=128)


def _distinct(reads, k):
    words = encoding.extract_kmers(torch.from_numpy(reads), k, 2)
    return torch.unique(words).numel()


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_sizing_is_sample_without_heavy_words(name):
    reads, cfg, p = _cfg(CASES[name])
    split = dataclasses.replace(cfg, store_sizing="split")
    assert (fabsp._sampled_distinct_estimate(reads, split, p)
            == fabsp._sampled_distinct_estimate(reads, cfg, p))
    assert (fabsp._resolve_store_capacity(reads, split, p)
            == fabsp._resolve_store_capacity(reads, cfg, p))


@pytest.mark.parametrize("name", sorted(SKEWED))
def test_split_estimate_near_distinct_count_on_skewed_reads(name):
    reads, k, chunk = SKEWED[name]
    cfg = fabsp.DAKCConfig(k=k, chunk_reads=chunk, store_sizing="split")
    est = fabsp._sampled_distinct_estimate(torch.from_numpy(reads), cfg, 4)
    exact = _distinct(reads, k)
    assert 0.5 * exact <= est <= 2 * exact, (est, exact)


def _serial(reads, k):
    ser = serial.count_kmers_serial(torch.from_numpy(reads), k)
    n = int(ser.num_unique[0])
    return dict(zip(ser.unique[0, :n].tolist(), ser.counts[0, :n].tolist()))


def _histogram(res, p):
    width = res.unique.numel() // p
    keys, counts = res.unique.view(p, width), res.counts.view(p, width)
    out = {}
    for r in range(p):
        n = int(res.num_unique.view(-1)[r])
        out.update(zip(keys[r, :n].tolist(), counts[r, :n].tolist()))
    return out


@pytest.fixture(scope="module")
def aatgg_serial():
    return _serial(AATGG, COUNT["k"])


def test_count_kmers_split_store_holds_planted_runs(aatgg_serial):
    """'split' sizes a store that holds the planted runs' k-mers in one
    round, at the serial count. 'sample' reads the same sample as a small
    pool: its store has fewer slots than the busiest PE's distinct k-mers,
    so it has to drop and rehash."""
    reads = torch.from_numpy(AATGG)
    cfg = fabsp.DAKCConfig(store_sizing="split", **COUNT)
    res, stats = fabsp.count_kmers(reads, cfg, num_pes=4, device="cpu")
    assert _histogram(res, 4) == aatgg_serial
    assert stats.retry_store_rehash == 0
    sample = dataclasses.replace(cfg, store_sizing="sample")
    assert (fabsp._resolve_store_capacity(reads, sample, 4)
            < int(res.num_unique.max()))


def test_kmer_counter_sizes_and_bins_from_the_split_estimate(
        aatgg_serial, tmp_path, monkeypatch):
    """`KmerCounter` reads the same estimate: its store is made at the
    'split' capacity, and where a forced drop meets a rehash ceiling below
    that store and so engages the spill tier, `auto_bins` gets the
    estimate."""
    reads = torch.from_numpy(AATGG)
    cfg = fabsp.DAKCConfig(store_sizing="split", **COUNT)
    est = fabsp._sampled_distinct_estimate(reads, cfg, 4)
    cap = fabsp._resolve_store_capacity(reads, cfg, 4)
    kc = fabsp.KmerCounter(cfg, num_pes=4, device="cpu")
    kc.update(reads)
    assert kc.store_capacity == cap
    res, stats = kc.finalize()
    assert stats.retry_store_rehash == 0
    assert _histogram(res, 4) == aatgg_serial

    seen = []
    auto_bins = spill.auto_bins

    def spy(distinct_est, *a, **kw):
        seen.append(distinct_est)
        return auto_bins(distinct_est, *a, **kw)

    monkeypatch.setattr(spill, "auto_bins", spy)
    forced = dataclasses.replace(
        cfg, spill="auto", spill_dir=str(tmp_path / "bins"),
        retry=RetryPolicy(store_cap_ceiling=cap // 2),
        faults=FaultPlan(site="store_drop"))
    spilled = fabsp.KmerCounter(forced, num_pes=4, device="cpu")
    spilled.update(reads)
    assert seen == [est]
    res, _ = spilled.finalize()
    assert _histogram(res, 4) == aatgg_serial
