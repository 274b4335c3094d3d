"""The port's host spans (`repro_torch.core.spans`) around `count_kmers`,
under torch.profiler on the CPU: which spans a call emits, that none nests
in another, how often each comes, that they cost no `record_function`
with no profiler running, and that they change no count or stat."""

from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.core import fabsp, spans
from repro_torch.data import genome

P, CHUNK = 4, 16
READS = {
    "uniform": genome.sample_reads(genome.ReadSetSpec(
        genome_bases=4096, n_reads=384, read_len=100, seed=3)),
    "all_a": np.zeros((128, 40), np.uint8),
}
CASES = {
    "dual": dict(k=31),
    "superkmer": dict(k=31, transport_impl="superkmer"),
    "stacked": dict(k=13, receiver_impl="stacked"),
    "slack_retry": dict(k=13, use_l3=False, slack=1.01, reads="all_a"),
}


def _count(case):
    spec = dict(CASES[case])
    reads = READS[spec.pop("reads", "uniform")]
    cfg = fabsp.DAKCConfig(chunk_reads=CHUNK, **spec)
    return reads, fabsp.count_kmers(reads, cfg, num_pes=P, device="cpu")


def _traced(case):
    """(the port's spans as (start, end, stage, thread), sorted; the
    reads; the result and stats) of one call under the profiler."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        reads, (res, st) = _count(case)
    got = sorted((e.start_ns(), e.start_ns() + e.duration_ns(),
                  e.name()[len(spans.PREFIX):], e.start_thread_id())
                 for e in prof.profiler.kineto_results.events()
                 if e.name().startswith(spans.PREFIX))
    return got, reads, res, st


@pytest.fixture(scope="module")
def traced():
    return {case: _traced(case) for case in CASES}


@pytest.mark.parametrize("case", sorted(CASES))
def test_emits_exactly_the_named_spans(traced, case):
    got = traced[case][0]
    assert sorted({s[2] for s in got}) == sorted(spans.NAMES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_are_flat(traced, case):
    got = traced[case][0]
    assert len({s[3] for s in got}) == 1
    for (_, end, a, _), (start, _, b, _) in zip(got, got[1:]):
        assert start >= end, f"{b} opens inside {a}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_span_counts_follow_steps_and_rounds(traced, case):
    got, reads, _, st = traced[case]
    rounds = 1 + st.retry_route_slack + st.retry_store_rehash \
        + st.retry_hop2_fallback
    steps = reads.shape[0] // (P * CHUNK)
    n = Counter(s[2] for s in got)
    assert n["place"] == 1
    assert n["plan"] == 1 + rounds
    assert n["histogram"] == n["stats"] == rounds
    for stage in ("compress", "route", "insert"):
        assert n[stage] == steps * rounds, stage
    if case == "slack_retry":
        assert rounds > 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_profiler_changes_no_count_or_stat(traced, case):
    _, _, res, st = traced[case]
    _, (res0, st0) = _count(case)
    assert st == st0
    for a, b in zip(res, res0):
        assert torch.equal(a, b)


def test_no_record_function_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _count("dual")
    with spans.span("route"):
        pass
