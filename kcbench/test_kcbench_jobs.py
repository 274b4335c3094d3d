"""The jobs loop driven on the CPU at a tiny size, sound and with the
timed path broken underneath: each fault has to make `correct` false."""

import pytest

from kcbench import reference, spec

FAULTS = ("state_unchanged", "half_batch", "no_exchange", "answer_altered")


def judged(cell):
    loop = spec.loop_module(cell["traffic"]["loop"])
    run = loop.run(cell, 2**33 + 7, 0.0, False, 0.0, device="cpu")
    return run, reference.verdict(run.checks, run.failed)


def break_path(monkeypatch, fault):
    from repro_torch.core import aggregation, countstore, fabsp
    if fault == "state_unchanged":
        monkeypatch.setattr(countstore, "store_insert",
                            lambda store, words, counts=None: store)
    elif fault == "half_batch":
        count = fabsp.count_kmers
        monkeypatch.setattr(fabsp, "count_kmers", lambda reads, cfg, **kw:
                            count(reads[:reads.shape[0] // 2], cfg, **kw))
    elif fault == "no_exchange":
        monkeypatch.setattr(aggregation, "_exchange_1d",
                            lambda t, num_pes, group=None:
                            t.reshape(num_pes, -1))
    else:
        histogram = countstore.store_histogram

        def altered(*a, **kw):
            res = histogram(*a, **kw)
            res.counts.view(-1)[0] += 1
            return res
        monkeypatch.setattr(countstore, "store_histogram", altered)


def test_jobs_sound_run_is_correct(tiny_cell):
    run, correct = judged(tiny_cell("count.synth26"))
    assert correct and run.checks and run.units and run.store


@pytest.mark.parametrize("fault", FAULTS)
def test_jobs_fault_makes_correct_false(tiny_cell, monkeypatch, fault):
    break_path(monkeypatch, fault)
    run, correct = judged(tiny_cell("count.synth26"))
    assert not correct, run.checks
