"""The count.skew30 cell on the CPU at a tiny size: the jobs loop over a
genome with planted AATGG runs under the 'split' store sizing is judged
correct, and each of the jobs loop's faults makes it false. The least
bytes that accumulate_roofline.count gives a call, against a hand count."""

import pytest
import torch

from kcbench import spec
from kcbench.test_kcbench_jobs import FAULTS, break_path, judged

SENT = -1


def test_skew_sound_run_is_correct(tiny_cell):
    cell = tiny_cell("count.skew30")
    assert cell["config"]["dakc"]["store_sizing"] == "split"
    assert cell["traffic"]["heavy_frac"] > 0
    run, correct = judged(cell)
    assert correct and run.checks and run.units and run.store


@pytest.mark.parametrize("fault", FAULTS)
def test_skew_fault_makes_correct_false(tiny_cell, monkeypatch, fault):
    break_path(monkeypatch, fault)
    run, correct = judged(tiny_cell("count.skew30"))
    assert not correct, run.checks


# Two rows of sorted keys: row 0 has the runs 1, 2, 5 and two sentinels,
# row 1 the runs 3, 4 and one sentinel: 12 elements, 5 runs.
KEYS = torch.tensor([[1, 1, 2, 5, SENT, SENT], [3, 3, 3, 3, 4, SENT]])
WEIGHTS = torch.tensor([[2, 1, 7, 1, 0, 0], [1, 1, 1, 1, 9, 0]],
                       dtype=torch.int32)
# (weights, compact) -> bytes by hand:
# 12 keys x 8 B; 12 weights x 4 B where weighted; compacting, 5 runs x
# (8 B key + 4 B count) and 2 rows x 4 B run count, else 12 x (1 + 1 + 4) B.
HAND = {(False, True): 96 + 60 + 8,
        (True, True): 96 + 48 + 60 + 8,
        (True, False): 96 + 48 + 72}


@pytest.mark.parametrize("weighted,compact", sorted(HAND))
def test_accumulate_bytes_hand_count(weighted, compact):
    from repro_torch.kernels import ops
    mod = spec.metric_module("accumulate_roofline.count")
    keys = KEYS.clone()
    weights = WEIGHTS if weighted else None
    record = mod.METER["segment_accumulate"](keys, weights,
                                              sentinel_val=SENT,
                                              compact=compact)
    assert torch.equal(keys, KEYS)
    call = tuple(int(x) for x in record)
    assert call == (2, 12, int(weighted), int(compact), 5)
    assert mod.accumulate_bytes(*call) == HAND[(weighted, compact)]
    if compact:
        runs = ops.segment_accumulate(keys, weights, sentinel_val=SENT,
                                      compact=True)[2]
        assert int(runs.sum()) == call[-1]
