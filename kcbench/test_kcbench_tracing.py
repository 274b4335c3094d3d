"""The reduction of a trace, on hand-made intervals: busy time and idle
gaps inside a window, the spans a reader counts in, the breakdown's
labels, and the meter's wrapping of the port's entry points."""

import types

import pytest
import torch

from kcbench import readers, tracing, window

S = tracing.SPAN


def trace(device_ops, spans=(), host_ops=()):
    return tracing.Trace(device_ops=sorted(device_ops), spans=sorted(spans),
                         host_ops=sorted(host_ops))


@pytest.mark.parametrize("ops,busy,gaps", [
    # an op after the window's end adds neither busy time nor a gap past it
    ([(10, 20, "a"), (150, 160, "b")], 10, [(0, 10), (20, 100)]),
    # ops across either edge count only their part inside
    ([(-5, 10, "a"), (90, 130, "b")], 20, [(10, 90)]),
    # overlapping ops count their union once
    ([(10, 40, "a"), (20, 30, "b"), (35, 50, "c")], 40, [(0, 10), (50, 100)]),
    ([], 0, [(0, 100)]),
    ([(100, 110, "a")], 0, [(0, 100)]),
])
def test_busy_counts_the_union_inside_the_window(ops, busy, gaps):
    assert trace(ops).busy(0, 100) == (busy, gaps)


def test_device_idle_reads_the_traced_span():
    t = trace([(10, 20, "k"), (40, 70, "k"), (150, 160, "k")],
              spans=[(0, 100, S + "traced"), (110, 170, S + "metered")])
    run = window.Run(device=torch.device("cpu"), trace=t)
    assert readers.device_idle(run) == pytest.approx(60.0)


def test_port_spans_and_launches_per_step():
    spans = [(0, 100, S + "traced"), (5, 45, S + "job"), (50, 95, S + "job"),
             (110, 170, S + "metered"), (120, 160, S + "job")]
    ops = [(10, 12, "k1"), (20, 22, "Memcpy HtoD"), (30, 32, "k2"),
           (60, 62, "k3"), (130, 132, "k4")]
    t = trace(ops, spans)
    t.steps = 2
    assert [s[:2] for s in t.port_spans()] == [(5, 45), (50, 95)]
    run = window.Run(device=torch.device("cpu"), trace=t)
    assert readers.launches_per_step(run) == 1.5


def test_breakdown_labels_gaps_by_span_and_host_op():
    spans = [(0, 100, S + "traced"), (0, 100, S + "job")]
    t = trace([(10, 50, "kern")], spans, host_ops=[(60, 90, "aten::nonzero")])
    got = t.breakdown()
    assert got["device_ops"] == [["kern", 40e-9]]
    assert dict(got["idle_gaps"]) == {"job/python": 10e-9,
                                      "job/aten::nonzero": 50e-9}


def test_meter_wraps_and_restores_the_entry_points():
    def insert(table_keys, table_counts, keys, weights, *, sentinel_val):
        return keys.sum()
    insert.launches = 3
    ops = types.SimpleNamespace(hash_insert=insert)
    meter = tracing.Meter(ops, {"hash_insert": readers.hash_insert_live,
                                "gone": lambda *a, **kw: (0,)})
    keys = torch.tensor([1, 7, 7, 4])
    with meter.active():
        assert ops.hash_insert is not insert
        assert ops.hash_insert.launches == 3
        ops.hash_insert(None, None, keys, torch.tensor([1, 1, 0, 2]),
                        sentinel_val=7)
        ops.hash_insert.launches += 1
    assert ops.hash_insert is insert and insert.launches == 4
    assert meter.calls() == {"hash_insert": [(4, 2)], "gone": []}
