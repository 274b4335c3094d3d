"""The readers of the port's spans (`port_spans`), on hand-made traces:
idle counted only inside a span, per step and per job, the unspanned
share, the metered job left out, None without port spans; and the jobs
loop traced on the CPU, where the port's spans reach the readers."""

import pytest
import torch

from kcbench import port_spans, readers, spec, tracing, window

S = tracing.SPAN
R = port_spans.PREFIX
READERS = ("step_host_ms", "plan_idle_ms", "compress_idle_ms",
           "route_idle_ms", "insert_idle_ms", "idle_unspanned")


def run_of(device_ops, spans, host_ops, steps=1):
    t = tracing.Trace(device_ops=sorted(device_ops), spans=sorted(spans),
                      host_ops=sorted(host_ops))
    t.steps = steps
    return window.Run(device=torch.device("cpu"), trace=t)


def read(name, run):
    return getattr(port_spans, name)(run)


def test_gap_across_a_span_edge_counts_its_inside_part():
    # idle (100, 300) and (700, 800); plan spans (200, 400) and (650, 750)
    run = run_of([(0, 100, "k"), (300, 700, "k"), (800, 1000, "k")],
                 [(0, 1000, S + "traced"), (0, 1000, S + "job")],
                 [(200, 400, R + "plan"), (650, 750, R + "plan")])
    assert read("plan_idle_ms", run) == pytest.approx(150 / 1e6)


def test_step_and_job_division():
    spans = [(0, 2000, S + "traced"), (0, 1000, S + "job"),
             (1000, 2000, S + "job")]
    host, ops = [], []
    for job in (0, 1000):
        host += [(job + 0, job + 100, R + "plan"),
                 (job + 100, job + 300, R + "compress"),
                 (job + 300, job + 600, R + "route"),
                 (job + 600, job + 1000, R + "insert")]
        # the card busy over the first half of each span
        ops += [(job + 0, job + 50, "k"), (job + 100, job + 200, "k"),
                (job + 300, job + 450, "k"), (job + 600, job + 800, "k")]
    run = run_of(ops, spans, host, steps=4)
    assert read("plan_idle_ms", run) == pytest.approx(50 / 1e6)
    assert read("compress_idle_ms", run) == pytest.approx(2 * 100 / 4 / 1e6)
    assert read("route_idle_ms", run) == pytest.approx(2 * 150 / 4 / 1e6)
    assert read("insert_idle_ms", run) == pytest.approx(2 * 200 / 4 / 1e6)
    assert read("step_host_ms", run) == pytest.approx(2 * 900 / 4 / 1e6)
    assert read("idle_unspanned", run) == pytest.approx(0.0)


def test_idle_in_and_out_of_spans_adds_up_to_device_idle():
    spans = [(0, 1000, S + "traced"), (0, 1000, S + "job")]
    ops = [(0, 100, "k"), (250, 400, "k"), (600, 900, "k")]
    host = [(50, 300, R + "compress"), (450, 550, R + "route"),
            (580, 950, R + "insert")]
    run = run_of(ops, spans, host, steps=1)
    idle = 1000 * readers.device_idle(run) / 100       # 450 ns
    inside = sum(read(n, run) * 1e6 for n in
                 ("compress_idle_ms", "route_idle_ms", "insert_idle_ms"))
    outside = idle * read("idle_unspanned", run) / 100
    assert inside == pytest.approx(150 + 100 + 70)
    assert inside + outside == pytest.approx(idle)


def test_spans_of_the_metered_job_are_left_out():
    spans = [(0, 1000, S + "traced"), (0, 1000, S + "job"),
             (1100, 2000, S + "metered"), (1100, 2000, S + "job")]
    host = [(0, 500, R + "route"), (1100, 2000, R + "route")]
    run = run_of([(500, 1000, "k"), (1500, 1600, "k")], spans, host)
    assert read("route_idle_ms", run) == pytest.approx(500 / 1e6)
    assert read("step_host_ms", run) == pytest.approx(500 / 1e6)
    assert read("idle_unspanned", run) == pytest.approx(0.0)


@pytest.mark.parametrize("name", READERS)
def test_none_without_port_spans(name):
    spans = [(0, 1000, S + "traced"), (0, 1000, S + "job")]
    run = run_of([(0, 100, "k")], spans, [(200, 300, "aten::nonzero")])
    assert read(name, run) is None
    assert read(name, window.Run(device=torch.device("cpu"))) is None


def test_jobs_loop_traced_on_the_cpu_reads_the_port_spans(tiny_cell,
                                                          monkeypatch):
    monkeypatch.setattr(window, "TRACE_SECONDS", 0.0)
    cell = tiny_cell("count.synth26")
    run = spec.loop_module("jobs").run(cell, 2**33 + 11, 0.0, True, 0.0,
                                       device="cpu")
    for name in READERS:
        assert read(name, run) is not None, name
    labels = [k for k, _ in run.trace.breakdown(top=100)["idle_gaps"]]
    assert any(k.startswith("job/" + R) for k in labels), labels
