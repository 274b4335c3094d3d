"""BENCHMARK.json against its contract, every cell's pieces found by name,
and no module of JAX or of the JAX package loaded by the harness."""

import json
import os
import re
import subprocess
import sys

import pytest

from kcbench import spec

SPEC = spec.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]
MIXES = sorted(p.stem for p in (spec.HERE / "traffic").glob("*.json"))


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_spec_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["kcbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert all(line(w) for w in SPEC["command"])
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names)) and all(map(NAME.match, names))
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert line(m["layer"]) and m["moves"] in e2e
    for c in SPEC["configs"]:
        assert line(c["source"]) and line(c["why"])
        assert c["file"].startswith("kcbench/")
        assert all(map(NAME.match, c["reduced"]))
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_by_name(name):
    cell = spec.load_cell(name)
    assert line(cell["entry"]["why"]) and cell["entry"]["chips"] in (1, 4)
    assert callable(spec.loop_module(cell["traffic"]["loop"]).run)
    cfg = cell["config"]
    assert set(cfg["reduced"]) == set(
        next(c for c in SPEC["configs"]
             if c["name"] == cell["entry"]["config"])["reduced"])
    names = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2 and cell["per_layer"]
    for m in cell["per_layer"]:
        assert m["moves"] in names


@pytest.mark.parametrize("mix", MIXES)
def test_traffic_file_names_a_loop(mix):
    """Every mix kept under traffic/, a cell's or one queued for later,
    is data that names a loop file there is."""
    traffic = json.loads((spec.HERE / "traffic" / f"{mix}.json").read_text())
    assert isinstance(traffic["about"], str)
    assert callable(spec.loop_module(traffic["loop"]).run)


@pytest.mark.parametrize("entry", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_file_matches_its_entry(entry):
    mod = spec.metric_module(entry["name"])
    assert (mod.UNIT, mod.BETTER, mod.SOURCE) == (
        entry["unit"], entry["better"], entry["source"])
    if "layer" in entry:
        assert (mod.LAYER, mod.MOVES) == (entry["layer"], entry["moves"])
    assert callable(mod.read)


def test_no_jax_module_after_the_harness_loads():
    code = (
        "import importlib.util, sys\n"
        f"sys.path[0:0] = [{str(spec.ROOT)!r}, {str(spec.ROOT / 'src')!r}]\n"
        "s = importlib.util.spec_from_file_location('kcbench_run', "
        f"{str(spec.HERE / 'run.py')!r})\n"
        "run = importlib.util.module_from_spec(s); s.loader.exec_module(run)\n"
        "from kcbench import control, spec, window\n"
        "import repro_torch.core.fabsp, repro_torch.kernels.ops\n"
        "for c in spec.load_spec()['workloads']:\n"
        "    cell = spec.load_cell(c['name'])\n"
        "    spec.loop_module(cell['traffic']['loop'])\n"
        "    for m in cell['end_to_end'] + cell['per_layer']:\n"
        "        spec.metric_module(m['name'])\n"
        "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
