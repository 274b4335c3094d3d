"""Find a cell's pieces by the names `BENCHMARK.json` gives them.

A cell (an entry of `workloads`) names a configuration, whose entry in
`configs` names its file, and a traffic mix, `kcbench/traffic/<mix>.json`,
whose `loop` names the closed loop that drives it, `kcbench/loops/<loop>.py`.
A metric `<name>` is read by `kcbench/metrics/<name>.py`. Adding a
configuration, a mix, a loop or a metric adds files and entries; nothing
here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
SPEC_FILE = ROOT / "BENCHMARK.json"


def load_spec() -> dict:
    return json.loads(SPEC_FILE.read_text())


def load_cell(name: str, spec: dict = None) -> dict:
    """The cell `name`: its entry, configuration and traffic dicts, and
    the entries of the end-to-end and per-layer metrics it reports."""
    spec = load_spec() if spec is None else spec
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {SPEC_FILE.name} "
                       f"(have: {sorted(cells)})")
    entry = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((ROOT / configs[entry["config"]]["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{entry['traffic']}.json").read_text())
    end_to_end = [m for m in spec["end_to_end"]
                  if name in m.get("workloads", [name])]
    moved = {m["name"] for m in end_to_end}
    per_layer = [m for m in spec["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in moved
                                  else [])]
    return {"name": name, "entry": entry, "config": config,
            "traffic": traffic, "end_to_end": end_to_end,
            "per_layer": per_layer}


def _load(kind: str, name: str) -> ModuleType:
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} file {path.relative_to(ROOT)}")
    mod_spec = importlib.util.spec_from_file_location(
        f"kcbench.{kind}.{name}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def metric_module(name: str) -> ModuleType:
    """The reader of metric `name`, `metrics/<name>.py`."""
    return _load("metrics", name)


def loop_module(name: str) -> ModuleType:
    """The closed loop `name`, `loops/<name>.py`: its `run(cell, seed,
    seconds, trace, t_start, device=None)` sets up, runs the window on as
    many cards as the cell asks for, and judges, returning a
    `window.Run`."""
    return _load("loops", name)
