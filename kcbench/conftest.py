"""CPU tests of the benchmark: the port's package on the path, and cells
cut to a size the CPU runs in well under a second."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny(name: str) -> dict:
    """Cell `name` of BENCHMARK.json at a CPU test's size: 2 PEs, chunks of
    64 reads, a 2**14-base genome; its shapes otherwise as committed."""
    from kcbench import spec
    cell = copy.deepcopy(spec.load_cell(name))
    cfg, mix = cell["config"], cell["traffic"]
    cfg.update(genome_bases=1 << 14, num_pes=2)
    cfg["dakc"]["chunk_reads"] = 64
    mix.update(job_reads=256, read_sets=2)
    return cell


@pytest.fixture
def tiny_cell():
    return tiny


@pytest.fixture(autouse=True)
def one_thread():
    """These tests' tensors are tiny: one intra-op thread each keeps the
    suite's parallel workers from oversubscribing the cores."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
