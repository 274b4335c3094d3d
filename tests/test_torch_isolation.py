"""The port stands alone: it imports no JAX and nothing of `repro`, runs on
the card unless the caller asks for the CPU, refuses what is outside its
slice, and `chip_smoke.py` fails without a card or without the repo.

Three tests keep the names they had while the port refused spill, save
and restore, and now check that those settings run:
- `test_settings_outside_the_slice_raise[spill]`: `count_kmers` under
  spill='auto' engages the tier and is exact;
- `test_spill_fault_sites_are_refused_by_validation`: the spill fault
  sites are refused without spill (its ValueError half) and fire with it;
- `test_counter_durability_and_spill_raise_item_10[spill|faults|save]`:
  a spilled counter restores from its checkpoint, a 'ckpt_write' plan
  fires in `save`, and a saved counter restores in place."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import fabsp

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"


def _run(code, cwd=None, env_extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=cwd, timeout=300)


def test_port_imports_no_jax_and_no_repro():
    code = r"""
import sys
import numpy as np
import torch
import repro_torch
from repro_torch import words
from repro_torch.core import (aggregation, bsp, countstore, encoding, fabsp,
                              minimizer, owner, query, resilience, serial,
                              sort, spill)
from repro_torch.data import genome
from repro_torch.kernels import build, hash_table, ops, radix_partition, ref
from repro_torch.kernels import minimizer as kminimizer
from repro_torch.kernels import flash_attention, segment_count
from repro_torch.kernels import kmer_extract, radix_hist
from repro_torch.configs import get_config, reduced_config
from repro_torch.data import tokens
from repro_torch.launch import kc_serve, train
from repro_torch.train import checkpoint
from repro_torch.models import attention, convert, layers, model
from repro_torch.train import optimizer, train_step
out = train.train("qwen1.5-0.5b", reduced=True, steps=2, batch=2, seq=16,
                  device="cpu", attn_impl="flash_train")
assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
reads = genome.sample_reads(genome.ReadSetSpec(genome_bases=512, n_reads=64,
                                               read_len=30, seed=1))
res, st = fabsp.count_kmers(reads, fabsp.DAKCConfig(k=13, chunk_reads=8),
                            num_pes=2, device="cpu")
assert st.overflow == 0 and int(res.counts.sum()) == st.raw_kmers
kc = fabsp.KmerCounter(fabsp.DAKCConfig(k=13, chunk_reads=8,
                                        transport_impl="superkmer",
                                        minimizer_order="hashed"),
                       num_pes=2, device="cpu")
kc.update(reads)
assert int(kc.finalize()[0].counts.sum()) == st.raw_kmers
assert int(kc.count(reads[:4, :13]).min()) > 0
words = ops.kmer_extract(torch.from_numpy(reads), 13, canonical=True)
srt = sort.radix_sort(words.reshape(1, -1), 26)
assert int(ops.radix_hist(srt, 0, 4, srt.shape[1]).sum()) == srt.numel()
acc = sort.accumulate(srt, sentinel_val=encoding.sentinel(13),
                      boundaries_impl="kernel")
assert int(acc.counts.sum()) == st.raw_kmers
res2, st2 = fabsp.count_kmers(
    reads, fabsp.DAKCConfig(k=13, chunk_reads=8, topology="2d",
                            hop2_impl="compact",
                            faults=resilience.FaultPlan("hop2_misfit")),
    num_pes=4, grid=(2, 2), device="cpu")
assert st2.retry_hop2_fallback == 1 and torch.equal(res2.counts.sum(),
                                                    res.counts.sum())
res3, st3 = bsp.count_kmers(reads, bsp.BSPConfig(k=13, batch_reads=8),
                            num_pes=2, device="cpu")
assert int(res3.counts.sum()) == st.raw_kmers and st3.num_global_syncs == 5
kc_serve.run_demo(device="cpu")
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print("LEAKED", bad)
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LEAKED []" in proc.stdout, proc.stdout


def test_sources_name_no_jax_module():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                         re.M)
    files = list((SRC / "repro_torch").rglob("*.py")) + [ROOT /
                                                         "chip_smoke.py"]
    for f in files:
        assert not pattern.search(f.read_text()), f


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs on it")
    reads = torch.zeros((16, 30), dtype=torch.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fabsp.count_kmers(reads, fabsp.DAKCConfig(k=13, chunk_reads=8),
                          num_pes=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fabsp.KmerCounter(fabsp.DAKCConfig(k=13), num_pes=1)


def test_lm_training_needs_a_card():
    from repro_torch.launch import train

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.train("qwen1.5-0.5b", reduced=True, steps=1, batch=2, seq=16)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "moonshot-v1-16b-a3b",
                                  "mamba2-370m", "zamba2-1.2b",
                                  "llava-next-mistral-7b", "hubert-xlarge"])
def test_lm_families_outside_the_slice_raise(arch):
    from repro_torch.configs import reduced_config
    from repro_torch.launch import train
    from repro_torch.models import model

    cfg = reduced_config(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        model.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        train.train(arch, reduced=True, steps=1, batch=2, seq=16,
                    device="cpu")


def test_attention_with_a_kv_cache_raises():
    """Prefill and decode (LM serving) are not in this slice."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import attention

    cfg = reduced_config("qwen1.5-0.5b", compute_dtype="float32")
    p = attention.init_attention(torch.Generator().manual_seed(0), cfg,
                                 "cpu")
    x = torch.zeros((1, 4, cfg.d_model))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        attention.attention(p, x, cfg=cfg, window=None,
                            positions=torch.arange(4), cache=object())


@pytest.mark.parametrize("knobs", [
    dict(spill="auto", store_capacity=8),
], ids=lambda d: next(iter(d)))
def test_settings_outside_the_slice_raise(knobs, tmp_path):
    """Named for when spill raised: spill='auto' now runs through
    count_kmers exactly (a store of 8 slots engages the tier)."""
    from repro_torch.core import resilience, serial
    from repro_torch.data import genome

    cfg = fabsp.DAKCConfig(k=13, chunk_reads=8, spill_dir=str(tmp_path),
                           retry=resilience.RetryPolicy(store_cap_ceiling=8),
                           **knobs)
    reads = genome.sample_reads(genome.ReadSetSpec(
        genome_bases=512, n_reads=16, read_len=30, seed=1))
    res, st = fabsp.count_kmers(reads, cfg, num_pes=1, device="cpu")
    want = serial.count_kmers_serial(torch.from_numpy(reads), 13)
    n = int(res.num_unique[0])
    assert torch.equal(res.unique[:n], want.unique[0, :n])
    assert torch.equal(res.counts[:n], want.counts[0, :n])
    assert st.spilled_bins >= 1 and st.bins_folded == st.spilled_bins


@pytest.mark.parametrize("grid", [None, (2, 3), (3, 2), (0, 6)],
                         ids=["missing", "2x3", "3x2", "0x6"])
def test_2d_needs_a_grid_that_folds_the_pes(grid):
    cfg = fabsp.DAKCConfig(k=13, chunk_reads=8, topology="2d")
    reads = torch.zeros((32, 30), dtype=torch.uint8)
    with pytest.raises(ValueError, match="grid"):
        fabsp.count_kmers(reads, cfg, num_pes=4, grid=grid, device="cpu")
    with pytest.raises(ValueError, match="grid"):
        fabsp.KmerCounter(cfg, num_pes=4, grid=grid, device="cpu")


def test_1d_refuses_a_grid():
    cfg = fabsp.DAKCConfig(k=13, chunk_reads=8)
    with pytest.raises(ValueError, match="grid"):
        fabsp.count_kmers(torch.zeros((16, 30), dtype=torch.uint8), cfg,
                          num_pes=2, grid=(1, 2), device="cpu")


def test_compact_hop2_under_1d_equals_padded():
    """As in the JAX package, 'compact' applies to the 2d 'oneplan' route
    only; under 1d it is accepted and changes nothing."""
    from repro_torch.data import genome

    reads = genome.sample_reads(genome.ReadSetSpec(
        genome_bases=512, n_reads=64, read_len=30, seed=1))
    runs = [fabsp.count_kmers(
        reads, fabsp.DAKCConfig(k=13, chunk_reads=8, hop2_impl=h),
        num_pes=4, device="cpu") for h in ("padded", "compact")]
    (pres, pst), (cres, cst) = runs
    assert torch.equal(pres.unique, cres.unique) and pst == cst


def test_spill_fault_sites_are_refused_by_validation(tmp_path):
    """Named for when every spill site was refused: without spill they
    still are; with it they fire, a torn segment write raising
    InjectedFault and a corrupted bin SpillCorrupt."""
    from repro_torch.core import resilience, spill

    reads = torch.randint(0, 4, (16, 30), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(0))
    for site, raised in (("spill_write", resilience.InjectedFault),
                         ("bin_corrupt", spill.SpillCorrupt)):
        with pytest.raises(ValueError, match="spill"):
            fabsp.DAKCConfig(k=13, faults=resilience.FaultPlan(site))
        cfg = fabsp.DAKCConfig(k=13, chunk_reads=8, spill="auto",
                               spill_dir=str(tmp_path / site), spill_bins=1,
                               store_capacity=8,
                               retry=resilience.RetryPolicy(
                                   store_cap_ceiling=8),
                               faults=resilience.FaultPlan(site))
        with pytest.raises(raised):
            fabsp.count_kmers(reads, cfg, num_pes=1, device="cpu")


@pytest.mark.parametrize("case", ["spill", "faults", "save"])
def test_counter_durability_and_spill_raise_item_10(case, tmp_path):
    """Named for when durability and spill raised; they now run: 'spill'
    counts out of core and restores from its checkpoint; 'faults', a
    'ckpt_write' plan, counts as usual and fires in `save`, leaving no
    checkpoint; 'save' restores the counter in place."""
    from repro_torch.core import resilience
    from repro_torch.train import checkpoint

    knobs = {"spill": dict(spill="always", spill_dir=str(tmp_path / "bins")),
             "faults": dict(faults=resilience.FaultPlan("ckpt_write")),
             "save": {}}[case]
    cfg = fabsp.DAKCConfig(k=13, chunk_reads=8, **knobs)
    reads = torch.randint(0, 4, (16, 30), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(1))
    kc = fabsp.KmerCounter(cfg, num_pes=1, device="cpu")
    kc.update(reads)
    res, st = kc.finalize()
    assert int(res.counts.sum()) == st.raw_kmers == 16 * 18
    ck = str(tmp_path / "ckpt")
    if case == "faults":
        with pytest.raises(resilience.InjectedFault):
            kc.save(ck)
        assert checkpoint.latest_step(ck) is None
        return
    kc.save(ck)
    kc2 = fabsp.KmerCounter.restore(ck, cfg, num_pes=1, device="cpu")
    res2, _ = kc2.finalize()
    assert torch.equal(res2.unique, res.unique)
    assert torch.equal(res2.counts, res.counts)


def test_config_validation_matches_jax():
    from repro.core import fabsp as jfabsp

    for bad in (dict(partition_impl="sort"), dict(store_capacity=0),
                dict(store_slack=0), dict(spill="sometimes"),
                dict(spill="auto"), dict(store_sizing="exact")):
        with pytest.raises(ValueError):
            jfabsp.DAKCConfig(k=13, **bad)
        with pytest.raises(ValueError):
            fabsp.DAKCConfig(k=13, **bad)
    assert [f.name for f in fabsp.dataclasses.fields(fabsp.DAKCConfig)] == \
        [f.name for f in fabsp.dataclasses.fields(jfabsp.DAKCConfig)]


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", alone / "chip_smoke.py")
    for cwd in (ROOT, alone):
        proc = subprocess.run(
            [sys.executable, str(Path(cwd) / "chip_smoke.py")],
            capture_output=True, text=True, cwd=cwd, timeout=300,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
