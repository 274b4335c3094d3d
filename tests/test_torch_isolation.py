"""The port stands alone: it imports no JAX and nothing of `repro`, runs on
the card unless the caller asks for the CPU, refuses what is outside its
slice, and `chip_smoke.py` fails without a card or without the repo.

Some tests keep the names they had while the port refused a setting, and
now check that it runs:
- `test_lm_families_outside_the_slice_raise[...]`: the MoE, SSM, hybrid,
  VLM and audio archs initialise and train a step;
- `test_attention_with_a_kv_cache_raises`: the KV cache path fills the
  cache and gives the no-cache output;
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
from repro_torch.core import (aggregation, analytical_model, bsp, countstore,
                              dist, encoding, encoding128, fabsp, minimizer,
                              ngram, owner, query, resilience, serial, sort,
                              spill)
from repro_torch.configs import dakc_kc
from repro_torch.data import corpus_stats, genome
from repro_torch.launch import kc_dryrun
from repro_torch.kernels import build, hash_table, ops, radix_partition, ref
from repro_torch.kernels import minimizer as kminimizer
from repro_torch.kernels import flash_attention, segment_count
from repro_torch.kernels import kmer_extract, radix_hist
from repro_torch.configs import get_config, reduced_config
from repro_torch.data import tokens
from repro_torch.launch import kc_serve, mesh, serve, train
from repro_torch.train import checkpoint
from repro_torch.models import (attention, convert, frontends, layers, model,
                                moe, parallel, sharding, ssm)
from repro_torch.train import (compression, elastic, optimizer, pipeline,
                               serve_step, sharded, train_step)
import tempfile
with tempfile.TemporaryDirectory() as ck:
    out = train.train("qwen1.5-0.5b", reduced=True, steps=2, batch=2, seq=16,
                      device="cpu", attn_impl="flash_train", ckpt_dir=ck,
                      ckpt_every=1)
    assert checkpoint.latest_step(ck) == 2
assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
m = elastic.remesh(list(range(48)), 16, pods=2)
assert dict(m.shape) == {"data": 3, "model": 16}
assert mesh.data_axes_of(mesh.make_test_mesh((2, 2, 2), ("pod", "data",
                                                         "model"),
                                             list(range(8)))) == ("pod",
                                                                  "data")
assert not hasattr(sharded, "check_shardable")
lcfg = sharding.local_config(get_config("gemma2-9b"), m)
assert (lcfg.num_heads, lcfg.num_kv_heads) == (1, 1)
specs = sharding.param_specs(out["params"], m)
assert specs["embed"]["tok"] == sharding.P("model", None)
w = {"w": torch.ones(2, 4)}
y = pipeline.pipeline_forward(lambda p, x: x * p["w"], w, torch.ones(4, 4),
                              num_microbatches=2)
assert torch.equal(y, torch.ones(4, 4))
g, e = compression.compress_psum(w, compression.init_error_feedback(w),
                                 frac=0.5, sharded=True)
assert g["w"].shape == (4,) and e["w"].shape == (2, 4)
srv = serve.serve("zamba2-1.2b", reduced=True, batch=2, prompt_len=8, gen=4,
                  device="cpu")
assert tuple(srv["tokens"].shape) == (2, 4)
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
toks = tokens.batch_for_step(tokens.TokenPipelineConfig(
    vocab_size=151_936, batch_size=16, seq_len=24), 0)
cs = corpus_stats.corpus_ngram_stats(toks, 151_936, 3, num_pes=2,
                                     chunk_rows=8, device="cpu")
assert cs.total == 16 * 22 and cs.top_ngrams.shape == (16, 3)
acc = encoding128.count_kmers_serial128(
    torch.from_numpy(genome.poly_a_reads(8, 70, seed=1)), 47)
assert int(acc.counts.sum()) == 8 * 24
assert analytical_model.predict(
    analytical_model.Workload(1 << 23, 150, dakc_kc.config().k, 1),
    analytical_model.H100_SXM)["total"] > 0
kc_dryrun.run_skew("polya", "hashed", "prefix", device="cpu")
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print("LEAKED", bad)
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LEAKED []" in proc.stdout, proc.stdout


def test_dry_run_imports_no_jax_and_touches_no_cuda(tmp_path):
    """The dry-run's modules and CLIs run on the host: no JAX, nothing of
    `repro`, and CUDA never initialised."""
    code = rf"""
import sys
import torch
from repro_torch.kernels import meta
from repro_torch.launch import dryrun, kc_dryrun, roofline, specs
recs = dryrun.main(["--arch", "mamba2-370m", "--shape", "decode_32k",
                    "--mesh", "both", "--out", r"{tmp_path}"])
assert all("memory" in r for r in recs)
table = roofline.main(["--dir", r"{tmp_path}"])
assert table.count("mamba2-370m") == 2
rec = kc_dryrun.main(["--reads", "16384", "--chunk-reads", "64",
                      "--receiver", "stream", "--out", ""])
assert rec["memory"]["temp_gb"] > 0
params, opt = dryrun.abstract_state(dryrun.get_config("qwen1.5-0.5b"),
                                    dryrun.abstract_mesh(False))
assert opt.step.tensor.dtype == torch.int32 and opt.step.spec == ()
assert params["embed"]["tok"].tensor.device.type == "meta"
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print("LEAKED", bad, "CUDA", torch.cuda.is_initialized())
"""
    proc = _run(code, env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LEAKED [] CUDA False" in proc.stdout, proc.stdout


def test_one_rank_group_goes_through_all_to_all_single(tmp_path,
                                                      monkeypatch):
    """A gloo group of world 1 takes the same collective as any other: no
    world == 1 shortcut back to the stacked transpose."""
    import numpy as np
    import torch.distributed as tdist
    from repro_torch.core import dist
    from repro_torch.data import genome
    reads = genome.sample_reads(genome.ReadSetSpec(
        genome_bases=512, n_reads=64, read_len=30, seed=1))
    cfg = fabsp.DAKCConfig(k=13, chunk_reads=8)
    want, want_st = fabsp.count_kmers(reads, cfg, num_pes=2, device="cpu")
    calls = []
    real = tdist.all_to_all_single

    def counted(*a, **kw):
        calls.append(a[1].shape)
        return real(*a, **kw)

    monkeypatch.setattr(tdist, "all_to_all_single", counted)
    g = dist.init_group("gloo", "file://" + str(tmp_path / "store"), 0, 1)
    try:
        res, st = fabsp.count_kmers(reads, cfg, num_pes=2, group=g)
    finally:
        g.destroy()
    # 4 scan steps of the 'dual' format, 3 lanes each (a NORMAL word lane,
    # a HEAVY word and count pair)
    assert len(calls) == 4 * 3
    assert torch.equal(res.unique, want.unique)
    assert torch.equal(res.counts, want.counts)
    assert np.array_equal([float(x) for x in st],
                          [float(x) for x in want_st])


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


def test_counter_surface_needs_a_card():
    from repro_torch.core import ngram
    from repro_torch.data import corpus_stats
    from repro_torch.launch import kc_dryrun

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs on it")
    toks = torch.zeros((16, 30), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ngram.count_ngrams(toks, 100, 2, num_pes=1, chunk_rows=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        corpus_stats.corpus_ngram_stats(toks, 100, 2, num_pes=1,
                                        chunk_rows=8)
    proc = _run("from repro_torch.launch import kc_dryrun as d; "
                "d.main(['--inject'])")
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert "inject sweep OK" not in proc.stdout


def test_lm_training_needs_a_card(tmp_path):
    from repro_torch.launch import train

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.train("qwen1.5-0.5b", reduced=True, steps=1, batch=2, seq=16)
    ck = tmp_path / "ckpt"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.train("qwen1.5-0.5b", reduced=True, steps=1, batch=2, seq=16,
                    ckpt_dir=str(ck), ckpt_every=1)
    assert not ck.exists()


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "moonshot-v1-16b-a3b",
                                  "mamba2-370m", "zamba2-1.2b",
                                  "llava-next-mistral-7b", "hubert-xlarge"])
def test_lm_families_outside_the_slice_raise(arch):
    """Named for when these families raised; they now run: init_params,
    and `launch.train` for the token-batch archs (MoE and SSM, as the JAX
    launcher trains) or one train step on a batch with the frontend's
    inputs (llava's patches, hubert's frames and labels)."""
    from repro_torch.configs import reduced_config
    from repro_torch.launch import train
    from repro_torch.models import model
    from repro_torch.train import optimizer, train_step

    cfg = reduced_config(arch)
    params = model.init_params(cfg, seed=0, device="cpu")
    if cfg.frontend.kind == "none":
        out = train.train(arch, reduced=True, steps=1, batch=2, seq=16,
                          device="cpu")
        assert all(map(torch.isfinite, map(torch.tensor, out["losses"])))
        return
    g = torch.Generator().manual_seed(0)
    f = cfg.frontend
    if f.kind == "audio":
        batch = {"frames": torch.randn((2, 16, f.frontend_dim), generator=g),
                 "labels": torch.randint(0, cfg.vocab_size, (2, 16),
                                         generator=g)}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                         generator=g),
                 "patches": torch.randn((2, f.num_patches, f.frontend_dim),
                                        generator=g)}
    step = train_step.make_train_step(cfg, train_step.TrainConfig())
    _, _, m = step(params, optimizer.init(params), batch)
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])


def test_attention_with_a_kv_cache_raises():
    """Named for when prefill and decode raised; the cache path now runs:
    a prefill through an f32 cache gives the no-cache attention's output
    and leaves k and v in the cache's first positions, the rest zero."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import attention

    cfg = reduced_config("qwen1.5-0.5b", compute_dtype="float32")
    p = attention.init_attention(torch.Generator().manual_seed(0), cfg,
                                 "cpu")
    x = torch.randn((1, 4, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    cache = attention.init_cache(cfg, 1, 8, torch.float32, device="cpu")
    y, c = attention.attention(p, x, cfg=cfg, window=None,
                               positions=torch.arange(4), cache=cache,
                               cache_index=0)
    want, none = attention.attention(p, x, cfg=cfg, window=None,
                                     positions=torch.arange(4))
    assert c is cache and none is None
    torch.testing.assert_close(y, want, rtol=0, atol=1e-5)
    assert bool(cache.k[:, :, :4].abs().sum() > 0)
    assert not bool(cache.k[:, :, 4:].any() or cache.v[:, :, 4:].any())


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
