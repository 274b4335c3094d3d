"""Sharded serving (`serve_step.generate(group=...)`) over (data, model)
meshes of gloo ranks, against the JAX package and the port's one-process
`generate`, on the CPU.

- One launcher per world (2 and 4 ranks, `file://` store, 60 s timeout)
  serves reduced configs at f32 compute and cache from the JAX package's
  initial parameters (carried across by `convert.params_from_jax`, each
  rank taking `sharding.shard_params`' blocks): a prompt of 36 positions
  (llava: 8 patches and 28 tokens), 8 greedy tokens, a cache of 96
  positions, so a sequence-sharded cache has blocks that no position has
  reached yet (a partial softmax whose maximum is -inf).
  - qwen1.5-0.5b at (1, 2), (2, 1) and (2, 2): head-parallel decode;
  - qwen at batch 1 on (2, 2): the cache sequence over `data`;
  - gemma2-9b with 2 KV heads at (1, 4): the sequence over `model`, with
    its windows and soft caps;
  - deepseek-moe-16b at (1, 2), batch 2 (the engine over `model`) and
    batch 1 (decode batches below the shard count take GShard), at a
    capacity factor of 8, so no expert drops a token in either path;
  - zamba2-1.2b and llava-next-mistral-7b at (2, 2), and llava at batch
    1 on (2, 2) (its one KV head: the sequence over data and model).
  Greedy tokens equal JAX's `generate` (llava: JAX's `prefill` and
  `decode_step` from the prefill's length, as test_torch_serve_lm.py
  drives them), every rank returns the same tokens, and every step's
  logits are within 1e-5 of the largest of the port's one-process
  `generate`.
- The vocab-parallel greedy pick breaks ties to the lowest index, as
  torch.argmax, within a rank's columns and across ranks; sampling draws
  the same token on every rank from generators seeded alike.
- `make_prefill_step(group=)` and `make_decode_step(group=)`, each with
  its own rank model, give `generate`'s greedy tokens; a VLM prefill
  without patches raises KeyError, as the one-process model does.
- Each rank's caches have the local block shapes of
  `sharding.cache_specs` (the Mamba2 conv state: the rank's channels).
- In one process: the flash-decode combine of `ref.mha_partial` blocks,
  empty blocks among them, against `ref.mha_ref` over the whole cache,
  and the greedy pick's (max, lowest index) reduction against
  torch.argmax.
"""

import dataclasses
import os
import subprocess
import sys
import traceback

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.core import dist
from repro_torch.kernels import ref
from repro_torch.launch import train as train_lib
from repro_torch.launch.mesh import Mesh, MeshGroup, device_array, mesh_group
from repro_torch.models import model as model_lib
from repro_torch.models import parallel
from repro_torch.models import sharding as shd
from repro_torch.train import serve_step as tss

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
T, MAX_SEQ, GEN = 36, 96, 8
LOGIT_TOL = 1e-5
NO_DROP = dict(capacity_factor=8.0)
# name -> (arch, ModelConfig overrides, MoEConfig overrides or None)
MODELS = {
    "qwen": ("qwen1.5-0.5b", {}, None),
    "gemma2": ("gemma2-9b", dict(num_kv_heads=2), None),
    "deepseek": ("deepseek-moe-16b", {}, NO_DROP),
    "zamba2": ("zamba2-1.2b", {}, None),
    "llava": ("llava-next-mistral-7b", {}, None),
}
# world -> [(model, batch, (data, model))]
RUNS = {
    2: [("qwen", 2, (1, 2)), ("qwen", 2, (2, 1)), ("deepseek", 2, (1, 2)),
        ("deepseek", 1, (1, 2))],
    4: [("qwen", 2, (2, 2)), ("qwen", 1, (2, 2)), ("gemma2", 2, (1, 4)),
        ("zamba2", 2, (2, 2)), ("llava", 2, (2, 2)), ("llava", 1, (2, 2))],
}


def overrides(name, reduced):
    arch, over, moe = MODELS[name]
    out = dict(compute_dtype="float32", **over)
    if moe is not None:
        out["moe"] = dataclasses.replace(reduced(arch).moe, **moe)
    return out


def _cfg(name):
    return reduced_config(MODELS[name][0], **overrides(name, reduced_config))


def _scfg(temperature=0.0):
    return tss.ServeConfig(max_seq=MAX_SEQ, temperature=temperature,
                           cache_dtype="float32")


def inputs(cfg, batch, seed=0):
    """(prompt tokens (B, S) int64, patches or None); S + patches = T."""
    rng = np.random.default_rng(seed)
    n_patch = cfg.frontend.num_patches if cfg.frontend.kind == "vision" else 0
    tok = rng.integers(0, cfg.vocab_size, (batch, T - n_patch))
    patches = (rng.normal(size=(batch, n_patch, cfg.frontend.frontend_dim))
               .astype(np.float32) if n_patch else None)
    return tok, patches


def _generate(name, batch, params, mg=None, temperature=0.0, gen=None):
    """(tokens (B, GEN), logits (GEN, B, V)) of `generate`."""
    cfg = _cfg(name)
    tok, patches = inputs(cfg, batch)
    extra = None if patches is None else {"patches": torch.from_numpy(
        patches)}
    lg = []
    out = tss.generate(params, torch.from_numpy(tok), cfg,
                       _scfg(temperature), GEN, group=mg, gen=gen,
                       extra_batch=extra, logits=lg)
    return out.numpy(), torch.stack(lg).numpy()


def _ties(mg) -> np.ndarray:
    """The vocab-parallel greedy pick of logits with ties within a rank's
    columns and across ranks, beside torch.argmax of the whole rows."""
    rm = tss.rank_model(_cfg("gemma2"), _scfg(), mg, 4)
    v = rm.cfg.vocab_size
    full = torch.zeros(4, v)
    full[0, [5, v - 7]] = 3.0             # two ranks' columns
    full[1, [v // 4 + 2, v // 4 + 3]] = 2.0   # one rank's columns
    full[3, v - 1] = 1.0                  # the last column alone
    n = v // rm.M
    local = full[:, rm.mi * n:(rm.mi + 1) * n][:, None]
    return np.stack([rm.greedy(local)[:, 0].numpy(),
                     torch.argmax(full, -1).numpy()])


def _steps(name, batch, params, mg) -> np.ndarray:
    """The greedy tokens of `make_prefill_step` and `make_decode_step` on
    the group, each building its own rank model."""
    cfg, scfg = _cfg(name), _scfg()
    tok, _ = inputs(cfg, batch)
    prefill = tss.make_prefill_step(cfg, scfg, group=mg, batch=batch)
    decode = tss.make_decode_step(cfg, scfg, group=mg, batch=batch)
    rm = tss.rank_model(cfg, scfg, mg, batch)
    caches = rm.init_caches(torch.float32, "cpu")
    with torch.no_grad():
        lg, caches = prefill(params, {"tokens": rm.rows(
            torch.from_numpy(tok))}, caches)
        out = [rm.greedy(lg)]
        for i in range(GEN - 1):
            nxt, _, caches = decode(params, out[-1], caches, T + i)
            out.append(nxt)
    return rm.join_rows(torch.cat(out, dim=1)).numpy()


def _no_patches(name, batch, params, mg) -> bool:
    """Whether a VLM's prefill without patches raises KeyError."""
    cfg = _cfg(name)
    tok, _ = inputs(cfg, batch)
    rm = tss.rank_model(cfg, _scfg(), mg, batch)
    try:
        with torch.no_grad():
            rm.prefill(params, {"tokens": rm.rows(torch.from_numpy(tok))},
                       rm.init_caches(torch.float32, "cpu"))
    except KeyError:
        return True
    return False


def rank_main(rank: int, world: int, tmp: str) -> None:
    """One rank: join the gloo group, serve its meshes, write rank 0's."""
    torch.set_num_threads(1)
    g = dist.init_group("gloo", "file://" + os.path.join(tmp, "store"),
                        rank, world, "cpu")
    shared = os.path.join(tmp, "..", "shared")
    out = {}
    try:
        for name, batch, (d, m) in RUNS[world]:
            tag = f"{name}_b{batch}_{d}x{m}"
            mg = mesh_group(train_lib.build_mesh(m, range(world)), g)
            full = torch.load(os.path.join(shared, name + ".pt"))
            mine = shd.shard_params(full, mg.mesh, mg.coord)
            toks, lg = _generate(name, batch, mine, mg)
            every = dist.all_gather_object(toks.tolist(), g)
            out[tag + "_tokens"] = toks
            out[tag + "_logits"] = lg
            out[tag + "_agree"] = np.array(all(e == every[0]
                                               for e in every))
            if tag == "qwen_b2_2x2":
                toks, _ = _generate(name, batch, mine, mg, temperature=1.0,
                                    gen=torch.Generator().manual_seed(7))
                every = dist.all_gather_object(toks.tolist(), g)
                out["sampled"] = toks
                out["sampled_agree"] = np.array(all(e == every[0]
                                                    for e in every))
            if tag == "gemma2_b2_1x4":
                out["ties"] = _ties(mg)
            if tag == "qwen_b2_1x2":
                out["steps"] = _steps(name, batch, mine, mg)
            if tag == "llava_b2_2x2":
                out["no_patches"] = np.array(_no_patches(name, batch, mine,
                                                         mg))
            mg.destroy()
        dist.barrier(g)
    except Exception:
        traceback.print_exc()
        raise
    finally:
        if rank == 0:
            np.savez(os.path.join(tmp, "rank0.npz"), **out)
        g.destroy()


def _launch(world: int, tmp: str) -> None:
    torch.multiprocessing.spawn(rank_main, args=(world, tmp), nprocs=world,
                                join=True)


# --- the pytest side ------------------------------------------------------

def _jax_tokens(name, batch, jparams):
    """JAX's greedy tokens: `generate`, or for a VLM its prefill and
    decode_step from the prefill's length."""
    import jax
    import jax.numpy as jnp
    from repro.configs import reduced_config as jreduced
    from repro.models import model as jmodel
    from repro.train import serve_step as jss
    jcfg = jreduced(MODELS[name][0], **overrides(name, jreduced))
    tok, patches = inputs(jcfg, batch)
    tok = jnp.asarray(tok, jnp.int32)
    if patches is None:
        return np.asarray(jss.generate(
            jparams, tok, jcfg, jss.ServeConfig(
                max_seq=MAX_SEQ, cache_dtype="float32"), GEN))
    prefill = jax.jit(lambda p, b, c: jmodel.prefill(p, b, c, jcfg))
    decode = jax.jit(lambda p, t, c, i: jmodel.decode_step(p, t, c, i, jcfg))
    c = jmodel.init_caches(jcfg, batch, MAX_SEQ, jnp.float32)
    lg, c = prefill(jparams, {"tokens": tok,
                              "patches": jnp.asarray(patches)}, c)
    toks = [jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)]
    for i in range(GEN - 1):
        lg, c = decode(jparams, toks[-1], c, jnp.int32(T + i))
        toks.append(jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32))
    return np.asarray(jnp.concatenate(toks, axis=1))


def _cases():
    return [(w, name, b, dm) for w, rs in sorted(RUNS.items())
            for name, b, dm in rs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank 0's outputs by world, the one-process (tokens, logits) and
    JAX's tokens by (model, batch))."""
    import jax
    from repro.configs import reduced_config as jreduced
    from repro.models import model as jmodel
    from repro_torch.models import convert
    base = tmp_path_factory.mktemp("serve")
    shared = str(base / "shared")
    os.makedirs(shared)
    jparams, params = {}, {}
    for name, (arch, _, _) in MODELS.items():
        jp = jmodel.init_params(jax.random.PRNGKey(0),
                                jreduced(arch, **overrides(name, jreduced)))
        jparams[name] = jp
        params[name] = convert.params_from_jax(
            jax.tree.map(np.asarray, jp), _cfg(name), "cpu")
        torch.save(params[name], os.path.join(shared, name + ".pt"))
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs, dirs = {}, {}
    for world in RUNS:
        d = str(base / f"world{world}")
        os.makedirs(d)
        dirs[world] = d
        procs[world] = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(world), d],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    try:
        one, jax_toks = {}, {}
        for _, name, b, _ in _cases():
            if (name, b) in one:
                continue
            with torch.no_grad():
                one[(name, b)] = _generate(name, b, params[name])
            jax_toks[(name, b)] = _jax_tokens(name, b, jparams[name])
    finally:
        logs = {w: p.communicate(timeout=600)[0] for w, p in procs.items()}
    for world, p in procs.items():
        assert p.returncode == 0, logs[world][-6000:]
    ranks = {w: dict(np.load(os.path.join(dirs[w], "rank0.npz")))
             for w in RUNS}
    return ranks, one, jax_toks


@pytest.mark.parametrize("world,name,batch,dm", _cases())
def test_sharded_greedy_tokens_equal_jax(runs, world, name, batch, dm):
    out = runs[0][world]
    tag = f"{name}_b{batch}_{dm[0]}x{dm[1]}"
    assert out[tag + "_tokens"].shape == (batch, GEN)
    np.testing.assert_array_equal(out[tag + "_tokens"],
                                  runs[2][(name, batch)])
    assert bool(out[tag + "_agree"])


@pytest.mark.parametrize("world,name,batch,dm", _cases())
def test_sharded_logits_match_one_process(runs, world, name, batch, dm):
    out = runs[0][world]
    tag = f"{name}_b{batch}_{dm[0]}x{dm[1]}"
    toks, lg = runs[1][(name, batch)]
    np.testing.assert_array_equal(out[tag + "_tokens"], toks)
    got = out[tag + "_logits"]
    assert got.shape == lg.shape
    err = np.abs(got.astype(np.float64) - lg).max()
    assert err <= LOGIT_TOL * np.abs(lg).max(), err


def test_vocab_parallel_greedy_breaks_ties_as_argmax(runs):
    got, want = runs[0][4]["ties"]
    np.testing.assert_array_equal(got, want)
    assert want[0] == 5 and want[2] == 0


def test_sampling_draws_the_same_token_on_every_rank(runs):
    out = runs[0][4]
    assert bool(out["sampled_agree"])
    s = out["sampled"]
    assert s.shape == (2, GEN) and s.min() >= 0 \
        and s.max() < _cfg("qwen").vocab_size


def test_public_steps_on_a_group_equal_generate(runs):
    out = runs[0][2]
    np.testing.assert_array_equal(out["steps"], out["qwen_b2_1x2_tokens"])


def test_vlm_prefill_without_patches_raises(runs):
    assert bool(runs[0][4]["no_patches"])


@pytest.mark.parametrize("blocks,index,band", [
    (4, 23, {}),                                  # the last block empty
    (4, 35, dict(window=4, softcap=20.0)),        # the first three empty
    (3, 0, {}),                                   # one key in all
    (1, 39, dict(causal=True)),                   # one block: no combine
])
def test_flash_decode_combine_matches_mha_ref(blocks, index, band):
    rng = np.random.default_rng(blocks * 100 + index)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((2, 4, 1, 8), (2, 2, 36, 8), (2, 2, 36, 8)))
    n = -(-k.shape[2] // blocks)
    parts = [ref.mha_partial(q, k[:, :, lo:lo + n], v[:, :, lo:lo + n],
                             q_offset=index, k_offset=lo, **band)
             for lo in range(0, k.shape[2], n)]
    m, l, o = (torch.stack(t) for t in zip(*parts))
    got = parallel.flash_decode_combine(m, l, o)
    want = ref.mha_ref(q, k, v, q_offset=index, **band)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()


def test_pick_lowest_breaks_ties_as_argmax():
    vals = torch.tensor([[3.0, 2.0, 0.0], [3.0, 1.0, 0.0],
                         [1.0, 2.0, 0.0]])          # (N, B)
    idx = torch.tensor([[10.0, 7.0, 4.0], [5.0, 3.0, 2.0],
                        [0.0, 9.0, 8.0]])
    got = parallel.pick_lowest(torch.stack([vals, idx], -1))
    assert got.tolist() == [5, 7, 2]


def _fake_mesh_group(mesh: Mesh, pos) -> MeshGroup:
    """The `MeshGroup` of the rank at mesh position `pos`, its axis groups
    stand-ins that carry rank and size alone (no process group)."""
    coord = dict(zip(mesh.axis_names, pos))
    cpu = torch.device("cpu")

    def grp(rank, world):
        return dist.Group(pg=None, backend="gloo", rank=rank, world=world,
                          device=cpu)
    axis = {a: grp(coord[a], mesh.shape[a]) for a in mesh.axis_names}
    return MeshGroup(mesh=mesh, group=grp(int(mesh.devices[pos]),
                                          mesh.size),
                     coord=coord, axis=axis)


@pytest.mark.parametrize("world,name,batch,dm", _cases())
def test_rank_caches_are_cache_specs_blocks(world, name, batch, dm):
    cfg = _cfg(name)
    mesh = Mesh(device_array(range(dm[0] * dm[1]), dm), ("data", "model"))
    split = batch % dm[0] == 0
    specs = shd.cache_specs(cfg, mesh, batch_axes=("data",),
                            seq_axis=None if split else "data")
    full = model_lib.init_caches(cfg, batch, MAX_SEQ, torch.float32,
                                 device="meta")
    s = cfg.ssm
    for pos in np.ndindex(*dm):
        mg = _fake_mesh_group(mesh, pos)
        got = tss.rank_model(cfg, _scfg(), mg, batch).init_caches(
            torch.float32, "cpu")
        for layer, (g, f, sp) in enumerate(zip(got, full, specs)):
            assert sorted(g) == sorted(f)
            for kind in g:
                for field in g[kind]._fields:
                    shape = tuple(getattr(g[kind], field).shape)
                    whole = getattr(f[kind], field).shape
                    block = shd.LeafSharding(mesh, getattr(sp[kind], field),
                                             whole).indices(mg.coord)
                    want = tuple(len(range(*sl.indices(n)))
                                 for sl, n in zip(block, whole))
                    if field == "conv":
                        # the rank's x channels, then all of B and C
                        d_in = s.d_inner(cfg.d_model)
                        want = (want[0], d_in // dm[1]
                                + 2 * s.n_groups * s.d_state, want[2])
                    assert shape == want, (layer, kind, field, pos)


if __name__ == "__main__":
    _launch(int(sys.argv[1]), sys.argv[2])
