"""The port's LM serving path against the JAX package, on the CPU.

Every causal architecture with no frontend, plus llava-next with its
vision patches, reduced and at compute float32, from the JAX package's own
initial parameters carried across by `convert.params_from_jax`: the
prefill's logits and every cache leaf after it against
`repro.models.model.prefill`; three `decode_step`s (fed the same tokens)
against JAX's, logits and caches, and one decode step from JAX's own
prefill caches carried across (`convert.caches_from_jax`, which
`caches_to_numpy` turns back into them exactly); and
`serve_step.generate`'s 8 greedy
tokens bit-equal to JAX's `generate`. The prompt (36 positions) is longer
than the reduced window (32) and than two SSD chunks (16), so the windowed
mask, the chunked scan and its padding all run on the cache path.

llava-next: JAX's `generate` starts decoding at the TEXT prompt's length,
so its first decode step overwrites a cached position and takes the wrong
RoPE position (ROADMAP.md section 3); the port starts at the prefill's
length (patches + text), and its tokens are held to JAX's prefill and
decode_step driven from that position.

Tolerances (f32 on both sides, sums in other orders): logits within 1e-5
of the largest logit's magnitude (rtol 0); cache leaves within 1e-5 of the
leaf's largest magnitude. A bf16 cache under f32 compute (the rounding
trap: attention reads the cache after the write, in the cache's dtype):
bf16 leaves within one bf16 step of the value (2**-7 of it) plus 1e-5 of
the leaf's largest, as f32 values that differ in the last place may round
to neighbouring bf16 values; logits within 1e-4 of the largest, ten times
the f32 bound, which the same run without the rounding misses by far.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jreduced
from repro.models import model as jmodel
from repro.train import serve_step as jss
from repro_torch.configs import reduced_config
from repro_torch.models import convert
from repro_torch.models import model as tmodel
from repro_torch.train import serve_step as tss

ARCHS = ("qwen1.5-0.5b", "gemma2-9b", "minitron-8b", "h2o-danube-3-4b",
         "deepseek-moe-16b", "moonshot-v1-16b-a3b", "mamba2-370m",
         "zamba2-1.2b", "llava-next-mistral-7b")
B, T, MAX_SEQ, DECODES, GEN = 2, 36, 48, 3, 8
LOGIT_TOL, CACHE_TOL = 1e-5, 1e-5


def _inputs(cfg, seed=0):
    """(prompt tokens (B, S) int32, patches or None); S + patches = T."""
    rng = np.random.default_rng(seed)
    n_patch = cfg.frontend.num_patches if cfg.frontend.kind == "vision" else 0
    tok = rng.integers(0, cfg.vocab_size, (B, T - n_patch)).astype(np.int32)
    patches = (rng.normal(size=(B, n_patch, cfg.frontend.frontend_dim))
               .astype(np.float32) if n_patch else None)
    return tok, patches


def _jbatch(tok, patches):
    b = {"tokens": jnp.asarray(tok)}
    if patches is not None:
        b["patches"] = jnp.asarray(patches)
    return b


def _tbatch(tok, patches):
    b = {"tokens": torch.from_numpy(tok).long()}
    if patches is not None:
        b["patches"] = torch.from_numpy(patches)
    return b


def _jax_caches_np(caches):
    """JAX caches -> the same tuple/dict/NamedTuple tree of f32 numpy."""
    return jax.tree.map(lambda a: np.asarray(a, np.float32), caches)


def _dtypes(caches, port):
    """Each (slot, kind, field)'s dtype name; the port's from its first
    period group (every group has the same)."""
    out = []
    for slot in caches:
        for name in sorted(slot):
            for f in slot[name]:
                out.append(str(f.dtype).replace("torch.", "") if port
                           else jnp.dtype(f.dtype).name)
    return out


def _logits_close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    bound = tol * np.abs(want).max()
    assert err <= bound, f"{what}: max err {err:.3e} > {bound:.3e}"
    return err


def _caches_close(got, want, what, bf16=False):
    """Leaf by leaf: every (slot, kind, field) of the stacked caches."""
    assert len(got) == len(want), what
    for slot, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), (what, slot)
        for name in g:
            for field in g[name]._fields:
                a = np.asarray(getattr(g[name], field), np.float64)
                b = np.asarray(getattr(w[name], field), np.float64)
                tag = f"{what} slot {slot} {name}.{field}"
                assert a.shape == b.shape, tag
                bound = CACHE_TOL * max(np.abs(b).max(), 1e-30)
                if bf16:
                    bound = bound + 2.0 ** -7 * np.abs(b)
                err = np.abs(a - b) - bound
                assert err.max() <= 0, f"{tag}: over its bound by " \
                                       f"{err.max():.3e}"


def _run_pair(arch, cache_dtype="float32", gen=True):
    """Prefill, DECODES decode steps and (with `gen`) GEN generated tokens
    through both packages; numpy results, JAX side 'j_*', port 't_*'."""
    kw = dict(compute_dtype="float32")
    jcfg, tcfg = jreduced(arch, **kw), reduced_config(arch, **kw)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                     "cpu")
    tok, patches = _inputs(jcfg)
    out = {}

    jdt = jnp.dtype(cache_dtype)
    jcaches = jmodel.init_caches(jcfg, B, MAX_SEQ, jdt)
    jprefill = jax.jit(lambda p, b, c: jmodel.prefill(p, b, c, jcfg))
    jdecode = jax.jit(lambda p, t, c, i: jmodel.decode_step(p, t, c, i,
                                                            jcfg))
    lg, jcaches = jprefill(jparams, _jbatch(tok, patches), jcaches)
    out["j_prefill"] = np.asarray(lg)
    out["j_prefill_caches"] = _jax_caches_np(jcaches)
    j_prefill_raw = jax.tree.map(np.asarray, jcaches)
    out["j_dtypes"] = [_dtypes(jcaches, False)]
    nxt = np.asarray(jnp.argmax(lg[:, -1], -1))[:, None].astype(np.int32)
    feed, j_steps = [], []
    for i in range(DECODES):
        feed.append(nxt)
        lg, jcaches = jdecode(jparams, jnp.asarray(nxt), jcaches,
                              jnp.int32(T + i))
        j_steps.append((np.asarray(lg), _jax_caches_np(jcaches)))
        out["j_dtypes"].append(_dtypes(jcaches, False))
        nxt = np.asarray(jnp.argmax(lg[:, -1], -1))[:, None].astype(np.int32)
    out["j_steps"] = j_steps

    tdt = getattr(torch, cache_dtype)
    with torch.no_grad():
        caches = tmodel.init_caches(tcfg, B, MAX_SEQ, tdt, device="cpu")
        lg, caches = tmodel.prefill(params, _tbatch(tok, patches), caches,
                                    tcfg)
        out["t_prefill"] = lg.numpy()
        out["t_prefill_caches"] = convert.caches_to_numpy(caches, tcfg)
        out["t_dtypes"] = [_dtypes(caches[:len(tcfg.period)], True)]
        t_steps = []
        for i, f in enumerate(feed):
            lg, caches = tmodel.decode_step(params, torch.from_numpy(f).long(),
                                            caches, T + i, tcfg)
            t_steps.append((lg.numpy(), convert.caches_to_numpy(caches,
                                                                tcfg)))
            out["t_dtypes"].append(_dtypes(caches[:len(tcfg.period)], True))
        out["t_steps"] = t_steps
        carried = convert.caches_from_jax(j_prefill_raw, tcfg, "cpu")
        out["t_carried"] = convert.caches_to_numpy(carried, tcfg)
        out["t_from_jax_caches"] = tmodel.decode_step(
            params, torch.from_numpy(feed[0]).long(), carried, T,
            tcfg)[0].numpy()

    if not gen:
        return out
    if patches is None:
        out["j_gen"] = np.asarray(jss.generate(
            jparams, jnp.asarray(tok), jcfg,
            jss.ServeConfig(max_seq=MAX_SEQ, cache_dtype=cache_dtype), GEN))
    else:
        # JAX's prefill and decode_step from the prefill's length.
        c = jmodel.init_caches(jcfg, B, MAX_SEQ, jdt)
        lg, c = jprefill(jparams, _jbatch(tok, patches), c)
        toks = [jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)]
        for i in range(GEN - 1):
            lg, c = jdecode(jparams, toks[-1], c, jnp.int32(T + i))
            toks.append(jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32))
        out["j_gen"] = np.asarray(jnp.concatenate(toks, axis=1))
    extra = (None if patches is None
             else {"patches": torch.from_numpy(patches)})
    out["t_gen"] = tss.generate(
        params, torch.from_numpy(tok).long(), tcfg,
        tss.ServeConfig(max_seq=MAX_SEQ, cache_dtype=cache_dtype), GEN,
        extra_batch=extra).numpy()
    return out


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(arch, cache_dtype="float32"):
        if (arch, cache_dtype) not in cache:
            cache[(arch, cache_dtype)] = _run_pair(
                arch, cache_dtype, gen=cache_dtype == "float32")
        return cache[(arch, cache_dtype)]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches_match_jax(runs, arch):
    r = runs(arch)
    _logits_close(r["t_prefill"], r["j_prefill"], LOGIT_TOL, "prefill")
    _caches_close(r["t_prefill_caches"], r["j_prefill_caches"], "prefill")
    assert r["t_dtypes"] == r["j_dtypes"]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(runs, arch):
    r = runs(arch)
    for i, ((tl, tc), (jl, jc)) in enumerate(zip(r["t_steps"],
                                                 r["j_steps"])):
        _logits_close(tl, jl, LOGIT_TOL, f"decode step {i}")
        _caches_close(tc, jc, f"decode step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_jax_caches_matches_jax(runs, arch):
    """JAX's prefill caches carried into the port, leaf for leaf, and the
    port's first decode step from them."""
    r = runs(arch)
    for g, w in zip(r["t_carried"], r["j_prefill_caches"]):
        for name in g:
            for field in g[name]._fields:
                np.testing.assert_array_equal(getattr(g[name], field),
                                              getattr(w[name], field))
    _logits_close(r["t_from_jax_caches"], r["j_steps"][0][0], LOGIT_TOL,
                  "decode from JAX's caches")


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_bit_equal_to_jax(runs, arch):
    r = runs(arch)
    assert r["t_gen"].shape == (B, GEN)
    np.testing.assert_array_equal(r["t_gen"], r["j_gen"])


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "zamba2-1.2b"])
def test_bf16_cache_under_f32_compute_matches_jax(runs, arch):
    """The cache rounds k and v (and the SSM state after each decode step)
    to bf16 where the JAX package does; the prefill's SSM states come back
    in the compute dtype, as JAX's do."""
    r, f32 = runs(arch, "bfloat16"), runs(arch)
    err = _logits_close(r["t_prefill"], r["j_prefill"], 10 * LOGIT_TOL,
                        "bf16-cache prefill")
    _caches_close(r["t_prefill_caches"], r["j_prefill_caches"],
                  "bf16-cache prefill", bf16=True)
    for i, ((tl, tc), (jl, jc)) in enumerate(zip(r["t_steps"],
                                                 r["j_steps"])):
        err = max(err, _logits_close(tl, jl, 10 * LOGIT_TOL,
                                     f"bf16-cache decode step {i}"))
        _caches_close(tc, jc, f"bf16-cache decode step {i}", bf16=True)
    # Without the rounding the logits would be the f32 cache's: far
    # outside the bound.
    miss = np.abs(f32["t_steps"][-1][0] - r["j_steps"][-1][0]).max()
    assert miss > 10 * max(err, 1e-30)
    assert r["t_dtypes"] == r["j_dtypes"]
    assert "bfloat16" in r["t_dtypes"][0]


def test_sampled_generate_follows_its_generator():
    """Temperature sampling draws from the torch.Generator given: the same
    seed gives the same tokens, in the vocab."""
    cfg = reduced_config("qwen1.5-0.5b", compute_dtype="float32")
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    tok = torch.from_numpy(_inputs(cfg)[0]).long()
    scfg = tss.ServeConfig(max_seq=MAX_SEQ, temperature=1.0)
    a, b = (tss.generate(params, tok, cfg, scfg, GEN,
                         gen=torch.Generator().manual_seed(5))
            for _ in range(2))
    assert torch.equal(a, b)
    assert a.shape == (B, GEN) and int(a.min()) >= 0 \
        and int(a.max()) < cfg.vocab_size
