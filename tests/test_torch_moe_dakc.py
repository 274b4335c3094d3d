"""The port's DAKC MoE dispatch (EP shards as a leading tensor dimension)
against the JAX package's shard_map engine, on the CPU.

The JAX side runs `moe_block` on a (1, 4) ('data', 'model') host mesh of
four forced devices, in one subprocess, with reduced deepseek-moe-16b
(8 experts, top-2, compute float32): EP over the four 'model' shards, each
with its own capacity. The port runs `moe_block(..., ep_shards=4)` on the
same parameters and tokens. Outputs within 1e-5 of the largest magnitude;
the aux loss (the shards' mean) 1e-6 relative; the dropped share equal.
Both at capacity_factor 8 (no drops) and 0.5 (drops). Then the engine
against the port's own GShard path at capacity_factor 8, as
`examples/moe_dispatch_demo.py` holds the JAX engines to each other; and
a batch that does not split into 4 shards (a decode step) takes the
GShard path, as the JAX rule does.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_parity import run_jax
from repro.configs import reduced_config as jreduced
from repro.models import moe as jmoe
from repro_torch.configs import reduced_config
from repro_torch.models import moe as tmoe

SHARDS = 4
FACTORS = {"no_drops": 8.0, "drops": 0.5}
TOL = 1e-5

JAX_BODY = """
import dataclasses
from jax.sharding import Mesh
from repro.configs import reduced_config
from repro.models import moe
cfg = reduced_config("deepseek-moe-16b", compute_dtype="float32")
mesh = Mesh(np.array(jax.devices()).reshape(1, 4), ("data", "model"))
p = {k: jnp.asarray(I[k]) for k in ("router", "wi", "wg", "wo")}
p["shared"] = {k: jnp.asarray(I["shared_" + k]) for k in ("wi", "wg", "wo")}
for name, factor in (("no_drops", 8.0), ("drops", 0.5)):
    c = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=factor))
    y, aux = moe.moe_block(p, jnp.asarray(I["x"]), cfg=c, mesh=mesh,
                           data_axes=("data",))
    O[name + "_y"] = y
    O[name + "_aux"] = aux.load_balance_loss
    O[name + "_drop"] = aux.dropped_frac
"""


def _cfg(factor):
    cfg = reduced_config("deepseek-moe-16b", compute_dtype="float32")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=factor))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    jcfg = jreduced("deepseek-moe-16b", compute_dtype="float32")
    p = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(0), jcfg))
    x = (np.random.default_rng(0).normal(size=(4, 32, jcfg.d_model)) * 0.5
         ).astype(np.float32)
    inputs = {"x": x, **{k: p[k] for k in ("router", "wi", "wg", "wo")},
              **{"shared_" + k: v for k, v in p["shared"].items()}}
    want = run_jax(tmp_path_factory.mktemp("dakc"), JAX_BODY, inputs,
                   devices=4)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()
          if k != "shared"}
    tp["shared"] = {k: torch.from_numpy(np.array(v))
                    for k, v in p["shared"].items()}
    return tp, torch.from_numpy(x), want


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    bound = TOL * np.abs(want).max()
    assert err <= bound, f"{what}: max err {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("name", sorted(FACTORS))
def test_stacked_dakc_matches_jax_shard_map(case, name):
    tp, x, want = case
    y, aux = tmoe.moe_block(tp, x, cfg=_cfg(FACTORS[name]),
                            ep_shards=SHARDS)
    _close(y.numpy(), want[name + "_y"], f"{name} y")
    assert float(aux.dropped_frac) == float(want[name + "_drop"])
    assert (float(aux.dropped_frac) > 0) == (name == "drops")
    assert float(aux.load_balance_loss) == pytest.approx(
        float(want[name + "_aux"]), rel=1e-6)


def test_stacked_dakc_equals_gshard_without_drops(case):
    tp, x, _ = case
    cfg = _cfg(8.0)
    yd, auxd = tmoe.moe_block(tp, x, cfg=cfg, ep_shards=SHARDS)
    yg, auxg = tmoe.moe_block(tp, x, cfg=cfg)
    _close(yd.numpy(), yg.numpy(), "dakc vs gshard")
    assert float(auxd.dropped_frac) == float(auxg.dropped_frac) == 0.0


def test_tiny_batches_take_the_gshard_path(case):
    """2 tokens do not make 4 shards of one token: the GShard path, bit
    for bit."""
    tp, x, _ = case
    cfg = _cfg(1.25)
    xs = x[:2, :1]
    yd, auxd = tmoe.moe_block(tp, xs, cfg=cfg, ep_shards=SHARDS)
    yg, auxg = tmoe.moe_block(tp, xs, cfg=cfg)
    assert torch.equal(yd, yg)
    assert float(auxd.load_balance_loss) == float(auxg.load_balance_loss)
