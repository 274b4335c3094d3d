"""The port's sharding rules against the JAX package's, on the CPU.

The port keeps one dict per layer, so a block leaf's spec is the JAX
spec of its slot with the stacked `num_periods` None removed. Parameter
shapes are the JAX package's `eval_shape` tree at full config size,
unstacked per layer as `convert` unstacks real arrays (nothing is
allocated); reduced configs check that this layout is the port's own
`init_params` tree. Meshes are the production shapes, (data=16,
model=16) and (pod=2, data=16, model=16), built by the port's `remesh`
over integer stand-ins for devices (the rules read only `.shape`).
"""

import jax
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced
from repro.models import model as jmodel
from repro.models import sharding as jshd
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import convert, sharding
from repro_torch.models import model as tmodel
from repro_torch.train import elastic


class _FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


MESHES = {"single_pod": (256, None), "multi_pod": (512, 2)}


def _meshes(name):
    n, pods = MESHES[name]
    port = elastic.remesh(list(range(n)), 16, pods=pods)
    return port, _FakeMesh(port.shape)


def _shapes(jcfg, cfg):
    """(JAX eval_shape tree, the port-layout tree of the same shapes)."""
    jshapes = jax.eval_shape(
        lambda: jmodel.init_params(jax.random.PRNGKey(0), jcfg))
    return jshapes, convert.unstack_blocks(
        jshapes, cfg, lambda s: s,
        lambda s, g: jax.ShapeDtypeStruct(s.shape[1:], s.dtype))


_SHAPES = {}


def _full_shapes(arch):
    if arch not in _SHAPES:
        _SHAPES[arch] = _shapes(jget_config(arch), get_config(arch))
    return _SHAPES[arch]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _jax_path(path, cfg):
    """The JAX tree's path of a port leaf, and whether it is stacked."""
    if path[0] != "blocks":
        return path, False
    return ("blocks", path[1] % len(cfg.period)) + path[2:], True


def _unstacked(spec, stacked):
    spec = tuple(spec)
    if stacked and spec:
        assert spec[0] is None, spec
        return spec[1:]
    return spec


def test_fit_drops_indivisible_axes():
    m = _FakeMesh({"data": 16, "model": 16})
    for spec, shape, want in (
            (("data", "model", None), (3584, 8, 256), ("data", None, None)),
            (("model", "data"), (50280, 1024), (None, "data")),
            (("model", "data"), (163840, 2048), ("model", "data"))):
        assert tuple(sharding._fit(sharding.P(*spec), shape, m)) == want
        assert tuple(jshd._fit(JP(*spec), shape, m)) == want


def test_fit_handles_missing_axes_and_rank():
    m = _FakeMesh({"data": 16, "model": 16})
    for spec, shape, want in ((("stage",), (8,), (None,)),
                              (("data", "model"), (64,), ("data",)),
                              (("data",), (64, 32, 16), ("data", None, None)),
                              ((("data", "model"),), (512,), (("data",
                                                               "model"),)),
                              ((("data", "model"),), (64,), (None,))):
        assert tuple(sharding._fit(sharding.P(*spec), shape, m)) == want
        assert tuple(jshd._fit(JP(*spec), shape, m)) == want
    assert tuple(sharding._fit(sharding.P("model"), (32,), None)) == \
        ("model",)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_port_layout_is_init_params(arch):
    """The unstacked JAX shapes are the port's own parameter tree."""
    cfg = reduced_config(arch)
    _, shapes = _shapes(jreduced(arch), cfg)
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    got = [(p, tuple(t.shape)) for p, t in tmodel.named_leaves(params)]
    want = [(p, tuple(s.shape)) for p, s in tmodel.named_leaves(shapes)]
    assert got == want
    caches = tmodel.init_caches(cfg, 1, 8, device="cpu")
    specs = sharding.cache_specs(cfg, _meshes("single_pod")[0],
                                 batch_axes=("data",))
    assert [sorted(c) for c in caches] == [sorted(c) for c in specs]


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_jax(arch, mesh_name):
    port_mesh, fake = _meshes(mesh_name)
    cfg = get_config(arch)
    jshapes, shapes = _full_shapes(arch)
    jspecs = jshd.param_specs(jshapes, fake)
    specs = sharding.param_specs(shapes, port_mesh)
    n = 0
    for path, leaf in tmodel.named_leaves(shapes):
        jpath, stacked = _jax_path(path, cfg)
        got = _at(specs, path)
        assert isinstance(got, sharding.PartitionSpec)
        assert tuple(got) == _unstacked(_at(jspecs, jpath), stacked), path
        assert got == sharding.param_spec(path, leaf, port_mesh)
        n += 1
    blocks = jax.tree.leaves(jshapes["blocks"])
    assert n == len(jax.tree.leaves(jshapes)) + len(blocks) * (
        cfg.num_periods - 1)


@pytest.mark.parametrize("seq_axis", [None, "data"])
@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_cache_and_logits_specs_match_jax(arch, mesh_name, seq_axis):
    port_mesh, fake = _meshes(mesh_name)
    cfg, jcfg = get_config(arch), jget_config(arch)
    axes = ("pod", "data") if mesh_name == "multi_pod" else ("data",)
    got = sharding.batch_specs(cfg, batch_axes=axes, seq_axis=seq_axis)
    want = jshd.batch_specs(jcfg, batch_axes=axes, seq_axis=seq_axis)
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}
    assert tuple(sharding.logits_spec(axes, seq_axis)) == \
        tuple(jshd.logits_spec(axes, seq_axis))
    got = sharding.cache_specs(cfg, port_mesh, batch_axes=axes,
                               seq_axis=seq_axis)
    want = jshd.cache_specs(jcfg, fake, batch_axes=axes, seq_axis=seq_axis)
    assert len(got) == cfg.num_layers
    for i, layer in enumerate(got):
        slot = want[i % len(cfg.period)]
        assert sorted(layer) == sorted(slot)
        for name, nt in layer.items():
            assert type(nt)._fields == type(slot[name])._fields
            for g, w in zip(nt, slot[name]):
                assert tuple(g) == _unstacked(w, True)
