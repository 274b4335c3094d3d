"""The port's input specs (`repro_torch.launch.specs`) against the JAX
package's `repro.launch.specs`, for every arch x shape cell the dry-run
traces, on the (16, 16) production mesh.

The JAX side runs in one subprocess with 256 forced host devices (it
builds `ShapeDtypeStruct`s with `NamedSharding`s and compiles nothing).
Shapes, dtypes and fitted specs must be equal, exactly. The caches are
the port's per-layer list, so layer l's leaf is compared with its period
slot's stacked JAX leaf without the leading `num_periods` axis, in shape
and in spec.
"""

import json

import pytest
import torch

from _torch_parity import run_jax
from repro_torch.configs import ARCH_IDS, SHAPES, applicable_shapes
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import data_axes_of

CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES
         if applicable_shapes(get_config(a))[s][0]]

JAX_BODY = """
import json
from repro.configs import ARCH_IDS, SHAPES, applicable_shapes, get_config
from repro.launch import specs as jspecs
from repro.launch.mesh import data_axes_of, make_production_mesh

mesh = make_production_mesh()
axes = data_axes_of(mesh)

def leaf(sd):
    spec = None if sd.sharding is None else [
        list(e) if isinstance(e, tuple) else e for e in sd.sharding.spec]
    return [list(sd.shape), str(sd.dtype), spec]

out = {}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    for shape, (ok, _) in applicable_shapes(cfg).items():
        if not ok:
            continue
        kw = jspecs.input_specs(cfg, SHAPES[shape], mesh, axes)
        cell = {}
        if "batch" in kw:
            for k, v in kw["batch"].items():
                cell["batch/" + k] = leaf(v)
        else:
            cell["tokens"] = leaf(kw["tokens"])
            cell["cache_index"] = leaf(kw["cache_index"])
            for slot, c in enumerate(kw["caches"]):
                for name, nt in c.items():
                    for field, sd in zip(nt._fields, nt):
                        cell[f"caches/{slot}/{name}/{field}"] = leaf(sd)
        out[arch + "|" + shape] = cell
O["json"] = np.frombuffer(json.dumps(out).encode(), np.uint8)
"""


@pytest.fixture(scope="module")
def jax_specs(tmp_path_factory):
    out = run_jax(tmp_path_factory.mktemp("specs"), JAX_BODY, devices=256)
    return json.loads(out["json"].tobytes().decode())


def _leaf(a: specs.Abstract):
    spec = None if a.spec is None else [
        list(e) if isinstance(e, tuple) else e for e in a.spec]
    return [list(a.tensor.shape), str(a.tensor.dtype).replace("torch.", ""),
            spec]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_jax(jax_specs, arch, shape):
    cfg = get_config(arch)
    mesh = dryrun.abstract_mesh(False)
    kw = specs.input_specs(cfg, SHAPES[shape], mesh, data_axes_of(mesh))
    want = jax_specs[arch + "|" + shape]
    if "batch" in kw:
        got = {"batch/" + k: _leaf(v) for k, v in kw["batch"].items()}
        assert got == want
        for v in kw["batch"].values():
            assert v.tensor.device.type == "meta"
        return
    assert _leaf(kw["tokens"]) == want["tokens"]
    assert _leaf(kw["cache_index"]) == want["cache_index"]
    n_slots = len(cfg.period)
    assert len(kw["caches"]) == cfg.num_layers
    seen = set()
    for layer, c in enumerate(kw["caches"]):
        slot = layer % n_slots
        for name, nt in c.items():
            for field, a in zip(nt._fields, nt):
                key = f"caches/{slot}/{name}/{field}"
                shp, dt, spec = want[key]
                assert shp[0] == cfg.num_periods
                assert _leaf(a) == [shp[1:], dt, spec[1:]], (layer, key)
                assert spec[0] is None
                assert a.tensor.device.type == "meta"
                seen.add(key)
    assert seen == {k for k in want if k.startswith("caches/")}


def test_no_mesh_leaves_specs_out():
    cfg = get_config("llava-next-mistral-7b")
    kw = specs.input_specs(cfg, SHAPES["train_4k"], None, ("data",))
    assert kw["batch"]["tokens"].tensor.shape == (
        256, 4096 - cfg.frontend.num_patches)
    assert kw["batch"]["patches"].tensor.dtype == torch.float32
    assert all(v.spec is None for v in kw["batch"].values())
