"""Parameter and activation partition specs for the production mesh
(counterpart of `repro.models.sharding`).

Scheme: tensor parallelism over `model` (heads, MLP hidden, experts,
vocab), FSDP over `data` on a non-TP axis of every large matrix, pure data
parallelism over `pod`; optimiser moments take their parameter's spec.
Rules match leaf paths, then fit the concrete mesh: a sharded dim whose
size does not divide by its axis size, or whose axis the mesh lacks, falls
back to replication (gemma2's 8 KV heads on a 16-way `model` axis, mamba2's
vocab 50280).

The port keeps one dict per layer (`models/convert.py`), so a
`blocks/<layer>/...` leaf has no stacked `num_periods` axis and takes its
rule's spec as it stands, where the JAX package prefixes a None. Caches are
the port's per-layer list.

Placement. A mesh's elements are ranks of a `torch.distributed` group
(`launch.mesh.MeshGroup`), and a rank holds, of each leaf, the block its
mesh coordinate picks (`param_shardings`: the JAX `NamedSharding`'s
`devices_indices_map`, per coordinate). `shard_params` cuts a full tree
to one rank's tensors, `gather_params` puts the ranks' tensors back
together (saves, tests); with `models/convert.py` they carry the JAX
package's weights onto a rank. `local_config` is the config of one rank's
share of the model, which the sharded train step (`train/sharded.py`)
runs and the dry-run traces.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.models.attention import KVCache
from repro_torch.models.ssm import SSMState


class PartitionSpec(tuple):
    """One entry per leaf dim: a mesh axis name, a tuple of names, or None
    (replicated). Trailing dims past the entries are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

# (path regex, spec of a per-layer leaf).
_RULES: Tuple[Tuple[str, P], ...] = (
    (r"embed/tok$",        P("model", "data")),     # vocab-sharded embedding
    (r"head/w$",           P("model", "data")),
    (r"attn/wq$",          P("data", "model", None)),
    (r"attn/wk$",          P("data", "model", None)),
    (r"attn/wv$",          P("data", "model", None)),
    (r"attn/wo$",          P("model", None, "data")),
    (r"attn/b[qkv]$",      P("model", None)),
    (r"mlp/w[ig]$",        P("data", "model")),
    (r"mlp/wo$",           P("model", "data")),
    (r"moe/router$",       P("data", None)),
    (r"moe/w[ig]$",        P("model", "data", None)),  # experts over model
    (r"moe/wo$",           P("model", "data", None)),
    (r"moe/shared/w[ig]$", P("data", "model")),
    (r"moe/shared/wo$",    P("model", "data")),
    (r"mamba/in_proj$",    P("data", "model")),
    (r"mamba/out_proj$",   P("model", "data")),
    (r"mamba/conv_w$",     P(None, "model")),
    (r"mamba/conv_b$",     P("model")),
    (r"mamba/(a_log|dt_bias|d_skip)$", P("model")),
    (r"frontend/proj$",    P(None, "model")),
)


def _axis_size(mesh: Mesh, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        return math.prod(mesh.shape[a] for a in entry)
    return mesh.shape[entry]


def _fit(spec: P, shape, mesh: Optional[Mesh]) -> P:
    """Trim or pad the spec to the leaf's rank and drop the shardings that
    do not divide or name an axis the mesh lacks."""
    entries = list(spec)[:len(shape)]
    entries += [None] * (len(shape) - len(entries))
    if mesh is not None:
        fixed = []
        for i, e in enumerate(entries):
            if e is None:
                fixed.append(None)
                continue
            names = e if isinstance(e, (tuple, list)) else (e,)
            if any(n not in mesh.shape for n in names):
                fixed.append(None)
                continue
            fixed.append(e if shape[i] % _axis_size(mesh, e) == 0 else None)
        entries = fixed
    return P(*entries)


def param_spec(path: Tuple, leaf, mesh: Optional[Mesh]) -> P:
    """The spec of one leaf at `path` (a tuple of dict keys and list
    indices) with `leaf.shape`."""
    s = "/".join(str(e) for e in path)
    for pat, spec in _RULES:
        if re.search(pat, s):
            return _fit(spec, leaf.shape, mesh)
    return P()  # norms, scalars: replicated


def param_specs(params, mesh: Optional[Mesh] = None):
    """The tree of specs matching `params`, a nest of dicts, lists and
    tuples whose leaves have `.shape` (tensors or shapes alone)."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, path + (i,))
                              for i, v in enumerate(tree))
        return param_spec(path, tree, mesh)
    return walk(params, ())


def batch_specs(cfg: ModelConfig, *, batch_axes: Tuple[str, ...],
                seq_axis: Optional[str] = None) -> dict:
    """Input batch specs. `seq_axis` shards the sequence (a batch of one
    cannot occupy the data axis)."""
    b_ax = batch_axes if len(batch_axes) > 1 else batch_axes[0]
    out = {"tokens": P(b_ax, seq_axis)}
    if cfg.frontend.kind == "vision":
        out["patches"] = P(b_ax, None, None)
    if cfg.frontend.kind == "audio":
        out = {"frames": P(b_ax, seq_axis, None)}
    return out


def cache_specs(cfg: ModelConfig, mesh: Mesh, *,
                batch_axes: Tuple[str, ...],
                seq_axis: Optional[str] = None) -> List[dict]:
    """Specs of `model.init_caches`' per-layer list.

    KV layout (B, Hkv, S, hd): heads shard over `model` when divisible;
    otherwise the cache sequence takes `model` (the distributed
    flash-decode regime). With `seq_axis` the sequence is sharded over it
    too."""
    b_ax = (batch_axes if len(batch_axes) > 1 else batch_axes[0]) \
        if seq_axis is None else None
    heads_div = cfg.num_kv_heads % mesh.shape["model"] == 0
    head_ax = "model" if heads_div else None
    kv_seq_ax = seq_axis if heads_div else (
        (seq_axis, "model") if seq_axis is not None else "model")
    kv = KVCache(k=P(b_ax, head_ax, kv_seq_ax, None),
                 v=P(b_ax, head_ax, kv_seq_ax, None))
    # SSM head counts are multiples of 16 in every arch of the registry.
    sstate = SSMState(conv=P(b_ax, "model", None),
                      ssm=P(b_ax, "model", None, None))
    out = []
    for i in range(cfg.num_layers):
        kind = cfg.period[i % len(cfg.period)]
        c = {}
        if kind in ("mamba", "mamba_shared_attn"):
            c["ssm"] = sstate
        if kind != "mamba":
            c["kv"] = kv
        out.append(c)
    return out


def logits_spec(batch_axes: Tuple[str, ...],
                seq_axis: Optional[str] = None) -> P:
    b_ax = batch_axes if len(batch_axes) > 1 else batch_axes[0]
    if seq_axis is not None:
        return P(None, seq_axis, "model")
    return P(b_ax, None, "model")


# --- one rank's share --------------------------------------------------------

def model_div(mesh: Mesh, n: int) -> int:
    """n over the `model` axis where it divides (the fitted spec's rule),
    else n whole."""
    m = mesh.shape.get("model", 1)
    return n // m if n % m == 0 else n


@dataclasses.dataclass(frozen=True)
class ShardedSSM(SSMConfig):
    """One device's share of a Mamba2 layer: the inner width, and with it
    the heads, over `shards`."""
    shards: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model // self.shards


def local_config(cfg: ModelConfig, mesh: Mesh) -> ModelConfig:
    """The config of one device's share of the model: heads, MLP hidden
    and vocabulary over the `model` axis where they divide (the fitted
    specs' rule); the KV heads too where they divide, else the KV heads
    the local query heads read; experts (with top-k and a capacity factor
    that keep each local expert's global capacity) and the Mamba2 inner
    width and heads likewise."""
    m = mesh.shape.get("model", 1)
    h = model_div(mesh, cfg.num_heads)
    hkv = (cfg.num_kv_heads // m if cfg.num_kv_heads % m == 0
           else max(1, h * cfg.num_kv_heads // cfg.num_heads))
    over = dict(num_heads=h, num_kv_heads=hkv,
                head_dim=cfg.resolved_head_dim,
                d_ff=model_div(mesh, cfg.d_ff) if cfg.d_ff else 0,
                vocab_size=model_div(mesh, cfg.vocab_size))
    if cfg.moe is not None:
        mo = cfg.moe
        e = model_div(mesh, mo.num_experts)
        k = min(mo.top_k, e)
        # each local expert keeps the global capacity: cap = N K / E * cf
        over["moe"] = dataclasses.replace(
            mo, num_experts=e, top_k=k,
            capacity_factor=mo.capacity_factor * mo.top_k * e
            / (mo.num_experts * k))
    if cfg.ssm is not None:
        s = cfg.ssm
        if s.d_inner(cfg.d_model) // s.headdim % m == 0:
            over["ssm"] = ShardedSSM(**dataclasses.asdict(s), shards=m)
    return dataclasses.replace(cfg, **over)


def kv_head_range(cfg: ModelConfig, mesh: Mesh, model_index: int
                  ) -> Tuple[int, int]:
    """[lo, hi) of the KV heads that model rank `model_index` projects:
    its own block where the KV heads divide the `model` axis, else the
    heads its query heads read (`local_config`), which must then be a
    whole block of query heads per KV head or of KV heads per rank."""
    m = mesh.shape.get("model", 1)
    if cfg.num_kv_heads % m == 0:
        n = cfg.num_kv_heads // m
        return model_index * n, (model_index + 1) * n
    h_loc = model_div(mesh, cfg.num_heads)
    group = cfg.num_heads // cfg.num_kv_heads
    if h_loc % group and group % h_loc:
        raise ValueError(
            f"{h_loc} query heads a rank do not map onto whole KV heads "
            f"({group} query heads a KV head)")
    lo = model_index * h_loc // group
    return lo, lo + max(1, h_loc // group)


class LeafSharding:
    """Where a leaf of `shape` lies under `spec` on `mesh`: the
    counterpart of a JAX `NamedSharding` bound to a shape."""

    def __init__(self, mesh: Mesh, spec: P, shape):
        self.mesh, self.spec, self.shape = mesh, spec, tuple(shape)

    def indices(self, coord: Dict[str, int]) -> Tuple[slice, ...]:
        """The block the device at mesh coordinate `coord` ({axis: index})
        holds: one slice a dim, slice(None) where the dim is whole (the
        JAX `devices_indices_map` entry)."""
        out = []
        for dim, size in enumerate(self.shape):
            e = self.spec[dim] if dim < len(self.spec) else None
            if e is None:
                out.append(slice(None))
                continue
            idx, n = 0, 1
            for a in (e if isinstance(e, (tuple, list)) else (e,)):
                idx = idx * self.mesh.shape[a] + coord[a]
                n *= self.mesh.shape[a]
            out.append(slice(idx * (size // n), (idx + 1) * (size // n)))
        return tuple(out)

    def axes(self) -> Tuple[str, ...]:
        """The mesh axes that shard this leaf."""
        names = []
        for e in self.spec:
            if e is not None:
                names += list(e) if isinstance(e, (tuple, list)) else [e]
        return tuple(names)



def param_shardings(params, mesh: Mesh):
    """The tree of `LeafSharding`s of `params` (the JAX package's
    `param_shardings`: each leaf's fitted spec on `mesh`)."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, path + (i,))
                              for i, v in enumerate(tree))
        return LeafSharding(mesh, param_spec(path, tree, mesh), tree.shape)
    return walk(params, ())


def _map2(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map2(fn, v, o) for v, o in zip(tree, other))
    return fn(tree, other)


def shard_params(params, mesh: Mesh, coord: Dict[str, int]):
    """A full parameter-shaped tree -> the block of every leaf the rank at
    `coord` holds (contiguous copies)."""
    return _map2(lambda t, sh: t[sh.indices(coord)].contiguous(), params,
                 param_shardings(params, mesh))


def gather_params(local, full_shapes, mesh: Mesh, group):
    """Every rank's `local` tree (`shard_params`' blocks) -> the full
    leaves on every rank, in one all-gather over `group` (a `core.dist`
    group whose rank r is mesh element r). `full_shapes` is a
    parameter-shaped tree of the full leaves (tensors or shapes)."""
    from repro_torch.core import dist as rdist
    shardings = param_shardings(full_shapes, mesh)
    leaves = []
    _map2(lambda t, sh: leaves.append((t, sh)), local, shardings)
    flat = torch.cat([t.reshape(-1).float() for t, _ in leaves])
    every = rdist.gather_rows(flat[None], group)       # (world, n)
    coords = {}
    for pos in np.ndindex(*mesh.devices.shape):
        coords[int(mesh.devices[pos])] = dict(zip(mesh.axis_names, pos))
    out, off = [], 0
    for t, sh in leaves:
        full = torch.empty(sh.shape, dtype=t.dtype, device=t.device)
        n = t.numel()
        for r in range(every.shape[0]):
            full[sh.indices(coords[r])] = every[r, off:off + n].view(
                t.shape).to(t.dtype)
        out.append(full)
        off += n
    it = iter(out)
    return _map2(lambda t, sh: next(it), local, shardings)
