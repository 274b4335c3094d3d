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
the port's per-layer list. Placing leaves by these specs needs more than
one device, which the port does not drive yet (ROADMAP.md section 1, item
13); the specs are plain data.
"""

from __future__ import annotations

import math
import re
from typing import List, Optional, Tuple

from repro_torch.configs.base import ModelConfig
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
