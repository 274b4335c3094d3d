"""Input specs of every (arch x shape) cell: `meta` tensors at the cell's
global shapes, in the JAX package's dtypes, each with its PartitionSpec
(counterpart of `repro.launch.specs`).

`Abstract(tensor, spec)` stands in for `jax.ShapeDtypeStruct(shape, dtype,
sharding=NamedSharding(mesh, spec))`: the tensor is on `meta`, so it has a
shape and a dtype and no storage. For a VLM the text tokens shrink by
`num_patches`, so the backbone sequence is the cell's seq_len; audio gets
frame embeddings and frame labels. Decode caches come from
`model.init_caches` on `meta`, each leaf's spec from
`sharding.cache_specs` fitted to the leaf (`sharding._fit`); the caches are
the port's per-layer list, where the JAX package stacks each period slot
over a leading `num_periods` axis.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as model_lib
from repro_torch.models import sharding as shd
from repro_torch.models.sharding import PartitionSpec as P

META = torch.device("meta")


class Abstract(NamedTuple):
    """A meta tensor and its PartitionSpec (None without a mesh)."""
    tensor: torch.Tensor
    spec: Optional[P]


def _abstract(shape, dtype, mesh: Optional[Mesh], spec: Optional[P]
              ) -> Abstract:
    return Abstract(torch.empty(shape, dtype=dtype, device=META),
                    None if mesh is None else spec)


def train_inputs(cfg: ModelConfig, cell: ShapeCell, mesh: Optional[Mesh],
                 batch_axes: Tuple[str, ...]) -> Dict[str, Abstract]:
    b, s = cell.global_batch, cell.seq_len
    specs = shd.batch_specs(cfg, batch_axes=batch_axes)
    out = {}
    if cfg.frontend.kind == "audio":
        out["frames"] = _abstract((b, s, cfg.frontend.frontend_dim),
                                  torch.float32, mesh, specs["frames"])
        out["labels"] = _abstract((b, s), torch.int32, mesh,
                                  P(*tuple(specs["frames"])[:2]))
        return out
    n_text = s - (cfg.frontend.num_patches
                  if cfg.frontend.kind == "vision" else 0)
    out["tokens"] = _abstract((b, n_text), torch.int32, mesh,
                              specs["tokens"])
    if cfg.frontend.kind == "vision":
        out["patches"] = _abstract(
            (b, cfg.frontend.num_patches, cfg.frontend.frontend_dim),
            torch.float32, mesh, specs["patches"])
    return out


def decode_inputs(cfg: ModelConfig, cell: ShapeCell, mesh: Optional[Mesh],
                  batch_axes: Tuple[str, ...], seq_axis: Optional[str]):
    """(tokens, caches, cache_index) for one decode step against a seq_len
    cache. The caches are the per-layer list of `model.init_caches` with
    each leaf an `Abstract`."""
    b, s = cell.global_batch, cell.seq_len
    caches = model_lib.init_caches(cfg, b, s, torch.bfloat16, device=META)
    cspecs = (None if mesh is None else
              shd.cache_specs(cfg, mesh, batch_axes=batch_axes,
                              seq_axis=seq_axis))

    def attach(leaf, spec):
        return Abstract(leaf, None if spec is None
                        else shd._fit(spec, leaf.shape, mesh))

    caches = [{name: type(c)(*(attach(leaf, None if cspecs is None
                                      else cspecs[i][name][j])
                               for j, leaf in enumerate(c)))
               for name, c in layer.items()}
              for i, layer in enumerate(caches)]
    tok_spec = (P(batch_axes if len(batch_axes) > 1 else batch_axes[0], None)
                if cell.global_batch > 1 else P(None, None))
    tokens = _abstract((b, 1), torch.int32, mesh, tok_spec)
    index = Abstract(torch.empty((), dtype=torch.int32, device=META), None)
    return tokens, caches, index


def input_specs(cfg: ModelConfig, cell: ShapeCell, mesh: Optional[Mesh],
                batch_axes: Tuple[str, ...]) -> dict:
    """Dispatch per cell kind: the keyword arguments of the traced step."""
    if cell.kind in ("train", "prefill"):
        return {"batch": train_inputs(cfg, cell, mesh, batch_axes)}
    seq_axis = "data" if cell.global_batch == 1 else None
    tokens, caches, index = decode_inputs(cfg, cell, mesh, batch_axes,
                                          seq_axis)
    return {"tokens": tokens, "caches": caches, "cache_index": index}
