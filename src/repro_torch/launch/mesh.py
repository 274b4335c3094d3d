"""Device meshes (counterpart of `repro.launch.mesh`).

Single pod: (data=16, model=16) = 256 devices. Multi-pod: (pod=2, data=16,
model=16) = 512; the `pod` axis is pure data parallelism (optionally with
the compressed gradient all-reduce of `train/compression.py`), `data` and
`model` the FSDP and tensor-parallel axes of `models/sharding.py`.

`Mesh` is what the sharding rules and `elastic.remesh` read of
`jax.sharding.Mesh`: a numpy object array of devices, its `axis_names`,
the ordered `shape` and the `size`. Its elements may be devices or the
ranks of a `torch.distributed` group: `mesh_group` gives a rank of such a
mesh its coordinate and one sub-group for each axis (the ranks of its
line along that axis), which the sharded train step's collectives run
over. The functions touch no device state when the module is imported.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """An n-d array of devices with one name per axis."""

    def __init__(self, devices, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d devices, axes {axis_names}")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        return collections.OrderedDict(zip(self.axis_names,
                                           self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size


def device_array(devices: Sequence, shape: Tuple[int, ...]) -> np.ndarray:
    """The first prod(shape) of `devices` as an object array of `shape`
    (each device an element, whatever its type)."""
    need = math.prod(shape)
    devs = list(devices)[:need]
    if len(devs) < need:
        raise ValueError(f"{len(devs)} devices for a mesh of {shape}")
    arr = np.empty(need, dtype=object)
    for i, d in enumerate(devs):
        arr[i] = d
    return arr.reshape(shape)


def cuda_devices() -> list:
    """Every CUDA device of this process; raises without one (the port
    runs on the card unless the caller passes its devices)."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the caller "
            "passes its devices")
    return [torch.device("cuda", i) for i in range(n)]


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    """(16, 16) or, with `multi_pod`, (2, 16, 16) over `devices` (every
    CUDA device by default). Raises RuntimeError with fewer devices than
    the mesh needs, as the JAX function does: on one card it always
    raises."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    devs = list(devices if devices is not None else cuda_devices())
    if len(devs) < need:
        raise RuntimeError(
            f"need {need} devices for mesh {shape}; have {len(devs)}")
    return Mesh(device_array(devs, shape), axes)


def make_test_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
                   devices: Optional[Sequence] = None) -> Mesh:
    """Small meshes for unit tests over the first prod(shape) devices."""
    devs = list(devices if devices is not None else cuda_devices())
    return Mesh(device_array(devs, shape), axes)


def data_axes_of(mesh: Mesh) -> Tuple[str, ...]:
    """Batch-bearing axes: ('pod', 'data') on multi-pod, ('data',) else."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


@dataclasses.dataclass
class MeshGroup:
    """One rank's view of a mesh whose elements are the ranks 0..world-1
    of `group` (a `core.dist.Group`): its coordinate and, for each axis,
    the `core.dist.Group` of the ranks that share its other coordinates."""
    mesh: Mesh
    group: Any
    coord: Dict[str, int]
    axis: Dict[str, Any]
    _pgs: list = dataclasses.field(default_factory=list, repr=False)

    def destroy(self) -> None:
        """Tear the axis sub-groups down (not `group`)."""
        import torch.distributed as tdist
        for pg in self._pgs:
            tdist.destroy_process_group(pg)
        self._pgs = []


def mesh_group(mesh: Mesh, group) -> MeshGroup:
    """The `MeshGroup` of this rank. Every rank of `group` must call it
    with the same mesh: it makes one sub-group for every line of every
    axis, in the same order on every rank (`torch.distributed.new_group`
    is collective over the whole group, so a rank that skipped one would
    hang the others until the group's timeout)."""
    import torch.distributed as tdist
    from repro_torch.core import dist
    ranks = np.vectorize(int, otypes=[object])(mesh.devices)
    if sorted(ranks.reshape(-1).tolist()) != list(range(group.world)):
        raise ValueError(f"a mesh of {mesh.size} ranks over a group of "
                         f"{group.world}")
    pos = tuple(int(i) for i in np.argwhere(ranks == group.rank)[0])
    coord = dict(zip(mesh.axis_names, pos))
    axis, pgs = {}, []
    for ax_i, name in enumerate(mesh.axis_names):
        lines = np.moveaxis(ranks, ax_i, -1).reshape(-1, ranks.shape[ax_i])
        for line in lines:
            line = [int(r) for r in line]
            pg = tdist.new_group(ranks=line, backend=group.backend)
            pgs.append(pg)
            if group.rank in line:
                axis[name] = dist.Group(
                    pg=pg, backend=group.backend,
                    rank=line.index(group.rank), world=len(line),
                    device=group.device)
    return MeshGroup(mesh=mesh, group=group, coord=coord, axis=axis,
                     _pgs=pgs)
