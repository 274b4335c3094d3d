"""Device meshes (counterpart of `repro.launch.mesh`).

Single pod: (data=16, model=16) = 256 devices. Multi-pod: (pod=2, data=16,
model=16) = 512; the `pod` axis is pure data parallelism (optionally with
the compressed gradient all-reduce of `train/compression.py`), `data` and
`model` the FSDP and tensor-parallel axes of `models/sharding.py`.

`Mesh` is what the sharding rules and `elastic.remesh` read of
`jax.sharding.Mesh`: a numpy object array of devices, its `axis_names`,
the ordered `shape` and the `size`. The port's train step runs on one
device, so nothing here places a tensor (ROADMAP.md section 1, item 13).
The functions touch no device state when the module is imported.
"""

from __future__ import annotations

import collections
import math
from typing import Optional, Sequence, Tuple

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
