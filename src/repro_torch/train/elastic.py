"""Elastic scaling and straggler detection (counterpart of
`repro.train.elastic`).

- `remesh`: after a node failure, the largest legal mesh over the
  surviving devices. The `model` extent is kept (the tensor-parallel
  degree is baked into the layer math); `data` (and `pod`) shrink to what
  the survivors support, and `scale_microbatches` raises the gradient
  accumulation to keep the global batch. A checkpoint holds full logical
  arrays (`train/checkpoint.py`), so restoring onto the new mesh places
  the same leaves again.
- `StragglerWatchdog`: an EWMA step-time monitor. A step slower than
  mean + k_sigma * sigma is flagged; `trip_after` flags in a row trip it,
  and the caller acts (`launch/train.py` checkpoints early). It reads the
  host clock, so on CUDA the caller synchronises the device before
  `step_end`.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Sequence, Tuple

from repro_torch.launch.mesh import Mesh, device_array


def remesh(devices: Sequence, model_parallel: int,
           pods: Optional[int] = None) -> Mesh:
    """The largest (pod?, data, model) mesh over `devices` (devices, or
    the ranks of a group, which `launch.mesh.mesh_group` then gives their
    axis sub-groups): `model` fixed, `data` as large as whole rows of
    `model_parallel` devices allow, the devices past the last whole row
    dropped."""
    devs = list(devices)
    rows = len(devs) // model_parallel
    if rows == 0:
        raise ValueError(
            f"{len(devs)} devices cannot host model_parallel="
            f"{model_parallel}")
    if pods is not None and rows % pods == 0 and pods > 1:
        return Mesh(device_array(devs, (pods, rows // pods, model_parallel)),
                    ("pod", "data", "model"))
    return Mesh(device_array(devs, (rows, model_parallel)), ("data", "model"))


def scale_microbatches(old_data_rows: int, new_data_rows: int,
                       old_num_microbatches: int) -> int:
    """Keep the global batch across a shrink: fewer data rows, more
    gradient-accumulation microbatches."""
    scale = old_data_rows / new_data_rows
    return max(1, math.ceil(old_num_microbatches * scale))


@dataclasses.dataclass
class StragglerWatchdog:
    k_sigma: float = 3.0
    ewma_alpha: float = 0.05
    warmup_steps: int = 5
    trip_after: int = 3           # consecutive flags before tripping

    _mean: float = 0.0
    _var: float = 0.0
    _n: int = 0
    _consecutive: int = 0
    _last_start: Optional[float] = None
    events: List[Tuple[int, float]] = dataclasses.field(default_factory=list)

    def step_start(self) -> None:
        self._last_start = time.perf_counter()

    def step_end(self, step: int) -> bool:
        """True when the watchdog trips (sustained straggling)."""
        if self._last_start is None:
            raise RuntimeError("step_end before step_start")
        dt = time.perf_counter() - self._last_start
        self._n += 1
        if self._n <= self.warmup_steps:
            self._mean = dt if self._n == 1 else (
                self._mean + (dt - self._mean) / self._n)
            self._var = max(self._var, (dt - self._mean) ** 2)
            return False
        sigma = math.sqrt(self._var) if self._var > 0 else self._mean * 0.1
        slow = dt > self._mean + self.k_sigma * sigma
        if slow:
            self._consecutive += 1
            self.events.append((step, dt))
        else:
            self._consecutive = 0
            a = self.ewma_alpha
            self._mean = (1 - a) * self._mean + a * dt
            self._var = (1 - a) * self._var + a * (dt - self._mean) ** 2
        return self._consecutive >= self.trip_after
