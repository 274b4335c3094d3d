"""Sorted-run sweeps (the Accumulate phase): run-start flags, and the
fused run-boundary and run-total sweep, which can also compact the runs
into (unique keys, counts).

Counterparts of `repro.kernels.segment_count.segment_boundaries_pallas`
and `segment_accumulate_pallas`; the CUDA kernels are in
`csrc/segment_count.cu`. Rows of a (P, n) tensor are independent sorted
streams.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

BLOCK = 1024  # must equal kBlock in the source

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "segment_boundaries_launch": (_P, _I64, _I64, _I64, _P, _P),
    "segment_accumulate_launch": (_P, _P, _I64, _I64, _I64, ctypes.c_int,
                                  _P, _P, _P, _P, _P, _P, _P, _P),
}
# A row's run count and slots are int32.
MAX_ROW = (1 << 31) - 1


# A launch's tags differ from those of the 2**32 - 1 launches before it on
# its state; the wrapper renews a state well before that.
_STATE_LAUNCHES = 1 << 31


class _LookBack:
    """The accumulate kernel's state on one stream: the epoch and ticket
    word, and one tag, aggregate and inclusive prefix per tile, all uint64
    carried as int64. The word and the tags start at zero; every launch
    leaves them fit for the next, so nothing is cleared between
    launches."""

    def __init__(self, tiles: int, device):
        self.ctr = torch.zeros(1, dtype=torch.int64, device=device)
        self.tags = torch.zeros(tiles, dtype=torch.int64, device=device)
        self.agg = torch.empty(tiles, dtype=torch.int64, device=device)
        self.inc = torch.empty(tiles, dtype=torch.int64, device=device)
        self.launches = 0


# (device index, stream) -> its look-back state: launches on two streams
# never share tickets or tags.
_STATE: Dict[Tuple[int, int], _LookBack] = {}


@functools.cache
def _lib():
    lib = build.load("segment_count", _SIGNATURES)
    if lib.segment_block() != BLOCK:
        raise RuntimeError("csrc/segment_count.cu block differs from BLOCK")
    return lib


def segment_boundaries_cuda(sorted_keys: torch.Tensor,
                            sentinel_val: int) -> torch.Tensor:
    """(P, n) sorted int64 words -> (P, n) bool run-start flags."""
    build.check_arg(sorted_keys, "sorted_keys", torch.int64, 2)
    rows, n = sorted_keys.shape
    is_new = torch.empty((rows, n), dtype=torch.bool,
                         device=sorted_keys.device)
    if is_new.numel():
        build.check_status(_lib().segment_boundaries_launch(
            sorted_keys.data_ptr(), rows, n, sentinel_val, is_new.data_ptr(),
            build.stream_ptr(sorted_keys)), "segment_boundaries")
    return is_new


def segment_accumulate_cuda(sorted_keys: torch.Tensor,
                            weights: Optional[torch.Tensor],
                            sentinel_val: int, compact: bool = False):
    """(P, n) sorted int64 words + int32 weights (None: every valid word
    weighs 1), in one launch ->
    - compact=False: (is_new, is_end, run_totals), bool, bool, int32, each
      (P, n);
    - compact=True: (unique (P, n) int64, counts (P, n) int32, num_unique
      (P,) int32), each row's runs in order from slot 0, the slots past
      num_unique holding the sentinel and 0."""
    build.check_arg(sorted_keys, "sorted_keys", torch.int64, 2)
    if weights is not None:
        build.check_arg(weights, "weights", torch.int32, 2,
                        sorted_keys.device)
        if weights.shape != sorted_keys.shape:
            raise ValueError("weights and keys differ in shape")
    rows, n = sorted_keys.shape
    if n > MAX_ROW:
        raise ValueError(f"a row of {n} elements > {MAX_ROW}")
    dev = sorted_keys.device
    if compact:
        outs = (torch.full((rows, n), sentinel_val, dtype=torch.int64,
                           device=dev),
                torch.zeros((rows, n), dtype=torch.int32, device=dev),
                torch.empty((rows,), dtype=torch.int32, device=dev))
    else:
        outs = (torch.empty((rows, n), dtype=torch.bool, device=dev),
                torch.empty((rows, n), dtype=torch.bool, device=dev),
                torch.empty((rows, n), dtype=torch.int32, device=dev))
    if not rows:
        return outs
    if not n:
        if compact:
            outs[2].zero_()
        return outs
    tiles = rows * -(-n // BLOCK)
    stream = build.stream_ptr(sorted_keys)
    key = (dev.index, stream)
    state = _STATE.get(key)
    if (state is None or state.tags.numel() < tiles
            or state.launches >= _STATE_LAUNCHES):
        state = _STATE[key] = _LookBack(max(tiles, 1024), dev)
    state.launches += 1
    build.check_status(_lib().segment_accumulate_launch(
        sorted_keys.data_ptr(),
        None if weights is None else weights.data_ptr(), rows, n,
        sentinel_val, int(compact), state.ctr.data_ptr(),
        state.tags.data_ptr(), state.agg.data_ptr(), state.inc.data_ptr(),
        *(o.data_ptr() for o in outs), stream), "segment_accumulate")
    return outs
