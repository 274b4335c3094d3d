"""Processing elements across the ranks of a `torch.distributed` group.

The JAX package runs one PE per device under `shard_map`; the port's
stacked path holds all P PEs as the leading dimension of every tensor on
one device, and each `all_to_all` is a transpose. With a group, the P PEs
are spread over the group's ranks instead: PE p lives on rank
p // local_pes, so each rank holds a contiguous block of `local_pes` PEs
as its leading dimension, and every exchange is one
`dist.all_to_all_single` call per lane. Entry points take `group=None`
(the stacked path, unchanged) or the `Group` that `init_group` returns.

- `exchange`: the 1d tiled all_to_all. Each local source PE's (P, ...)
  destination-major tiles go out; each local destination PE gets (P, ...)
  tiles in source-major order, the JAX receive order.
- `hop`: one hop of the 2d (rows, cols) grid (PE p at (p // cols,
  p % cols)), among the PEs of a row ('col') or of a column ('row'): one
  `all_to_all_single` over the whole group whose split sizes are zero for
  ranks outside the row or column.
- `all_sum`, `gather_rows`, `barrier`: the reductions the
  retry loop, the queries and the BSP rounds need;
  `all_gather_object` and `broadcast_object`: the host-side agreements of
  the counter's checkpoints and spill manifests (segment lists, a save's
  outcome).

Backends: 'gloo' takes CPU tensors, 'nccl' CUDA tensors with rank r on
cuda:{local_rank}. A tensor on the other kind of device raises; nothing is
staged through the host, and a one-rank group goes through the same
collective calls as any other.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
from typing import Optional, Tuple

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(seconds=60)


class PeerFailure(RuntimeError):
    """Raised on the ranks whose own work succeeded when another rank of
    the group failed the same step (a checkpoint write, a spilled batch):
    every rank then stops at the same point."""


def nccl_device(local_rank: int, device_count: int) -> torch.device:
    """The card of an NCCL rank: cuda:{local_rank}, which must exist."""
    if not 0 <= local_rank < device_count:
        raise ValueError(
            f"NCCL rank with local_rank {local_rank} needs a card of its "
            f"own, but this host has {device_count}: NCCL refuses two "
            f"ranks on one GPU")
    return torch.device(f"cuda:{local_rank}")


@dataclasses.dataclass(frozen=True)
class Group:
    """A process group as the port's entry points take it."""
    pg: Optional[dist.ProcessGroup]   # None: the default group
    backend: str
    rank: int
    world: int
    device: torch.device

    def pes(self, num_pes: int) -> "PEGroup":
        """This group holding `num_pes` PEs, `num_pes // world` a rank."""
        if num_pes < 1 or num_pes % self.world:
            raise ValueError(
                f"{num_pes} PEs do not split over {self.world} ranks "
                f"(num_pes must be a multiple of the group's world size)")
        return PEGroup(group=self, num_pes=num_pes,
                       local_pes=num_pes // self.world)

    def destroy(self) -> None:
        """Tear the process group down (the default one when pg is None)."""
        dist.destroy_process_group(self.pg)


@dataclasses.dataclass(frozen=True)
class PEGroup:
    """P PEs over the ranks of a `Group`: PE p on rank p // local_pes."""
    group: Group
    num_pes: int
    local_pes: int

    @property
    def pg(self):
        return self.group.pg

    @property
    def backend(self) -> str:
        return self.group.backend

    @property
    def rank(self) -> int:
        return self.group.rank

    @property
    def world(self) -> int:
        return self.group.world

    @property
    def device(self) -> torch.device:
        return self.group.device

    @property
    def first_pe(self) -> int:
        """Global index of this rank's first PE."""
        return self.rank * self.local_pes


def init_group(backend: str, init_method: str, rank: int, world: int,
               device=None, *, local_rank: Optional[int] = None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> Group:
    """Join the default process group and return it as a `Group`.

    init_method: a rendezvous URL, best a `file://` path under a temporary
    directory (parallel runs cannot collide on it); timeout: how long a
    collective waits for a peer, so a rank that dies fails its peers
    instead of hanging them. 'gloo' runs on the CPU; 'nccl' on
    cuda:{local_rank} (local_rank defaults to rank), checked before any
    collective runs. `device` may name that device, nothing else.
    """
    if backend == "gloo":
        dev = torch.device("cpu")
    elif backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend 'nccl' needs CUDA, and this "
                               "process sees no card")
        dev = nccl_device(rank if local_rank is None else local_rank,
                          torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        raise ValueError(f"backend must be 'gloo' or 'nccl', got "
                         f"{backend!r}")
    if device is not None and torch.device(device).type != dev.type:
        raise ValueError(f"backend {backend!r} at rank {rank} runs on "
                         f"{dev}, not {device}")
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=timeout, **kw)
    return Group(pg=None, backend=backend, rank=rank, world=world,
                 device=dev)


def resolve_device(g: PEGroup, device=None) -> torch.device:
    """The device a group's entry point runs on: the group's; `device`, if
    given, must be of its kind."""
    if device is not None and torch.device(device).type != g.device.type:
        raise ValueError(
            f"a {g.backend!r} group runs on {g.device.type} tensors; "
            f"device={device!r} is not one")
    return g.device


def check_tensor(t: torch.Tensor, g) -> None:
    """A collective's tensor must lie on the group's kind of device."""
    want = g.device.type
    if t.device.type != want:
        raise ValueError(
            f"backend {g.backend!r} takes {want} tensors, got one on "
            f"{t.device}; the port stages nothing through the host")


def exchange(tiles: torch.Tensor, g: PEGroup) -> torch.Tensor:
    """The tiled 1d all_to_all: (local_pes, P, ...) destination-major tiles
    of this rank's source PEs -> (local_pes, P, ...) tiles of its
    destination PEs, indexed by source PE (the JAX receive order)."""
    check_tensor(tiles, g)
    L, P = g.local_pes, g.num_pes
    if tuple(tiles.shape[:2]) != (L, P):
        raise ValueError(f"exchange takes ({L}, {P}, ...) tiles, got "
                         f"{tuple(tiles.shape)}")
    rest = tiles.shape[2:]
    # [dst_rank, dst_loc, src_loc, ...]: one contiguous block a rank
    send = tiles.reshape(L, g.world, L, *rest).movedim(0, 2).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=g.pg)
    # recv is [src_rank, dst_loc, src_loc, ...]; source PE src_rank * L +
    # src_loc
    return recv.transpose(0, 1).reshape(L, P, *rest)


@functools.lru_cache(maxsize=64)
def _hop_plan(rank: int, world: int, local_pes: int, rows: int, cols: int,
              axis: str):
    """Row orders of one grid hop: (send rows, send splits, receive
    placement, receive splits). Bucket b of source PE s goes to PE
    (row(s), b) over 'col' and (b, col(s)) over 'row'; the receiver files
    it at its source's column, or row, index."""
    L = local_pes
    B = cols if axis == "col" else rows

    def dest(s, b):
        return (s // cols) * cols + b if axis == "col" else b * cols + s % cols

    def src_pos(s):
        return s % cols if axis == "col" else s // cols

    send, in_splits = [], [0] * world
    for r in range(world):
        for s_loc in range(L):
            for b in range(B):
                if dest(rank * L + s_loc, b) // L == r:
                    send.append(s_loc * B + b)
                    in_splits[r] += 1
    place, out_splits = [], [0] * world
    for q in range(world):
        for s_loc in range(L):
            s = q * L + s_loc
            for b in range(B):
                d = dest(s, b)
                if d // L == rank:
                    place.append((d % L) * B + src_pos(s))
                    out_splits[q] += 1
    inv = [0] * len(place)
    for i, pos in enumerate(place):
        inv[pos] = i
    return tuple(send), tuple(in_splits), tuple(inv), tuple(out_splits)


def hop(tiles: torch.Tensor, g: PEGroup, grid: Tuple[int, int],
        axis: str) -> torch.Tensor:
    """One tiled all_to_all over the 2d grid's 'col' axis (among the PEs of
    a row) or 'row' axis (among those of a column): (local_pes, B, ...)
    tiles whose B buckets are that axis' PEs -> (local_pes, B, ...) tiles
    indexed by the source's position on the axis."""
    check_tensor(tiles, g)
    rows, cols = grid
    if axis not in ("col", "row"):
        raise ValueError(f"axis must be 'col' or 'row', got {axis!r}")
    L = g.local_pes
    B = cols if axis == "col" else rows
    if tuple(tiles.shape[:2]) != (L, B):
        raise ValueError(f"a {axis!r} hop takes ({L}, {B}, ...) tiles, got "
                         f"{tuple(tiles.shape)}")
    send_rows, in_splits, inv, out_splits = _hop_plan(
        g.rank, g.world, L, rows, cols, axis)
    flat = tiles.reshape(L * B, -1)
    idx = torch.tensor(send_rows, dtype=torch.int64, device=tiles.device)
    send = flat.index_select(0, idx)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, list(out_splits), list(in_splits),
                           group=g.pg)
    back = torch.tensor(inv, dtype=torch.int64, device=tiles.device)
    return recv.index_select(0, back).reshape(tiles.shape)


def all_sum(t: torch.Tensor, g) -> torch.Tensor:
    """The sum of `t` over the group's ranks, on every rank (a new tensor;
    the stats go as one packed int64 vector)."""
    check_tensor(t, g)
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=g.pg)
    return out


def all_gather_object(obj, g) -> list:
    """Every rank's picklable `obj`, in rank order, on every rank."""
    out = [None] * g.world
    dist.all_gather_object(out, obj, group=g.pg)
    return out


def broadcast_object(obj, g, src: int = 0):
    """Rank `src`'s picklable `obj` on every rank (the others pass any
    placeholder)."""
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=g.pg)
    return box[0]


def gather_rows(t: torch.Tensor, g) -> torch.Tensor:
    """Every rank's `t` stacked along dim 0 in rank order, on every rank."""
    check_tensor(t, g)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(g.world)]
    dist.all_gather(parts, t, group=g.pg)
    return torch.cat(parts, 0)


def barrier(g) -> None:
    """Every rank waits for the others."""
    if g.device.type == "cuda":
        dist.barrier(group=g.pg, device_ids=[g.device.index])
    else:
        dist.barrier(group=g.pg)
