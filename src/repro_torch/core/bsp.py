"""The BSP k-mer counting baseline (counterpart of `repro.core.bsp`; paper
Algorithm 2, PakMan*/HySortK style).

The read stream goes in batches of `batch_reads` reads a PE, and EVERY
batch ends with a host-synchronous many-to-many round: one exchange, then
the host waits for the card (`torch.cuda.synchronize`) before it issues
the next. That wait is the per-batch T_sync the paper's Eq. (1) charges
BSP for, so it is the algorithm, not overhead to remove. Host-visible
synchronisations: n_batches + 1 (the final sort round), against DAKC's 3.

No L2/L3 compression: raw k-mer words on the wire. Each round is one
single-lane `aggregation.route_lanes` call (1d only), with the same
bucketing and exact wire-byte convention as DAKC's transports; the final
round sorts each PE's received words (`sort.radix_sort`, then
`sort.accumulate(impl='fused')`, or the 'argsort' oracle).

The P PEs are the leading dimension of every tensor on one device, as in
`fabsp`. The rounds write into one preallocated (P, P, n_batches, cap)
receive buffer, the JAX package's [source][batch][slot] order per PE.
With `group=` (a `core.dist.Group`) the PEs are spread over the group's
ranks as in `fabsp`: each rank holds its PEs' rows of the buffer, each
round exchanges over the group and ends in `dist.barrier` as well, and
the stats are summed over the ranks.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from repro_torch.core import aggregation, dist, encoding, fabsp
from repro_torch.core.aggregation import plan_capacity
from repro_torch.core.owner import owner_pe
from repro_torch.core.sort import (AccumResult, accumulate, radix_sort,
                                   sort_with_weights)


@dataclasses.dataclass(frozen=True)
class BSPConfig:
    """The fields, defaults and validation of `repro.core.bsp.BSPConfig`."""
    k: int
    batch_reads: int = 256     # reads a PE per collective round
    slack: float = 1.5
    canonical: bool = False
    bits_per_symbol: int = 2
    partition_impl: str = "radix"   # per-batch bucketing: 'radix' | 'argsort'
    phase2_impl: str = "radix"      # final sort round: 'radix' | 'argsort'

    def __post_init__(self):
        for knob in ("partition_impl", "phase2_impl"):
            v = getattr(self, knob)
            if v not in ("radix", "argsort"):
                raise ValueError(
                    f"{knob} must be 'radix' or 'argsort', got {v!r}")


class BSPStats(NamedTuple):
    overflow: int
    sent_words: int
    wire_bytes: float
    raw_kmers: int
    num_global_syncs: int      # n_batches + 1


def _batch_round(batch: torch.Tensor, *, cfg: BSPConfig, num_pes: int,
                 cap: int, group=None):
    """One superstep's exchange: (P, batch_reads, m) codes -> every PE's
    raw k-mer words routed to their owners. Returns the (P, P * cap)
    receive lanes and the (P,) overflow and sent counts (P the local PEs
    under a `group`)."""
    wb = encoding.word_bits(cfg.k, cfg.bits_per_symbol)
    words = encoding.extract_kmers(batch, cfg.k, cfg.bits_per_symbol,
                                   canonical=cfg.canonical)
    rr = aggregation.route_lanes(
        (words,), ("word",), owner_pe(words, num_pes, wb),
        torch.ones(words.shape, dtype=torch.bool, device=words.device),
        num_pes=num_pes, capacity=cap, word_bits=wb,
        impl=cfg.partition_impl, group=group)
    return rr.lanes[0], rr.overflow, rr.sent_valid


def _final_round(recv_all: torch.Tensor, *, cfg: BSPConfig) -> AccumResult:
    """Sort and accumulate each PE's (P, n) received words."""
    sent = encoding.sentinel(cfg.k, cfg.bits_per_symbol)
    if cfg.phase2_impl == "radix":
        skeys = radix_sort(recv_all,
                           encoding.kmer_bits(cfg.k, cfg.bits_per_symbol),
                           sentinel_val=sent)
        return accumulate(skeys, sentinel_val=sent, impl="fused")
    return accumulate(sort_with_weights(recv_all,
                                        torch.zeros_like(recv_all))[0],
                      sentinel_val=sent)


def _superstep_barrier(dev: torch.device) -> None:
    """The host waits for the round's exchange to finish (the T_sync); under
    a group `dist.barrier` follows, for every other rank."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def count_kmers(reads, cfg: BSPConfig, *, num_pes: int, device=None,
                group=None) -> Tuple[AccumResult, BSPStats]:
    """Host-synchronous batched BSP counting of P PEs on one device.

    reads: (n_reads, m) uint8 codes; PE p owns rows [p * n_local,
    (p + 1) * n_local), n_local a multiple of cfg.batch_reads. device: None
    runs on the CUDA card (and raises without one). Returns the per-PE
    AccumResult laid out as the JAX package's and the BSPStats. A routing
    overflow raises RuntimeError: there is no retry, and no L3 layer to
    absorb skew. `group`: as in `fabsp.count_kmers` (the global reads on
    every rank; this rank's PEs' rows of the result, global stats).
    """
    if group is not None:
        group = group.pes(num_pes)
    dev = fabsp.resolve_device(device, group)
    reads, local = fabsp._place_reads(reads, num_pes, dev, group)
    rows = local.shape[0]
    n_reads, m = reads.shape
    per_pe = n_reads // num_pes
    if per_pe % cfg.batch_reads != 0:
        raise ValueError(
            f"per-PE reads {per_pe} not divisible by batch_reads "
            f"{cfg.batch_reads}")
    n_batches = per_pe // cfg.batch_reads
    batch_kmers = cfg.batch_reads * (m - cfg.k + 1)
    cap = plan_capacity(batch_kmers, num_pes, cfg.slack)
    wb = encoding.word_bits(cfg.k, cfg.bits_per_symbol)

    reads_r = local.reshape(rows, n_batches, cfg.batch_reads, m)
    recv_all = torch.empty((rows, num_pes, n_batches, cap),
                           dtype=torch.int64, device=dev)
    overflow = torch.zeros((rows,), dtype=torch.int64, device=dev)
    sent_words = torch.zeros_like(overflow)
    for b in range(n_batches):
        recv, ovf, sw = _batch_round(reads_r[:, b], cfg=cfg,
                                     num_pes=num_pes, cap=cap, group=group)
        recv_all[:, :, b] = recv.view(rows, num_pes, cap)
        overflow += ovf
        sent_words += sw
        del recv
        _superstep_barrier(dev)
        if group is not None:
            dist.barrier(group)
    totals = torch.stack([overflow.sum(), sent_words.sum()])
    if group is not None:
        totals = dist.all_sum(totals, group)
    overflow, sent_words = (int(x) for x in totals.tolist())
    if overflow > 0:
        raise RuntimeError(
            f"BSP capacity overflow: {overflow} entries; raise slack "
            f"(no L3 layer to absorb skew -- that is the paper's point)")

    result = _final_round(recv_all.view(rows, -1), cfg=cfg)
    # exact wire bytes in Python ints: every round each PE moves one padded
    # single-word-lane tile
    slot_b = aggregation.lane_wire_bytes(("word",), wb)
    wire_bytes = n_batches * num_pes * num_pes * cap * slot_b
    stats = BSPStats(
        overflow=overflow, sent_words=sent_words,
        wire_bytes=float(wire_bytes), raw_kmers=n_reads * (m - cfg.k + 1),
        num_global_syncs=n_batches + 1)
    return fabsp._flat(result), stats
