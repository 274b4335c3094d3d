"""DAKC: the asynchronous k-mer counter (counterpart of `repro.core.fabsp`).

`count_kmers` and the incremental `KmerCounter` run the JAX package's
pipeline with the P processing elements (PEs) held as the leading
dimension of every tensor on one device, in place of one device per PE
under `shard_map`:

- the reads are split into P contiguous shards, (P, n_local, m), and each
  shard into chunks of `chunk_reads`;
- each scan step takes chunk i of every PE and routes it by owner PE (an
  all_to_all is a transpose of the stacked tiles): either its k-mers,
  L3-compressed ('dual', 'packed' or 'none'), or its super-k-mers
  (`transport_impl='superkmer'`), optionally compacted to their valid
  prefix first (`compact_impl='prefix'`), over the 1d topology or the 2d
  one (`topology='2d'` with `grid=(rows, cols)`, the JAX mesh's shape);
- the streaming receiver folds the decoded pairs into the per-PE count
  store; the 'stacked' oracle keeps every step's tiles and sorts them once.

Running statistics stay on the device through the scan and are read once
per round by the retry loop, which doubles the routing slack, rehashes
the store or moves the compact hop 2 onto the padded tile exactly as the
JAX package does; a `resilience.FaultPlan` in `cfg.faults` forces those
rounds on demand. The per-PE results and every `DAKCStats` field equal
the JAX package's.

`KmerCounter` also carries the counter's durability and its out-of-core
tier, as the JAX package's does: `save` / `restore` checkpoint the store
and every sticky knob through `train.checkpoint` (restoring onto another
PE count, or another ownership family, re-routes every live entry: the
elastic reshard), and `cfg.spill` moves the counts into disk bins
(`core.spill`) once the rehash ladder runs out of device memory
('auto') or from the start ('always'); `finalize` then drains the bins
and `count` serves them through the spilled-bin query tier
(`query.query_spilled_counts`). `count_kmers` with a spill setting runs
one such counter.

Across processes: with `group=` (a `core.dist.Group`), the P PEs are
spread over the group's ranks, `num_pes // world` a rank. Every rank is
given the global read set and plans the same capacities from it, moves
only its PEs' rows to its device, and runs the same scan on them; each
route's exchange goes over the group (`aggregation.route_lanes`), and a
retry round's stats are one `dist.all_sum`, so every rank's retry
controller sees the same numbers and takes the same path. A rank's
result is its PEs' rows of the per-PE result; the stats are global. The
checkpoint and the spill tier do not run across ranks yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import words as W
from repro_torch.core import (aggregation, countstore, dist, encoding,
                              minimizer, resilience, spill)
from repro_torch.core.aggregation import plan_capacity
from repro_torch.core.owner import owner_pe
from repro_torch.core.sort import (AccumResult, accumulate, radix_sort,
                                   sort_with_weights)


@dataclasses.dataclass(frozen=True)
class DAKCConfig:
    """Tuning parameters (paper Table III / Sec. VI-H); the fields, defaults
    and validation of `repro.core.fabsp.DAKCConfig`."""
    k: int
    chunk_reads: int = 256        # reads per scan step
    slack: float = 1.5            # capacity = E[load] * slack   (L2 tile)
    heavy_frac: float = 0.5       # HEAVY tile capacity as fraction of NORMAL
    use_l3: bool = True
    l3_mode: str = "auto"         # 'packed' | 'dual' | 'auto'
    topology: str = "1d"          # '1d' | '2d'
    canonical: bool = False
    bits_per_symbol: int = 2
    partition_impl: str = "radix"  # 'radix' kernels | 'argsort' oracle
    phase2_impl: str = "radix"     # 'radix' kernels | 'argsort' oracle
    canonical_impl: str = "fused"  # 'fused' | 'sweep' oracle
    route2d_impl: str = "oneplan"
    hop2_impl: str = "padded"
    receiver_impl: str = "stream"
    transport_impl: str = "kmer"
    minimizer_len: int = 7
    minimizer_order: str = "plain"
    compact_impl: str = "off"
    store_sizing: str = "sample"   # 'sample' estimate | 'bound' oracle
    store_slack: float = 1.5
    store_capacity: Optional[int] = None
    retry: resilience.RetryPolicy = resilience.RetryPolicy()
    faults: Optional[resilience.FaultPlan] = None
    spill: str = "off"
    spill_bins: Optional[int] = None
    spill_dir: Optional[str] = None
    spill_flush_bytes: int = 1 << 22
    spill_host_budget_bytes: int = 1 << 27
    spill_query: str = "fold"
    query_bin_cache_bytes: int = 1 << 26

    def __post_init__(self):
        for knob, allowed in (
                ("partition_impl", ("radix", "argsort")),
                ("phase2_impl", ("radix", "argsort")),
                ("canonical_impl", ("fused", "sweep")),
                ("route2d_impl", ("oneplan", "perhop")),
                ("hop2_impl", ("padded", "compact")),
                ("receiver_impl", ("stream", "stacked")),
                ("transport_impl", ("kmer", "superkmer")),
                ("minimizer_order", ("plain", "hashed")),
                ("compact_impl", ("prefix", "off")),
                ("store_sizing", ("sample", "bound")),
                ("spill_query", ("fold", "refuse"))):
            v = getattr(self, knob)
            if v not in allowed:
                raise ValueError(f"{knob} must be one of {allowed}, got {v!r}")
        if (self.topology == "2d" and self.route2d_impl == "perhop"
                and self.hop2_impl == "compact"):
            raise ValueError(
                "hop2_impl='compact' slices the one-plan route's "
                "already-partitioned hop-2 tile; the 'perhop' oracle "
                "re-plans per hop and has no compact seam")
        if self.transport_impl == "superkmer":
            if not 1 <= self.minimizer_len <= self.k:
                raise ValueError(
                    f"minimizer_len {self.minimizer_len} outside "
                    f"[1, k={self.k}]")
            if self.topology == "2d" and self.route2d_impl == "perhop":
                raise ValueError(
                    "superkmer transport routes 2d hops off the one-plan "
                    "decomposition; route2d_impl='perhop' (which re-derives "
                    "owners from received words) is kmer-transport-only")
        if self.store_capacity is not None and self.store_capacity < 1:
            raise ValueError(
                f"store_capacity must be >= 1, got {self.store_capacity}")
        if self.store_slack <= 0:
            raise ValueError(
                f"store_slack must be positive, got {self.store_slack}")
        if self.spill not in ("off", "auto", "always"):
            raise ValueError(
                f"spill must be one of ('off', 'auto', 'always'), "
                f"got {self.spill!r}")
        if self.spill_bins is not None and self.spill_bins < 1:
            raise ValueError(f"spill_bins must be >= 1, got {self.spill_bins}")
        if self.query_bin_cache_bytes < 1:
            raise ValueError(
                f"query_bin_cache_bytes must be >= 1, "
                f"got {self.query_bin_cache_bytes}")
        if self.spill != "off":
            if self.spill_dir is None:
                raise ValueError("spill != 'off' requires spill_dir")
            if self.receiver_impl != "stream":
                raise ValueError(
                    "the spill tier rides the streaming receiver "
                    "(receiver_impl='stream'): the stacked oracle has no "
                    "per-chunk receive tile to bin")
        site = getattr(self.faults, "site", None)
        if site in ("spill_write", "bin_corrupt") and self.spill == "off":
            raise ValueError(
                f"FaultPlan site {site!r} targets the spill tier; it "
                f"requires spill='auto' or 'always'")
        if site == "store_drop" and self.receiver_impl != "stream":
            raise ValueError(
                "FaultPlan site 'store_drop' targets the streaming "
                "receiver's count store; receiver_impl='stacked' has no "
                "store to drop inserts from")
        if site == "hop2_misfit" and not (
                self.topology == "2d" and self.hop2_impl == "compact"
                and self.route2d_impl == "oneplan"):
            raise ValueError(
                "FaultPlan site 'hop2_misfit' forces a compact hop-2 "
                "misfit: it requires topology='2d', "
                "hop2_impl='compact', route2d_impl='oneplan'")


class DAKCStats(NamedTuple):
    """Summed over PEs, as the JAX package's psum'd stats (host values)."""
    overflow: int                  # entries dropped by ROUTING capacity
    sent_words: int                # valid payload slots on the wire
    wire_bytes: np.int64           # exact padded bytes moved
    raw_kmers: int                 # k-mer instances before compression
    num_global_syncs: int          # 3 for DAKC (paper Sec. I)
    store_overflow: int            # inserts dropped by a full count store
    hop2_dropped: int = 0          # 0: the 1d route has no second hop
    load_max_over_mean: float = 0.0
    owner_fill_p99: int = 0
    retry_route_slack: int = 0
    retry_store_rehash: int = 0
    retry_hop2_fallback: int = 0
    spilled_bins: int = 0
    spilled_bytes: int = 0
    bins_folded: int = 0


def _topology_grid(cfg: DAKCConfig, num_pes: int,
                   grid) -> Optional[Tuple[int, int]]:
    """(rows, cols) of the 2d topology, or None under '1d'. The grid
    stands in for the JAX package's two-axis mesh: PE p is (p // cols,
    p % cols), its row-major fold."""
    if cfg.topology != "2d":
        if grid is not None:
            raise ValueError(f"grid= applies to topology='2d' only, got "
                             f"{grid!r} under {cfg.topology!r}")
        return None
    if grid is None:
        raise ValueError("topology='2d' needs grid=(rows, cols)")
    rows, cols = (int(g) for g in grid)
    if rows < 1 or cols < 1 or rows * cols != num_pes:
        raise ValueError(f"grid {grid!r} does not fold {num_pes} PEs "
                         f"(rows * cols must equal num_pes)")
    return rows, cols


def _imbalance(fill) -> Tuple[float, int]:
    """(load_max_over_mean, owner_fill_p99) of one summed fill histogram."""
    fill = np.asarray(fill, dtype=np.float64)
    if fill.size == 0 or fill.sum() <= 0:
        return 0.0, 0
    return (float(fill.max() / fill.mean()),
            int(np.percentile(fill, 99)))


def _stamp_retries(stats: DAKCStats, counts) -> DAKCStats:
    return stats._replace(
        retry_route_slack=counts[resilience.ROUTE_SLACK],
        retry_store_rehash=counts[resilience.STORE_REHASH],
        retry_hop2_fallback=counts[resilience.HOP2_FALLBACK])


def _resolve_l3_mode(cfg: DAKCConfig, chunk_kmers: int) -> str:
    if not cfg.use_l3:
        return "none"
    if cfg.l3_mode != "auto":
        return cfg.l3_mode
    cap = encoding.count_capacity(cfg.k, cfg.bits_per_symbol)
    return "packed" if cap >= chunk_kmers else "dual"


def _l3_split_dual(words: torch.Tensor, valid: torch.Tensor, k: int,
                   bps: int, impl: str = "radix"):
    """Alg. 4 AddToL2Buffer on (P, n) rows: local accumulate -> NORMAL
    duplicates (count <= 2) + HEAVY {kmer, count} pairs (count > 2).

    Returns (normal_words (P, 2n), normal_valid, heavy_words (P, n),
    heavy_counts, heavy_valid).
    """
    sent = encoding.sentinel(k, bps)
    masked = torch.where(valid, words, sent)
    if impl == "radix":
        acc = accumulate(
            radix_sort(masked, encoding.kmer_bits(k, bps), sentinel_val=sent),
            sentinel_val=sent, impl="fused")
    else:
        acc = accumulate(sort_with_weights(masked, torch.zeros_like(masked))[0],
                         sentinel_val=sent)
    n = words.shape[1]
    slot_valid = (torch.arange(n, device=words.device)[None, :]
                  < acc.num_unique[:, None])
    cnt = acc.counts
    is_heavy = slot_valid & (cnt > 2)
    is_norm = slot_valid & (cnt <= 2)
    norm1 = torch.where(is_norm, acc.unique, sent)
    norm2 = torch.where(is_norm & (cnt == 2), acc.unique, sent)
    normal_words = torch.cat([norm1, norm2], 1)
    heavy_words = torch.where(is_heavy, acc.unique, sent)
    heavy_counts = torch.where(is_heavy, cnt, 0)
    return (normal_words, normal_words != sent, heavy_words, heavy_counts,
            is_heavy)


def _phase1_step(chunk: torch.Tensor, *, cfg: DAKCConfig, num_pes: int,
                 cap_n: int, cap_h: int, mode: str, grid=None,
                 hop2_caps=None, compact_caps=None, chunk_idx: int = 0,
                 fault: Optional[resilience.FaultPlan] = None, group=None):
    """One scan step for every PE: (P, chunk_reads, m) codes -> k-mers or
    super-k-mers -> one `route_lanes` exchange per lane set.

    `grid` is the 2d topology's (rows, cols) or None; `hop2_caps` the
    compact hop 2's (normal, heavy) capacities or None. The super-k-mer
    route always takes the 'oneplan' 2d route, the k-mer route
    `cfg.route2d_impl`.

    `compact_caps` is the pre-route compaction plan of `_resolve_compact`,
    (compact_n, compact_h, route_cap_n, route_cap_h), or None: each lane
    set, with its owners riding as an 'i32' lane, shrinks to its valid
    prefix and routes at the re-derived capacity; valid entries past the
    prefix count as routing overflow.

    `fault` is an armed 'route_drop' plan (or None): its mask at scan
    step `chunk_idx` invalidates entries of the primary lane before the
    route, and the drops count as routing overflow.

    `group` is None or the `dist.PEGroup` whose local PEs `chunk` holds;
    every route then exchanges over it.

    Returns (recv, (raw, sent_valid, wire_bytes, overflow, hop2_dropped,
    fill)): `raw` and `wire_bytes` are per-PE ints (the same on every PE),
    the rest (P,) or (P, P) device tensors.
    """
    k, bps = cfg.k, cfg.bits_per_symbol
    wb = encoding.word_bits(k, bps)
    h2n, h2h = (None, None) if hop2_caps is None else hop2_caps
    cc_n, cc_h, rc_n, rc_h = ((None,) * 4 if compact_caps is None
                              else compact_caps)

    def inject_drop(pvalid):
        if fault is None or fault.site != "route_drop":
            return pvalid, 0
        hit = resilience.fault_mask(pvalid.shape[1], fault, chunk_idx,
                                    pvalid.device)
        return pvalid & ~hit, (pvalid & hit).sum(1, dtype=torch.int32)

    def route(lanes, kinds, owners, valid, capacity, ccap, rcap, hop2,
              route2d="oneplan", rederive=None):
        covf = 0
        if ccap is not None and ccap < valid.shape[1]:
            out, valid, covf = aggregation.compact_lanes(
                lanes + (owners,), kinds + ("i32",), valid, ccap,
                word_bits=wb, impl=cfg.partition_impl)
            lanes, owners, capacity = out[:-1], out[-1], rcap
        rr = aggregation.route_lanes(
            lanes, kinds, owners, valid, num_pes=num_pes, capacity=capacity,
            word_bits=wb, grid=grid, impl=cfg.partition_impl,
            route2d=route2d, hop2_capacity=hop2, rederive_owners=rederive,
            group=group)
        return rr._replace(overflow=rr.overflow + covf)

    if mode == "superkmer":
        # Route packed super-k-mers to the owner of their minimizer; the
        # receiver re-extracts the k-mers (`_recv_pairs`).
        m = cfg.minimizer_len
        sk = minimizer.segment_superkmers(
            chunk, k, m, bps, canonical=cfg.canonical,
            canonical_impl=cfg.canonical_impl, order=cfg.minimizer_order)
        raw = sk.lengths.shape[1]           # one slot per k-mer instance
        lanes = tuple(sk.words[..., s] for s in range(sk.words.shape[-1]))
        kinds = ("word",) * len(lanes) + ("i32",)
        owners = owner_pe(sk.minimizers, num_pes, encoding.word_bits(m, bps))
        sk_valid, injected = inject_drop(sk.lengths > 0)
        rr = route(lanes + (sk.lengths,), kinds, owners, sk_valid,
                   cap_n, cc_n, rc_n, h2n)
        return (torch.stack(rr.lanes[:-1], -1), rr.lanes[-1], None), \
            (raw, rr.sent_valid, rr.wire_bytes, rr.overflow + injected,
             rr.hop2_dropped, rr.fill)

    words = encoding.extract_kmers(chunk, k, bps, canonical=cfg.canonical,
                                   canonical_impl=cfg.canonical_impl)
    raw = words.shape[1]
    mask = encoding.kmer_mask(k, bps)

    def kmer_owners(w):
        return owner_pe(w & mask, num_pes, wb)

    def route_kmers(payload, counts, pvalid, capacity, ccap, rcap, hop2):
        lanes = (payload,) if counts is None else (payload, counts)
        kinds = ("word",) if counts is None else ("word", "i32")
        return route(lanes, kinds, kmer_owners(payload), pvalid, capacity,
                     ccap, rcap, hop2, cfg.route2d_impl, kmer_owners)

    if mode == "packed":
        payload, pvalid = aggregation.l3_compress(words, k, bps,
                                                  impl=cfg.phase2_impl)
        pvalid, injected = inject_drop(pvalid)
        rr = route_kmers(payload, None, pvalid, cap_n, cc_n, rc_n, h2n)
        return (rr.lanes[0], None, None), (raw, rr.sent_valid, rr.wire_bytes,
                                           rr.overflow + injected,
                                           rr.hop2_dropped, rr.fill)
    if mode == "dual":
        valid = torch.ones(words.shape, dtype=torch.bool, device=words.device)
        nw, nv, hw, hc, hv = _l3_split_dual(words, valid, k, bps,
                                            impl=cfg.phase2_impl)
        nv, injected = inject_drop(nv)
        rn = route_kmers(nw, None, nv, cap_n, cc_n, rc_n, h2n)
        rh = route_kmers(hw, hc, hv, cap_h, cc_h, rc_h, h2h)
        return (rn.lanes[0], rh.lanes[0], rh.lanes[1]), \
            (raw, rn.sent_valid + rh.sent_valid,
             rn.wire_bytes + rh.wire_bytes,
             rn.overflow + rh.overflow + injected,
             rn.hop2_dropped + rh.hop2_dropped, rn.fill + rh.fill)
    if mode != "none":
        raise ValueError(f"unknown l3_mode {mode!r}")
    valid, injected = inject_drop(
        torch.ones(words.shape, dtype=torch.bool, device=words.device))
    rr = route_kmers(words, None, valid, cap_n, cc_n, rc_n, h2n)
    return (rr.lanes[0], None, None), (raw, rr.sent_valid, rr.wire_bytes,
                                       rr.overflow + injected,
                                       rr.hop2_dropped, rr.fill)


def _recv_pairs(recv, *, cfg: DAKCConfig, mode: str):
    """Decode received tiles into (P, N) (kmer, count) lanes; sentinel
    entries carry count 0, HEAVY pairs their counts, and super-k-mer slots
    ((P, N, S) payloads, (P, N) lengths) expand to their unit k-mers."""
    k, bps = cfg.k, cfg.bits_per_symbol
    rn, rh, rhc = recv
    sent = encoding.sentinel(k, bps)
    if mode == "superkmer":
        return minimizer.superkmer_to_kmers(
            rn, rh, k, cfg.minimizer_len, bps, canonical=cfg.canonical,
            canonical_impl=cfg.canonical_impl)
    if mode == "packed":
        return aggregation.l3_decompress(rn, k, bps)
    if mode == "dual":
        kmers = torch.cat([rn, rh], 1)
        counts = torch.cat([(rn != sent).to(torch.int32),
                            torch.where(rh != sent, rhc.to(torch.int32), 0)],
                           1)
        return kmers, counts
    return rn, (rn != sent).to(torch.int32)


def _phase2(recvs, *, cfg: DAKCConfig, mode: str) -> AccumResult:
    """The 'stacked' receiver oracle: decode every step's received tiles
    (each PE's stream in step order), then one sort and accumulate."""
    k, bps = cfg.k, cfg.bits_per_symbol
    impl = cfg.phase2_impl
    total_bits = encoding.kmer_bits(k, bps)
    accum_impl = "fused" if impl == "radix" else "segment_sum"
    sent = encoding.sentinel(k, bps)
    stacked = tuple(None if r[0] is None else torch.cat(r, 1)
                    for r in zip(*recvs))
    if mode == "none":
        keys = stacked[0]
        skeys = (radix_sort(keys, total_bits, sentinel_val=sent)
                 if impl == "radix" else
                 sort_with_weights(keys, torch.zeros_like(keys))[0])
        return accumulate(skeys, sentinel_val=sent, impl=accum_impl)
    kmers, weights = _recv_pairs(stacked, cfg=cfg, mode=mode)
    keys, w = sort_with_weights(kmers, weights, impl=impl,
                                total_bits=total_bits, sentinel_val=sent)
    return accumulate(keys, w, sentinel_val=sent, impl=accum_impl)


def _drop_inserts(store: countstore.CountStore, kmers: torch.Tensor,
                  cnts: torch.Tensor, fault: resilience.FaultPlan,
                  chunk_idx: int) -> torch.Tensor:
    """The 'store_drop' site: zero the masked inserts of one scan step
    (with `fault.fill`, only on PEs whose store holds at least that share
    of its slots, compared in float32 as the JAX package does) and charge
    them to `store.dropped`. Returns the counts to insert."""
    hit = resilience.fault_mask(kmers.shape[1], fault, chunk_idx,
                                kmers.device)[None, :]
    if fault.fill > 0:
        occupied = (store.keys != W.sentinel(store.word_bits)).sum(1)
        level = float(np.float32(fault.fill * store.keys.shape[1]))
        hit = hit & (occupied.to(torch.float32) >= level)[:, None]
    drop = hit & (cnts > 0)
    store.dropped.add_(drop.sum(1, dtype=torch.int32))
    return torch.where(drop, 0, cnts)


def _stream_fold(chunks: torch.Tensor, store: Optional[countstore.CountStore],
                 *, cfg: DAKCConfig, num_pes: int, cap_n: int, cap_h: int,
                 mode: str, grid=None, hop2_caps=None, compact_caps=None,
                 fault: Optional[resilience.FaultPlan] = None, sink=None,
                 group=None):
    """The Phase-1 scan: route chunk i of every PE, then fold the decoded
    receive tiles into the count store (the streaming receiver), hand
    them to `sink` (the spill tier), or keep them for `_phase2` when
    neither is given (the stacked oracle). An armed 'route_drop' `fault`
    rides into `_phase1_step`, a 'store_drop' one into `_drop_inserts`.

    chunks: (P, n_chunks, chunk_reads, m), or the local PEs' rows under a
    `group` (whose routes exchange over it). No host sync happens here: the
    running stats stay on the device. Returns (store or the list of receive
    tiles, (raw, sent_words, wire_bytes, route_overflow, hop2_dropped,
    fill)), raw and wire_bytes as per-PE ints, the rest per-PE device
    tensors.
    """
    p, n_chunks = chunks.shape[:2]
    dev = chunks.device
    sent_t = torch.zeros((p,), dtype=torch.int32, device=dev)
    ovf_t = torch.zeros_like(sent_t)
    h2_t = torch.zeros_like(sent_t)
    fill_t = torch.zeros((p, num_pes), dtype=torch.int32, device=dev)
    raw_t = wire_t = 0
    recvs = []
    for i in range(n_chunks):
        recv, (raw, sent_w, wire, ovf, h2, fl) = _phase1_step(
            chunks[:, i], cfg=cfg, num_pes=num_pes, cap_n=cap_n,
            cap_h=cap_h, mode=mode, grid=grid, hop2_caps=hop2_caps,
            compact_caps=compact_caps, chunk_idx=i, fault=fault, group=group)
        if sink is not None:
            sink(recv)
        elif store is None:
            recvs.append(recv)
        else:
            kmers, cnts = _recv_pairs(recv, cfg=cfg, mode=mode)
            del recv
            if fault is not None and fault.site == "store_drop":
                cnts = _drop_inserts(store, kmers, cnts, fault, i)
            countstore.store_insert(store, kmers, cnts)
        raw_t += raw
        wire_t += wire
        sent_t += sent_w
        ovf_t += ovf
        h2_t += h2
        fill_t += fl
    return (recvs if store is None else store), \
        (raw_t, sent_t, wire_t, ovf_t, h2_t, fill_t)


def _chunked(reads_local: torch.Tensor, chunk_reads: int) -> torch.Tensor:
    p, n_local, m = reads_local.shape
    if n_local % chunk_reads != 0:
        raise ValueError(
            f"local reads {n_local} not divisible by chunk_reads "
            f"{chunk_reads}; pad the read set to a multiple of "
            f"num_pes * chunk_reads")
    return reads_local.reshape(p, n_local // chunk_reads, chunk_reads, m)


def _round_stats(num_pes: int, store_ovf, fold_stats):
    """The stats tuple `_host_stats` reads, summed over PEs (device
    tensors, except the static raw and wire totals)."""
    raw, sent_w, wire, ovf, h2, fill = fold_stats
    return (ovf.sum(), store_ovf.sum(), sent_w.sum(), num_pes * wire,
            num_pes * raw, h2.sum(), fill.sum(0))


def _flat(result: AccumResult) -> AccumResult:
    return AccumResult(unique=result.unique.reshape(-1),
                       counts=result.counts.reshape(-1),
                       num_unique=result.num_unique)


def _local_count(reads_local: torch.Tensor, *, cfg: DAKCConfig, num_pes: int,
                 cap_n: int, cap_h: int, store_cap: int, mode: str,
                 grid=None, hop2_caps=None, compact_caps=None, fault=None,
                 group=None):
    """One round: every PE's scan, then its histogram (of the store, or of
    the stacked receive tiles). Returns the flat per-PE AccumResult and the
    round's stats (`_round_stats`), of the local PEs under a `group`."""
    chunks = _chunked(reads_local, cfg.chunk_reads)
    rows = chunks.shape[0]
    kw = dict(cfg=cfg, num_pes=num_pes, cap_n=cap_n, cap_h=cap_h, mode=mode,
              grid=grid, hop2_caps=hop2_caps, compact_caps=compact_caps,
              fault=fault, group=group)
    if cfg.receiver_impl == "stacked":
        recvs, fold_stats = _stream_fold(chunks, None, **kw)
        result = _phase2(recvs, cfg=cfg, mode=mode)
        del recvs
        return _flat(result), _round_stats(
            num_pes, torch.zeros((rows,), dtype=torch.int32,
                                 device=chunks.device), fold_stats)
    wb = encoding.word_bits(cfg.k, cfg.bits_per_symbol)
    store = countstore.empty_store(rows, store_cap, wb, chunks.device)
    store, fold_stats = _stream_fold(chunks, store, **kw)
    result = countstore.store_histogram(
        store, total_bits=encoding.kmer_bits(cfg.k, cfg.bits_per_symbol),
        impl=cfg.phase2_impl)
    store_ovf = store.dropped
    del store
    return _flat(result), _round_stats(num_pes, store_ovf, fold_stats)


def _default_store_capacity(cfg: DAKCConfig, shape, num_pes: int) -> int:
    """Per-PE count-store slots from the instance-count bound."""
    if cfg.receiver_impl != "stream":
        return 0
    if cfg.store_capacity is not None:
        return cfg.store_capacity
    n_reads, m = shape
    total = n_reads * (m - cfg.k + 1)
    distinct_bound = min(total,
                         1 << encoding.kmer_bits(cfg.k, cfg.bits_per_symbol))
    return plan_capacity(distinct_bound, num_pes, cfg.store_slack)


def _sampled_distinct_estimate(reads: torch.Tensor, cfg: DAKCConfig,
                               num_pes: int, dev=None) -> Optional[int]:
    """Global distinct-count estimate from one sample chunk, inverted under
    the uniform-pool model (see the JAX package); None when the sample is
    fully distinct. The sample's k-mers are extracted on `dev` (None: where
    the reads lie) and counted on the host, as the JAX package's are."""
    n_reads, m = reads.shape
    k, bps = cfg.k, cfg.bits_per_symbol
    sample = reads[:min(cfg.chunk_reads, n_reads)].to(dev)
    words = encoding.extract_kmers(
        sample, k, bps, canonical=cfg.canonical,
        canonical_impl=cfg.canonical_impl).cpu().numpy()
    s = int(words.size)
    d = int(np.unique(words).size)
    total = n_reads * (m - k + 1)
    bound = min(total, 1 << encoding.kmer_bits(k, bps))
    if d >= s:
        return None

    def exp_distinct(u: float, n: int) -> float:
        return u * -math.expm1(n * math.log1p(-1.0 / u))

    lo, hi = float(max(d, 2)), float(bound)
    if exp_distinct(hi, s) < d:
        u = hi
    else:
        for _ in range(60):
            mid = math.sqrt(lo * hi)
            if exp_distinct(mid, s) < d:
                lo = mid
            else:
                hi = mid
        u = hi
    return min(max(int(math.ceil(exp_distinct(u, total))), d), bound)


def _sampled_store_capacity(reads: torch.Tensor, cfg: DAKCConfig,
                            num_pes: int, dev=None) -> int:
    """Per-PE store slots from the sample estimate, rounded up to a power
    of two (the JAX package's quantization, kept so the layouts agree)."""
    est = _sampled_distinct_estimate(reads, cfg, num_pes, dev)
    if est is None:
        return _default_store_capacity(cfg, tuple(reads.shape), num_pes)
    cap = plan_capacity(est, num_pes, cfg.store_slack)
    return 1 << (cap - 1).bit_length()


def _resolve_store_capacity(reads: torch.Tensor, cfg: DAKCConfig,
                            num_pes: int, dev=None) -> int:
    """Explicit override > 'sample' estimate > shape-only bound."""
    if cfg.receiver_impl != "stream":
        return 0
    if cfg.store_capacity is not None:
        return cfg.store_capacity
    if cfg.store_sizing == "sample":
        return _sampled_store_capacity(reads, cfg, num_pes, dev)
    return _default_store_capacity(cfg, tuple(reads.shape), num_pes)


def _plan_caps(cfg: DAKCConfig, num_pes: int, shape, slack: float):
    """(mode, cap_n, cap_h) for one reads shape. Under the super-k-mer
    transport cap_n is the per-destination super-k-mer slot capacity,
    planned from the expected run density, and cap_h is 0."""
    n_reads, m = shape
    chunk_kmers = cfg.chunk_reads * (m - cfg.k + 1)
    if cfg.transport_impl == "superkmer":
        est = minimizer.expected_superkmers(cfg.chunk_reads, m, cfg.k,
                                            cfg.minimizer_len)
        return "superkmer", plan_capacity(est, num_pes, slack), 0
    mode = _resolve_l3_mode(cfg, chunk_kmers)
    # the 'dual' NORMAL lane can carry up to 2x duplicated entries
    n_items = chunk_kmers * (2 if mode == "dual" else 1)
    cap_n = plan_capacity(n_items, num_pes, slack)
    cap_h = max(8, int(cap_n * cfg.heavy_frac))
    return mode, cap_n, cap_h


def _pow2ceil(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


# Evenly spaced chunks that `_chunk_valid_estimate` samples.
_SAMPLE_CHUNKS = 4


def _ownership_word_bits(cfg: DAKCConfig) -> int:
    """Width of the word `owner_pe` hashes: the k-mer's, or under the
    super-k-mer transport its minimizer's."""
    k = cfg.minimizer_len if cfg.transport_impl == "superkmer" else cfg.k
    return encoding.word_bits(k, cfg.bits_per_symbol)


def _owner_peak(words: torch.Tensor, cfg: DAKCConfig, num_pes: int,
                weights: Optional[torch.Tensor] = None) -> int:
    """Valid slots of the busiest destination under the real owner hash."""
    if words.numel() == 0:
        return 0
    own = owner_pe(words, num_pes, _ownership_word_bits(cfg)).to(torch.int64)
    return int(torch.bincount(own, weights=weights, minlength=num_pes).max())


def _chunk_valid_estimate(reads: torch.Tensor, cfg: DAKCConfig, mode: str,
                          shape, num_pes: int = 1, dev=None
                          ) -> Tuple[int, int, int, int]:
    """Measured per-chunk (normal, heavy, peak_normal, peak_heavy) valid
    slot counts: the max over up to `_SAMPLE_CHUNKS` evenly spaced chunks
    of the read set, pushed through the mode's own compression, and the
    valid slots of the busiest single owner. 'none' ships every instance,
    so the shape bound is exact; with no reads (`reads` None: the
    dry-run's shape-only plan) the estimate is that bound and the peak
    its mean over the PEs. A sample shorter than a chunk is scaled
    up. The JAX package's function of the same name, on the host here too;
    the sample chunks move to `dev` (None: where the reads lie).
    """
    n_reads, m = shape
    chunk_kmers = cfg.chunk_reads * (m - cfg.k + 1)
    if mode == "none" or reads is None or n_reads == 0:
        est_n = (minimizer.expected_superkmers(cfg.chunk_reads, m, cfg.k,
                                               cfg.minimizer_len)
                 if mode == "superkmer"
                 else chunk_kmers * (2 if mode == "dual" else 1))
        est_h = 0 if mode == "superkmer" else chunk_kmers
        return est_n, est_h, -(-est_n // num_pes), -(-est_h // num_pes)
    k, bps = cfg.k, cfg.bits_per_symbol
    n_chunks = max(1, n_reads // cfg.chunk_reads)
    est_n = est_h = peak_n = peak_h = 0
    for c in sorted({(i * n_chunks) // _SAMPLE_CHUNKS
                     for i in range(min(_SAMPLE_CHUNKS, n_chunks))}):
        lo = c * cfg.chunk_reads
        sample = reads[lo:lo + min(cfg.chunk_reads, n_reads)].to(dev)
        scale = -(-cfg.chunk_reads // sample.shape[0])
        if mode == "superkmer":
            sk = minimizer.segment_superkmers(
                sample, k, cfg.minimizer_len, bps, canonical=cfg.canonical,
                canonical_impl=cfg.canonical_impl, order=cfg.minimizer_order)
            valid = sk.lengths > 0
            est_n = max(est_n, scale * int(valid.sum()))
            peak_n = max(peak_n, scale * _owner_peak(sk.minimizers[valid],
                                                     cfg, num_pes))
            continue
        words = encoding.extract_kmers(sample, k, bps,
                                       canonical=cfg.canonical,
                                       canonical_impl=cfg.canonical_impl)
        uniq, counts = torch.unique(words, return_counts=True)
        if mode == "packed":
            est_n = max(est_n, scale * int(counts.numel()))
            peak_n = max(peak_n, scale * _owner_peak(uniq, cfg, num_pes))
            continue
        # 'dual': NORMAL ships `count` copies for count <= 2, HEAVY a pair.
        normal = counts <= 2
        est_n = max(est_n, scale * int((counts == 1).sum()
                                       + 2 * (counts == 2).sum()))
        est_h = max(est_h, scale * int((~normal).sum()))
        peak_n = max(peak_n, scale * _owner_peak(
            uniq[normal], cfg, num_pes, counts[normal].to(torch.float64)))
        peak_h = max(peak_h, scale * _owner_peak(uniq[~normal], cfg,
                                                 num_pes))
    return est_n, est_h, peak_n, peak_h


def _compact_engaged(cfg: DAKCConfig) -> bool:
    """Whether the pre-route prefix compaction applies to this config."""
    return cfg.compact_impl == "prefix"


def _resolve_compact(cfg: DAKCConfig, num_pes: int, shape, slack: float,
                     est: Tuple[int, int, int, int]
                     ) -> Optional[Tuple[int, int, int, int]]:
    """(compact_n, compact_h, route_cap_n, route_cap_h) of the pre-route
    prefix compaction, or None where it cannot pay ('off', the 'none' wire
    format, or lanes the measured density shows are already dense).

    compact_* is the kept prefix: the measured valid estimate `est`
    (`_chunk_valid_estimate`) with the routing slack, a power of two of at
    least 64. route_cap_* is the capacity the compacted lanes route at: the
    larger of the mean-density plan and the measured busiest owner, with
    the slack as headroom, a power of two of at least 64, at most the
    positional capacity unless the busiest owner overflows it (then the
    prefix length, which routes any skew without overflow). Both grow with
    the controller's slack on a retry round.
    """
    if not _compact_engaged(cfg):
        return None
    mode, cap_n, cap_h = _plan_caps(cfg, num_pes, shape, slack)
    if mode == "none":
        return None
    est_n, est_h, peak_n, peak_h = est
    n_reads, m = shape
    chunk_kmers = cfg.chunk_reads * (m - cfg.k + 1)
    n_n = chunk_kmers * (2 if mode == "dual" else 1)

    def caps(n_slots, est_lane, peak_lane, cap_lane):
        cc = max(64, _pow2ceil(int(math.ceil(max(est_lane, 1) * slack))))
        if cc >= n_slots:
            return n_slots, cap_lane     # already dense: nothing to compact
        peak_need = int(math.ceil(max(peak_lane, 1) * slack))
        target = max(plan_capacity(max(est_lane, 1), num_pes, slack),
                     peak_need)
        ceiling = cap_lane if peak_need <= cap_lane else cc
        return cc, min(ceiling, max(64, _pow2ceil(target)))

    cc_n, rc_n = caps(n_n, est_n, peak_n, cap_n)
    cc_h, rc_h = (caps(chunk_kmers, est_h, peak_h, cap_h) if mode == "dual"
                  else (0, 0))
    if cc_n >= n_n and (mode != "dual" or cc_h >= chunk_kmers):
        return None
    return cc_n, cc_h, rc_n, rc_h


def _hop2_engaged(cfg: DAKCConfig) -> bool:
    """Whether the compact hop 2 applies to this config at all."""
    return (cfg.topology == "2d" and cfg.hop2_impl == "compact"
            and cfg.route2d_impl == "oneplan")


def _resolve_hop2_caps(cfg: DAKCConfig, num_pes: int, shape, slack: float,
                       est: Tuple[int, int, int, int]
                       ) -> Optional[Tuple[int, int]]:
    """(normal, heavy) compact hop-2 capacities, or None where the compact
    hop 2 does not engage: the measured valid estimate spread over the PEs
    with the slack, a power of two of at least 64, at most the hop-1
    capacity (where compact equals padded). The estimate does not depend
    on the slack, so a retry round re-plans on it without reading the data
    again."""
    if not _hop2_engaged(cfg):
        return None
    _, cap_n, cap_h = _plan_caps(cfg, num_pes, shape, slack)
    est_n, est_h = est[:2]

    def cap2(cap, est_lane):
        return min(cap, max(64, _pow2ceil(
            plan_capacity(max(est_lane, 1), num_pes, slack))))

    return cap2(cap_n, est_n), cap2(cap_h, est_h) if cap_h else 0


def _retry_hop2_caps(cfg: DAKCConfig, num_pes: int, shape,
                     ctrl: resilience.RetryController,
                     est) -> Optional[Tuple[int, int]]:
    """Compact hop-2 capacities of the controller's current round, None
    once it runs on the padded tile. An armed 'hop2_misfit' fault forces a
    1-slot tile, which no hop-1 fill fits: the padded fallback on
    demand."""
    if ctrl.hop2_padded:
        return None
    caps = _resolve_hop2_caps(cfg, num_pes, shape, ctrl.slack, est)
    plan = cfg.faults
    if (caps is not None and plan is not None
            and plan.site == "hop2_misfit" and plan.fires(ctrl.attempts)):
        caps = (1, 1 if caps[1] else 0)
    return caps


def _valid_estimate(reads: torch.Tensor, cfg: DAKCConfig, num_pes: int,
                    shape, hop2: bool, dev=None):
    """The measured valid-slot sample (`_chunk_valid_estimate`) that the
    compact hop 2 (when `hop2`, it engages) and the pre-route compaction
    plan from, taken once per call or batch; None when neither engages."""
    if not (hop2 or _compact_engaged(cfg)):
        return None
    mode = _plan_caps(cfg, num_pes, shape, cfg.slack)[0]
    return _chunk_valid_estimate(reads, cfg, mode, shape, num_pes, dev)


# Words a piece when `_ownership_keys` recomputes minimizers: each word
# unpacks to k int64 base codes, so a reshard or engage-time export of
# hundreds of millions of words runs in pieces of this many.
_OWNERSHIP_PIECE = 1 << 20


def _ownership_keys(words: torch.Tensor, cfg: DAKCConfig) -> torch.Tensor:
    """The word `owner_pe` hashes for stored k-mer words (any shape): the
    masked word itself, or under the super-k-mer transport the k-mer's
    minimizer, recomputed from its bases (base j at bit bps*(k-1-j)) by the
    sliding minimum the sender ran, `_OWNERSHIP_PIECE` words at a time.
    Its width is `_ownership_word_bits`."""
    k, bps = cfg.k, cfg.bits_per_symbol
    w = words & encoding.kmer_mask(k, bps)
    if cfg.transport_impl != "superkmer":
        return w
    shifts = torch.arange(k - 1, -1, -1, device=words.device) * bps
    flat = w.reshape(-1)
    out = torch.empty_like(flat)
    for lo in range(0, flat.numel(), _OWNERSHIP_PIECE):
        piece = flat[lo:lo + _OWNERSHIP_PIECE]
        codes = (piece[:, None] >> shifts) & ((1 << bps) - 1)
        out[lo:lo + piece.numel()] = minimizer.window_minimizers(
            codes[:, None, :], k, cfg.minimizer_len, bps,
            canonical=cfg.canonical, canonical_impl=cfg.canonical_impl,
            order=cfg.minimizer_order)[:, 0, 0]
    return out.reshape(words.shape)


def _reshard_round(keys: torch.Tensor, counts: torch.Tensor, *,
                   cfg: DAKCConfig, num_pes: int, grid, route_cap: int,
                   store_cap: int, word_bits: int, group=None):
    """One elastic-reshard round (the JAX package's `_reshard_executable`):
    every PE routes its (P, n_local) slice of (key, count) records to their
    owners under this counter's PE count and ownership, in one
    `route_lanes` exchange, and folds what it receives into a fresh store
    of `store_cap` slots. Returns (store, route drops, store drops), the
    drops summed over PEs for the caller's retry controller; under a
    `group`, of this rank's PEs' rows, the drops summed over the group."""
    sent = W.sentinel(word_bits)
    valid = (keys != sent) & (counts > 0)
    owners = owner_pe(_ownership_keys(keys, cfg), num_pes,
                      _ownership_word_bits(cfg))
    rr = aggregation.route_lanes(
        (keys, counts), ("word", "i32"), owners, valid, num_pes=num_pes,
        capacity=route_cap, word_bits=word_bits, grid=grid,
        impl=cfg.partition_impl, route2d="oneplan", group=group)
    del owners, valid
    store = countstore.empty_store(keys.shape[0], store_cap, word_bits,
                                   keys.device)
    countstore.store_insert(store, rr.lanes[0], rr.lanes[1])
    drops = torch.stack([rr.overflow.sum(), store.dropped.sum()]).to(
        torch.int64)
    if group is not None:
        drops = dist.all_sum(drops, group)
    route_drop, store_drop = drops.tolist()
    return store, route_drop, store_drop


def _spill_lanes(recv, *, cfg: DAKCConfig, mode: str, n_bins: int):
    """One scan step's receive tiles as the spill tier's flat lanes (the
    JAX package's `_spill_route_executable`), each record given its bin on
    the card: the slot's recovered minimizer under the super-k-mer
    transport (`minimizer.superkmer_minimizers`), else the masked k-mer,
    through `spill.bin_of`. Returns super-k-mer words (N, S), int32
    lengths and bins; or k-mers (N,), int32 counts and bins."""
    k, bps = cfg.k, cfg.bits_per_symbol
    if mode == "superkmer":
        words, lengths, _ = recv
        minz = minimizer.superkmer_minimizers(
            words, k, cfg.minimizer_len, bps, canonical=cfg.canonical,
            canonical_impl=cfg.canonical_impl, order=cfg.minimizer_order)
        return (words.reshape(-1, words.shape[-1]),
                lengths.reshape(-1).to(torch.int32),
                spill.bin_of(minz, n_bins,
                             _ownership_word_bits(cfg)).reshape(-1))
    kmers, cnts = _recv_pairs(recv, cfg=cfg, mode=mode)
    return (kmers.reshape(-1), cnts.reshape(-1).to(torch.int32),
            spill.bin_of(kmers & encoding.kmer_mask(k, bps), n_bins,
                         encoding.word_bits(k, bps)).reshape(-1))


# Checkpoint compatibility: the fingerprint's fields decide what a stored
# word means (a mismatch cannot be repaired, so restore refuses); the
# ownership tag's decide which PE owns a word (a mismatch, like another
# PE count, makes the restore reshard).
_FINGERPRINT_FIELDS = ("k", "bits_per_symbol", "canonical")


def _cfg_fingerprint(cfg: DAKCConfig) -> dict:
    return {f: getattr(cfg, f) for f in _FINGERPRINT_FIELDS}


def _ownership_tag(cfg: DAKCConfig) -> dict:
    sk = cfg.transport_impl == "superkmer"
    return {"transport_impl": cfg.transport_impl,
            "minimizer_len": cfg.minimizer_len if sk else None,
            # the order decides which m-mer wins a window, so it is part
            # of the ownership family
            "minimizer_order": cfg.minimizer_order if sk else None}


def _host_stats(raw_stats, group=None) -> Tuple[DAKCStats, list]:
    """The round's one device-to-host read of the stats; under a `group`
    after one `dist.all_sum` of them, packed, so that every rank reads the
    same numbers. Returns the stats and the summed fill histogram."""
    route_ovf, store_ovf, sent_w, wire, raw, h2, fill = raw_stats
    packed = torch.cat([torch.stack([route_ovf, store_ovf, sent_w, h2])
                        .to(torch.int64), fill.to(torch.int64)])
    if group is not None:
        packed = dist.all_sum(packed, group)
    host = packed.tolist()
    route_ovf, store_ovf, sent_w, h2 = host[:4]
    lmm, p99 = _imbalance(host[4:])
    return DAKCStats(overflow=route_ovf, sent_words=sent_w,
                     wire_bytes=np.int64(wire), raw_kmers=raw,
                     num_global_syncs=3, store_overflow=store_ovf,
                     hop2_dropped=h2, load_max_over_mean=lmm,
                     owner_fill_p99=p99), host[4:]


def _agree_failure(err: Optional[BaseException], group) -> None:
    """Under a `group`, make one rank's failure every rank's: one
    `dist.all_sum` of the ranks' failures; the failed rank raises its own
    error, the others `dist.PeerFailure`. Alone, raise `err` if set."""
    if group is not None:
        n = int(dist.all_sum(torch.tensor(
            [int(err is not None)], dtype=torch.int64,
            device=group.device), group)[0])
        if n and err is None:
            raise dist.PeerFailure(f"{n} rank(s) of the group failed this "
                                   f"step; this rank stops with them")
    if err is not None:
        raise err


def resolve_device(device=None, group=None) -> torch.device:
    """`device`, or the CUDA card when None; raises when CUDA is asked for
    and absent (the port never carries on silently on the CPU). Under a
    `group`, the group's device (`dist.resolve_device`)."""
    if group is not None:
        return dist.resolve_device(group, device)
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the caller "
            "passes device='cpu'")
    return dev


def _as_device_reads(reads, dev: torch.device) -> torch.Tensor:
    if not isinstance(reads, torch.Tensor):
        reads = torch.from_numpy(np.ascontiguousarray(reads))
    return reads.to(dev)


def _split(reads: torch.Tensor, num_pes: int) -> torch.Tensor:
    n_reads, m = reads.shape
    if n_reads % num_pes != 0:
        raise ValueError(f"{n_reads} reads do not split over {num_pes} PEs")
    return reads.reshape(num_pes, n_reads // num_pes, m)


def _place_reads(reads, num_pes: int, dev: torch.device, group=None):
    """(the global read set the planning reads, the (P, n_local, m) rows
    the scan reads on `dev`). Under a `group` only this rank's PEs' rows
    are moved to `dev`, and the planning moves its sample chunks there; a
    card's reads given to a CPU group raise (nothing is staged through
    the host)."""
    if group is None:
        reads = _as_device_reads(reads, dev)
        return reads, _split(reads, num_pes)
    if not isinstance(reads, torch.Tensor):
        reads = torch.from_numpy(np.ascontiguousarray(reads))
    if reads.device.type not in ("cpu", dev.type):
        raise ValueError(f"a {group.backend!r} group runs on {dev.type}; "
                         f"the reads lie on {reads.device}")
    first = group.first_pe
    return reads, _split(reads, num_pes)[first:first + group.local_pes].to(
        dev)


def count_kmers(reads, cfg: DAKCConfig, *, num_pes: int, grid=None,
                device=None, group=None) -> Tuple[AccumResult, DAKCStats]:
    """Distributed asynchronous k-mer counting (DAKC) of P PEs on one device.

    reads: (n_reads, m) integer symbol codes below 2**bits_per_symbol
           (numpy array or tensor: uint8 bases, or int32 tokens through
           `core.ngram`); PE p owns rows [p * n_local, (p + 1) * n_local),
           and n_local must divide by cfg.chunk_reads.
    grid: (rows, cols) with rows * cols == num_pes under topology='2d'
           (the JAX mesh's shape; PE p is (p // cols, p % cols)); None
           under '1d'.
    device: None runs on the CUDA card (and raises without one); tests
           pass "cpu".
    group: None (every PE on this device) or a `core.dist.Group` whose
           world divides num_pes; `reads` is then the global read set on
           every rank, `device` defaults to the group's, and the result
           holds this rank's PEs only (module docstring).
    Returns the per-PE AccumResult laid out as the JAX package's: unique
    (P * L,) int64 words (sentinel past each PE's num_unique), counts
    (P * L,) int32, num_unique (P,), with local_pes for P under a group;
    and the DAKCStats, over all PEs.

    Overflow rounds run through `cfg.retry`: a routing overflow replays at
    doubled slack, a full count store replays at doubled capacity (a
    rehash round), a compact hop-2 misfit replays on the padded tile; the
    per-cause round counts come back in `retry_*`. With `cfg.spill` on,
    the call is one `KmerCounter` update and its drain (under a group too).
    """
    if cfg.spill != "off":
        # The out-of-core path runs one incremental counter (an update and
        # its drain), so the spill tier lives in one place for both entry
        # points.
        kc = KmerCounter(cfg, num_pes=num_pes, grid=grid, device=device,
                         group=group)
        ustats = kc.update(reads)
        result, fstats = kc.finalize()
        return result, ustats._replace(
            retry_route_slack=fstats.retry_route_slack,
            retry_store_rehash=fstats.retry_store_rehash,
            retry_hop2_fallback=fstats.retry_hop2_fallback,
            spilled_bins=fstats.spilled_bins,
            spilled_bytes=fstats.spilled_bytes,
            bins_folded=fstats.bins_folded)
    if group is not None:
        group = group.pes(num_pes)
    grid = _topology_grid(cfg, num_pes, grid)
    dev = resolve_device(device, group)
    reads, local = _place_reads(reads, num_pes, dev, group)
    shape = tuple(reads.shape)
    store_cap = _resolve_store_capacity(reads, cfg, num_pes, dev)
    engaged = _hop2_engaged(cfg)
    est = _valid_estimate(reads, cfg, num_pes, shape, engaged, dev)
    ctrl = resilience.RetryController(cfg.retry, slack=cfg.slack,
                                      store_cap=store_cap,
                                      hop2_padded=not engaged)
    while True:
        mode, cap_n, cap_h = _plan_caps(cfg, num_pes, shape, ctrl.slack)
        hop2_caps = _retry_hop2_caps(cfg, num_pes, shape, ctrl, est)
        compact_caps = (None if est is None else _resolve_compact(
            cfg, num_pes, shape, ctrl.slack, est))
        result, raw_stats = _local_count(
            local, cfg=cfg, num_pes=num_pes, cap_n=cap_n, cap_h=cap_h,
            store_cap=ctrl.store_cap, mode=mode, grid=grid,
            hop2_caps=hop2_caps, compact_caps=compact_caps,
            fault=resilience.active_trace_fault(cfg.faults, ctrl.attempts),
            group=group)
        stats, _ = _host_stats(raw_stats, group)
        if not ctrl.observe(route_dropped=stats.overflow,
                            store_dropped=stats.store_overflow,
                            hop2_dropped=stats.hop2_dropped):
            return result, _stamp_retries(stats, ctrl.counts)
        del result


class KmerCounter:
    """Incremental DAKC: fold batches of reads into one persistent store
    (counterpart of `repro.core.fabsp.KmerCounter`).

    `update(reads)` runs the counting pipeline for one batch and folds it
    into the per-PE count store; `finalize()` sorts the store into the
    per-PE histogram; `count` / `contains` serve point queries from the
    last committed store (`core.query`). Two updates give exactly the
    histogram of one `count_kmers` call over both batches.

    Each update runs through `cfg.retry`: a routing overflow doubles the
    slack for this and later batches, a full store rehashes into doubled
    capacity and the batch replays, and a compact hop-2 misfit moves this
    and later batches onto the padded tile. A 'update_fail' fault plan
    raises `resilience.InjectedFault` from its update before anything
    commits. The JAX package replays from its
    immutable committed arrays; this store updates in place, so every
    attempt inserts into a copy of the committed store (`store_copy`),
    which becomes the committed store when the batch folds cleanly. The
    committed tensors are then never written again, so the snapshot that
    `count()` serves (`StoreSnapshot`) stays exact through later updates,
    rehashes and failed rounds, at the cost of one more store in memory
    while an update runs.

    Durability: `save()` checkpoints the committed store and every sticky
    knob (slack, hop-2 fallback, store capacity, totals, round history,
    the spill manifest) through `train.checkpoint`; `restore()` rebuilds a
    counter mid-stream, loading the store in place, or re-routing every
    live entry when the PE count or the ownership family differs.

    The spill tier (`cfg.spill`): 'always' spills from the first batch;
    'auto' counts in core until the rehash ladder reaches
    `cfg.retry.store_cap_ceiling`, then exports the committed store into
    disk bins and replays that batch out of core. From then on each batch
    routes as usual and its receive lanes go to bin segments
    (`spill.SpillWriter`), committed only when the batch routed cleanly;
    the resident store shrinks to `_SPILL_STORE_CAP` slots a PE, and
    `finalize()` drains the bins one at a time through the reshard's fold.

    Store capacity starts from `cfg.store_capacity`, else from the first
    batch's sample estimate ('sample') or its instance bound ('bound').
    `grid` and `group` are as in `count_kmers`: under a group every rank
    feeds the same global batches and queries, holds its PEs' stores,
    `finalize` returns its PEs' rows and `count` the global answers on
    every rank. `save` gathers the rows to rank 0, which writes the one
    checkpoint; `restore` loads each rank's rows or reshards a share of
    the entries over the group; the spill tier writes each rank's receive
    lanes into rank-tagged segments of the same bins and drains each bin
    through the group's fold (`core.spill`). `spill_dir` must then lie on
    a filesystem that every rank sees (one host, or a shared mount).
    """

    # Once the tier engages, the resident store only has to exist for
    # `save`, `finalize` and the query tier's first stage: 8 slots a PE.
    _SPILL_STORE_CAP = 8

    def __init__(self, cfg: DAKCConfig, *, num_pes: int, grid=None,
                 device=None, group=None):
        if cfg.receiver_impl != "stream":
            raise ValueError("KmerCounter requires receiver_impl='stream'")
        self._cfg = cfg
        self._num_pes = num_pes
        self._grid = _topology_grid(cfg, num_pes, grid)
        self._group = None if group is None else group.pes(num_pes)
        self._dev = resolve_device(device, self._group)
        # the store's rows: every PE, or this rank's under a group
        self._rows = (num_pes if self._group is None
                      else self._group.local_pes)
        self._wb = encoding.word_bits(cfg.k, cfg.bits_per_symbol)
        self._slack = cfg.slack
        # once a batch's hop-1 fills miss the compact hop-2 tile, the
        # stream stays on the padded tile, as the doubled slack stays
        self._hop2_padded = False
        self._store_cap: Optional[int] = cfg.store_capacity
        self._store: Optional[countstore.CountStore] = None
        # the first batch's sampled distinct estimate; sizes the spill
        # bins and rides the checkpoint
        self._distinct_est: Optional[int] = None
        # lifetime totals across updates (host ints)
        self._raw = 0
        self._sent = 0
        self._wire_bytes = 0
        self._fill: Optional[np.ndarray] = None
        self._retries = {c: 0 for c in resilience.CAUSES}
        self._n_updates = 0
        self._rounds: list = []
        # the spill tier, None until it engages
        self._spill: Optional[spill.SpillWriter] = None
        self._bins_folded = 0
        self.last_query_stats = None
        self._gen = 0
        self._committed: Optional[countstore.StoreSnapshot] = None
        # the spilled-bin query tier's LRU of folded bins
        # (`query.BinShardCache`), made on first use
        self._bin_cache = None

    @property
    def store_capacity(self) -> Optional[int]:
        return self._store_cap

    def _alloc(self, reads: torch.Tensor) -> None:
        cfg = self._cfg
        if self._distinct_est is None and cfg.store_sizing == "sample":
            self._distinct_est = _sampled_distinct_estimate(
                reads, cfg, self._num_pes, self._dev)
        if self._store_cap is None:
            if self._distinct_est is not None:
                cap = plan_capacity(self._distinct_est, self._num_pes,
                                    cfg.store_slack)
                self._store_cap = 1 << (cap - 1).bit_length()
            else:
                self._store_cap = _resolve_store_capacity(
                    reads, cfg, self._num_pes, self._dev)
        self._alloc_store()

    def _alloc_store(self) -> None:
        self._store = countstore.empty_store(self._rows, self._store_cap,
                                             self._wb, self._dev)

    def _grow(self, new_cap: int) -> None:
        """Rehash the committed store into `new_cap` slots per PE, into new
        tensors (a published snapshot keeps the old ones)."""
        grown = countstore.store_grow(self._store, new_cap)
        dropped = int(grown.dropped.sum())
        if dropped:   # unreachable unless the store state is corrupt
            raise resilience.RehashInvariantBroken(
                f"rehash into {new_cap} slots/PE dropped {dropped} live "
                f"entries", self._rounds, dict(self._retries),
                dropped=dropped)
        self._store = grown
        self._store_cap = new_cap

    def _publish(self) -> None:
        """Publish the committed store as the generation `count()` serves:
        one reference assignment, of tensors no later call writes, with a
        copy of the spill manifest as it stands."""
        self._gen += 1
        self._committed = countstore.StoreSnapshot(
            gen=self._gen, keys=self._store.keys, counts=self._store.counts,
            store_cap=self._store_cap, word_bits=self._wb,
            spill_state=None if self._spill is None else self._spill.state())

    def update(self, reads) -> DAKCStats:
        """Fold one (n_reads, m) batch into the store; returns this batch's
        stats (the clean round's, with its replay counts in retry_*).

        Under `cfg.spill` the batch may go to the disk tier instead:
        'always' from the first batch on; 'auto' once the rehash ladder
        gives up (`CapacityExhausted` for the store), when the committed
        store is exported to bins and this batch replays through the tier
        (nothing counts twice: the committed store is untouched until a
        batch folds cleanly)."""
        plan = self._cfg.faults
        if (plan is not None and plan.site == "update_fail"
                and self._n_updates == plan.update_n):
            # the preemption drill: die before anything commits
            raise resilience.InjectedFault(
                f"injected failure at update #{self._n_updates} "
                f"(FaultPlan site='update_fail')")
        reads, local = _place_reads(reads, self._num_pes, self._dev,
                                    self._group)
        if self._spill is None and self._cfg.spill == "always":
            self._engage_spill()
        if self._spill is not None:
            return self._spill_update(reads, local)
        try:
            return self._incore_update(reads, local)
        except resilience.CapacityExhausted as e:
            if (self._cfg.spill != "auto"
                    or e.cause != resilience.STORE_REHASH):
                raise
            # the ladder's rounds and replays stay in the history, so a
            # later give-up still shows why the tier engaged
            self._rounds = list(e.rounds)
            for cause, n in e.counts.items():
                self._retries[cause] += n
            self._engage_spill()
            return self._spill_update(reads, local)

    def _incore_update(self, reads: torch.Tensor,
                       local: torch.Tensor) -> DAKCStats:
        """One in-core batch: `reads` the global batch the planning reads,
        `local` the (rows, n_local, m) reads of this device's PEs."""
        cfg, p = self._cfg, self._num_pes
        plan = cfg.faults
        chunks = _chunked(local, cfg.chunk_reads)
        if self._store is None:
            self._alloc(reads)
        shape = tuple(reads.shape)
        engaged = _hop2_engaged(cfg) and not self._hop2_padded
        est = _valid_estimate(reads, cfg, p, shape, engaged, self._dev)
        ctrl = resilience.RetryController(
            cfg.retry, slack=self._slack, store_cap=self._store_cap,
            hop2_padded=not engaged, history=self._rounds)
        while True:
            if ctrl.store_cap != self._store_cap:
                self._grow(ctrl.store_cap)   # rehash round; then replay
            mode, cap_n, cap_h = _plan_caps(cfg, p, shape, ctrl.slack)
            hop2_caps = _retry_hop2_caps(cfg, p, shape, ctrl, est)
            compact_caps = (None if est is None else _resolve_compact(
                cfg, p, shape, ctrl.slack, est))
            work, fold_stats = _stream_fold(
                chunks, countstore.store_copy(self._store), cfg=cfg,
                num_pes=p, cap_n=cap_n, cap_h=cap_h, mode=mode,
                grid=self._grid, hop2_caps=hop2_caps,
                compact_caps=compact_caps,
                fault=resilience.active_trace_fault(plan, ctrl.attempts),
                group=self._group)
            raw_stats = _round_stats(p, work.dropped, fold_stats)
            stats, fill = _host_stats(raw_stats, self._group)
            if not ctrl.observe(route_dropped=stats.overflow,
                                store_dropped=stats.store_overflow,
                                hop2_dropped=stats.hop2_dropped):
                break
            del work
        self._store = work
        self._slack = ctrl.slack
        self._rounds = ctrl.rounds
        if _hop2_engaged(cfg):
            self._hop2_padded = ctrl.hop2_padded
        for cause, n in ctrl.counts.items():
            self._retries[cause] += n
        self._n_updates += 1
        self._raw += stats.raw_kmers
        self._sent += stats.sent_words
        self._wire_bytes += int(stats.wire_bytes)
        self._add_fill(fill)
        self._publish()
        return _stamp_retries(stats, ctrl.counts)

    def _add_fill(self, fill: list) -> None:
        fill = np.asarray(fill, dtype=np.int64)
        self._fill = fill if self._fill is None else self._fill + fill

    # --- the spill tier (core/spill.py) --------------------------------------

    def _spill_fault(self) -> Optional[resilience.FaultPlan]:
        plan = self._cfg.faults
        if plan is not None and plan.site in ("spill_write", "bin_corrupt"):
            return plan
        return None

    def _engage_spill(self) -> None:
        """Stand up the spill writer; if a committed store exists, export
        its live (key, count) entries into their bins. Either way the
        resident store becomes `_SPILL_STORE_CAP` empty slots a PE: from
        here on batches spill and `finalize()` drains the bins."""
        cfg = self._cfg
        n_bins = cfg.spill_bins
        if n_bins is None:
            # each bin's drain-time fold near the capacity the ladder
            # could afford
            n_bins = spill.auto_bins(self._distinct_est, self._num_pes,
                                     self._store_cap, cfg.store_slack)
        meta = {"transport": cfg.transport_impl, "k": cfg.k,
                "bits_per_symbol": cfg.bits_per_symbol,
                "canonical": cfg.canonical,
                "minimizer_len": cfg.minimizer_len,
                "minimizer_order": cfg.minimizer_order}
        self._spill = spill.SpillWriter(
            cfg.spill_dir, n_bins, meta=meta,
            flush_bytes=cfg.spill_flush_bytes, fault=self._spill_fault(),
            group=self._group)
        if self._store is not None:
            keys = self._store.keys.reshape(-1)
            counts = self._store.counts.reshape(-1)
            live = (keys != W.sentinel(self._wb)) & (counts > 0)
            k_live = keys[live]
            if k_live.numel():
                bins = spill.bin_of(_ownership_keys(k_live, cfg), n_bins,
                                    _ownership_word_bits(cfg))
                self._spill.add_pairs(bins.cpu().numpy(),
                                      W.to_numpy_words(k_live, self._wb),
                                      counts[live].cpu().numpy())
            del keys, counts, live, k_live
            self._spill.commit()
        # the tier owns the counts now: release the pressured store
        self._store_cap = self._SPILL_STORE_CAP
        self._alloc_store()

    def _absorb_spill(self, host_lanes, mode: str) -> None:
        """Hand one chunk's host lanes to the writer as numpy, without the
        tile padding (length 0 or count 0)."""
        if mode == "superkmer":
            words, lengths, bins = host_lanes
            lengths = lengths.numpy()
            live = lengths > 0
            self._spill.add_superkmers(
                bins.numpy()[live], W.to_numpy_words(words, self._wb)[live],
                lengths[live])
        else:
            kmers, cnts, bins = host_lanes
            cnts = cnts.numpy()
            live = cnts > 0
            self._spill.add_pairs(bins.numpy()[live],
                                  W.to_numpy_words(kmers, self._wb)[live],
                                  cnts[live])

    def _spill_update(self, reads: torch.Tensor,
                      local: torch.Tensor) -> DAKCStats:
        """The partition phase's update: each chunk's exchange runs on the
        card as in core (hop 2 padded, no compaction), its receive lanes
        get their bins there (`_spill_lanes`) and stream to the host
        through the bounded copier into bin segments. Nothing enters the
        manifest until the whole batch routed cleanly (a routing overflow
        aborts the pending segments and replays at doubled slack), so a
        replay never spills twice. Under a group a rank whose writes fail
        keeps routing to the batch's end; then one `dist.all_sum` of the
        failures decides, and either every rank commits or every rank
        aborts and raises (`_agree_failure`)."""
        cfg, p = self._cfg, self._num_pes
        w = self._spill
        chunks = _chunked(local, cfg.chunk_reads)
        shape = tuple(reads.shape)
        ctrl = resilience.RetryController(
            cfg.retry, slack=self._slack,
            store_cap=self._store_cap or self._SPILL_STORE_CAP,
            hop2_padded=True, history=self._rounds)
        while True:
            w.begin_batch()
            mode, cap_n, cap_h = _plan_caps(cfg, p, shape, ctrl.slack)
            copier = spill.AsyncHostCopier(cfg.spill_host_budget_bytes)
            failed = []

            def absorb(hosts):
                for host in hosts:
                    if failed:
                        return
                    try:
                        self._absorb_spill(host, mode)
                    except (OSError, resilience.InjectedFault) as e:
                        # a failed segment write: every rank decides together
                        if self._group is None:
                            raise
                        failed.append(e)

            def sink(recv):
                if not failed:
                    absorb(copier.submit(_spill_lanes(
                        recv, cfg=cfg, mode=mode, n_bins=w.n_bins)))

            _, fold_stats = _stream_fold(
                chunks, None, cfg=cfg, num_pes=p, cap_n=cap_n, cap_h=cap_h,
                mode=mode, grid=self._grid, sink=sink,
                fault=resilience.active_trace_fault(cfg.faults,
                                                    ctrl.attempts),
                group=self._group)
            absorb(copier.drain())
            try:
                _agree_failure(failed[0] if failed else None, self._group)
            except Exception:
                w.abort_batch()
                raise
            raw_stats = _round_stats(
                p, torch.zeros((self._rows,), dtype=torch.int32,
                               device=local.device), fold_stats)
            stats, fill = _host_stats(raw_stats, self._group)
            if not ctrl.observe(route_dropped=stats.overflow,
                                hop2_dropped=stats.hop2_dropped):
                w.commit()             # seal this batch into the manifest
                break
            w.abort_batch()            # its pending segments die with it
        self._slack = ctrl.slack
        self._rounds = ctrl.rounds
        for cause, n in ctrl.counts.items():
            self._retries[cause] += n
        self._n_updates += 1
        self._raw += stats.raw_kmers
        self._sent += stats.sent_words
        self._wire_bytes += int(stats.wire_bytes)
        self._add_fill(fill)
        self._publish()
        stats = stats._replace(spilled_bins=w.spilled_bins,
                               spilled_bytes=w.spilled_bytes,
                               bins_folded=self._bins_folded)
        return _stamp_retries(stats, ctrl.counts)

    def _bin_pairs(self, b: int, segments=None):
        """One bin's committed records as (keys, int32 counts) on the
        card, or None for an empty bin: the segment files are read (and
        checked) on the host, then decoded on the card, super-k-mer slots
        back to their k-mers. `segments` pins the manifest view (a
        snapshot's `spill_state['segments']`); None reads the live one.
        Under a group every rank reads the whole bin (`_fold_pairs` then
        routes its PEs' rows)."""
        cfg, dev = self._cfg, self._dev
        keys_l, cnts_l = [], []
        for kind, arrays in self._spill.read_bin(b, segments=segments):
            if kind == "pairs":
                keys_l.append(W.to_torch_words(arrays["keys"], dev)[0])
                cnts_l.append(torch.from_numpy(
                    arrays["counts"].astype(np.int32)).to(dev))
                continue
            words = W.to_torch_words(arrays["words"], dev)[0]
            lengths = torch.from_numpy(
                arrays["lengths"].astype(np.int32)).to(dev)
            kk, cc = minimizer.superkmer_to_kmers(
                words, lengths, cfg.k, cfg.minimizer_len,
                cfg.bits_per_symbol, canonical=cfg.canonical,
                canonical_impl=cfg.canonical_impl)
            live = cc > 0
            keys_l.append(kk[live])
            cnts_l.append(cc[live])
        if not keys_l:
            return None
        return torch.cat(keys_l), torch.cat(cnts_l)

    def _drain_bins(self) -> Tuple[AccumResult, int]:
        """The fold phase: each bin's records (checked on read ->
        `spill.SpillCorrupt`) are routed to their owners and folded
        (`_fold_pairs`), then sorted into per-PE histograms; each PE's
        runs of all bins, sorted in the words' unsigned order, make the
        usual AccumResult. Bins partition k-mer space, so this is the
        exact histogram. It runs at this counter's PE count: a spilled run
        restored onto another P drains there. Under a group each rank
        reads every bin, the fold routes its PEs' rows over the group, and
        the result holds this rank's PEs' rows."""
        p = self._rows
        sent = W.sentinel(self._wb)
        total_bits = encoding.kmer_bits(self._cfg.k,
                                        self._cfg.bits_per_symbol)
        shard_u = [[] for _ in range(p)]
        shard_c = [[] for _ in range(p)]
        folded = 0
        for b in range(self._spill.n_bins):
            pairs = self._bin_pairs(b)
            if pairs is None:
                continue
            store, _ = self._fold_pairs(*pairs)
            del pairs
            res = countstore.store_histogram(store, total_bits=total_bits,
                                             impl=self._cfg.phase2_impl)
            del store
            for s, n in enumerate(res.num_unique.tolist()):
                shard_u[s].append(res.unique[s, :n].clone())
                shard_c[s].append(res.counts[s, :n].clone())
            del res
            folded += 1
        width = max([sum(x.numel() for x in shard_u[s]) for s in range(p)]
                    + [1])
        out_u = torch.full((p, width), sent, dtype=torch.int64,
                           device=self._dev)
        out_c = torch.zeros((p, width), dtype=torch.int32, device=self._dev)
        out_n = torch.zeros((p,), dtype=torch.int32, device=self._dev)
        for s in range(p):
            if not shard_u[s]:
                continue
            uu, cc = sort_with_weights(torch.cat(shard_u[s])[None, :],
                                       torch.cat(shard_c[s])[None, :])
            n = uu.shape[1]
            out_u[s, :n] = uu[0]
            out_c[s, :n] = cc[0]
            out_n[s] = n
        return AccumResult(unique=out_u.reshape(-1),
                           counts=out_c.reshape(-1), num_unique=out_n), folded

    def finalize(self) -> Tuple[AccumResult, DAKCStats]:
        """Sort the store into the per-PE histogram (callable more than
        once; updates may follow). With the spill tier engaged this is the
        drain (`_drain_bins`), in the same layout. The stats are the
        lifetime totals."""
        lmm, p99 = (_imbalance(self._fill) if self._fill is not None
                    else (0.0, 0))
        stats = DAKCStats(
            overflow=0, sent_words=self._sent,
            wire_bytes=np.int64(self._wire_bytes), raw_kmers=self._raw,
            num_global_syncs=3, store_overflow=0, load_max_over_mean=lmm,
            owner_fill_p99=p99)
        if self._spill is not None:
            result, folded = self._drain_bins()
            self._bins_folded = folded
            stats = stats._replace(spilled_bins=self._spill.spilled_bins,
                                   spilled_bytes=self._spill.spilled_bytes,
                                   bins_folded=folded)
            return result, _stamp_retries(stats, self._retries)
        if self._store is None:
            raise RuntimeError("KmerCounter.finalize before any update")
        result = countstore.store_histogram(
            self._store,
            total_bits=encoding.kmer_bits(self._cfg.k,
                                          self._cfg.bits_per_symbol),
            impl=self._cfg.phase2_impl)
        return _flat(result), _stamp_retries(stats, self._retries)

    def count(self, kmers) -> np.ndarray:
        """Per-query occurrence counts from the last committed store, in
        request order (0 = never counted): (n,) packed words or (n, k) base
        codes (`query.pack_queries`). Read only; the batch's
        `query.QueryStats` lands in `last_query_stats`.

        A committed generation with the spill tier engaged is served by the
        spilled-bin tier (`query.query_spilled_counts`: the resident store,
        then each touched bin folded on demand into a byte-bounded LRU),
        or, under `spill_query='refuse'`, refused with
        `query.QueryUnavailable`. The dispatch reads the committed
        snapshot, not the live tier: an engage whose first spilled batch
        died leaves the committed histogram in core."""
        from repro_torch.core import query
        snap = self._committed
        if snap is None:
            raise RuntimeError("KmerCounter.count before any update")
        if snap.spill_state is not None:
            if self._cfg.spill_query == "refuse":
                raise query.QueryUnavailable(
                    "the counter's committed generation has an engaged "
                    "spill tier and cfg.spill_query='refuse' opts out of "
                    "the spilled-bin query tier's on-demand folds")
            counts, stats = query.query_spilled_counts(self, snap, kmers)
        else:
            counts, stats = query.query_counts(kmers, self._cfg, snap,
                                               num_pes=self._num_pes,
                                               grid=self._grid,
                                               group=self._group)
        self.last_query_stats = stats
        return counts

    def contains(self, kmers) -> np.ndarray:
        """Batched membership: `count(kmers) > 0`, request order."""
        return self.count(kmers) > 0

    # --- durability ----------------------------------------------------------

    def save(self, ckpt_dir: Optional[str] = None, step: int = 0, *,
             saver=None, keep: int = 3):
        """Checkpoint the committed store and every sticky knob.

        The store goes as the JAX package's flat (P * cap,) uint32/uint64
        keys and int32 counts, through `train.checkpoint`: staged, then
        renamed, so a crash mid-write (or an armed
        `FaultPlan(site='ckpt_write')`) leaves the latest complete
        checkpoint as it was. Pass `ckpt_dir` for a blocking save (returns
        the checkpoint's directory) or `saver=AsyncSaver(...)` to write on
        its thread (returns None; its `wait()` raises a failed write).

        Under a group every rank calls it: the ranks' rows are gathered
        (`dist.gather_rows`) into the one checkpoint of the stacked layout,
        which rank 0 writes, and every rank returns once rank 0's rename
        has happened or failed. With a saver, rank 0 waits for its write;
        a failure is then held by every rank's saver for its next `wait()`
        (rank 0's own error, `dist.PeerFailure` elsewhere). Blocking, every
        rank raises (the others `dist.PeerFailure`)."""
        if self._store is None:
            raise RuntimeError("KmerCounter.save before any update")
        if (ckpt_dir is None) == (saver is None):
            raise ValueError("pass exactly one of ckpt_dir / saver")
        from repro_torch.train import checkpoint as ckpt_lib
        keys, counts = self._store.keys, self._store.counts
        g = self._group
        if g is not None:
            keys, counts = dist.gather_rows(keys, g), dist.gather_rows(
                counts, g)
        trees = {"store": {
            "keys": W.to_numpy_words(keys.reshape(-1), self._wb),
            "counts": counts.reshape(-1).cpu().numpy()}}
        del keys, counts
        extra = {
            "format": 1,
            "fingerprint": _cfg_fingerprint(self._cfg),
            "ownership": _ownership_tag(self._cfg),
            "num_pes": self._num_pes,
            "store_cap": self._store_cap,
            "slack": self._slack,
            "hop2_padded": self._hop2_padded,
            "raw": self._raw,
            "sent": self._sent,
            "wire_bytes": self._wire_bytes,
            "n_updates": self._n_updates,
            "distinct_est": self._distinct_est,
            "retries": dict(self._retries),
            # a run killed mid-spill restores with the checkpoint's view of
            # the committed bins, and a give-up after the restore shows the
            # rounds before it
            "rounds": resilience.rounds_to_json(self._rounds),
            "spill": None if self._spill is None else self._spill.state(),
        }
        plan = self._cfg.faults
        fault = plan if (plan is not None
                         and plan.site == "ckpt_write") else None
        if g is None:
            if saver is not None:
                saver.save(step, trees, extra=extra)
                return None
            return ckpt_lib.save(ckpt_dir, step, trees, extra=extra,
                                 keep=keep, fault=fault)
        path, err = None, None
        if g.rank == 0:
            try:
                if saver is not None:
                    saver.save(step, trees, extra=extra)
                    saver.wait()
                else:
                    path = ckpt_lib.save(ckpt_dir, step, trees, extra=extra,
                                         keep=keep, fault=fault)
            except (OSError, resilience.InjectedFault) as e:
                err = e
        del trees
        outcome = dist.broadcast_object(
            (path, None if err is None else f"{type(err).__name__}: {err}"),
            g)
        if outcome[1] is not None and err is None:
            err = dist.PeerFailure(f"rank 0's checkpoint write failed: "
                                   f"{outcome[1]}")
        if saver is not None:
            if err is not None:
                saver.hold(err)
            return None
        if err is not None:
            raise err
        return outcome[0]

    @classmethod
    def restore(cls, ckpt_dir: str, cfg: DAKCConfig, *, num_pes: int,
                grid=None, device=None, step: Optional[int] = None,
                group=None) -> "KmerCounter":
        """Rebuild a counter mid-stream from a checkpoint (the latest
        complete step unless `step` is given), on `device` (None: the
        card).

        With the saved PE count and ownership family (transport, minimizer
        length and order), the store loads in place. Otherwise this is an
        elastic reshard: every live (key, count) entry is routed to its
        owner under `num_pes` in one `route_lanes` exchange and folded
        into a fresh store (`_fold_pairs`); counts merge exactly. `cfg`
        must match the saved fingerprint (k, bits_per_symbol, canonical),
        else `ValueError`. A checkpoint with the spill tier engaged needs
        a spill cfg and the bins' `spill_dir`; its manifest is attached,
        and segment files it does not list are deleted.

        Under a `group` every rank reads the checkpoint (from a filesystem
        all of them see): in place, each rank loads its PEs' rows; else
        each rank routes its PEs' rows of the stacked fold's layout over
        the group. Any checkpoint restores so, whoever wrote it: the
        stacked path, ranks of any world, or the JAX package."""
        from repro_torch.train import checkpoint as ckpt_lib
        if step is None:
            step = ckpt_lib.latest_step(ckpt_dir)
            if step is None:
                raise FileNotFoundError(
                    f"no complete checkpoint under {ckpt_dir}")
        wb = encoding.word_bits(cfg.k, cfg.bits_per_symbol)
        dt = np.uint64 if wb == 64 else np.uint32
        templates = {"store": {"keys": np.zeros(0, dt),
                               "counts": np.zeros(0, np.int32)}}
        trees, extra = ckpt_lib.restore(ckpt_dir, step, templates)
        saved_fp = extra["fingerprint"]
        want_fp = _cfg_fingerprint(cfg)
        if saved_fp != want_fp:
            raise ValueError(
                f"checkpoint fingerprint {saved_fp} is incompatible with "
                f"cfg {want_fp}: the stored words would be reinterpreted")
        self = cls(cfg, num_pes=num_pes, grid=grid, device=device,
                   group=group)
        self._raw = int(extra["raw"])
        self._sent = int(extra["sent"])
        self._wire_bytes = int(extra["wire_bytes"])
        self._n_updates = int(extra["n_updates"])
        de = extra.get("distinct_est")
        self._distinct_est = None if de is None else int(de)
        saved_retries = extra.get("retries", {})
        self._retries = {c: int(saved_retries.get(c, 0))
                         for c in resilience.CAUSES}
        self._slack = float(extra["slack"])
        self._hop2_padded = bool(extra["hop2_padded"])
        self._rounds = resilience.rounds_from_json(extra.get("rounds"))
        sp = extra.get("spill")
        if sp is not None:
            if cfg.spill == "off" or cfg.spill_dir is None:
                raise ValueError(
                    "checkpoint has an engaged spill tier; restoring it "
                    "needs a cfg with spill enabled and the spill_dir the "
                    "bins live under")
            # spill_bins=None adopts the checkpoint's partition; a pinned
            # count must match it (bins partition k-mer space)
            if (cfg.spill_bins is not None
                    and int(sp["n_bins"]) != cfg.spill_bins):
                raise ValueError(
                    f"checkpoint spilled into {sp['n_bins']} bins; "
                    f"cfg.spill_bins={cfg.spill_bins} would repartition "
                    f"k-mer space mid-run")
            self._spill = spill.SpillWriter.attach(
                cfg.spill_dir, sp, flush_bytes=cfg.spill_flush_bytes,
                fault=self._spill_fault(), group=self._group)
        keys_np = np.asarray(trees["store"]["keys"], dtype=dt)
        counts_np = np.asarray(trees["store"]["counts"], dtype=np.int32)
        if (num_pes == int(extra["num_pes"])
                and extra["ownership"] == _ownership_tag(cfg)):
            self._store_cap = int(extra["store_cap"])
            g = self._group
            if g is not None:   # this rank's PEs' rows
                lo = g.first_pe * self._store_cap
                hi = lo + g.local_pes * self._store_cap
                keys_np, counts_np = keys_np[lo:hi], counts_np[lo:hi]
            self._store = countstore.store_from_numpy(
                keys_np, counts_np, self._rows, device=self._dev)
        else:
            keys = W.to_torch_words(keys_np, self._dev)[0]
            del keys_np
            self._reshard_from(keys, torch.from_numpy(counts_np).to(self._dev))
        self._publish()
        return self

    def _fold_pairs(self, keys: torch.Tensor, counts: torch.Tensor, *,
                    store_cap: Optional[int] = None, sticky: bool = False):
        """Route (key, count) records on the card to their owner PEs and
        fold them into a fresh store: the one fold behind the elastic
        restore (`_reshard_from`), the drain (`_drain_bins`) and the query
        tier's bin folds.

        The records, padded to P * n_local, go out in one `_reshard_round`;
        an overflow on either side retries through `cfg.retry` as any round
        does, each attempt into a fresh store. n_local and the default
        store capacity are powers of two, as in the JAX package (a
        restored `store_cap` rides the next checkpoint). `sticky=True`
        keeps the controller's final slack (the restore); its rounds and
        replays are recorded either way. Returns (store, store_cap).

        Under a group every rank passes the same records and sends its PEs'
        rows of the stacked layout over the group, so the rounds are the
        stacked path's; the store holds this rank's PEs."""
        p, g = self._num_pes, self._group
        sent = W.sentinel(self._wb)
        live = int(((keys != sent) & (counts > 0)).sum())
        if store_cap is None:
            store_cap = _pow2ceil(plan_capacity(max(live, 1), p,
                                                self._cfg.store_slack))
        n_local = _pow2ceil(max(1, -(-keys.shape[0] // p)))
        gk = torch.full((p * n_local,), sent, dtype=torch.int64,
                        device=keys.device)
        gc = torch.zeros((p * n_local,), dtype=torch.int32,
                         device=keys.device)
        gk[:keys.shape[0]] = keys
        gc[:counts.shape[0]] = counts
        gk, gc = gk.view(p, n_local), gc.view(p, n_local)
        if g is not None:
            gk = gk[g.first_pe:g.first_pe + g.local_pes]
            gc = gc[g.first_pe:g.first_pe + g.local_pes]
        ctrl = resilience.RetryController(
            self._cfg.retry, slack=self._slack, store_cap=store_cap,
            hop2_padded=True, history=self._rounds)
        while True:
            store_cap = ctrl.store_cap   # a fresh store each attempt
            store, route_drop, store_drop = _reshard_round(
                gk, gc, cfg=self._cfg, num_pes=p, grid=self._grid,
                route_cap=plan_capacity(n_local, p, ctrl.slack),
                store_cap=store_cap, word_bits=self._wb, group=g)
            if not ctrl.observe(route_dropped=route_drop,
                                store_dropped=store_drop):
                break
            del store
        if sticky:
            self._slack = ctrl.slack
        self._rounds = ctrl.rounds
        for cause, n in ctrl.counts.items():
            self._retries[cause] += n
        return store, store_cap

    def _reshard_from(self, keys: torch.Tensor, counts: torch.Tensor) -> None:
        """Re-route saved (key, count) entries onto this counter's
        ownership (`_fold_pairs`) and commit the folded store. Under a
        group every rank holds every saved entry and routes its share."""
        if self._store_cap is None:
            live = int(((keys != W.sentinel(self._wb)) & (counts > 0)).sum())
            self._store_cap = _pow2ceil(plan_capacity(
                max(live, 1), self._num_pes, self._cfg.store_slack))
        self._store, self._store_cap = self._fold_pairs(
            keys, counts, store_cap=self._store_cap, sticky=True)
