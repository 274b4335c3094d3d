"""DAKC: the asynchronous k-mer counter (counterpart of `repro.core.fabsp`).

`count_kmers` runs the JAX package's main path with the P processing
elements (PEs) held as the leading dimension of every tensor on one
device, in place of one device per PE under `shard_map`:

- the reads are split into P contiguous shards, (P, n_local, m), and each
  shard into chunks of `chunk_reads`;
- each scan step takes chunk i of every PE: extract k-mers, L3-compress
  ('dual', 'packed' or 'none'), route by owner PE (the 1d all_to_all is a
  transpose of the stacked tiles), decode the received pairs and fold them
  into the per-PE count store;
- after the scan each store is sorted into the per-PE histogram.

Running statistics stay on the device through the scan and are read once
per round by the retry loop, which doubles the routing slack or rehashes
the store exactly as the JAX package does. The per-PE results and every
`DAKCStats` field equal the JAX package's.

Settings outside this slice (super-k-mer transport, 2d topology, the
stacked receiver, spill, fault injection, pre-route compaction, compact
hop 2) raise NotImplementedError naming the ROADMAP.md item that brings
them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import aggregation, countstore, encoding, resilience
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
    faults: Optional[object] = None
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


# Settings this package does not run yet, with the ROADMAP.md section 1
# item that brings each.
_NOT_PORTED = (
    ("transport_impl", "superkmer", "item 8 (super-k-mer transport)"),
    ("topology", "2d", "item 9 (2d topology)"),
    ("receiver_impl", "stacked", "item 6 (the 'stacked' receiver oracle)"),
    ("compact_impl", "prefix", "item 8 (pre-route compaction)"),
    ("hop2_impl", "compact", "item 9 (compact hop 2)"),
)


def _refuse_out_of_slice(cfg: DAKCConfig) -> None:
    for knob, value, item in _NOT_PORTED:
        if getattr(cfg, knob) == value:
            raise NotImplementedError(
                f"{knob}={value!r} is not ported yet: ROADMAP.md section 1, "
                f"{item}")
    if cfg.spill != "off":
        raise NotImplementedError(
            f"spill={cfg.spill!r} is not ported yet: ROADMAP.md section 1, "
            "item 10 (durability, spill and serving)")
    if cfg.faults is not None:
        raise NotImplementedError(
            "fault injection (faults=) is not ported yet: ROADMAP.md "
            "section 1, item 10 (durability, spill and serving)")


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
                 cap_n: int, cap_h: int, mode: str):
    """One scan step for every PE: (P, chunk_reads, m) codes -> k-mers ->
    L3 -> one `route_lanes` exchange per lane set.

    Returns (recv, (raw, sent_valid, wire_bytes, overflow, hop2_dropped,
    fill)): `raw` and `wire_bytes` are per-PE ints (the same on every PE),
    the rest (P,) or (P, P) device tensors.
    """
    k, bps = cfg.k, cfg.bits_per_symbol
    wb = encoding.word_bits(k, bps)
    words = encoding.extract_kmers(chunk, k, bps, canonical=cfg.canonical,
                                   canonical_impl=cfg.canonical_impl)
    raw = words.shape[1]
    mask = encoding.kmer_mask(k, bps)

    def route(payload, counts, pvalid, capacity):
        lanes = (payload,) if counts is None else (payload, counts)
        kinds = ("word",) if counts is None else ("word", "i32")
        return aggregation.route_lanes(
            lanes, kinds, owner_pe(payload & mask, num_pes, wb), pvalid,
            num_pes=num_pes, capacity=capacity, word_bits=wb,
            impl=cfg.partition_impl)

    if mode == "packed":
        payload, pvalid = aggregation.l3_compress(words, k, bps,
                                                  impl=cfg.phase2_impl)
        rr = route(payload, None, pvalid, cap_n)
        return (rr.lanes[0], None, None), (raw, rr.sent_valid, rr.wire_bytes,
                                           rr.overflow, rr.hop2_dropped,
                                           rr.fill)
    if mode == "dual":
        valid = torch.ones(words.shape, dtype=torch.bool, device=words.device)
        nw, nv, hw, hc, hv = _l3_split_dual(words, valid, k, bps,
                                            impl=cfg.phase2_impl)
        rn = route(nw, None, nv, cap_n)
        rh = route(hw, hc, hv, cap_h)
        return (rn.lanes[0], rh.lanes[0], rh.lanes[1]), \
            (raw, rn.sent_valid + rh.sent_valid,
             rn.wire_bytes + rh.wire_bytes, rn.overflow + rh.overflow,
             rn.hop2_dropped + rh.hop2_dropped, rn.fill + rh.fill)
    if mode != "none":
        raise ValueError(f"unknown l3_mode {mode!r}")
    valid = torch.ones(words.shape, dtype=torch.bool, device=words.device)
    rr = route(words, None, valid, cap_n)
    return (rr.lanes[0], None, None), (raw, rr.sent_valid, rr.wire_bytes,
                                       rr.overflow, rr.hop2_dropped, rr.fill)


def _recv_pairs(recv, *, cfg: DAKCConfig, mode: str):
    """Decode one step's received tiles into (P, N) (kmer, count) lanes;
    sentinel entries carry count 0, HEAVY pairs their counts."""
    k, bps = cfg.k, cfg.bits_per_symbol
    rn, rh, rhc = recv
    sent = encoding.sentinel(k, bps)
    if mode == "packed":
        return aggregation.l3_decompress(rn, k, bps)
    if mode == "dual":
        kmers = torch.cat([rn, rh], 1)
        counts = torch.cat([(rn != sent).to(torch.int32),
                            torch.where(rh != sent, rhc.to(torch.int32), 0)],
                           1)
        return kmers, counts
    return rn, (rn != sent).to(torch.int32)


def _stream_fold(chunks: torch.Tensor, store: countstore.CountStore, *,
                 cfg: DAKCConfig, num_pes: int, cap_n: int, cap_h: int,
                 mode: str):
    """The Phase-1 scan with the streaming receiver: route chunk i of every
    PE, then fold the decoded receive tiles into the count store.

    chunks: (P, n_chunks, chunk_reads, m). No host sync happens here: the
    running stats stay on the device. Returns (store, (raw, sent_words,
    wire_bytes, route_overflow, hop2_dropped, fill)), raw and wire_bytes as
    per-PE ints, the rest per-PE device tensors.
    """
    p, n_chunks = chunks.shape[:2]
    dev = chunks.device
    sent_t = torch.zeros((p,), dtype=torch.int32, device=dev)
    ovf_t = torch.zeros_like(sent_t)
    h2_t = torch.zeros_like(sent_t)
    fill_t = torch.zeros((p, num_pes), dtype=torch.int32, device=dev)
    raw_t = wire_t = 0
    for i in range(n_chunks):
        recv, (raw, sent_w, wire, ovf, h2, fl) = _phase1_step(
            chunks[:, i], cfg=cfg, num_pes=num_pes, cap_n=cap_n,
            cap_h=cap_h, mode=mode)
        kmers, cnts = _recv_pairs(recv, cfg=cfg, mode=mode)
        del recv
        countstore.store_insert(store, kmers, cnts)
        raw_t += raw
        wire_t += wire
        sent_t += sent_w
        ovf_t += ovf
        h2_t += h2
        fill_t += fl
    return store, (raw_t, sent_t, wire_t, ovf_t, h2_t, fill_t)


def _chunked(reads_local: torch.Tensor, chunk_reads: int) -> torch.Tensor:
    p, n_local, m = reads_local.shape
    if n_local % chunk_reads != 0:
        raise ValueError(
            f"local reads {n_local} not divisible by chunk_reads "
            f"{chunk_reads}; pad the read set to a multiple of "
            f"num_pes * chunk_reads")
    return reads_local.reshape(p, n_local // chunk_reads, chunk_reads, m)


def _local_count(reads_local: torch.Tensor, *, cfg: DAKCConfig, num_pes: int,
                 cap_n: int, cap_h: int, store_cap: int, mode: str):
    """One round: every PE's scan, then its store histogram. Returns the
    flat per-PE AccumResult and the stats summed over PEs (device tensors,
    except the static raw and wire totals)."""
    chunks = _chunked(reads_local, cfg.chunk_reads)
    wb = encoding.word_bits(cfg.k, cfg.bits_per_symbol)
    store = countstore.empty_store(num_pes, store_cap, wb, chunks.device)
    store, (raw, sent_w, wire, ovf, h2, fill) = _stream_fold(
        chunks, store, cfg=cfg, num_pes=num_pes, cap_n=cap_n, cap_h=cap_h,
        mode=mode)
    result = countstore.store_histogram(
        store, total_bits=encoding.kmer_bits(cfg.k, cfg.bits_per_symbol),
        impl=cfg.phase2_impl)
    store_ovf = store.dropped
    del store
    stats = (ovf.sum(), store_ovf.sum(), sent_w.sum(), num_pes * wire,
             num_pes * raw, h2.sum(), fill.sum(0))
    return AccumResult(unique=result.unique.reshape(-1),
                       counts=result.counts.reshape(-1),
                       num_unique=result.num_unique), stats


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
                               num_pes: int) -> Optional[int]:
    """Global distinct-count estimate from one sample chunk, inverted under
    the uniform-pool model (see the JAX package); None when the sample is
    fully distinct. Runs on the host, as the JAX package's does."""
    n_reads, m = reads.shape
    k, bps = cfg.k, cfg.bits_per_symbol
    sample = reads[:min(cfg.chunk_reads, n_reads)]
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
                            num_pes: int) -> int:
    """Per-PE store slots from the sample estimate, rounded up to a power
    of two (the JAX package's quantization, kept so the layouts agree)."""
    est = _sampled_distinct_estimate(reads, cfg, num_pes)
    if est is None:
        return _default_store_capacity(cfg, tuple(reads.shape), num_pes)
    cap = plan_capacity(est, num_pes, cfg.store_slack)
    return 1 << (cap - 1).bit_length()


def _resolve_store_capacity(reads: torch.Tensor, cfg: DAKCConfig,
                            num_pes: int) -> int:
    """Explicit override > 'sample' estimate > shape-only bound."""
    if cfg.receiver_impl != "stream":
        return 0
    if cfg.store_capacity is not None:
        return cfg.store_capacity
    if cfg.store_sizing == "sample":
        return _sampled_store_capacity(reads, cfg, num_pes)
    return _default_store_capacity(cfg, tuple(reads.shape), num_pes)


def _plan_caps(cfg: DAKCConfig, num_pes: int, shape, slack: float):
    """(mode, cap_n, cap_h) for one reads shape."""
    n_reads, m = shape
    chunk_kmers = cfg.chunk_reads * (m - cfg.k + 1)
    mode = _resolve_l3_mode(cfg, chunk_kmers)
    # the 'dual' NORMAL lane can carry up to 2x duplicated entries
    n_items = chunk_kmers * (2 if mode == "dual" else 1)
    cap_n = plan_capacity(n_items, num_pes, slack)
    cap_h = max(8, int(cap_n * cfg.heavy_frac))
    return mode, cap_n, cap_h


def _host_stats(raw_stats) -> DAKCStats:
    """The round's one device-to-host read of the stats."""
    route_ovf, store_ovf, sent_w, wire, raw, h2, fill = raw_stats
    host = torch.cat([torch.stack([route_ovf, store_ovf, sent_w, h2])
                      .to(torch.int64), fill.to(torch.int64)]).tolist()
    route_ovf, store_ovf, sent_w, h2 = host[:4]
    lmm, p99 = _imbalance(host[4:])
    return DAKCStats(overflow=route_ovf, sent_words=sent_w,
                     wire_bytes=np.int64(wire), raw_kmers=raw,
                     num_global_syncs=3, store_overflow=store_ovf,
                     hop2_dropped=h2, load_max_over_mean=lmm,
                     owner_fill_p99=p99)


def resolve_device(device=None) -> torch.device:
    """`device`, or the CUDA card when None; raises when CUDA is asked for
    and absent (the port never carries on silently on the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: count_kmers runs on the card unless the caller "
            "passes device='cpu'")
    return dev


def count_kmers(reads, cfg: DAKCConfig, *, num_pes: int, device=None
                ) -> Tuple[AccumResult, DAKCStats]:
    """Distributed asynchronous k-mer counting (DAKC) of P PEs on one device.

    reads: (n_reads, m) uint8 symbol codes (numpy array or tensor); PE p
           owns rows [p * n_local, (p + 1) * n_local), and n_local must
           divide by cfg.chunk_reads.
    device: None runs on the CUDA card (and raises without one); tests
           pass "cpu".
    Returns the per-PE AccumResult laid out as the JAX package's: unique
    (P * L,) int64 words (sentinel past each PE's num_unique), counts
    (P * L,) int32, num_unique (P,); and the DAKCStats.

    Overflow rounds run through `cfg.retry`: a routing overflow replays at
    doubled slack, a full count store replays at doubled capacity (a
    rehash round); the per-cause round counts come back in `retry_*`.
    """
    _refuse_out_of_slice(cfg)
    dev = resolve_device(device)
    if not isinstance(reads, torch.Tensor):
        reads = torch.from_numpy(np.ascontiguousarray(reads))
    reads = reads.to(dev)
    n_reads, m = reads.shape
    if n_reads % num_pes != 0:
        raise ValueError(f"{n_reads} reads do not split over {num_pes} PEs")
    shape = (n_reads, m)
    store_cap = _resolve_store_capacity(reads, cfg, num_pes)
    local = reads.reshape(num_pes, n_reads // num_pes, m)
    ctrl = resilience.RetryController(cfg.retry, slack=cfg.slack,
                                      store_cap=store_cap, hop2_padded=True)
    while True:
        mode, cap_n, cap_h = _plan_caps(cfg, num_pes, shape, ctrl.slack)
        result, raw_stats = _local_count(
            local, cfg=cfg, num_pes=num_pes, cap_n=cap_n, cap_h=cap_h,
            store_cap=ctrl.store_cap, mode=mode)
        stats = _host_stats(raw_stats)
        if not ctrl.observe(route_dropped=stats.overflow,
                            store_dropped=stats.store_overflow,
                            hop2_dropped=stats.hop2_dropped):
            return result, _stamp_retries(stats, ctrl.counts)
        del result
