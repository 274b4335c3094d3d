"""Online k-mer queries: the aggregation protocol run in reverse
(counterpart of `repro.core.query`, in-core tier).

1. Pack: query k-mers take the counting path's word form
   (`pack_queries`), so a query word equals the stored word it asks about.
2. Forward hop: one `route_lanes` call sends each word to its owner PE,
   under the ownership the counting path used (`fabsp._ownership_keys`:
   the minimizer under the super-k-mer transport), with a 1-based query id
   in an 'i32' lane (0 marks tile padding).
3. Probe: every PE probes its committed store in place with the read-only
   lookup kernel (`countstore.store_lookup`); count 0 is a definitive miss.
   The kernel hashes each word's home slot and sums the batch's hits and
   probe walks, so the stats need no reduction over the batch.
4. Return hop: a second `route_lanes` call ships (qid, count) back to the
   PE that asked, (qid - 1) // n_local, which scatters each answer into
   request order at (qid - 1) % n_local.

Both hops route at capacity n_local, the per-PE padded query count, the
pow2 ceiling of nq / P: a sender has no more than n_local items, so no
bucket overflows and a query never needs a retry round.

Under a process group (`core.dist`) every rank is given the same global
batch, sends its PEs' rows of it through both routes over the group,
and gathers every rank's answers and stats, so each rank returns the
global answer in request order.

The spilled-bin tier (`query_spilled_counts`): a counter whose spill tier
is engaged keeps its counts in disk bins beside a vestigial store, so a
query runs in two stages. Stage 1 is the probe above against the
snapshot's store. Stage 2 bins the query words by the writer's own key
(`spill.bin_of` of the ownership word), folds each touched bin on demand
through the counter's fold (`KmerCounter._fold_pairs`, the drain's
engine), probes it the same way and adds the residuals. Folded bins live
in a byte-bounded LRU (`BinShardCache`, `DAKCConfig.query_bin_cache_bytes`)
versioned by the snapshot's segment list, so a later commit misses
cleanly. Bins partition k-mer space, so the sum is the exact count.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import words as W
from repro_torch.core import (aggregation, countstore, dist, encoding,
                              fabsp, spill)
from repro_torch.core.owner import owner_pe


class QueryUnavailable(RuntimeError):
    """The counter declines to serve: its committed generation has an
    engaged spill tier and the config opted out of the spilled-bin tier's
    on-demand folds (`spill_query='refuse'`). Typed, so a serving harness
    can refuse the tenant's requests and keep the others'."""


class QueryStats(NamedTuple):
    """Host-side stats of one `query_counts` batch."""
    n_queries: int      # live queries in the batch (before padding)
    n_hits: int         # queries with count > 0
    wire_bytes: int     # exact padded bytes both hops moved (all PEs)
    probe_sum: int      # probe steps of all live queries
    probe_max: int      # deepest single probe walk
    n_local: int        # per-PE padded query slots (the shape bucket)
    batch_fill: float   # n_queries / (n_local * P)
    bins_probed: int = 0  # spilled-bin tier: distinct disk bins probed
    bin_folds: int = 0    # ... of which needed a fold (LRU misses)

    @property
    def probe_avg(self) -> float:
        return self.probe_sum / max(1, self.n_queries)


class BinShardCache:
    """Byte-bounded LRU of folded spill bins.

    One entry per bin: the (P, cap) keys and counts its records folded
    into, costing `P * cap * (word + int32)` bytes with the word at its
    width in the store (4 bytes for k <= 16), as the JAX package charges:
    the int64 carrier of a 32-bit word is not charged, so the same budget
    evicts the same bins under either package. An entry is versioned
    by the snapshot's segment files of that bin, so a later commit (new
    segments) misses instead of serving a stale fold. Past `budget_bytes`
    the oldest entries go, the newest always stays (a budget below one
    bin still serves; every touch then folds again). `hits`, `misses`
    and `evictions` count what happened."""

    def __init__(self, budget_bytes: int):
        self.budget_bytes = int(budget_bytes)
        self._entries = {}   # bin -> (version, keys, counts, nbytes)
        self._order = []     # LRU order, oldest first
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, b: int, version):
        e = self._entries.get(b)
        if e is None or e[0] != version:
            self.misses += 1
            return None
        self.hits += 1
        self._order.remove(b)
        self._order.append(b)
        return e[1], e[2]

    def put(self, b: int, version, keys: torch.Tensor,
            counts: torch.Tensor, word_bits: int) -> None:
        nbytes = keys.numel() * (word_bits // 8 + counts.element_size())
        if b in self._entries:
            self._order.remove(b)
        self._entries[b] = (version, keys, counts, nbytes)
        self._order.append(b)
        total = sum(e[3] for e in self._entries.values())
        while total > self.budget_bytes and len(self._order) > 1:
            oldest = self._order.pop(0)
            total -= self._entries.pop(oldest)[3]
            self.evictions += 1


def pack_queries(kmers, cfg, device=None) -> torch.Tensor:
    """Query k-mers in the counting path's word form, (n,) int64.

    Takes (n, k) base codes (packed as the reads are, canonical iff
    cfg.canonical) or (n,) packed words (uint32/uint64 numpy words, or an
    int64 tensor of port words), masked to the k-mer width and
    canonicalized iff cfg.canonical.
    """
    k, bps = cfg.k, cfg.bits_per_symbol
    if isinstance(kmers, torch.Tensor):
        arr = kmers.to(device)
    else:
        arr = np.asarray(kmers)
        if arr.ndim == 1:
            arr = arr.astype(np.uint64).view(np.int64)
        arr = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    if arr.ndim == 2:
        if arr.shape[1] != k:
            raise ValueError(
                f"code-array queries must be (n, k={k}), got "
                f"{tuple(arr.shape)}")
        return encoding.pack_kmers(arr, k, bps, canonical=cfg.canonical,
                                   canonical_impl=cfg.canonical_impl
                                   ).reshape(-1)
    if arr.ndim != 1:
        raise ValueError(f"queries must be (n,) words or (n, k) codes, "
                         f"got shape {tuple(arr.shape)}")
    w = arr.to(torch.int64) & encoding.kmer_mask(k, bps)
    if cfg.canonical:
        w = encoding.canonical(w, k)
    return w


def route_queries(q: torch.Tensor, cfg, snap, *, num_pes: int, grid=None,
                  group=None):
    """The device half of `query_counts`: (P, n_local) query words,
    sentinel-padded, each PE's batch -> ((P, n_local + 1) int32 answers in
    each PE's request order, the last column padding's; (P, 3) int64
    hits, probe sum and longest walk; the wire bytes each PE moved).
    Forward route, in-place probe and return route, no host read. Under a
    `group`, P is this rank's local PEs (and `snap` their stores)."""
    dev = q.device
    p = num_pes
    rows, n_local = q.shape
    base = 0 if group is None else group.first_pe * n_local
    sent = W.sentinel(snap.word_bits)
    valid = q != sent
    qid = (torch.arange(rows * n_local, dtype=torch.int32, device=dev)
           .view(rows, n_local) + base + 1)  # 1-based: 0 marks tile padding
    owners = owner_pe(fabsp._ownership_keys(q, cfg), p,
                      fabsp._ownership_word_bits(cfg))
    rr = aggregation.route_lanes(
        (q, qid), ("word", "i32"), owners, valid, num_pes=p,
        capacity=n_local, word_bits=snap.word_bits, grid=grid,
        impl=cfg.partition_impl, route2d="oneplan", group=group)
    rwords, rqid = rr.lanes
    rvalid = rwords != sent
    # (hits, probe sum, longest walk) of each PE's live queries, summed by
    # the lookup itself
    lstats = torch.zeros((rows, 3), dtype=torch.int64, device=dev)
    counts, _ = countstore.store_lookup(snap, rwords, lstats)
    back = torch.div(rqid - 1, n_local, rounding_mode="floor")
    rr2 = aggregation.route_lanes(
        (rqid, counts), ("i32", "i32"), back, rvalid, num_pes=p,
        capacity=n_local, word_bits=snap.word_bits, grid=grid,
        impl=cfg.partition_impl, route2d="oneplan", group=group)
    bqid, bcounts = rr2.lanes
    # qids are unique, so each live answer owns its slot; padding (qid 0)
    # goes to one extra slot that is cut off
    dst = torch.where(bqid > 0, (bqid - 1) % n_local, n_local).to(torch.int64)
    out = torch.zeros((rows, n_local + 1), dtype=torch.int32, device=dev)
    out.scatter_add_(1, dst, bcounts)
    return out, lstats, rr.wire_bytes + rr2.wire_bytes


def query_counts(kmers, cfg, snap: countstore.StoreSnapshot, *,
                 num_pes: int, grid=None,
                 group=None) -> Tuple[np.ndarray, QueryStats]:
    """Batched lookup of `kmers` against a committed store snapshot of
    `num_pes` PEs. Returns ((n,) int32 counts in request order, 0 = never
    counted; QueryStats), exact for any batch: hits, misses, duplicates,
    the empty batch.

    `grid` is the counter's 2d (rows, cols) or None: both hops then take
    the 'oneplan' 2d route. The query id is built from the row-major PE
    index, which the 2d route folds owners into, so answers come back to
    the PE that asked under either topology.

    `group`: a `dist.PEGroup` whose local PEs `snap` holds; every rank
    passes the same batch and returns the same answers and stats."""
    dev = snap.keys.device
    p = num_pes
    words = pack_queries(kmers, cfg, dev)
    nq = int(words.shape[0])
    n_local = fabsp._pow2ceil(max(1, -(-nq // p)))
    sent = W.sentinel(snap.word_bits)
    q = torch.full((p * n_local,), sent, dtype=torch.int64, device=dev)
    q[:nq] = words
    q = q.view(p, n_local)
    if group is not None:
        q = q[group.first_pe:group.first_pe + group.local_pes]
    out, lstats, wire = route_queries(q, cfg, snap, num_pes=p, grid=grid,
                                      group=group)
    if group is not None:
        out = dist.gather_rows(out, group)
        lstats = dist.gather_rows(lstats, group)
    per_pe = lstats.tolist()
    hits = sum(r[0] for r in per_pe)
    psum = sum(r[1] for r in per_pe)
    pmax = max(r[2] for r in per_pe)
    stats = QueryStats(
        n_queries=nq, n_hits=hits, wire_bytes=p * wire, probe_sum=psum,
        probe_max=pmax, n_local=n_local, batch_fill=nq / (n_local * p))
    return out[:, :n_local].reshape(-1)[:nq].cpu().numpy(), stats


def query_spilled_counts(kc, snap: countstore.StoreSnapshot, kmers
                         ) -> Tuple[np.ndarray, QueryStats]:
    """Two-stage lookup against a spill-engaged generation `snap` of the
    counter `kc` (its cfg, PEs, fold and bin cache). Returns (counts,
    QueryStats) as `query_counts` does: request order, exact for any
    batch.

    Stage 1 probes the snapshot's resident store. Stage 2 bins the query
    words with the writer's key (`spill.bin_of` of
    `fabsp._ownership_keys`: under the super-k-mer transport a k-mer's
    recomputed minimizer is the minimizer its super-k-mer was binned by),
    folds each touched bin of the snapshot's manifest view (`BinShardCache`,
    else `kc._fold_pairs` of `kc._bin_pairs`), probes the queries that
    bin owns, and adds the residuals."""
    cfg, p, grid = kc._cfg, kc._num_pes, kc._grid
    dev = snap.keys.device
    words = pack_queries(kmers, cfg, dev)
    nq = int(words.shape[0])
    counts, stats = query_counts(words, cfg, snap, num_pes=p, grid=grid)
    counts = counts.copy()       # residuals accumulate in place
    sp = snap.spill_state
    n_bins = int(sp["n_bins"])
    by_bin = {}
    for seg in sp["segments"]:
        by_bin.setdefault(int(seg["bin"]), []).append(seg)
    wire = stats.wire_bytes
    probe_sum, probe_max = stats.probe_sum, stats.probe_max
    bins_probed = bin_folds = 0
    if nq and by_bin:
        cache = kc._bin_cache
        if cache is None or cache.budget_bytes != cfg.query_bin_cache_bytes:
            cache = kc._bin_cache = BinShardCache(cfg.query_bin_cache_bytes)
        qbins = spill.bin_of(fabsp._ownership_keys(words, cfg), n_bins,
                             fabsp._ownership_word_bits(cfg)).cpu().numpy()
        for b in np.unique(qbins):
            segs = by_bin.get(int(b))
            if not segs:
                continue         # no committed records: the residual is 0
            version = tuple(s["file"] for s in segs)
            shard = cache.get(int(b), version)
            if shard is None:
                pairs = kc._bin_pairs(int(b), segments=segs)
                if pairs is None:
                    continue
                store, _ = kc._fold_pairs(*pairs)
                del pairs
                shard = (store.keys, store.counts)
                cache.put(int(b), version, *shard, snap.word_bits)
                bin_folds += 1
            idx = np.nonzero(qbins == b)[0]
            sub, sstats = query_counts(
                words[torch.from_numpy(idx).to(dev)], cfg,
                countstore.StoreSnapshot(
                    gen=snap.gen, keys=shard[0], counts=shard[1],
                    store_cap=shard[0].shape[1], word_bits=snap.word_bits),
                num_pes=p, grid=grid)
            counts[idx] += sub
            wire += sstats.wire_bytes
            probe_sum += sstats.probe_sum
            probe_max = max(probe_max, sstats.probe_max)
            bins_probed += 1
    return counts, QueryStats(
        n_queries=nq, n_hits=int((counts > 0).sum()), wire_bytes=wire,
        probe_sum=probe_sum, probe_max=probe_max, n_local=stats.n_local,
        batch_fill=stats.batch_fill, bins_probed=bins_probed,
        bin_folds=bin_folds)
