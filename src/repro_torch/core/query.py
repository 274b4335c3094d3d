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

The spilled-bin tier (`query_spilled_counts`, `BinShardCache`) comes with
the spill tier, ROADMAP.md section 1 item 10.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import words as W
from repro_torch.core import aggregation, countstore, encoding, fabsp
from repro_torch.core.owner import owner_pe


class QueryUnavailable(RuntimeError):
    """The counter declines to serve its committed generation (raised by
    the spilled-bin tier under `spill_query='refuse'`, which comes with the
    spill tier)."""


class QueryStats(NamedTuple):
    """Host-side stats of one `query_counts` batch."""
    n_queries: int      # live queries in the batch (before padding)
    n_hits: int         # queries with count > 0
    wire_bytes: int     # exact padded bytes both hops moved (all PEs)
    probe_sum: int      # probe steps of all live queries
    probe_max: int      # deepest single probe walk
    n_local: int        # per-PE padded query slots (the shape bucket)
    batch_fill: float   # n_queries / (n_local * P)
    bins_probed: int = 0  # spilled-bin tier only: 0 in core
    bin_folds: int = 0

    @property
    def probe_avg(self) -> float:
        return self.probe_sum / max(1, self.n_queries)


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


def query_counts(kmers, cfg, snap: countstore.StoreSnapshot, *,
                 num_pes: int, grid=None) -> Tuple[np.ndarray, QueryStats]:
    """Batched lookup of `kmers` against a committed store snapshot of
    `num_pes` PEs. Returns ((n,) int32 counts in request order, 0 = never
    counted; QueryStats), exact for any batch: hits, misses, duplicates,
    the empty batch.

    `grid` is the counter's 2d (rows, cols) or None: both hops then take
    the 'oneplan' 2d route. The query id is built from the row-major PE
    index, which the 2d route folds owners into, so answers come back to
    the PE that asked under either topology."""
    dev = snap.keys.device
    p = num_pes
    words = pack_queries(kmers, cfg, dev)
    nq = int(words.shape[0])
    n_local = fabsp._pow2ceil(max(1, -(-nq // p)))
    sent = W.sentinel(snap.word_bits)
    q = torch.full((p * n_local,), sent, dtype=torch.int64, device=dev)
    q[:nq] = words
    q = q.view(p, n_local)
    valid = q != sent
    qid = (torch.arange(p * n_local, dtype=torch.int32, device=dev)
           .view(p, n_local) + 1)           # 1-based: 0 marks tile padding
    owners = owner_pe(fabsp._ownership_keys(q, cfg), p,
                      fabsp._ownership_word_bits(cfg))
    rr = aggregation.route_lanes(
        (q, qid), ("word", "i32"), owners, valid, num_pes=p,
        capacity=n_local, word_bits=snap.word_bits, grid=grid,
        impl=cfg.partition_impl, route2d="oneplan")
    rwords, rqid = rr.lanes
    rvalid = rwords != sent
    # (hits, probe sum, longest walk) of each PE's live queries, summed by
    # the lookup itself
    lstats = torch.zeros((p, 3), dtype=torch.int64, device=dev)
    counts, _ = countstore.store_lookup(snap, rwords, lstats)
    back = torch.div(rqid - 1, n_local, rounding_mode="floor")
    rr2 = aggregation.route_lanes(
        (rqid, counts), ("i32", "i32"), back, rvalid, num_pes=p,
        capacity=n_local, word_bits=snap.word_bits, grid=grid,
        impl=cfg.partition_impl, route2d="oneplan")
    bqid, bcounts = rr2.lanes
    # qids are unique, so each live answer owns its slot; padding (qid 0)
    # goes to one extra slot that is cut off
    dst = torch.where(bqid > 0, (bqid - 1) % n_local, n_local).to(torch.int64)
    out = torch.zeros((p, n_local + 1), dtype=torch.int32, device=dev)
    out.scatter_add_(1, dst, bcounts)
    per_pe = lstats.tolist()
    hits = sum(r[0] for r in per_pe)
    psum = sum(r[1] for r in per_pe)
    pmax = max(r[2] for r in per_pe)
    stats = QueryStats(
        n_queries=nq, n_hits=hits,
        wire_bytes=p * (rr.wire_bytes + rr2.wire_bytes), probe_sum=psum,
        probe_max=pmax, n_local=n_local, batch_fill=nq / (n_local * p))
    return out[:, :n_local].reshape(-1)[:nq].cpu().numpy(), stats
