"""The k-mer query service: named count stores, batched multi-tenant serving
(counterpart of `repro.launch.kc_serve`).

- `StoreRegistry`: named `fabsp.KmerCounter` tenants of one PE count on one
  device. `load()` restores a tenant from its checkpoint
  (`KmerCounter.restore`: a store counted on 8 PEs serves from 4).
- `QueryService`: request intake. `submit()` queues (tenant, k-mers)
  requests; `flush()` serves all a tenant's queued requests as one batch
  (one routed exchange), splits the answers back per request and gives
  each its `RequestStats`; `query()` serves one request alone.

Every store regime serves: a spill-engaged tenant answers exactly through
the spilled-bin query tier, and a tenant that keeps taking `update()`s
between flushes answers from its last committed generation. Errors are
typed and never silent: an unknown tenant raises `UnknownStore` at intake;
a tenant with `spill_query='refuse'` fails with `query.QueryUnavailable`.
`flush()` keeps failures to their tenant: each request's entry, in
submission order, is (counts, RequestStats) or the typed exception.

    PYTHONPATH=src python -m repro_torch.launch.kc_serve --demo
        # count -> save -> restore into the registry -> serve batched
        # queries (in core, spilled, refused, and between updates), each
        # answer checked exactly; on the card
    PYTHONPATH=src python -m repro_torch.launch.kc_serve --demo \\
        --device cpu --requests 64
        # the same on the CPU, then a loop of 64 one-shot requests
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np


class UnknownStore(KeyError):
    """A request named a tenant the registry does not hold."""


@dataclasses.dataclass
class RequestStats:
    """Serving stats of one submitted request (requests that shared a
    batch share its batch fields)."""
    tenant: str
    n_queries: int        # this request's queries
    n_hits: int           # this request's queries with count > 0
    batch_queries: int    # live queries in the batch
    batch_fill: float     # batch occupancy of the padded shape bucket
    n_local: int          # per-PE slot count (the shape bucket served)
    probe_avg: float      # mean probe walk across the batch
    probe_max: int        # deepest probe walk in the batch
    wire_bytes: int       # the batch's exact routed bytes (both hops)
    seconds: float        # wall time of the batch this request rode


class StoreRegistry:
    """Named `KmerCounter` tenants of `num_pes` PEs (as a `grid` under the
    2d topology) on `device` (None: the card)."""

    def __init__(self, *, num_pes: int, grid=None, device=None):
        from repro_torch.core import fabsp
        self._num_pes = num_pes
        self._grid = grid
        self._dev = fabsp.resolve_device(device)
        self._stores: Dict[str, object] = {}

    def register(self, name: str, counter) -> None:
        self._stores[name] = counter

    def load(self, name: str, ckpt_dir: str, cfg,
             step: Optional[int] = None) -> None:
        """Restore a tenant from its checkpoint directory
        (`KmerCounter.restore`: fingerprint-checked, resharded if the
        registry's PE count differs from the saved one)."""
        from repro_torch.core import fabsp
        self.register(name, fabsp.KmerCounter.restore(
            ckpt_dir, cfg, num_pes=self._num_pes, grid=self._grid,
            device=self._dev, step=step))

    def get(self, name: str):
        try:
            return self._stores[name]
        except KeyError:
            raise UnknownStore(
                f"no store named {name!r} (have: {sorted(self._stores)})"
            ) from None

    def names(self) -> List[str]:
        return sorted(self._stores)


class QueryService:
    """Request intake over a registry: queue, batch per tenant, serve."""

    def __init__(self, registry: StoreRegistry):
        self._registry = registry
        self._pending: List[Tuple[str, np.ndarray]] = []

    def submit(self, tenant: str, kmers) -> int:
        """Queue one request of numpy k-mers ((n,) words or (n, k) codes);
        returns its index into the next `flush()`. An unknown tenant fails
        here, at intake."""
        self._registry.get(tenant)
        self._pending.append((tenant, np.asarray(kmers)))
        return len(self._pending) - 1

    def query(self, tenant: str, kmers):
        """One request served alone: (counts, RequestStats)."""
        counter = self._registry.get(tenant)
        t0 = time.perf_counter()
        counts = counter.count(kmers)
        dt = time.perf_counter() - t0
        return counts, self._request_stats(
            tenant, counter.last_query_stats, len(counts), dt,
            n_hits=int((counts > 0).sum()))

    def flush(self):
        """Serve every queued request: one batch per tenant (its requests'
        queries concatenated in the tenant's word dtype, `_batch_dtype`),
        answers split back in request order.

        Returns a list in submission order; each entry is (counts,
        RequestStats), or the typed exception (`query.QueryUnavailable`,
        `UnknownStore`) its tenant raised. One tenant failing keeps every
        other tenant's answers. A request of no queries gets an empty
        answer and zeroed stats without touching the device.
        `RequestStats.seconds` is taken around `count()`, which returns
        host numpy, so the device work is inside it."""
        from repro_torch.core import query as query_lib
        pending, self._pending = self._pending, []
        by_tenant: Dict[str, List[int]] = {}
        for i, (tenant, _) in enumerate(pending):
            by_tenant.setdefault(tenant, []).append(i)
        results: List[object] = [None] * len(pending)
        for tenant, idxs in by_tenant.items():
            try:
                counter = self._registry.get(tenant)
                for i in idxs:
                    if len(pending[i][1]) == 0:
                        results[i] = (np.zeros((0,), np.int32),
                                      self._zero_stats(tenant))
                live = [i for i in idxs if len(pending[i][1])]
                if not live:
                    continue
                dt_word = self._batch_dtype(counter)
                batch = np.concatenate(
                    [pending[i][1] if pending[i][1].ndim != 1
                     else pending[i][1].astype(dt_word, copy=False)
                     for i in live])
                t0 = time.perf_counter()
                counts = counter.count(batch)
                dt = time.perf_counter() - t0
            except (query_lib.QueryUnavailable, UnknownStore) as e:
                for i in idxs:
                    results[i] = e
                continue
            qs = counter.last_query_stats
            off = 0
            for i in live:
                n = len(pending[i][1])
                part = counts[off:off + n]
                off += n
                results[i] = (part, self._request_stats(
                    tenant, qs, n, dt, n_hits=int((part > 0).sum())))
        return results

    @staticmethod
    def _batch_dtype(counter) -> np.dtype:
        """The tenant's numpy word dtype: uint32, or uint64 once k
        outgrows a 32-bit word."""
        from repro_torch.core import encoding
        cfg = counter._cfg
        wb = encoding.word_bits(cfg.k, cfg.bits_per_symbol)
        return np.dtype(np.uint64 if wb == 64 else np.uint32)

    @staticmethod
    def _zero_stats(tenant: str) -> RequestStats:
        return RequestStats(tenant=tenant, n_queries=0, n_hits=0,
                            batch_queries=0, batch_fill=0.0, n_local=0,
                            probe_avg=0.0, probe_max=0, wire_bytes=0,
                            seconds=0.0)

    @staticmethod
    def _request_stats(tenant: str, qs, n: int, seconds: float, *,
                       n_hits: int) -> RequestStats:
        return RequestStats(
            tenant=tenant, n_queries=n, n_hits=n_hits,
            batch_queries=qs.n_queries, batch_fill=qs.batch_fill,
            n_local=qs.n_local, probe_avg=qs.probe_avg,
            probe_max=qs.probe_max, wire_bytes=qs.wire_bytes,
            seconds=seconds)


def _histogram(counter, p: int) -> Dict[int, int]:
    """{word: count} of a counter's finalize()."""
    res, _ = counter.finalize()
    u = res.unique.reshape(p, -1).cpu().numpy()
    c = res.counts.reshape(p, -1).cpu().numpy()
    nu = res.num_unique.cpu().numpy()
    return {int(u[s, i]): int(c[s, i])
            for s in range(p) for i in range(int(nu[s]))}


def run_demo(n_requests: int = 0, device=None) -> None:
    """Count a known read set, checkpoint it, restore it into the registry
    under two tenant names, serve batched queries with known answers (hits
    and misses) and check every answer against the finalize() histogram;
    then a spilled tenant, a refusing one beside a serving one in one
    flush, and a tenant updated between flushes. Exits non-zero on any
    mismatch. Every tenant runs on 4 PEs."""
    import tempfile

    import torch

    from repro_torch.core import fabsp, query, serial
    from repro_torch.data import genome

    dev = fabsp.resolve_device(device)
    num_pes = 4
    cfg = fabsp.DAKCConfig(k=13, chunk_reads=64)
    spec = genome.ReadSetSpec(genome_bases=4096, n_reads=256, read_len=64,
                              heavy_hitter_frac=0.3, seed=11)
    reads = genome.sample_reads(spec)
    kc = fabsp.KmerCounter(cfg, num_pes=num_pes, device=dev)
    kc.update(reads)
    oracle = _histogram(kc, num_pes)
    word = np.uint32

    with tempfile.TemporaryDirectory() as ckpt_dir:
        kc.save(ckpt_dir)
        registry = StoreRegistry(num_pes=num_pes, device=dev)
        registry.load("human", ckpt_dir, cfg)
        registry.load("mouse", ckpt_dir, cfg)     # a second tenant
        service = QueryService(registry)

        rng = np.random.default_rng(0)
        uniq = np.asarray(sorted(oracle), dtype=word)
        misses: List[int] = []
        while len(misses) < 64:
            x = int(rng.integers(0, 1 << 26))
            if x not in oracle:
                misses.append(x)
        q = np.concatenate([uniq, np.asarray(misses, dtype=word)])
        rng.shuffle(q)

        def want(part, table=oracle):
            return np.asarray([table.get(int(x), 0) for x in part], np.int32)

        # batched intake: several requests per tenant, one flush
        parts = np.array_split(q, 5)
        order = [service.submit("human" if j % 2 else "mouse", part)
                 for j, part in enumerate(parts)]
        out = service.flush()
        for j, part in enumerate(parts):
            counts, st = out[order[j]]
            if not np.array_equal(counts, want(part)):
                raise SystemExit(f"FAIL: request {j} counts diverged from "
                                 f"the finalize() histogram")
            print(f"  req[{j}] tenant={st.tenant:5s} n={st.n_queries:4d} "
                  f"hits={st.n_hits:4d} fill={st.batch_fill:.2f} "
                  f"probe_avg={st.probe_avg:.2f} max={st.probe_max} "
                  f"wire={st.wire_bytes}")

        # unknown tenants fail at intake
        try:
            service.submit("yeast", q[:4])
            raise SystemExit("FAIL: unknown tenant did not raise")
        except UnknownStore:
            pass

        # a spill-engaged tenant answers exactly through the spilled-bin
        # tier (the default spill_query='fold')
        spilled = fabsp.KmerCounter(dataclasses.replace(
            cfg, spill="always", spill_dir=ckpt_dir + "/spill"),
            num_pes=num_pes, device=dev)
        spilled.update(reads)
        registry.register("spilled", spilled)
        counts, st = service.query("spilled", q[:256])
        if not np.array_equal(counts, want(q[:256])):
            raise SystemExit("FAIL: spilled tenant counts diverged from "
                             "the finalize() histogram")
        sqs = spilled.last_query_stats
        print(f"  spilled tenant served exactly: n={st.n_queries} "
              f"bins_probed={sqs.bins_probed} bin_folds={sqs.bin_folds}")

        # a refusing tenant in one flush with a serving one: its requests
        # come back as the typed error, the other tenant's answers stay
        strict = fabsp.KmerCounter(dataclasses.replace(
            cfg, spill="always", spill_dir=ckpt_dir + "/strict",
            spill_query="refuse"), num_pes=num_pes, device=dev)
        strict.update(reads)
        registry.register("strict", strict)
        i0 = service.submit("human", q[:32])
        i1 = service.submit("strict", q[:32])
        i2 = service.submit("human", q[32:64])
        i3 = service.submit("human", np.zeros((0,), word))
        out = service.flush()
        if not (isinstance(out[i1], query.QueryUnavailable)
                and isinstance(out[i0], tuple)
                and isinstance(out[i2], tuple)):
            raise SystemExit("FAIL: flush did not isolate the refusing "
                             "tenant")
        for i, lo, hi in ((i0, 0, 32), (i2, 32, 64)):
            if not np.array_equal(out[i][0], want(q[lo:hi])):
                raise SystemExit("FAIL: surviving tenant's flush answers "
                                 "diverged")
        if out[i3][0].size != 0 or out[i3][1].n_queries != 0:
            raise SystemExit("FAIL: empty request did not short-circuit")
        print("  strict tenant refused (typed, per request); the other "
              "tenant's answers survived the flush")

        # a live tenant takes update()s between flushes; every flush
        # answers the committed prefix exactly
        live = fabsp.KmerCounter(dataclasses.replace(cfg, chunk_reads=16),
                                 num_pes=num_pes, device=dev)
        registry.register("live", live)
        running: Dict[int, int] = {}
        qset = q[:128]
        for batch in np.array_split(reads, 4):
            live.update(batch)
            acc = serial.count_kmers_serial(
                torch.from_numpy(batch).to(dev), cfg.k)
            n = int(acc.num_unique[0])
            for w, c in zip(acc.unique[0, :n].tolist(),
                            acc.counts[0, :n].tolist()):
                running[w] = running.get(w, 0) + c
            service.submit("live", qset)
            (counts, _st), = service.flush()
            if not np.array_equal(counts, want(qset, running)):
                raise SystemExit("FAIL: interleaved flush diverged from "
                                 "the committed prefix")
        print("  read-write interleave: 4 update/flush rounds, each "
              "flush exact against the committed prefix")

        if n_requests > 0:
            lat = []
            for _ in range(n_requests):
                sub = rng.choice(q, size=min(256, q.size), replace=True)
                _, st = service.query("human", sub.astype(word))
                lat.append(st.seconds)
            lat = np.asarray(sorted(lat))
            total_q = n_requests * min(256, q.size)
            print(f"  serving loop: {n_requests} requests, "
                  f"{total_q / lat.sum():.0f} queries/s, "
                  f"p50={lat[len(lat) // 2] * 1e3:.1f}ms "
                  f"p99={lat[int(len(lat) * 0.99)] * 1e3:.1f}ms")
    print("kc_serve demo OK")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--demo", action="store_true",
                    help="count -> save -> restore -> serve, every answer "
                         "checked exactly")
    ap.add_argument("--requests", type=int, default=0,
                    help="with --demo: also a loop of N one-shot requests, "
                         "printing queries/s and latency")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.demo:
        run_demo(args.requests, device=args.device)
        return
    ap.error("this harness is library-first: use --demo, or build a "
             "StoreRegistry/QueryService from your own program")


if __name__ == "__main__":
    main()
