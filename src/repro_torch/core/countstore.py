"""The streaming receiver's count store (counterpart of `repro.core.countstore`).

One open-addressing table per PE, stacked as (P, capacity): keys (empty
slots hold the sentinel) and int32 counts, plus a (P,) int32 count of
dropped inserts. `store_insert` folds a batch in place (the insert kernel
on the card, the sequential plain version on the CPU); `store_histogram`
sorts the table into the usual `AccumResult`, so the slot layout, which
differs between the two, never reaches a result. `store_lookup` is the
read-only probe the query path serves from (the lookup kernel on the
card, which also sums the batch's stats); it reads a committed
`StoreSnapshot`, whose tensors no later call writes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import words as W
from repro_torch.core.sort import AccumResult, accumulate, sort_with_weights
from repro_torch.kernels import ops, ref


class CountStore(NamedTuple):
    keys: torch.Tensor     # (P, capacity) int64 words; sentinel == empty
    counts: torch.Tensor   # (P, capacity) int32
    dropped: torch.Tensor  # (P,) int32 live entries dropped (table full)
    word_bits: int


class StoreSnapshot(NamedTuple):
    """One committed store generation, as `KmerCounter.count` serves it.

    The JAX package's snapshot relies on its arrays being immutable. Here
    the store updates in place, so the counter publishes tensors that it
    never writes again: each update inserts into a copy of the committed
    store, and a rehash builds new tensors. `spill_state` is a copy of the
    spill writer's manifest at the commit (None while the tier is off):
    the live manifest grows with later commits, sealed segment files
    never change.
    """
    gen: int                 # commit counter
    keys: torch.Tensor       # (P, store_cap) int64 words
    counts: torch.Tensor     # (P, store_cap) int32
    store_cap: int
    word_bits: int
    spill_state: Optional[dict] = None


def empty_store(num_pes: int, capacity: int, word_bits: int,
                device=None) -> CountStore:
    """All-empty store: sentinel keys, zero counts."""
    return CountStore(
        keys=torch.full((num_pes, capacity), W.sentinel(word_bits),
                        dtype=torch.int64, device=device),
        counts=torch.zeros((num_pes, capacity), dtype=torch.int32,
                           device=device),
        dropped=torch.zeros((num_pes,), dtype=torch.int32, device=device),
        word_bits=word_bits)


def store_slots(words: torch.Tensor, capacity: int,
                word_bits: int) -> torch.Tensor:
    """Home slot of each word: the slot hash modulo capacity, unsigned."""
    return ref.home_slots(words, capacity, word_bits)


def store_insert(store: CountStore, words: torch.Tensor,
                 counts: Optional[torch.Tensor] = None) -> CountStore:
    """Fold (P, n) (words, counts) into the store IN PLACE; sentinel and
    zero-count entries are skipped. Returns the store (its tensors are the
    same objects, `dropped` accumulated).

    The home slots come from the insert itself (`ops.hash_insert` with no
    slots): on the card the kernel hashes each word, so no PyTorch op runs
    for them; on the CPU the plain version computes `store_slots`."""
    sent = W.sentinel(store.word_bits)
    if counts is None:
        counts = (words != sent).to(torch.int32)
    ops.hash_insert(store.keys, store.counts, words.contiguous(),
                    counts.to(torch.int32).contiguous(), None,
                    sentinel_val=sent, dropped=store.dropped,
                    word_bits=store.word_bits)
    return store


def store_lookup(store, words: torch.Tensor,
                 stats: Optional[torch.Tensor] = None):
    """Read-only probe of (P, n) words against every PE's table (a
    `CountStore` or a `StoreSnapshot`): ((P, n) int32 counts, 0 = miss
    or sentinel padding; (P, n) int32 probe-walk lengths).

    The home slots come from the lookup itself (`ops.hash_lookup` with no
    slots): on the card the kernel hashes each word, so the probe is one
    launch; on the CPU the plain version computes `store_slots`. `stats`
    (P, 3) int64, zeroed by the caller, receives each PE's hits, probe sum
    and longest walk (`ops.hash_lookup`)."""
    return ops.hash_lookup(store.keys, store.counts, words.contiguous(), None,
                           sentinel_val=W.sentinel(store.word_bits),
                           word_bits=store.word_bits, stats=stats)


def store_copy(store: CountStore) -> CountStore:
    """A copy of the table with `dropped` at 0: what an update inserts into
    while the committed store stays as it was."""
    return store._replace(keys=store.keys.clone(),
                          counts=store.counts.clone(),
                          dropped=torch.zeros_like(store.dropped))


def store_grow(store: CountStore, new_capacity: int) -> CountStore:
    """Rehash every live entry into a fresh table of `new_capacity` slots;
    the new store's `dropped` starts at 0. One `store_insert` of the whole
    old table: the kernel hashes every live key on the card, so no
    (P, capacity) temporary of home slots is made."""
    if new_capacity < store.keys.shape[1]:
        raise ValueError("store_grow cannot shrink the table")
    grown = empty_store(store.keys.shape[0], new_capacity, store.word_bits,
                        store.keys.device)
    return store_insert(grown, store.keys, store.counts)


def store_histogram(store: CountStore, *, total_bits: int,
                    impl: str = "radix") -> AccumResult:
    """One sort/compaction of every PE's table into (P, capacity) unique
    keys (ascending, sentinel-padded), int32 counts and (P,) num_unique.

    PEs are sorted one at a time, so the sort's temporaries take one
    table's size, not P of them.
    """
    p, cap = store.keys.shape
    sent = W.sentinel(store.word_bits)
    accum_impl = "fused" if impl == "radix" else "segment_sum"
    unique = torch.empty_like(store.keys)
    counts = torch.empty_like(store.counts)
    num_unique = torch.empty((p,), dtype=torch.int32, device=unique.device)
    for r in range(p):
        keys, w = sort_with_weights(store.keys[r:r + 1], store.counts[r:r + 1],
                                    impl=impl, total_bits=total_bits,
                                    sentinel_val=sent)
        acc = accumulate(keys, w, sentinel_val=sent, impl=accum_impl)
        del keys, w
        unique[r:r + 1] = acc.unique
        counts[r:r + 1] = acc.counts
        num_unique[r:r + 1] = acc.num_unique
    return AccumResult(unique=unique, counts=counts, num_unique=num_unique)


def store_from_numpy(keys: np.ndarray, counts: np.ndarray, num_pes: int,
                     dropped=None, device=None) -> CountStore:
    """A store built by the JAX package (flat (P * capacity,) uint32/uint64
    keys and int32 counts, as its sharded store arrays are) as a port
    store, copied: the port's store updates in place."""
    k, bits = W.to_torch_words(np.asarray(keys).reshape(num_pes, -1), device)
    c = torch.from_numpy(np.array(counts, dtype=np.int32).reshape(
        num_pes, -1)).to(device)
    d = torch.zeros((num_pes,), dtype=torch.int32, device=device)
    if dropped is not None:
        d += torch.as_tensor(np.asarray(dropped, dtype=np.int32),
                             device=device)
    return CountStore(keys=k, counts=c, dropped=d, word_bits=bits)


def snapshot_from_numpy(keys: np.ndarray, counts: np.ndarray, num_pes: int,
                        device=None, gen: int = 0) -> StoreSnapshot:
    """A committed store of the JAX package (flat sharded key and count
    arrays) as a port snapshot, for serving it with `query.query_counts`."""
    st = store_from_numpy(keys, counts, num_pes, device=device)
    return StoreSnapshot(gen=gen, keys=st.keys, counts=st.counts,
                         store_cap=st.keys.shape[1], word_bits=st.word_bits)
