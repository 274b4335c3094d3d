"""Plain versions of the kernels of the port.

Each function computes what its CUDA kernel computes, on the stacked
(P, ...) layout: one row per processing element (the sliding minimum: one
row per read; attention: (B, H, S, D)). `kernels.ops` runs these for
tensors on the CPU; tests and `chip_smoke.py` hold the kernels to them.
Counterparts of `repro.kernels.ref` (kmer_extract_ref, radix_hist_ref,
partition_plan_ref, bucket_hist_ref, bucket_positions_ref,
segment_boundaries_ref, segment_accumulate_ref, hash_insert_ref,
hash_lookup_ref, sliding_min_ref, sliding_min_pair_ref, mha_ref,
flash_ref). `flash_fwd` and `flash_bwd` are the plain versions of the flash
attention kernels (`repro.kernels.flash_attention` and
`flash_attention_bwd`), which have no counterpart in the JAX `ref.py`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import words as W
from repro_torch.core import encoding, owner
from repro_torch.kernels.radix_partition import PartitionPlan, hist_prefix

# XOR with the sign bit maps the unsigned order of int64-carried words onto
# the signed order.
_SIGN = -(1 << 63)


def kmer_extract(reads: torch.Tensor, k: int, bits_per_symbol: int = 2,
                 canonical: bool = False) -> torch.Tensor:
    """(n_reads, m) symbol codes -> (n_reads, m - k + 1) int64 words.

    The shift-or pack, then with `canonical` the separate reverse-complement
    sweep: the oracle the fused in-loop canonical form of the kernel must
    equal, as in `repro.kernels.ref.kmer_extract_ref`.
    """
    out = encoding.pack_kmers(reads, k, bits_per_symbol)
    return encoding.canonical(out, k) if canonical else out


def radix_hist(keys: torch.Tensor, shift: int, digit_bits: int,
               tile: int) -> torch.Tensor:
    """(P, n) int64-carried words -> (P, n // tile, 2**digit_bits) int32
    per-tile counts of the digit `(word >> shift) & (2**digit_bits - 1)`.

    The shift is logical on the unsigned word: a 64-bit word with its top
    bit set reads its top digit unsigned, and a shift of 64 or more leaves
    digit 0, as the JAX package's unsigned shift does (a 32-bit word is
    zero-extended, so any shift past its width also gives 0).
    """
    radix = 1 << digit_bits
    p, n = keys.shape
    if shift >= 64:
        digit = torch.zeros_like(keys)
    else:
        digit = W.srl(keys, shift) & (radix - 1)
    tile_id = torch.arange(p * (n // tile), device=keys.device)
    key = tile_id.view(p, -1, 1) * radix + digit.view(p, -1, tile)
    hist = torch.bincount(key.reshape(-1), minlength=tile_id.numel() * radix)
    return hist.view(p, n // tile, radix).to(torch.int32)


def _tile_keys(buckets: torch.Tensor, num_buckets: int, tile: int):
    """Flat (row, tile, bucket) key of every element, and the tile count."""
    p, n = buckets.shape
    n_tiles = -(-n // tile)
    dev = buckets.device
    row = torch.arange(p, device=dev, dtype=torch.int64)[:, None]
    t = torch.arange(n, device=dev, dtype=torch.int64)[None, :] // tile
    key = (row * n_tiles + t) * num_buckets + buckets.to(torch.int64)
    return key.reshape(-1), n_tiles


def bucket_hist(buckets: torch.Tensor, num_buckets: int,
                tile: int) -> torch.Tensor:
    """(P, n) int32 ids -> (P, ceil(n / tile), B) int32 per-tile
    histograms; a ragged last tile counts only its real elements, and ids
    outside [0, B) are not counted."""
    p = buckets.shape[0]
    key, n_tiles = _tile_keys(buckets, num_buckets, tile)
    live = ((buckets >= 0) & (buckets < num_buckets)).reshape(-1)
    hist = torch.bincount(key[live], minlength=p * n_tiles * num_buckets)
    return hist.reshape(p, n_tiles, num_buckets).to(torch.int32)


def bucket_prefix(buckets: torch.Tensor, num_buckets: int, tile: int):
    """(P, n) int32 ids -> the plan's prefix of their per-tile histograms:
    (base (P, n_tiles, B), totals (P, B), starts (P, B)), int32; ids
    outside [0, B) are not counted."""
    return hist_prefix(bucket_hist(buckets, num_buckets, tile))


def bucket_positions(buckets: torch.Tensor, base: torch.Tensor,
                     tile: int) -> torch.Tensor:
    """Stable destination of every element: base[p, tile, bucket] plus its
    rank among the equal-bucket elements of its tile, in input order."""
    p, n = buckets.shape
    num_buckets = base.shape[2]
    key, n_tiles = _tile_keys(buckets, num_buckets, tile)
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=p * n_tiles * num_buckets)
    group_start = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(key)
    rank[order] = (torch.arange(key.numel(), device=key.device)
                   - group_start[key[order]])
    pos = base.reshape(-1).to(torch.int64)[key] + rank
    return pos.reshape(p, n).to(torch.int32)


def partition_plan(buckets: torch.Tensor, num_buckets: int) -> PartitionPlan:
    """Stable-argsort oracle of `ops.make_partition_plan`: the positions of
    a stable bucket partition are each element's rank in the stable sort by
    bucket id."""
    p, n = buckets.shape
    b = buckets.to(torch.int64)
    order = torch.argsort(b, dim=1, stable=True)
    positions = torch.empty_like(b)
    positions.scatter_(1, order, torch.arange(n, device=b.device)
                       .expand(p, n).contiguous())
    row = torch.arange(p, device=b.device)[:, None] * num_buckets
    totals = torch.bincount((row + b).reshape(-1),
                            minlength=p * num_buckets).reshape(p, num_buckets)
    starts = torch.cumsum(totals, 1) - totals
    return PartitionPlan(positions=positions.to(torch.int32),
                         totals=totals.to(torch.int32),
                         starts=starts.to(torch.int32))


def segment_boundaries(sorted_keys: torch.Tensor,
                       sentinel_val: int) -> torch.Tensor:
    """Run-start flags of every row of sorted int64 words: a valid word
    that differs from the one before it, the sentinel standing before
    index 0 (so index 0 starts a run iff it is valid)."""
    sent = torch.full(sorted_keys.shape[:-1] + (1,), sentinel_val,
                      dtype=sorted_keys.dtype, device=sorted_keys.device)
    prev = torch.cat([sent, sorted_keys[..., :-1]], -1)
    return (sorted_keys != sentinel_val) & (sorted_keys != prev)


def segment_accumulate(sorted_keys: torch.Tensor,
                       weights: Optional[torch.Tensor], sentinel_val: int):
    """(is_new, is_end, run_totals) of every row of sorted int64 words.

    is_new / is_end flag the first / last element of each run of equal
    valid keys; run_totals holds the run's int32 weight sum (wrapping) at
    its last element and 0 elsewhere. `weights` None: every valid key
    weighs 1.
    """
    p, n = sorted_keys.shape
    dev = sorted_keys.device
    sent = torch.full((p, 1), sentinel_val, dtype=sorted_keys.dtype,
                      device=dev)
    valid = sorted_keys != sentinel_val
    w = valid.to(torch.int64) if weights is None else torch.where(
        valid, weights.to(torch.int64), 0)
    prev = torch.cat([sent, sorted_keys[:, :-1]], 1)
    nxt = torch.cat([sorted_keys[:, 1:], sent], 1)
    is_new = valid & (sorted_keys != prev)
    is_end = valid & (sorted_keys != nxt)
    seg = torch.clamp(torch.cumsum(is_new.to(torch.int64), 1) - 1, min=0)
    sums = torch.zeros((p, n), dtype=torch.int64, device=dev)
    sums.scatter_add_(1, seg, w)
    run_tot = torch.where(is_end, sums.gather(1, seg), 0)
    return is_new, is_end, run_tot.to(torch.int32)


def scatter_drop(idx: torch.Tensor, src: torch.Tensor,
                 fill: int) -> torch.Tensor:
    """`full(fill).at[idx].set(src, mode='drop')` along dim 1, where every
    dropped element points one past the end: scatter into one extra slot
    and slice it off. Kept destinations are unique, so this is
    deterministic on CUDA too."""
    p, n = src.shape
    buf = torch.full((p, n + 1), fill, dtype=src.dtype, device=src.device)
    buf.scatter_(1, idx, src)
    return buf[:, :n]


def segment_compact(sorted_keys: torch.Tensor,
                    weights: Optional[torch.Tensor], sentinel_val: int):
    """The compacting mode of the accumulate sweep: (unique (P, n) keys,
    counts (P, n) int32, num_unique (P,) int32). Run r of a row puts its
    key and its total at slot r; slots past num_unique hold the sentinel
    and 0."""
    n = sorted_keys.shape[1]
    is_new, is_end, run_tot = segment_accumulate(sorted_keys, weights,
                                                 sentinel_val)
    seg = torch.clamp(torch.cumsum(is_new, 1, dtype=torch.int64) - 1, min=0)
    unique = scatter_drop(torch.where(is_new, seg, n), sorted_keys,
                          sentinel_val)
    counts = scatter_drop(torch.where(is_end, seg, n), run_tot, 0)
    return unique, counts, is_new.sum(1, dtype=torch.int32)


def _wrap32(x: int) -> int:
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def home_slots(keys: torch.Tensor, capacity: int,
               word_bits: int) -> torch.Tensor:
    """int32 home slot of each `word_bits`-bit word: the slot hash modulo
    capacity, unsigned (`countstore.store_slots`; the insert kernel
    computes it on the card when it is given no slots)."""
    return W.umod(owner.slot_hash(keys, word_bits), capacity,
                  word_bits).to(torch.int32)


def hash_insert(table_keys: torch.Tensor, table_counts: torch.Tensor,
                keys: torch.Tensor, weights: torch.Tensor,
                slots: torch.Tensor, sentinel_val: int) -> torch.Tensor:
    """Sequential insert-or-add of every row's batch into its row of the
    open-addressing table, IN PLACE, folding items in stream order.

    Linear probing from `slots` wrapping modulo capacity: the first empty
    slot inserts, the first matching key adds; a sweep that visits every
    slot drops the item and counts it. Sentinel keys and weights <= 0 are
    skipped. The slot layout equals `repro.kernels.ref.hash_insert_ref`.
    Returns the (P,) int32 drop counts of this batch.
    """
    if table_keys.device.type != "cpu":
        raise ValueError("the sequential insert runs on CPU tensors")
    p, cap = table_keys.shape
    tk = table_keys.numpy()
    tc = table_counts.numpy()
    dropped = np.zeros(p, np.int32)
    for r in range(p):
        tkr, tcr = tk[r], tc[r]
        for key, w, slot in zip(keys[r].tolist(), weights[r].tolist(),
                                slots[r].tolist()):
            if key == sentinel_val or w <= 0:
                continue
            for _ in range(cap):
                cur = int(tkr[slot])
                if cur == sentinel_val:
                    tkr[slot] = key
                if cur == sentinel_val or cur == key:
                    tcr[slot] = _wrap32(int(tcr[slot]) + w)
                    break
                slot = 0 if slot + 1 == cap else slot + 1
            else:
                dropped[r] += 1
    return torch.from_numpy(dropped)


def hash_lookup(table_keys: torch.Tensor, table_counts: torch.Tensor,
                keys: torch.Tensor, slots: torch.Tensor, sentinel_val: int):
    """Read-only probe of every row's batch against its row of the table.

    The insert's walk (linear from `slots`, wrapping modulo capacity) that
    stops at an empty slot (a miss, count 0), at the key (its count), or
    after `cap` steps (a miss). Sentinel keys skip with count 0 and 0
    probes. Returns (counts, probes), both (P, n) int32: probes is the
    number of slots the walk read. All keys walk together, one step at a
    time; equal to `repro.kernels.ref.hash_lookup_ref` row by row.
    """
    cap = table_keys.shape[1]
    active = keys != sentinel_val
    slot = slots.to(torch.int64)
    counts = torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    probes = torch.zeros_like(counts)
    for _ in range(cap):
        if not bool(active.any()):
            break
        cur = table_keys.gather(1, slot)
        probes += active.to(torch.int32)
        hit = active & (cur == keys)
        counts = torch.where(hit, table_counts.gather(1, slot), counts)
        active = active & (cur != sentinel_val) & ~hit
        slot = torch.where(slot + 1 == cap, 0, slot + 1)
    return counts, probes


def lookup_stats(counts: torch.Tensor, probes: torch.Tensor) -> torch.Tensor:
    """(P, 3) int64 stats of a lookup's (P, n) outputs, row by row: the
    hits (count > 0; a sentinel query has count 0), the probe sum and the
    longest walk (a sentinel query has 0 probes), as `hash_lookup_cuda`
    sums them."""
    p = probes.to(torch.int64)
    longest = (p.amax(1) if p.shape[1] else
               torch.zeros(p.shape[0], dtype=torch.int64, device=p.device))
    return torch.stack([(counts > 0).sum(1), p.sum(1), longest], 1)


def sliding_min(vals: torch.Tensor, window: int) -> torch.Tensor:
    """(rows, n_pos) int64-carried words -> (rows, n_pos - window + 1)
    windowed minima in the UNSIGNED order of the words:
    out[r, p] = min(vals[r, p : p + window])."""
    n_out = vals.shape[-1] - window + 1
    flipped = vals ^ _SIGN
    acc = flipped[..., :n_out]
    for j in range(1, window):
        acc = torch.minimum(acc, flipped[..., j:j + n_out])
    return acc ^ _SIGN


def sliding_min_pair(keys: torch.Tensor, vals: torch.Tensor, window: int):
    """Minimum by KEY (unsigned) over every window, carrying the value:
    ((rows, n_out) keys, (rows, n_out) vals). The earliest position wins a
    key tie (strict `<`), as in `repro.kernels.ref.sliding_min_pair_ref`."""
    n_out = keys.shape[-1] - window + 1
    flipped = keys ^ _SIGN
    ak = flipped[..., :n_out]
    av = vals[..., :n_out]
    for j in range(1, window):
        nk = flipped[..., j:j + n_out]
        take = nk < ak
        ak = torch.where(take, nk, ak)
        av = torch.where(take, vals[..., j:j + n_out], av)
    return ak ^ _SIGN, av


# --- attention --------------------------------------------------------------

# The flash kernels mask with this finite constant, not -inf: a fully masked
# row then gives output 0 and logsumexp -1e30 without NaN guards.
NEG_INF = -1e30


def _band(rows: torch.Tensor, cols: torch.Tensor, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    """(len(rows), len(cols)) bool: the query at absolute position rows[i]
    sees the key at cols[j]. The window is one-sided, (row - col) < window,
    with or without `causal`."""
    mask = torch.ones((rows.numel(), cols.numel()), dtype=torch.bool,
                      device=rows.device)
    if causal:
        mask &= rows[:, None] >= cols[None, :]
    if window is not None:
        mask &= (rows[:, None] - cols[None, :]) < window
    return mask


def _full_band(q: torch.Tensor, k: torch.Tensor, q_offset: int,
               causal: bool, window: Optional[int]) -> torch.Tensor:
    """_band over all of q's rows (from q_offset) and all of k's columns."""
    return _band(q_offset + torch.arange(q.shape[2], device=q.device),
                 torch.arange(k.shape[2], device=q.device), causal, window)


def _expand_kv(k: torch.Tensor, hq: int) -> torch.Tensor:
    """GQA: query head h reads kv head h // (hq // hkv)."""
    group = hq // k.shape[1]
    return k if group == 1 else k.repeat_interleave(group, dim=1)


def split_bf16x3(x: torch.Tensor):
    """The f32 flash kernels' split of an f32 tensor into three bf16 parts,
    (hi, mid, lo) as f32 tensors: hi = bf16(x), mid = bf16(x - hi), lo =
    bf16(x - hi - mid). Both differences are exact in f32 and lo holds the
    last 8 of x's 24 bits, so hi + mid + lo == x wherever no part falls
    below bf16's normal range (|x| >= 2**-110); |x| must not exceed bf16's
    largest finite value."""
    x = x.float()
    hi = x.to(torch.bfloat16).float()
    r = x - hi
    mid = r.to(torch.bfloat16).float()
    return hi, mid, (r - mid).to(torch.bfloat16).float()


# The six (a part, b part) products of matmul_bf16x3 (0 hi, 1 mid, 2 lo),
# small terms first, in the order the kernels issue them in each chunk.
SPLIT_PAIRS = ((0, 2), (2, 0), (1, 1), (0, 1), (1, 0), (0, 0))


def matmul_bf16x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b from the f32 flash kernels' split: both operands split three
    ways (split_bf16x3) and six products of bf16 values, each over the
    whole reduction, summed in f32, the small ones first. The products
    left out (mid lo, lo mid, lo lo) are below 2**-24 |a b| term by term.
    This holds the split's accuracy, not the kernels' order of rounding:
    they interleave the six products of each reduction chunk of at most 64
    in one wgmma accumulation into a fresh accumulator, and add the chunk
    sums in f32 on the CUDA cores. chip_smoke.py's phase 3 holds that
    order, on the card."""
    pa, pb = split_bf16x3(a), split_bf16x3(b)
    out = None
    for i, j in SPLIT_PAIRS:
        term = torch.matmul(pa[i], pb[j])
        out = term if out is None else out + term
    return out


def _scores(q, k, scale: float, softcap: Optional[float],
            matmul=torch.matmul) -> torch.Tensor:
    """f32 scores q.k * scale, capped as cap * tanh(s / cap)."""
    s = matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    return s


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None, scale: Optional[float] = None,
              q_offset: int = 0, with_lse: bool = False,
              matmul=torch.matmul):
    """Plain version of the flash forward kernel (rows 11 and 12).

    q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D) -> o (B, Hq, Sq, D) in q's
    dtype, and with `with_lse` the per-row logsumexp (B, Hq, Sq) f32.
    Arithmetic is f32; p is rounded to v's dtype before the product with
    v, as the bf16 tensor-core kernel rounds it (in f32 the cast does
    nothing), while the row sum l is that of the f32 p. Masked scores are
    NEG_INF, so a fully masked row gives o = 0 and lse = NEG_INF. The
    kernel's online softmax reaches the same values up to f32 rounding,
    and in bf16 up to p's rounding against the running max where this
    rounds against the final one. `matmul` takes both products
    (matmul_bf16x3: the f32 kernels' split, whole reductions at a time).
    """
    hq, d = q.shape[1], q.shape[3]
    scale = d ** -0.5 if scale is None else scale
    mask = _full_band(q, k, q_offset, causal, window)
    s = torch.where(mask, _scores(q, _expand_kv(k, hq), scale, softcap,
                                  matmul), NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = (matmul(p.to(v.dtype).float(), _expand_kv(v, hq).float())
         / l_safe).to(q.dtype)
    if not with_lse:
        return o
    return o, (m + torch.log(l_safe))[..., 0]


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
              causal: bool, window: Optional[int], softcap: Optional[float],
              scale: float, q_offset: int = 0, matmul=torch.matmul):
    """Plain version of the flash backward kernels (row 13).

    Full head count: q, o, do (B, H, Sq, D); k, v (B, H, Skv, D); lse
    (B, H, Sq) f32 from the forward. Recomputes p = exp(s - lse) on the
    band and returns (dq, dk, dv) in the dtypes of q, k and v:
      dv = p^T dO;  ds = p (dO v^T - rowsum(dO * O));  softcap: ds *= 1 -
      (s / cap)^2;  dq = ds k * scale;  dk = ds^T q * scale.
    Arithmetic is f32, except that p is rounded to dO's dtype before dv's
    product and ds to q's dtype before dq's and dk's, as the bf16
    tensor-core kernels round them (in f32 the casts do nothing); ds
    itself is computed from the f32 p. `matmul` takes the five products
    (matmul_bf16x3: the f32 kernels' split, whole reductions at a time).
    """
    mask = _full_band(q, k, q_offset, causal, window)
    s = _scores(q, k, scale, softcap, matmul)
    p = torch.where(mask, torch.exp(torch.where(mask, s, NEG_INF)
                                    - lse[..., None]), 0.0)
    do32 = do.float()
    dsum = (do32 * o.float()).sum(-1, keepdim=True)
    dv = matmul(p.to(do.dtype).float().transpose(-1, -2), do32)
    ds = p * (matmul(do32, v.float().transpose(-1, -2)) - dsum)
    if softcap is not None:
        ds = ds * (1.0 - (s / softcap) ** 2)
    ds = ds.to(q.dtype).float()
    dq = matmul(ds, k.float()) * scale
    dk = matmul(ds.transpose(-1, -2), q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_rounded_terms(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool, window: Optional[int],
                        softcap: Optional[float], scale: float,
                        q_offset: int = 0):
    """For each output of the flash kernels in bf16, the sum of the
    magnitudes of the terms whose factor is rounded to bf16 (p in P V and
    P^T dO, ds in dS K and dS^T Q), in f32:
      (|P| |V| / l, scale |dS| |K|, scale |dS^T| |Q|, |P^T| |dO|)
    at the full head count (arguments as `flash_bwd`). Two implementations
    that round nearly equal f32 values of p or ds (summed in other orders,
    or in the forward against another running max) may land on
    neighbouring bf16 values, one bf16 step (2**-7) of the term apart.
    """
    mask = _full_band(q, k, q_offset, causal, window)
    s = _scores(q, k, scale, softcap)
    p = torch.where(mask, torch.exp(torch.where(mask, s, NEG_INF)
                                    - lse[..., None]), 0.0)
    do32 = do.float()
    dsum = (do32 * o.float()).sum(-1, keepdim=True)
    ds = p * (torch.matmul(do32, v.float().transpose(-1, -2)) - dsum)
    if softcap is not None:
        ds = ds * (1.0 - (s / softcap) ** 2)
    ds = ds.abs()
    return (torch.matmul(p, v.float().abs()),
            torch.matmul(ds, k.float().abs()) * scale,
            torch.matmul(ds.transpose(-1, -2), q.float().abs()) * scale,
            torch.matmul(p.transpose(-1, -2), do32.abs()))


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, window: Optional[int] = None,
            softcap: Optional[float] = None, scale: Optional[float] = None,
            q_offset: int = 0) -> torch.Tensor:
    """Reference attention (differentiable), as `repro.kernels.ref.mha_ref`.

    q (B, Hq, Sq, D); k, v (B, Hkv, Skv, D). Scores accumulate in f32 from
    the inputs' products (exact for bf16 inputs); masked scores are -inf
    and a fully masked row's NaN probabilities become 0. The probabilities
    are rounded to v's dtype before the product with v, as in the JAX
    reference; `flash_fwd` rounds the unnormalised p instead and divides
    by the row sum after the product.
    """
    hq, d = q.shape[1], q.shape[3]
    scale = d ** -0.5 if scale is None else scale
    vq = _expand_kv(v, hq)
    logits = _scores(q, _expand_kv(k, hq), scale, softcap)
    mask = _full_band(q, k, q_offset, causal, window)
    logits = torch.where(mask, logits, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(torch.isnan(probs), 0.0, probs)
    return torch.matmul(probs.to(vq.dtype).float(), vq.float()).to(q.dtype)


def mha_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                q_offset: int, k_offset: int, causal: bool = True,
                window: Optional[int] = None,
                softcap: Optional[float] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One block's share of attention: q (B, Hq, Sq, D) at positions from
    q_offset against the keys k, v (B, Hkv, Skv, D) at positions from
    k_offset -> (row max m (B, Hq, Sq), row sum l of exp(s - m), o = the
    exp(s - m)-weighted sum of v (B, Hq, Sq, D)), f32. A row that sees no
    key of the block has m = -inf and l = o = 0. Blocks combine as
    sum_b exp(m_b - M) o_b / sum_b exp(m_b - M) l_b with M = max_b m_b
    (the distributed flash-decode); p is rounded to v's dtype before the
    product, as in `flash_fwd`."""
    hq, d = q.shape[1], q.shape[3]
    s = _scores(q, _expand_kv(k, hq), d ** -0.5, softcap)
    mask = _band(q_offset + torch.arange(q.shape[2], device=q.device),
                 k_offset + torch.arange(k.shape[2], device=q.device),
                 causal, window)
    s = torch.where(mask, s, float("-inf"))
    m = s.amax(-1)
    p = torch.exp(s - torch.where(torch.isinf(m), 0.0, m)[..., None])
    vq = _expand_kv(v, hq)
    o = torch.matmul(p.to(vq.dtype).float(), vq.float())
    return m, p.sum(-1), o


def flash_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None, scale: Optional[float] = None,
              q_offset: int = 0, block_q: int = 1024,
              block_k: int = 1024) -> torch.Tensor:
    """Blockwise online-softmax attention in plain torch (differentiable),
    as `repro.kernels.ref.flash_ref`: only (block_q, block_k) scores are
    live at a time, and blocks wholly outside the causal or window band are
    skipped. The attention path takes it for kv longer than 8192."""
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    kq, vq = _expand_kv(k, hq), _expand_kv(v, hq)
    bq, bk = min(block_q, sq), min(block_k, skv)
    outs = []
    for q0 in range(0, sq, bq):
        q32 = q[:, :, q0:q0 + bq].float()
        n = q32.shape[2]
        rows = q_offset + q0 + torch.arange(n, device=q.device)
        first, last = q_offset + q0, q_offset + q0 + bq - 1
        m = torch.full((b, hq, n), float("-inf"), device=q.device)
        l = torch.zeros((b, hq, n), device=q.device)
        acc = torch.zeros((b, hq, n, d), device=q.device)
        for k0 in range(0, skv, bk):
            if causal and k0 > last:
                continue
            if window is not None and k0 + bk - 1 < first - window + 1:
                continue
            kb = kq[:, :, k0:k0 + bk]
            cols = k0 + torch.arange(kb.shape[2], device=q.device)
            s = torch.where(_band(rows, cols, causal, window),
                            _scores(q32, kb, scale, softcap), float("-inf"))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            p = torch.where(torch.isnan(p), 0.0, p)
            alpha = torch.exp(m - m_new)
            alpha = torch.where(torch.isnan(alpha), 0.0, alpha)
            l = alpha * l + p.sum(-1)
            acc = acc * alpha[..., None] + torch.matmul(
                p, vq[:, :, k0:k0 + bk].float())
            m = m_new
        l_safe = torch.where(l == 0.0, 1.0, l)
        outs.append((acc / l_safe[..., None]).to(q.dtype))
    return torch.cat(outs, dim=2)
