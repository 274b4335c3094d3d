#!/usr/bin/env python3
"""On-card smoke of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase, full size
    python3 chip_smoke.py --phases 1,2,3   # device, build, kernel checks only
    python3 chip_smoke.py --phases 1,2,3,8 # ... and the incremental counter
    python3 chip_smoke.py --phases 1,2,3,9 # ... and the LM training path
    python3 chip_smoke.py --phases 1,2,3,10  # ... and the sweep kernels
    python3 chip_smoke.py --phases 1,2,11,12 # the 2d topology and BSP
    python3 chip_smoke.py --phases 1,2,8,13  # the counter, its durability,
                                             # spill tier and serving
    python3 chip_smoke.py --phases 1,2,14    # LM serving and the families
    python3 chip_smoke.py --phases 1,2,4,15  # the counter's remaining surface
    python3 chip_smoke.py --phases 1,2,16    # the LM trainer's infrastructure
    python3 chip_smoke.py --phases 1,2,17    # the dry-run and its predictions
    python3 chip_smoke.py --phases 1,2,4,18  # the PEs across a process group
    python3 chip_smoke.py --phases 1,2,19    # durability, the sharded step
                                             # and the pipeline across ranks
    python3 chip_smoke.py --phases 1,2,20    # sharded serving and the
                                             # families on a mesh of ranks
    python3 chip_smoke.py --reads 4194304  # cut phases 4, 10-13 and 15's reads

Phases:
  1. device: require CUDA; print the card's name and power limit;
  2. build: compile every kernel in src/repro_torch/csrc with nvcc;
  3. each kernel against its plain version on the card, bit-equal (the
     insert: equal (key, count) sets and drops exactly when the plain
     version drops, with home slots given and hashed in the kernel, which
     hash_lookup then finds, and a store_grow rehash; the lookup with home
     slots given and hashed in the kernel, bit-equal in counts, probe
     lengths and the batch's stats, both word widths; the flash attention
     kernels within stated tolerances,
     f32 and bf16, head dims 15 to 256, and the training path's shape in
     both dtypes and phase 14's zamba2-1.2b prompt (4160 rows) in f32;
     the k-mer extraction, digit histogram and run-boundary kernels at
     small shapes and edge cases; the histogram's plain counts and its
     plan prefix at B = 2 to 1024, ids of -1 and B, rows on either side
     of PREFIX_MAX_CELLS and the store histogram's row; the rank kernel
     alone at B up to MAX_BUCKETS, with ids of -1 and B, one bucket and
     alternating buckets; the run sweep in its flags and compacting
     modes, with and without weights, int32 sums that wrap, a row of
     2**24 + 5 and the store histogram's row; the sliding minimum at
     w = 1 and w = n_pos, the query shape, long rows and rows that start
     8 bytes into 16);
  4. the paper's workload at full size: "Synthetic 26" (2**26 uniform
     bases), 2**23 reads of 150 bp, k=31, chunk_reads=256, 8 PEs on the
     card, checked exactly against an independent torch.unique count;
     every kernel of count_kmers must have launched on this path;
  5. small runs at k=13 (32-bit words, 'dual') and k=21 ('packed');
  18. the PEs across a process group: a one-rank NCCL group (its file://
     store under build/chip_smoke_phase18/, deleted afterwards), whose
     exchanges go through the same all_to_all_single, all_reduce and
     all_gather calls as a group of several ranks; (a) phase 4's workload
     through it (2**23 reads, k=31, chunk_reads 256, 8 PEs on rank 0),
     exact against torch.unique, every PE holding phase 4's (k-mer,
     count) set, every DAKCStats field equal to phase 4's, rows 1-4
     launched, wall time and peak memory beside phase 4's; (b) 4096-read
     runs on the group, each exact: the 2d one-plan route with the compact
     hop 2 on a (2, 4) grid, the 'perhop' route, a forced store rehash,
     BSP (n_batches + 1 global syncs), KmerCounter with hashed
     super-k-mers (2 updates, 2**16 queries); one full-width
     deepseek-moe-16b layer through moe_block(ep_shards=8, group=) against
     GShard within 1e-5 of the largest output, no drops at capacity factor
     8; compress_psum(group=) at frac 1.0 equal to its input; (c) the
     refusals: a gloo group given the card's tensors (ValueError);
  19. across a one-rank NCCL group (its store and files under
     build/chip_smoke_phase19/, deleted afterwards): (a) phase 8's
     configuration over its first 2**22 reads in 4 updates, the stacked
     path and KmerCounter(group=) each saving after update 2; the group's
     checkpoint restored on the stacked path at 8 and 4 PEs and the
     stacked one under the group, each finishing the updates; every PE's
     (k-mer, count) set (the histogram at 4 PEs) and all 2**20 query
     answers equal to the uninterrupted stacked run's; spill='always'
     and spill='auto' (stores 2**16 slots short of the fullest PE's
     distinct k-mers, so the tier engages at once) over the first 2**18
     reads under the group, every PE's set equal to the stacked in-core
     count's; save, restore, update and drain seconds and bytes; (b)
     qwen1.5-0.5b at full width and depth, 4 steps of 4 x 4096 under
     'flash_train' through launch.train.train on a (1, 1) mesh of the
     group (the sharded step: its gathers, reductions and vocab-parallel
     loss), against the unsharded trainer from the same init: loss within
     1e-3 and grad norm within 1e-2 relative at every step, rows 12-13
     launched on the tensor cores; its step-2 checkpoint resumed by the
     unsharded trainer, steps 3-4 within 1e-3; step seconds, tokens/s,
     peak memory and collective calls a step beside the unsharded run's;
     (c) pipeline_forward(group=) of phase 16's 4 stages, all on the one
     rank, within 1e-5 of the largest output of the stacked schedule;
  20. sharded serving and the families on a mesh of ranks, through a
     one-rank NCCL group on a (1, 1) mesh (its store under
     build/chip_smoke_phase20/, deleted afterwards): (a)
     serve_step.generate(group=) against the unsharded generate:
     qwen1.5-0.5b at full width and depth at phase 14's timed shape
     (batch 8, prompt 512, 128 tokens), f32 with equal greedy tokens, and
     bf16 with its first decode step's logits within 2e-2 of the largest,
     decode ms a step beside the unsharded run's; mamba2-370m,
     zamba2-1.2b, deepseek-moe-16b (4 layers) and llava-next-mistral-7b
     at phase 14's gate widths, cuts, batches and prompts, f32, 8 tokens
     equal to the unsharded run's; (b) the sharded step (launch.train.train
     on the group) of deepseek-moe-16b (4 layers), mamba2-370m,
     zamba2-1.2b, llava-next-mistral-7b (CUT to 4 layers) and
     hubert-xlarge, 3 steps of 2 x 1024 in bf16 under 'flash_train',
     against the unsharded step from the same init: loss within 1e-3 and
     grad norm within 1e-2 relative at every step; collective calls and
     bytes a step, step seconds and peak memory beside the unsharded
     run's; rows 12-13 launched on the tensor cores for the attention
     families; the phase's launches are its sharded runs' alone; before
     (a), in one process, the sequence-sharded cache's flash-decode
     combine of qwen1.5-0.5b's timed decode cache in 5 blocks (the last
     empty) within 1e-5 (f32) and 2e-2 (bf16) of the largest output of
     mha_ref over the whole cache, and the vocab-parallel greedy pick over
     4 vocabulary blocks with planted ties equal to torch.argmax;
  11. the 2d topology at full size: phase 4's read set counted by 8 PEs as
     a (2, 4) grid on the one-plan route with the compact hop 2, exact
     against torch.unique, every PE holding phase 4's (k-mer, count) set,
     no hop-2 drop and no retry round, fewer wire bytes than the padded
     hop 2 at the same caps, rows 1-4 launched; then 4096-read runs of the
     padded hop 2, the 'perhop' route (k=13), a forced 'hop2_misfit'
     round, 'route_drop' and 'store_drop' recoveries, and KmerCounter
     with hashed super-k-mers on a (4, 2) grid answering 2**16 queries,
     each exact;
  12. the BSP baseline at full size: the same read set, 8 PEs, 256 reads a
     PE a round (4096 rounds, each ending in a host barrier), exact
     against torch.unique and phase 4's per-PE sets, n_batches + 1 global
     syncs, rows 1-3 launched and the store insert not; the wall time
     beside phase 4's, and each round's time with its barrier;
  8. the incremental counter and its queries at full size: the same read
     set fed to KmerCounter (k=31, hashed super-k-mer transport, prefix
     compaction, 8 PEs) in 8 updates, finalized exactly against
     torch.unique, then 2**20 point queries answered exactly; plus small
     runs of the k-mer transport (k=13), the 'plain' minimizer order (the
     sliding minimum in the updates and at the query shape) and a rehash
     round;
  13. durability, spill and serving at phase 8's size: phase 8's counter
     saved (bytes and seconds) and restored onto 8 PEs in place (every PE
     holding phase 8's set) and onto 4 PEs (the elastic reshard), each
     finalized exactly; the same read set in 16 updates under
     spill='auto' with a store ceiling the stream outgrows, so the tier
     engages after an in-core commit, drained exactly (spilled_bytes,
     update and drain times, peak memory); the kill drill: a checkpoint
     with the tier engaged, a torn segment write in the next update,
     restore onto 4 PEs, replay and drain, exact; the restored in-core
     counter and the spilled one as two tenants of a StoreRegistry, 2**20
     queries each in 64 requests through one QueryService.flush, exact,
     cold and with a bin cache that holds every bin (queries/s), and a
     refusing tenant beside them; 4096-read drills of 'ckpt_write',
     'bin_corrupt', spill on a (2, 4) grid and count_kmers(spill=
     'always'); rows 1-5 and 7 must launch on the phase's path;
  9. the LM training path: qwen1.5-0.5b at full width and depth trains 10
     steps of 4 x 4096 tokens under attn_impl='flash_train' (bf16 compute,
     the flash forward and backward kernels in every layer); then, from
     one set of weights, a step under 'flash_train' against one under
     'ref' at seq 1024, and the forward-only 'flash' logits against
     'flash_train''s at seq 4096;
  14. LM serving and the MoE, SSM/hybrid, VLM and audio families: for
     qwen1.5-0.5b, mamba2-370m, zamba2-1.2b (a prompt of 4160 past its
     4096 window), deepseek-moe-16b (full width, CUT to 4 layers) and
     llava-next-mistral-7b (576 patches and 64 text tokens), f32 compute
     and cache, a prefill and 8 greedy decode steps, each step's
     last-position logits held to a full forward over the sequence so far
     (attn_impl='flash', row 11's f32 kernel) within 1e-4 of the largest
     logit, argmax equal; the stacked DAKC MoE dispatch over 8 EP shards
     against the GShard path on one full-width deepseek layer (capacity
     factor 8, no drops, 1e-5 of the largest output), and both paths'
     dropped shares at 1.25; one bf16 'flash_train' step of
     deepseek-moe-16b, mamba2-370m, zamba2-1.2b, llava-next-mistral-7b
     and hubert-xlarge (frame-target loss with a mask) at full width, 2
     periods deep, 2 x 1024 positions, finite loss and grad norm, each
     held to 'ref' on the same weights and batch as phase 9 holds qwen
     (loss within 1e-3, grad norm within 1e-2, relative); then
     `launch.serve.serve` at batch 8, prompt 512, 128 new tokens, bf16
     compute and cache, for qwen1.5-0.5b, mamba2-370m, zamba2-1.2b and
     deepseek-moe-16b (4 layers): prefill seconds, decode ms a step and
     tokens/s over steps 2 onward, peak memory; rows 11-13 must launch on
     the phase's path;
  15. the counter's remaining surface: (a) corpus_ngram_stats and
     count_ngrams over 2**15 x 4096 Zipf-1.2 tokens at qwen1.5-0.5b's
     vocabulary (151,936, 18 bits a token; the token pipeline's first 16
     batches of 2048 rows), 8 PEs, at n=3 (54-bit words) and n=1, each
     histogram exact against torch.unique (or torch.bincount) of n-gram
     words the smoke packs itself, total, distinct and the top 16 counts
     held to it; (b) count_kmers_serial128 at k=63 over the first 2**22
     reads of phase 4's set, exact against torch.unique(dim=0) of (hi, lo)
     lanes the smoke packs itself; (c) the kc_dryrun drills on the card
     (inject, spill, skew on three corpora with both orders and prefix
     compaction, the live query batches), each exact; (d) the analytical
     model's prediction for phase 4's workload on H100_SXM beside phase
     4's wall time; rows 1-7 must launch on the phase's path;
  16. the LM trainer's infrastructure at qwen1.5-0.5b's full width and
     depth, bf16 compute under 'flash_train', 4 x 4096 tokens a step:
     (a) `launch.train.train` for 8 steps saving at steps 4 and 8 (run A),
     then from A's step-4 checkpoint alone in a fresh directory (run B,
     which must resume at cursor 4 and take 4 steps); the step-4 trees
     restored onto the card equal the files bit for bit, B's losses equal
     A's (or lie within 1e-3 relative) and B's step-8 parameters lie
     within 4 x 2.5 x lr of A's; checkpoint bytes, the seconds each save
     blocks the loop and writes, restore seconds, step time with and
     without a save, peak memory, straggler events (it writes under
     build/chip_smoke_phase16/ and deletes it); (b) StragglerWatchdog
     around 12 real steps, steps 9 on slowed by a host sleep of twice the
     median step: no trip before step 9, a trip after; (c)
     pipeline_forward of the 24 layers as 4 stages of 6, f32 under
     'flash' (row 11's f32 kernel), 8 microbatches of 1 x 1024 positions,
     against sequential_oracle within 1e-5 of the largest output, both
     timed, bubble_fraction(4, 8); (d) compress_psum over one step's
     gradients on 4 batches stacked as 4 shards: 3 rounds at frac 0.01,
     sent plus residual equal to the summed gradient within 64 f32 unit
     roundoffs of sum |g| at each element, and frac 1.0 equal to the shard
     mean; ms a call and compression_ratio; rows 11-13 must launch on the
     phase's path;
  17. the dry-run and its predictions against the card: (a) on the
     card, each prediction held to a real run: phase 9's step
     (qwen1.5-0.5b, 4 x 4096, 'flash_train', as two microbatches of
     2 x 4096, a (1, 1) mesh), traced as `launch.dryrun` traces every
     cell (every layer and microbatch): argument bytes equal to what the
     trainer holds, FLOPs within [1.0, 1.6] x the model count, the
     roofline bound at most the fastest step, the predicted peak beside
     max_memory_allocated; one decode step of phase 14's serving (batch
     8, a 648-position cache): argument bytes equal to the parameters and
     caches, the bound at most the fastest step;
     `kc_dryrun.lower_kc` at phase 4's workload (2**23 reads, k=31,
     chunk_reads 256, 8 PEs on the card) beside `count_kmers`: its
     l3_mode equal to the one planned from the reads, its plan, route
     bytes and peak beside the run's, its bound (8 PEs on one card: 8 x
     the larger of the compute and memory terms) at most the measured
     wall; (b) then on the host, in subprocesses that see no card, so
     that no host job runs beside a timed run on the card:
     `launch.dryrun --all --mesh both --jobs <cores>` (every arch x shape
     cell traced on meta tensors on the (16, 16) and (2, 16, 16) meshes,
     or skipped with `applicable_shapes`' reason), `launch.roofline`
     over its records, the counter's default lowering (Synthetic-30/8,
     44,564,480 reads, both receivers, --stream-batches 4) and
     `kc_dryrun --query 1048576`, each one's wall time and the
     stacked/stream temp ratio (it writes under build/chip_smoke_phase17/
     and deletes it);
  10. the sweep kernels through their entry points on the same read set:
     ops.kmer_extract over all 2**23 reads (forward and canonical, each
     piece bit-equal to its plain version); the canonical k-mers of the
     first 2**22 reads as 8 rows, ops.radix_hist on every 4-bit digit
     (bit-equal, and its tiles summing to a bincount of the digit);
     sort.radix_sort of each row, then sort.accumulate with
     boundaries_impl='kernel', bit-equal to 'inline' and to impl='fused'
     and exact against torch.unique of the same words;
  6. each kernel's time at its path's shapes beside its plain version, one
     library call where one exists, and its bound (runs after phases 8,
     9 and 10): per call (CUDA events around back-to-back calls, so the
     host's launch path included) and on the device (torch.profiler's
     kernel records, no host time between launches); the insert cold (new
     keys, an empty store) and warm (phase 4's live share per batch slot
     and share of stored keys, a store pre-filled to phase 4's distinct
     k-mers), each beside the old path's store_slots on its batch; row 1
     with its prefix at B = 2, 9 and 257, row 3 in both modes at a scan
     step's and the store histogram's shapes; row 5 at a query batch of
     the full-size path, its live queries scattered and as route_lanes
     delivers them, beside the old path (store_slots, then the kernel
     given the slots) and with its byte and sector bounds; and the call
     sites of rows 1-3 and 5, make_partition_plan,
     sort.accumulate(impl='fused') and countstore.store_lookup, as whole
     calls (ms, device ms and device launches a call, in the JSON's
     `calls`); rows 11-13 in f32 and bf16 at head dims 64, 128 and 256,
     each call's kernels named by the profiler's records, which must be
     its dtype's tensor-core kernels;
  7. on request only: the main path, one step of phase 9's training and
     four decode steps of phase 14's qwen1.5-0.5b serving under
     torch.profiler (device time by kernel, the device's busy share, the
     main path's launches per scan step, device launches a decode step).

Phases run in the order 1-5, 18, 11, 12, 8, 13, 9, 14, 15, 16, 17, 19,
20, 10, 6, 7: phase 18 beside phase 4's result; phases 18,
11 and 12 before phase 8, whose counter keeps its store until phase 6;
phase 13 after phase 8, whose counter and histogram it reads, freeing
what it made before phase 9; and every phase whose wall time is kept
before phase 10, which profiles. The `kernels` record gives each row's
launches on phases 13's to 19's paths beside the full run's
(`launches_phase13` to `launches_phase20`).

The second-to-last line is the `kernels` JSON record, the last the result
record. Any failure raises and exits non-zero. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12    # H100 SXM dense bf16 tensor cores (data sheet)
# f32 on this card: the f32 flash kernels take each product as six bf16
# products (989e12 / 6 = 165e12 FLOP/s of f32 work, as 3xTF32's 3 / 495e12),
# against the CUDA cores' 67e12 f32 FMA rate (data sheet).
F32_SPLIT_FLOP_PER_S = BF16_FLOP_PER_S / 6
F32_CUDA_CORE_FLOP_PER_S = 67e12
K = 31
NUM_PES = 8
# The kernels of count_kmers' path (phase 4); the counter's path (phase 8)
# adds the lookup and the sliding minimum.
COUNT_KERNELS = ("bucket_hist", "bucket_prefix", "bucket_positions",
                 "segment_accumulate", "hash_insert")
ROW1 = ("bucket_hist", "bucket_prefix")   # row 1's two entry points
# The kernels reached only through their entry points (phase 10).
SWEEP_KERNELS = ("kmer_extract", "radix_hist", "segment_boundaries")
DEV = "cuda"
# Phase 10: the extraction runs over every read, the radix-histogram,
# sort and accumulate chain over the k-mers of the first SWEEP_SORT_READS.
SWEEP_SORT_READS = 1 << 22
SWEEP_DIGIT_BITS, SWEEP_TILE = 4, 1024
SWEEP_TIMED_SHIFT = 28         # the digit phase 6 times
# Phase 9: the LM training path, and the flash kernels' shape on it. The
# 'flash_train' / 'ref' check runs at LM_CHECK_SEQ, where mha_ref's (S, S)
# scores fit.
LM_ARCH, LM_STEPS, LM_BATCH, LM_SEQ = "qwen1.5-0.5b", 10, 4, 4096
LM_CHECK_SEQ = 1024
# (batch, heads, seq, head_dim), bf16 on the path; phases 3 and 6 also
# in f32
FLASH_PATH = (4, 16, 4096, 64)
# Flash tolerances. f32: 1e-5 on o and lse, 5e-5 on dq, dk, dv (the JAX
# package's gradient bound). bf16: kernel and plain version round nearly
# equal f32 values, so they may differ by one bf16 step at the value
# (2**-7 of it), plus 1e-4 of the tensor's largest magnitude for values
# that f32 sums of thousands of terms leave near zero; and, as both round
# p (and ds) to bf16 before a product, by one bf16 step of each rounded
# term (ref.flash_rounded_terms): nearly equal f32 values of p or ds,
# summed in other orders or (forward) taken against another running max,
# may round to neighbouring bf16 values. The logsumexp has no rounded
# term and keeps 1e-5 in bf16 too.
FLASH_F32_TOL = {"o": 1e-5, "lse": 1e-5, "grad": 5e-5}
BF16_STEP, BF16_SLACK = 2.0 ** -7, 1e-4
# The f32 share of each phase's flash launches (ops.f32_launch_counts),
# by phase, read where the phase reads its launch counts.
F32_LAUNCHES = {}
SPIN_PAD = 8    # phase 6: spin kernels on each side of a profiled window


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# --- phase 3: kernels against their plain versions -------------------------

def _sorted_runs(torch, gen, rows, n, n_distinct, sent, word_bits, dev,
                 long_run=0, all_sentinel=False):
    hi = (1 << 62) if word_bits == 64 else (1 << 30)
    vals = torch.randint(0, hi, (rows, n_distinct), generator=gen, device=dev)
    idx = torch.randint(0, n_distinct, (rows, n), generator=gen, device=dev)
    keys = torch.sort(vals.gather(1, idx), dim=1).values
    if long_run:
        keys[:, 1000:1000 + long_run] = keys[:, 1000:1001]
        keys = torch.sort(keys, dim=1).values
    tail = n // 10
    keys[:, n - tail:] = sent
    if all_sentinel:
        keys[:] = sent
    w = torch.randint(1, 6, (rows, n), generator=gen, dtype=torch.int32,
                      device=dev)
    return keys, w


def check_kernels(torch, ops, ref, errs):
    from repro_torch import words as W

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    dgen = torch.Generator(device=dev).manual_seed(0)
    store_per_pe = 188_743_680   # one PE's store on the full-size path

    check_partition(torch, ops, ref, gen, store_per_pe)
    check_positions(torch, ops, ref, dev)
    errs["bucket_hist"] = errs["bucket_prefix"] = 0   # every case equal
    errs["bucket_positions"] = 0
    check_accumulate(torch, ops, ref, dgen, store_per_pe)
    errs["segment_accumulate"] = 0

    log("[kernels] hash_insert")
    for word_bits in (32, 64):
        sent = W.sentinel(word_bits)
        hi = (1 << 62) if word_bits == 64 else (1 << 30)
        for rows, cap, n, nd, wrap, name in (
                (4, 4096, 20000, 1500, False, "duplicates"),
                (3, 257, 600, 200, True, "wraps past the last slot"),
                (2, 64, 400, 100, False, "fills until it drops"),
                (2, 64, 400, 64, False, "exactly full"),
                (8, 1 << 20, 138_240, 400_000, False, "main-path batch")):
            vals = torch.randint(0, hi, (rows, nd), generator=gen)
            keys = vals.gather(1, torch.randint(0, nd, (rows, n),
                                                generator=gen))
            keys[:, ::17] = sent
            w = torch.randint(0, 4, (rows, n), generator=gen,
                              dtype=torch.int32)
            # a key's home slot is a function of the key, as on the path
            slots = (torch.full((rows, n), cap - 1, dtype=torch.int32)
                     if wrap else (keys % cap).to(torch.int32))
            tk = torch.full((rows, cap), sent, dtype=torch.int64)
            tc = torch.zeros((rows, cap), dtype=torch.int32)
            dk, dc = tk.to(dev), tc.to(dev)
            dd = torch.zeros((rows,), dtype=torch.int32, device=dev)
            ops.hash_insert(dk, dc, keys.to(dev), w.to(dev), slots.to(dev),
                            sentinel_val=sent, dropped=dd)
            torch.cuda.synchronize()
            pd = torch.zeros((rows,), dtype=torch.int32)
            ops.hash_insert(tk, tc, keys, w, slots, sentinel_val=sent,
                            dropped=pd)
            dk, dc, dd = dk.cpu(), dc.cpu(), dd.cpu()
            for r in range(rows):
                got = sorted(zip(dk[r][dk[r] != sent].tolist(),
                                 dc[r][dk[r] != sent].tolist()))
                want = sorted(zip(tk[r][tk[r] != sent].tolist(),
                                  tc[r][tk[r] != sent].tolist()))
                if int(pd[r]) == 0:
                    check(got == want, f"hash_insert set differs ({name})")
                else:   # a full table: which keys win the slots may differ
                    check(len(got) == len(want) == cap,
                          f"hash_insert fill differs ({name})")
                check((int(dd[r]) > 0) == (int(pd[r]) > 0),
                      f"hash_insert drop signal differs ({name})")
            log(f"  {word_bits}-bit rows={rows} cap={cap} n={n} ({name}): "
                f"same (key, count) sets, drops {dd.tolist()} vs plain "
                f"{pd.tolist()}")
    check_home_slots(torch, ops, dev)
    errs["hash_insert"] = 0
    check_lookup(torch, ops, ref, gen, dev)
    errs["hash_lookup"] = 0
    check_sliding_min(torch, ops, ref, gen, dev)
    errs["sliding_min"] = errs["sliding_min_pair"] = 0
    check_flash(torch, ops, ref, errs)
    check_sweeps(torch, ops, ref, errs)


def check_partition(torch, ops, ref, gen, store_per_pe):
    """Row 1 (its plain counts and its prefix) and whole plans against
    their plain versions: B = 2 to 1024, ragged tiles, ids of -1 and B,
    rows whose (tiles, B) table lies on either side of PREFIX_MAX_CELLS
    (the large side must still launch row 1, for its plain counts), and
    the store histogram's row."""
    from repro_torch.kernels.radix_partition import PREFIX_MAX_CELLS

    dev = torch.device("cuda")
    log("[kernels] partition: bucket_hist, bucket_prefix, whole plans")
    for rows, n, b, kind in (
            (3, 1000, 2, ""), (8, 30720, 2, ""), (8, 30720, 9, ""),
            (8, 61440, 9, ""), (3, 5000, 9, "invalid"), (8, 30720, 257, ""),
            (2, 5000, 257, "invalid"), (1, 3001, 9, ""),
            (2, PREFIX_MAX_CELLS // 1024 * 1024, 1024, ""),
            (2, PREFIX_MAX_CELLS // 1024 * 1024 + 5, 1024, "invalid"),
            (8, PREFIX_MAX_CELLS // 2 * 1024, 2, ""),
            (2, PREFIX_MAX_CELLS // 2 * 1024 + 1, 2, ""),
            (1, store_per_pe, 257, "")):
        ids = torch.randint(0, b, (rows, n), generator=gen,
                            dtype=torch.int32).to(dev)
        if kind == "invalid":
            ids[:, ::5] = -1
            ids[:, 2::7] = b
        hist = ops.bucket_hist(ids, b)
        torch.cuda.synchronize()
        check(torch.equal(hist, ref.bucket_hist(ids, b, ops.TILE)),
              f"bucket_hist differs at {(rows, n, b, kind)}")
        before = (ops.bucket_prefix.launches, ops.bucket_hist.launches)
        got = ops.bucket_prefix(ids, b)
        torch.cuda.synchronize()
        fits = -(-n // ops.TILE) * b <= PREFIX_MAX_CELLS
        check((ops.bucket_prefix.launches - before[0],
               ops.bucket_hist.launches - before[1])
              == ((1, 0) if fits else (0, 1)),
              f"bucket_prefix took the wrong branch at {(rows, n, b)}")
        for g, w, name in zip(got, ref.bucket_prefix(ids, b, ops.TILE),
                              ("base", "totals", "starts")):
            check(torch.equal(g, w), f"bucket_prefix {name} differs at "
                  f"{(rows, n, b, kind)}")
        if not kind:
            plan = ops.make_partition_plan(ids, b)
            torch.cuda.synchronize()
            want = ref.partition_plan(ids, b)
            for field in ("positions", "totals", "starts"):
                check(torch.equal(getattr(plan, field), getattr(want, field)),
                      f"partition {field} differs at {(rows, n, b)}")
            del plan, want
        log(f"  rows={rows} n={n} B={b} {kind or 'random'}: bit-equal "
            f"({'prefix in the kernel' if fits else 'prefix in tensor code'})")
        del ids, hist, got


def check_accumulate(torch, ops, ref, dgen, store_per_pe):
    """Row 3, both modes, against the plain versions: runs that span many
    tiles, all-sentinel rows, int32 sums that wrap, every valid key
    weighing 1 (weights=None), ragged rows, a row of 2**24 + 5 elements,
    the store histogram's row."""
    from repro_torch import words as W
    from repro_torch.core import sort

    log("[kernels] segment_accumulate, flags and compacting modes")
    cases = []
    for word_bits in (32, 64):
        for rows, n, nd, long_run, all_s, wkind in (
                (8, 30720, 3000, 0, False, "small"),
                (8, 30720, 40, 0, False, "ones"),
                (2, 300_000, 5, 150_000, False, "wrap"),
                (3, 5000, 10, 0, True, "small"),
                (1, 4099, 7, 0, False, "small"),
                (1, (1 << 24) + 5, 1 << 20, 0, False, "small")):
            cases.append((word_bits, rows, n, nd, long_run, all_s, wkind))
    cases.append((64, 1, store_per_pe, 1 << 26, 0, False, "small"))
    for word_bits, rows, n, nd, long_run, all_s, wkind in cases:
        sent = W.sentinel(word_bits)
        keys, w = _sorted_runs(torch, dgen, rows, n, nd, sent, word_bits,
                               "cuda", long_run, all_s)
        if wkind == "wrap":
            w = torch.randint(1 << 29, (1 << 31) - 1, (rows, n),
                              generator=dgen, dtype=torch.int32,
                              device="cuda")
        elif wkind == "ones":
            w = None
        what = (word_bits, rows, n, nd, long_run, all_s, wkind)
        for compact in (False, True):
            got = ops.segment_accumulate(keys, w, sentinel_val=sent,
                                         compact=compact)
            torch.cuda.synchronize()
            plain = ref.segment_compact if compact else ref.segment_accumulate
            for g, r in zip(got, plain(keys, w, sent)):
                check(torch.equal(g, r), f"segment_accumulate differs at "
                      f"{what}, compact={compact}")
            del got
        if n < store_per_pe:
            fused = sort.accumulate(keys, w, sentinel_val=sent, impl="fused")
            oracle = sort.accumulate(keys, w, sentinel_val=sent,
                                     impl="segment_sum")
            for field in fused._fields:
                check(torch.equal(getattr(fused, field),
                                  getattr(oracle, field)),
                      f"accumulate(impl='fused') {field} differs at {what}")
            del fused, oracle
        log(f"  {word_bits}-bit rows={rows} n={n} distinct<={nd} "
            f"long_run={long_run} all_sentinel={all_s} weights={wkind}: "
            f"both modes bit-equal")
        del keys, w
    torch.cuda.empty_cache()


def check_sweeps(torch, ops, ref, errs):
    """Rows 8-10 against their plain versions, bit-equal: the extraction at
    k 1 to 31, canonical and not, 3 bits per symbol, and rows longer than
    a position tile; the digit histogram at 2 to 13 bits and shifts up to
    and past the top digit, on 32- and 64-bit words with the sentinel; the
    run-start flags on runs that span blocks and an all-sentinel row."""
    from repro_torch import words as W
    from repro_torch.data import genome

    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(11)
    log("[kernels] kmer_extract")
    spec = genome.ReadSetSpec(genome_bases=1 << 20, n_reads=4096,
                              read_len=150, seed=5)
    reads = genome.sample_reads_torch(spec, dev)
    reads[:8] = 0                                  # poly-A rows
    cases = [(k, 2, c, reads) for k in (1, 13, 15, 21, 31)
             for c in (False, True)]
    cases += [(10, 3, False, torch.randint(0, 8, (4096, 150), generator=gen,
                                           device=dev, dtype=torch.uint8)),
              (31, 2, True, reads.view(-1)[:3 * 9000].view(3, 9000)),
              (7, 8, False, torch.randint(0, 256, (100, 64), generator=gen,
                                          device=dev, dtype=torch.uint8)),
              (62, 1, False, reads[:40] & 1)]
    # The packed-row design's edges: odd k; k * bits = 62; m = k; odd
    # n_pos; rows that span tiles (n_pos > 8192); every bits 1-8; codes
    # that start off a 16-byte boundary.
    flat = reads.view(-1)
    cases += [(31, 2, True, reads[:40, :31]), (29, 2, True, reads[:70]),
              (15, 2, True, flat[:300 * 60].view(300, 60)),
              (31, 2, True, flat[5:5 + 3 * 4201].view(3, 4201)),
              (31, 2, True, flat[7:7 + 3 * 8223].view(3, 8223)),
              (21, 2, False, flat[3:3 + 2 * 9001].view(2, 9001)),
              (20, 3, False, reads[:100] | 4),
              (12, 5, False, reads[:100] * 7),
              (10, 6, False, reads[:100] * 21),
              (8, 7, False, reads[:100] * 42),
              (15, 4, False, reads[:100] * 5)]
    for k, bits, canonical, codes in cases:
        got = ops.kmer_extract(codes, k, bits, canonical=canonical)
        torch.cuda.synchronize()
        check(torch.equal(got, ref.kmer_extract(codes, k, bits, canonical)),
              f"kmer_extract differs at k={k} bits={bits} "
              f"canonical={canonical} shape={tuple(codes.shape)}")
        log(f"  k={k} bits={bits} canonical={canonical} "
            f"{tuple(codes.shape)}: bit-equal")
    errs["kmer_extract"] = 0

    log("[kernels] radix_hist")
    for word_bits in (32, 64):
        sent = W.sentinel(word_bits)
        hi = 1 << 62 if word_bits == 64 else 1 << 32
        keys = torch.randint(0, hi, (8, 1 << 16), generator=gen, device=dev)
        if word_bits == 64:
            keys[:, ::3] |= -(1 << 63)             # the top bit set
        keys[:, ::5] = sent
        for digit_bits, shift, tile in (
                (2, 0, 1024), (4, 24, 1024), (8, 60, 512), (4, 60, 1024),
                (2, 24, 512), (8, 0, 1024), (12, 52, 1024), (13, 51, 1024),
                (4, 32, 1024), (4, 64, 1024), (8, 8, 1 << 16)):
            for rows in (keys, keys[0]):
                got = ops.radix_hist(rows, shift, digit_bits, tile)
                torch.cuda.synchronize()
                want = ref.radix_hist(rows.reshape(-1, rows.shape[-1]),
                                      shift, digit_bits, tile)
                check(torch.equal(got.view(want.shape), want),
                      f"radix_hist differs at {word_bits}-bit "
                      f"digit_bits={digit_bits} shift={shift} tile={tile}")
            log(f"  {word_bits}-bit digit_bits={digit_bits} shift={shift} "
                f"tile={tile}: bit-equal, top bin "
                f"{int(got.sum(0).argmax())}")
    errs["radix_hist"] = 0

    log("[kernels] segment_boundaries")
    for word_bits in (32, 64):
        sent = W.sentinel(word_bits)
        for rows, n, nd, long_run, all_s in (
                (8, 30720, 3000, 0, False), (2, 300_000, 5, 150_000, False),
                (3, 5000, 10, 0, True), (1, 4099, 7, 0, False)):
            keys, _ = _sorted_runs(torch, gen, rows, n, nd, sent, word_bits,
                                   dev, long_run, all_s)
            got = ops.segment_boundaries(keys, sentinel_val=sent)
            torch.cuda.synchronize()
            check(torch.equal(got, ref.segment_boundaries(keys, sent)),
                  f"segment_boundaries differs at "
                  f"{(word_bits, rows, n, nd)}")
            check(torch.equal(got, ops.segment_accumulate(
                keys, torch.ones_like(keys, dtype=torch.int32),
                sentinel_val=sent)[0]), "segment_boundaries differs from "
                "segment_accumulate's run starts")
            log(f"  {word_bits}-bit rows={rows} n={n} distinct<={nd} "
                f"long_run={long_run} all_sentinel={all_s}: bit-equal, "
                f"{int(got.sum())} run starts")
    errs["segment_boundaries"] = 0


def _positions_want(torch, ref, ids, base, tile):
    """ref.bucket_positions with every id outside [0, B) moved to a bucket
    B of its own, and the mask of the valid ids: a valid id's slot does not
    depend on the others."""
    b = base.shape[2]
    valid = (ids >= 0) & (ids < b)
    base1 = torch.cat([base, torch.zeros_like(base[..., :1])], 2)
    return ref.bucket_positions(torch.where(valid, ids, b), base1,
                                tile), valid


def check_positions(torch, ops, ref, dev):
    """Row 2 on its own, against its plain version on every valid id: B up
    to MAX_BUCKETS, ragged tiles and rows that start mid-way into 16 bytes
    (n = 3001, 5000), ids of -1 and of B, a tile of one bucket and
    alternating buckets, with any int32 base."""
    from repro_torch.kernels.radix_partition import MAX_BUCKETS

    log("[kernels] bucket_positions alone")
    gen = torch.Generator(device=dev).manual_seed(12)
    for kind, rows, n, b in (
            ("random", 8, 30720, 2), ("random", 8, 30720, 9),
            ("random", 8, 30720, 257), ("random", 3, 5000, MAX_BUCKETS),
            ("random", 2, 3001, 257), ("invalid", 8, 30720, 257),
            ("invalid", 3, 3001, 9), ("one bucket", 8, 30720, 257),
            ("alternating", 8, 30720, 257), ("alternating", 1, 3001, 2)):
        ids = torch.randint(0, b, (rows, n), generator=gen, device=dev,
                            dtype=torch.int32)
        if kind == "invalid":
            ids[:, ::5] = -1
            ids[:, 2::7] = b
        elif kind == "one bucket":
            ids[:] = b // 2
        elif kind == "alternating":
            ids[:] = torch.where(torch.arange(n, device=dev) % 2 == 0, 0,
                                 b - 1).to(torch.int32)
        base = torch.randint(0, 1 << 24, (rows, -(-n // ops.TILE), b),
                             generator=gen, device=dev, dtype=torch.int32)
        got = ops.bucket_positions(ids, base)
        torch.cuda.synchronize()
        want, valid = _positions_want(torch, ref, ids, base, ops.TILE)
        check(torch.equal(got[valid], want[valid]),
              f"bucket_positions differs ({kind}, {(rows, n, b)})")
        log(f"  {kind} rows={rows} n={n} B={b}: bit-equal on "
            f"{int(valid.sum())} valid ids")


def check_home_slots(torch, ops, dev):
    """Row 4 with slots=None, through `countstore.store_insert`: the kernel
    hashes each key. 32- and 64-bit words (the top bit set), caps 1, 257,
    2**20 and one PE's full-size store: set-equal to the plain version with
    slots=None and the same drop signal; `hash_lookup` from `store_slots`
    and `store_lookup` (the lookup kernel's own home slots) then find every
    stored key with its count (a wrong home slot hides it), the lookup's
    stats counting each as a hit; and a `store_grow` rehash on the card
    keeps every (key, count)."""
    from repro_torch import words as W
    from repro_torch.core import countstore

    log("[kernels] hash_insert, home slots hashed in the kernel")
    gen = torch.Generator().manual_seed(7)
    for word_bits in (32, 64):
        sent = W.sentinel(word_bits)
        hi = (1 << 62) if word_bits == 64 else (1 << 32)
        for cap in (1, 257, 1 << 20, 188_743_680):
            rows, n = (2, 5000) if cap < 1 << 20 else (2, 400_000)
            pool = torch.randint(0, hi, (rows, min(cap + 50, n // 2)),
                                 generator=gen)
            if word_bits == 64:
                pool[:, ::2] |= -(1 << 63)          # the top bit set
            keys = pool.gather(1, torch.randint(0, pool.shape[1], (rows, n),
                                                generator=gen))
            keys[:, ::13] = sent
            w = torch.randint(0, 4, (rows, n), generator=gen,
                              dtype=torch.int32)
            st = countstore.empty_store(rows, cap, word_bits, dev)
            countstore.store_insert(st, keys.to(dev), w.to(dev))
            pt = countstore.empty_store(rows, cap, word_bits)
            countstore.store_insert(pt, keys, w)
            torch.cuda.synchronize()
            dk, dc, dd = st.keys.cpu(), st.counts.cpu(), st.dropped.cpu()
            for r in range(rows):
                occ, pocc = dk[r] != sent, pt.keys[r] != sent
                got = sorted(zip(dk[r][occ].tolist(), dc[r][occ].tolist()))
                if int(pt.dropped[r]) == 0:
                    check(got == sorted(zip(pt.keys[r][pocc].tolist(),
                                            pt.counts[r][pocc].tolist())),
                          f"hash_insert (slots=None) set differs at cap {cap}")
                else:   # a full table: which keys win the slots may differ
                    check(len(got) == cap, f"hash_insert (slots=None) fill "
                          f"differs at cap {cap}")
                check((int(dd[r]) > 0) == (int(pt.dropped[r]) > 0),
                      f"hash_insert (slots=None) drop signal differs at cap "
                      f"{cap}")
            del pt
            live = st.keys != sent
            counts, _ = ops.hash_lookup(
                st.keys, st.counts, st.keys,
                countstore.store_slots(st.keys, cap, word_bits),
                sentinel_val=sent)
            check(torch.equal(counts[live], st.counts[live]),
                  f"hash_lookup misses a key the kernel stored (cap {cap})")
            stats = torch.zeros((rows, 3), dtype=torch.int64, device=dev)
            counts, _ = countstore.store_lookup(st, st.keys, stats)
            check(torch.equal(counts[live], st.counts[live]) and torch.equal(
                stats[:, 0], (live & (st.counts > 0)).sum(1)),
                f"store_lookup misses a key the kernel stored (cap {cap})")
            grown = "no rehash (the table dropped)"
            if int(dd.sum()) == 0:
                g = countstore.store_grow(st, 2 * cap + 1)
                counts, _ = countstore.store_lookup(g, st.keys)
                check(torch.equal(counts[live], st.counts[live]) and
                      int((g.keys != sent).sum()) == int(live.sum()),
                      f"store_grow lost a key (cap {cap})")
                grown = f"store_grow to {2 * cap + 1} keeps all"
                del g
            log(f"  {word_bits}-bit rows={rows} cap={cap} n={n}: same "
                f"(key, count) sets, drops {dd.tolist()}, every stored key "
                f"found by hash_lookup and store_lookup; {grown}")
            del st, counts, live
    torch.cuda.empty_cache()


def _lookup_keys(torch, ref, gen, rows, n, word_bits, wrap_cap=None):
    """(rows, n) random keys below 2**62 (64-bit words, the top bit then set
    on every other column) or 2**30 (32-bit). With `wrap_cap`, keys whose
    hashed home slot is one of the last three of a `wrap_cap`-slot table,
    so their walks cross its end."""
    def draw(m):
        if word_bits == 32:
            return torch.randint(0, 1 << 30, (m,), generator=gen)
        k = torch.randint(0, 1 << 62, (m,), generator=gen)
        k[::2] |= -(1 << 63)
        return k

    if wrap_cap is None:
        return torch.stack([draw(n) for _ in range(rows)])
    out = []
    for _ in range(rows):
        row = torch.empty((0,), dtype=torch.int64)
        while row.numel() < n:
            cand = draw(64 * n)
            home = ref.home_slots(cand, wrap_cap, word_bits)
            row = torch.cat([row, cand[home >= wrap_cap - 3]])
        out.append(row[:n])
    return torch.stack(out)


def check_lookup(torch, ops, ref, gen, dev):
    """Row 5 against its plain version (`ref.home_slots`, `ref.hash_lookup`,
    `ref.lookup_stats`), bit-equal in counts, probe lengths and the batch's
    stats, with home slots given and hashed in the kernel (`slots=None`),
    in both word widths (64-bit keys with the top bit set on every other
    one): hits, misses and sentinels; walks that wrap past the last slot;
    a full table that misses sweep; the main path's batch. Each table is
    built by the insert kernel from the same home slots the lookup takes."""
    from repro_torch import words as W

    log("[kernels] hash_lookup")
    for word_bits in (32, 64):
        sent = W.sentinel(word_bits)
        for hashed in (False, True):
            for rows, cap, n_keys, n_q, wrap, name in (
                    (4, 4096, 3000, 20000, False, "hits, misses, sentinels"),
                    (3, 257, 200, 600, True, "wraps past the last slot"),
                    (2, 257, 400, 1000, False, "full table, misses sweep it"),
                    (8, 1 << 20, 500_000, 1 << 20, False, "main-path batch")):
                draw = functools.partial(_lookup_keys, torch, ref, gen, rows,
                                         word_bits=word_bits,
                                         wrap_cap=cap if wrap and hashed
                                         else None)
                keys = draw(n_keys)
                if hashed:
                    slot_of = lambda k: None
                elif wrap:
                    slot_of = lambda k: torch.full(k.shape, cap - 1,
                                                   dtype=torch.int32).to(dev)
                else:
                    slot_of = lambda k: ref.home_slots(k, cap, word_bits)
                tk = torch.full((rows, cap), sent, dtype=torch.int64,
                                device=dev)
                tc = torch.zeros((rows, cap), dtype=torch.int32, device=dev)
                dd = torch.zeros((rows,), dtype=torch.int32, device=dev)
                kd = keys.to(dev)
                ops.hash_insert(tk, tc, kd,
                                torch.randint(1, 9, keys.shape, generator=gen,
                                              dtype=torch.int32).to(dev),
                                slot_of(kd), sentinel_val=sent, dropped=dd,
                                word_bits=word_bits)
                pick = torch.randint(0, n_keys, (rows, n_q // 2),
                                     generator=gen)
                q = torch.cat([keys.gather(1, pick), draw(n_q - n_q // 2)],
                              1)
                q[:, ::13] = sent
                qd = q.to(dev)
                sd = slot_of(qd)
                stats = torch.zeros((rows, 3), dtype=torch.int64, device=dev)
                got = ops.hash_lookup(tk, tc, qd, sd, sentinel_val=sent,
                                      word_bits=word_bits, stats=stats)
                torch.cuda.synchronize()
                want = ref.hash_lookup(
                    tk, tc, qd, ref.home_slots(qd, cap, word_bits)
                    if hashed else sd, sent)
                mode = "slots=None" if hashed else "slots given"
                for g, w, what in zip(got, want, ("counts", "probes")):
                    check(torch.equal(g, w),
                          f"hash_lookup {what} differ ({name}, {mode})")
                check(torch.equal(stats, ref.lookup_stats(*want)),
                      f"hash_lookup stats differ ({name}, {mode})")
                hits = int((got[0] > 0).sum())
                log(f"  {word_bits}-bit {mode} rows={rows} cap={cap} "
                    f"n={n_q} ({name}): bit-equal counts, probes and stats, "
                    f"{hits} hits, longest walk {int(got[1].max())}, "
                    f"{int(((qd < 0) & (qd != sent)).sum())} keys with the "
                    f"top bit set")
                del tk, tc, qd, sd, got, want


def check_sliding_min(torch, ops, ref, gen, dev):
    from repro_torch.core import encoding, owner
    from repro_torch.data import genome

    log("[kernels] sliding_min + sliding_min_pair")
    spec = genome.ReadSetSpec(genome_bases=1 << 20, n_reads=2048,
                              read_len=150, seed=3)
    reads = genome.sample_reads_torch(spec, dev)
    reads[:64] = 0                          # poly-A rows: every key ties
    for m, w in ((7, 25), (20, 12), (7, 1), (20, 131)):
        wb = encoding.word_bits(m)
        mmers = encoding.pack_kmers(reads, m)
        key = owner.order_key(mmers, wb)
        for rows in (mmers, mmers[:1001]):   # 1001: not a multiple of a block
            rows = rows.contiguous()
            got = ops.sliding_min(rows, w)
            keys = key[:rows.shape[0]].contiguous()
            gk, gv = ops.sliding_min_pair(keys, rows, w)
            torch.cuda.synchronize()
            check(torch.equal(got, ref.sliding_min(rows, w)),
                  f"sliding_min differs at m={m} w={w}")
            pk, pv = ref.sliding_min_pair(keys, rows, w)
            check(torch.equal(gk, pk) and torch.equal(gv, pv),
                  f"sliding_min_pair differs at m={m} w={w}")
        top = int((key < 0).sum())
        log(f"  m={m} ({wb}-bit) w={w} rows={tuple(mmers.shape)}: bit-equal, "
            f"{top} keys with the top bit set")
    # the query path's shape: one window per query k-mer, w = n_pos
    q = torch.randint(0, 1 << 62, (1 << 20, 25), generator=gen).to(dev)
    q[::3] |= -(1 << 63)
    check(torch.equal(ops.sliding_min(q, 25), ref.sliding_min(q, 25)),
          "sliding_min differs at the query shape")
    vals = torch.flip(q, [1]).contiguous()
    gk, gv = ops.sliding_min_pair(q, vals, 25)
    pk, pv = ref.sliding_min_pair(q, vals, 25)
    check(torch.equal(gk, pk) and torch.equal(gv, pv),
          "sliding_min_pair differs at the query shape")
    log(f"  query shape {tuple(q.shape)} w=25: bit-equal")
    # Row 6 alone: w = 1 and w = n_pos, long rows in position tiles, and
    # rows that start 8 bytes into a 16-byte unit.
    for rows, n_pos, w, offset in (
            (1001, 144, 1, False), (1001, 144, 144, False),
            (1001, 144, 25, True), (1001, 25, 25, True),
            (3, 5000, 25, False), (3, 5000, 3000, False)):
        buf = torch.randint(0, 1 << 62, (rows * n_pos + 1,),
                            generator=gen).to(dev)
        vals = (buf[1:] if offset else buf[:-1]).view(rows, n_pos)
        vals[::3] |= -(1 << 63)
        check(torch.equal(ops.sliding_min(vals, w), ref.sliding_min(vals, w)),
              f"sliding_min differs at {(rows, n_pos)} w={w} "
              f"offset={offset}")
        log(f"  sliding_min {(rows, n_pos)} w={w}, starting "
            f"{vals.data_ptr() % 16} bytes into 16: bit-equal")


def _held(torch, got, want, tol_f32, what, terms=None):
    """Max |got - want|; raises unless within the f32 tolerance, or for
    bf16 within one bf16 step of each value and of its rounded terms'
    magnitude (`terms`), plus the slack."""
    g, w = got.float(), want.float()
    if not g.numel():
        return 0.0
    diff = (g - w).abs()
    err = float(diff.max())
    if got.dtype == torch.bfloat16:
        bound = (BF16_STEP * (w.abs() + terms)
                 + BF16_SLACK * float(w.abs().max()))
        ok = bool((diff <= bound).all())
    else:
        ok = err <= tol_f32
    check(ok and math.isfinite(err), f"{what}: max abs err {err:.3e}")
    return err


def _flash_launches(ops):
    """(flash launches, f32 flash launches) so far, over rows 11-13."""
    f32 = ops.f32_launch_counts()
    return (sum(n for k, n in ops.launch_counts().items() if k in f32),
            sum(f32.values()))


def check_flash(torch, ops, ref, errs):
    """Rows 11-13 against ref.flash_fwd / ref.flash_bwd on the same inputs:
    GQA by index, window, softcaps, causal=False, q_offset > 0, lengths
    that are not multiples of a tile, fully masked rows; many tiles
    through the kernels' rings (seq 1000 causal, seq 2048 under a window
    of 300), GQA 8/1 and a q_offset that is not a multiple of a tile; head
    dims 15 (no 16-byte copies), 16, 64, 120, 128 and 256, f32 and bf16;
    then the training path's shape (64 batch-heads of 4096 rows) in both
    dtypes, and phase 14's zamba2-1.2b prompt (32 heads of 4160 rows under
    a window of 4096) in f32. A case launches each row once, an f32 case
    the f32 kernels (phase 6 reads their names from the profiler). errs
    gets each kernel's largest f32 error."""
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(7)
    log("[kernels] flash attention forward (rows 11, 12) and backward "
        "(row 13)")
    # (b, hq, hkv, sq, skv, causal, window, softcap, q_offset)
    cases = [
        ("GQA 4/2, causal, 200 rows",
         (2, 4, 2, 200, 200, True, None, None, 0)),
        ("window 48, softcap 20", (1, 2, 2, 130, 130, True, 48, 20.0, 0)),
        ("causal=False, 70 x 150", (1, 2, 1, 70, 150, False, None, None, 0)),
        ("q_offset 100, window 64", (1, 4, 2, 37, 160, True, 64, None, 100)),
        ("fully masked rows", (1, 2, 2, 16, 32, False, 8, 5.0, 30)),
        ("seq 1000, causal", (1, 2, 2, 1000, 1000, True, None, None, 0)),
        ("seq 2048, window 300",
         (1, 2, 2, 2048, 2048, True, 300, None, 0)),
        ("GQA 8/1, causal, 300 rows",
         (1, 8, 1, 300, 300, True, None, None, 0)),
        ("q_offset 77, causal, 200 x 277",
         (1, 4, 2, 200, 277, True, None, None, 77)),
    ]
    worst = {"flash_attention": 0.0, "flash_attention_fwd_lse": 0.0,
             "flash_attention_bwd": 0.0}
    runs = [(name, c, d, dt) for name, c in cases
            for d in (15, 16, 64, 120, 128, 256)
            for dt in (torch.float32, torch.bfloat16)]
    b, h, s, d = FLASH_PATH
    runs += [("training path shape", (b, h, h, s, s, True, None, None, 0),
              d, dt) for dt in (torch.bfloat16, torch.float32)]
    # Phase 14's zamba2-1.2b prompt: 4160 rows past its 4096 window, f32.
    runs.append(("zamba2 prompt, window 4096",
                 (1, 32, 32, 4160, 4160, True, 4096, None, 0), 64,
                 torch.float32))
    for name, (b, hq, hkv, sq, skv, causal, window, softcap, q_offset), d, \
            dt in runs:
        q, do = (torch.randn((b, hq, sq, d), generator=gen, device=dev)
                 .to(dt) for _ in range(2))
        k, v = (torch.randn((b, hkv, skv, d), generator=gen, device=dev)
                .to(dt) for _ in range(2))
        band = dict(causal=causal, window=window, softcap=softcap,
                    q_offset=q_offset, scale=d ** -0.5)
        before = _flash_launches(ops)
        o = ops.flash_attention(q, k, v, **band)
        o2, lse = ops.flash_attention_fwd_lse(q, k, v, **band)
        torch.cuda.synchronize()
        wo, wlse = ref.flash_fwd(q, k, v, with_lse=True, **band)
        kq = k.repeat_interleave(hq // hkv, 1)
        vq = v.repeat_interleave(hq // hkv, 1)
        t_o, t_dq, t_dk, t_dv = (
            ref.flash_rounded_terms(q, kq, vq, wo, wlse, do, **band)
            if dt == torch.bfloat16 else (None,) * 4)
        tag = f"{name}, d={d}, {str(dt)[6:]}"
        e11 = _held(torch, o, wo, FLASH_F32_TOL["o"], f"row 11 o ({tag})",
                    t_o)
        e12 = max(_held(torch, o2, wo, FLASH_F32_TOL["o"],
                        f"row 12 o ({tag})", t_o),
                  _held(torch, lse, wlse, FLASH_F32_TOL["lse"],
                        f"row 12 lse ({tag})"))
        got = ops.flash_attention_bwd(q, kq, vq, wo, wlse, do, **band)
        torch.cuda.synchronize()
        want = ref.flash_bwd(q, kq, vq, wo, wlse, do, **band)
        e13 = max(_held(torch, g, w, FLASH_F32_TOL["grad"],
                        f"row 13 {n} ({tag})", t)
                  for g, w, n, t in zip(got, want, ("dq", "dk", "dv"),
                                        (t_dq, t_dk, t_dv)))
        n, f32 = (x - y for x, y in zip(_flash_launches(ops), before))
        check(n == 3 and f32 == (3 if dt == torch.float32 else 0),
              f"{tag}: {n} flash launches, {f32} of them f32")
        if dt == torch.float32:
            for key, e in zip(worst, (e11, e12, e13)):
                worst[key] = max(worst[key], e)
        log(f"  {tag}: max abs err o {e11:.2e}, o+lse {e12:.2e}, "
            f"dq/dk/dv {e13:.2e}")
        del q, k, v, do, o, o2, lse, wo, wlse, got, want, kq, vq
        del t_o, t_dq, t_dk, t_dv
    errs.update(worst)
    torch.cuda.empty_cache()


# --- phase 4/5: the main path and its independent reference ----------------

def reference_check(torch, reads, k, res, stats, num_pes, pieces,
                    keep=False):
    """Every k-mer extracted by a path of its own (unfold + multiply-add),
    counted with torch.unique in `pieces` slices of k-mer space, must equal
    the port's concatenated per-PE histograms exactly. With `keep`, returns
    the whole reference (ascending k-mers, counts) too."""
    L = res.unique.numel() // num_pes
    uniq = res.unique.view(num_pes, L)
    cnt = res.counts.view(num_pes, L)
    live = (torch.arange(L, device=uniq.device)[None, :]
            < res.num_unique[:, None].to(torch.int64))
    got_k, got_c = uniq[live], cnt[live].to(torch.int64)
    check(int(got_c.sum()) == stats.raw_kmers, "sum(counts) != raw_kmers")
    order = torch.argsort(got_k)
    got_k, got_c = got_k[order], got_c[order]
    check(bool((got_k[1:] != got_k[:-1]).all()), "a k-mer has two owners")
    block = 1 << 20
    kept = []
    for q in range(pieces):
        parts = []
        for lo in range(0, reads.shape[0], block):
            win = reads[lo:lo + block].unfold(1, k, 1)   # a uint8 view
            w = torch.zeros(win.shape[:2], dtype=torch.int64,
                            device=reads.device)
            for j in range(k):
                w = w * 4 + win[..., j].to(torch.int64)
            w = w.reshape(-1)
            parts.append(w[(w % pieces) == q])
            del win, w
        ref_k, ref_c = torch.unique(torch.cat(parts), return_counts=True)
        del parts
        sel = (got_k % pieces) == q
        check(torch.equal(ref_k, got_k[sel]), f"k-mer set differs (piece {q})")
        check(torch.equal(ref_c, got_c[sel]), f"counts differ (piece {q})")
        if keep:
            kept.append((ref_k, ref_c))
    if not keep:
        return int(got_k.numel())
    ref_k = torch.cat([p[0] for p in kept])
    order = torch.argsort(ref_k)
    ref_c = torch.cat([p[1] for p in kept])[order]
    return int(got_k.numel()), (ref_k[order], ref_c)


def per_pe_sets(torch, res, num_pes):
    """Each PE's live (k-mers, counts) of a flat per-PE AccumResult, as
    one compact pair of tensors and the per-PE lengths."""
    L = res.unique.numel() // num_pes
    live = (torch.arange(L, device=res.unique.device)[None, :]
            < res.num_unique[:, None].to(torch.int64))
    return (res.unique.view(num_pes, L)[live].clone(),
            res.counts.view(num_pes, L)[live].clone(),
            res.num_unique.tolist())


def check_same_owners(torch, got, want, what):
    """Per-PE sets `got` (`per_pe_sets`) are exactly phase 4's, `want`."""
    check(got[2] == want[2], f"{what}: per-PE distinct counts differ from "
          f"phase 4's")
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"{what}: a PE's (k-mer, count) set differs from phase 4's")
    log(f"  every PE holds phase 4's (k-mer, count) set ({got[2]})")


def run_count(torch, fabsp, ops, genome, n_reads, k, num_pes, pieces,
              genome_bases, chunk_reads=256, device="cuda", cfg=None,
              grid=None, keep_sets=False, reads=None, group=None):
    """count_kmers (phase 4's configuration unless `cfg` is given) of the
    Synthetic read set, exact against torch.unique; through `group` (a
    one-rank process group, phase 18) when given. Returns (launches,
    wall, peak, distinct, stats, the per-PE sets if `keep_sets`)."""
    if reads is None:
        spec = genome.ReadSetSpec(genome_bases=genome_bases,
                                  n_reads=n_reads, read_len=150, seed=0)
        t0 = time.perf_counter()
        reads = genome.sample_reads_torch(spec, device)
        torch.cuda.synchronize()
        log(f"  reads {tuple(reads.shape)} built on the card in "
            f"{time.perf_counter() - t0:.2f} s")
    if cfg is None:
        cfg = fabsp.DAKCConfig(k=k, chunk_reads=chunk_reads)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, stats = fabsp.count_kmers(reads, cfg, num_pes=num_pes, grid=grid,
                                   device=device, group=group)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"  count_kmers wall {wall:.3f} s, max_memory_allocated "
        f"{peak / 1e9:.2f} GB")
    log(f"  stats {stats._asdict()}")
    log(f"  store slots per PE {res.unique.numel() // num_pes}, retries: "
        f"route-slack {stats.retry_route_slack}, store-rehash "
        f"{stats.retry_store_rehash}")
    launches = {name: launches[name] for name in COUNT_KERNELS}
    log(f"  launches on this path {launches}")
    for name, n in launches.items():
        # Row 1 launches through bucket_prefix, and through bucket_hist for
        # rows too large for the prefix in the kernel (the store
        # histogram's at full size; a small run has none).
        if name not in ROW1:
            check(n > 0, f"kernel {name} did not launch on the main path")
    check(sum(launches[name] for name in ROW1) > 0,
          "row 1 did not launch on the main path")
    t0 = time.perf_counter()
    distinct = reference_check(torch, reads, k, res, stats, num_pes, pieces)
    log(f"  exact against torch.unique: {distinct} distinct k-mers, "
        f"{stats.raw_kmers} instances ({time.perf_counter() - t0:.1f} s)")
    sets = per_pe_sets(torch, res, num_pes) if keep_sets else None
    return launches, wall, peak, distinct, stats, sets


# --- phase 11: the 2d topology ---------------------------------------------

GRID = (2, 4)           # phase 11: 8 PEs as a (rows, cols) grid


def padded_hop2_wire(fabsp, cfg, shape, num_pes):
    """Wire bytes a run would move with the padded hop 2 at phase 11's
    caps: both hops ship every bucket's full capacity. The 'dual' format
    routes a NORMAL word lane and a HEAVY (word, i32) pair."""
    mode, cap_n, cap_h = fabsp._plan_caps(cfg, num_pes, shape, cfg.slack)
    check(mode == "dual", f"phase 11 expects the 'dual' format, got {mode}")
    n_chunks = shape[0] // num_pes // cfg.chunk_reads
    per_pe = num_pes * 2 * (cap_n * 8 + cap_h * 12)
    return n_chunks * num_pes * per_pe


def topology2d_phase(torch, fabsp, ops, genome, n_reads, phase4):
    """Phase 11: count_kmers over 8 PEs as a (2, 4) grid with the compact
    hop 2 at full size, then small runs of the other 2d settings and of the
    fault plans. `phase4` is (wall, per-PE sets) of phase 4, or None."""
    from repro_torch.core import resilience

    rows, cols = GRID
    log(f"[2d] Synthetic 26, {n_reads} reads of 150 bp, k=31, {NUM_PES} PEs "
        f"as a ({rows}, {cols}) grid, oneplan route, compact hop 2")
    cfg = fabsp.DAKCConfig(k=K, topology="2d", hop2_impl="compact")
    spec = genome.ReadSetSpec(genome_bases=1 << 26, n_reads=n_reads,
                              read_len=150, seed=0)
    t0 = time.perf_counter()
    reads = genome.sample_reads_torch(spec, DEV)
    torch.cuda.synchronize()
    log(f"  reads {tuple(reads.shape)} built on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    launches, wall, peak, distinct, stats, sets = run_count(
        torch, fabsp, ops, genome, n_reads, K, NUM_PES, pieces=4,
        genome_bases=1 << 26, cfg=cfg, grid=GRID, reads=reads,
        keep_sets=phase4 is not None)
    check(stats.hop2_dropped == 0 and stats.retry_hop2_fallback == 0,
          "the compact hop 2 misfit at full size")
    check(stats.retry_route_slack == 0 and stats.retry_store_rehash == 0,
          "phase 11 ran a retry round")
    padded = padded_hop2_wire(fabsp, cfg, tuple(reads.shape), NUM_PES)
    check(int(stats.wire_bytes) < padded,
          "the compact hop 2 moved no fewer bytes than the padded one")
    log(f"  wire bytes {int(stats.wire_bytes)} against {padded} with the "
        f"padded hop 2 at the same caps "
        f"({int(stats.wire_bytes) / padded:.4f})")
    for name in COUNT_KERNELS:
        if name not in ROW1:
            check(launches[name] > 0, f"kernel {name} did not launch on "
                  f"phase 11's path")
    check(sum(launches[name] for name in ROW1) > 0,
          "row 1 did not launch on phase 11's path")
    if phase4 is not None:
        check_same_owners(torch, sets, phase4[1], "phase 11")
        log(f"  [2d] wall {wall:.3f} s beside phase 4's {phase4[0]:.3f} s "
            f"(1d); peak {peak / 1e9:.2f} GB")
    del reads, sets
    torch.cuda.empty_cache()
    out = {"full": (launches, wall, peak)}

    small = (
        ("padded hop 2, k=31, (2, 4)", "padded", 31, (2, 4),
         dict(topology="2d")),
        ("'perhop' route, k=13, (4, 2)", "perhop", 13, (4, 2),
         dict(topology="2d", route2d_impl="perhop")),
        ("forced misfit: FaultPlan('hop2_misfit'), k=31, (2, 4)", "misfit",
         31, (2, 4), dict(topology="2d", hop2_impl="compact",
                          faults=resilience.FaultPlan("hop2_misfit"))),
        ("FaultPlan('route_drop'), compact hop 2, k=31, (4, 2)", "route_drop",
         31, (4, 2), dict(topology="2d", hop2_impl="compact",
                          faults=resilience.FaultPlan("route_drop", seed=1,
                                                      frac=0.3))),
        ("FaultPlan('store_drop'), k=31, (2, 4)", "store_drop", 31, (2, 4),
         dict(topology="2d", faults=resilience.FaultPlan(
             "store_drop", seed=2, chunk=-1, frac=0.25))),
    )
    for title, tag, k, grid, knobs in small:
        log(f"[2d small] {title}, 4096 reads")
        _, _, _, _, st, _ = run_count(
            torch, fabsp, ops, genome, 4096, k, NUM_PES, pieces=1,
            genome_bases=1 << 16, cfg=fabsp.DAKCConfig(k=k, **knobs),
            grid=grid)
        out[tag] = st
    check(out["misfit"].retry_hop2_fallback == 1
          and out["misfit"].hop2_dropped == 0,
          "the forced misfit did not fall back to the padded hop 2 once")
    check(out["route_drop"].retry_route_slack >= 1,
          "route_drop forced no slack-doubling round")
    check(out["store_drop"].retry_store_rehash >= 1,
          "store_drop forced no rehash round")

    log("[2d small] KmerCounter, hashed super-k-mers, compact hop 2, k=31, "
        "8 PEs as (4, 2), 2 updates, 2**16 queries")
    sspec = genome.ReadSetSpec(genome_bases=1 << 16, n_reads=4096,
                               read_len=150, seed=2)
    kc, kl, kn = run_counter(
        torch, fabsp, ops, genome,
        fabsp.DAKCConfig(k=K, topology="2d", hop2_impl="compact",
                         transport_impl="superkmer",
                         minimizer_order="hashed"),
        sspec, NUM_PES, 2, 1 << 16, 1, "2d counter", grid=(4, 2))
    del kc
    for name in ("sliding_min_pair", "hash_lookup"):
        check(kl[name] > 0, f"kernel {name} did not launch on the 2d "
              f"counter's path")
    check(kn["query_launches"]["hash_lookup"] > 0,
          "the 2d queries did not launch hash_lookup")
    torch.cuda.empty_cache()
    return out


# --- phase 12: the BSP baseline ----------------------------------------------

BSP_BATCH_READS = 256


def bsp_phase(torch, bsp, ops, genome, n_reads, phase4):
    """Phase 12: the BSP baseline at full size, one host barrier a batch.
    `phase4` is (wall, per-PE sets) of phase 4, or None."""
    from repro_torch.core.aggregation import plan_capacity

    n_batches = n_reads // NUM_PES // BSP_BATCH_READS
    cap = plan_capacity(BSP_BATCH_READS * (150 - K + 1), NUM_PES, 1.5)
    recv_bytes = NUM_PES * NUM_PES * n_batches * cap * 8
    log(f"[bsp] Synthetic 26, {n_reads} reads of 150 bp, k=31, {NUM_PES} "
        f"PEs, batch_reads={BSP_BATCH_READS}: {n_batches} rounds, cap {cap}, "
        f"a receive buffer of {recv_bytes / 1e9:.2f} GB")
    spec = genome.ReadSetSpec(genome_bases=1 << 26, n_reads=n_reads,
                              read_len=150, seed=0)
    t0 = time.perf_counter()
    reads = genome.sample_reads_torch(spec, DEV)
    torch.cuda.synchronize()
    log(f"  reads {tuple(reads.shape)} built on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    # time each round through its barrier (the barrier still synchronises)
    marks = []
    barrier = bsp._superstep_barrier

    def timed_barrier(dev):
        barrier(dev)
        marks.append(time.perf_counter())

    bsp._superstep_barrier = timed_barrier
    try:
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, stats = bsp.count_kmers(
            reads, bsp.BSPConfig(k=K, batch_reads=BSP_BATCH_READS),
            num_pes=NUM_PES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        bsp._superstep_barrier = barrier
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(len(marks) == n_batches, "a BSP round ended without its barrier")
    rounds = [b - a for a, b in zip([t0] + marks[:-1], marks)]
    rounds_s = marks[-1] - t0
    log(f"  bsp.count_kmers wall {wall:.3f} s: {n_batches} rounds "
        f"{rounds_s:.3f} s (median round with its sync "
        f"{sorted(rounds)[len(rounds) // 2] * 1e3:.3f} ms, max "
        f"{max(rounds) * 1e3:.3f} ms), final sort round "
        f"{wall - rounds_s:.3f} s; max_memory_allocated {peak / 1e9:.2f} GB")
    log(f"  stats {stats._asdict()}")
    check(stats.num_global_syncs == n_batches + 1,
          f"num_global_syncs {stats.num_global_syncs} != {n_batches + 1}")
    launches = {name: launches[name] for name in COUNT_KERNELS}
    log(f"  launches on this path {launches}")
    for name in ("bucket_positions", "segment_accumulate"):
        check(launches[name] > 0, f"kernel {name} did not launch on the "
              f"BSP path")
    check(sum(launches[name] for name in ROW1) > 0,
          "row 1 did not launch on the BSP path")
    check(launches["hash_insert"] == 0, "the BSP path ran the store insert")
    t0 = time.perf_counter()
    distinct = reference_check(torch, reads, K, res, stats, NUM_PES, 4)
    log(f"  exact against torch.unique: {distinct} distinct k-mers, "
        f"{stats.raw_kmers} instances ({time.perf_counter() - t0:.1f} s)")
    if phase4 is not None:
        check_same_owners(torch, per_pe_sets(torch, res, NUM_PES),
                          phase4[1], "phase 12")
        log(f"  [bsp] wall {wall:.3f} s beside DAKC's {phase4[0]:.3f} s "
            f"(phase 4): BSP/DAKC {wall / phase4[0]:.3f}")
    del res, reads
    torch.cuda.empty_cache()
    return {"wall": wall, "rounds_s": rounds_s, "peak": peak,
            "launches": launches}


# --- phase 18: the PEs across a process group --------------------------------

PHASE18_DIR = os.path.join(HERE, "build", "chip_smoke_phase18")
PHASE18_SMALL_READS = 4096
EXCHANGE_REPS = 1000    # phase 18: calls of the exchange alone, timed


def _accumulate(total, launches):
    for name, n in launches.items():
        total[name] = total.get(name, 0) + n


def exchange_times(torch, fabsp, rdist, g, n_reads):
    """One exchange of a scan step's NORMAL tile at phase 4's shape, the
    stacked transpose against `dist.exchange` over the group (the same
    lanes, checked equal), each over EXCHANGE_REPS back-to-back calls on
    the host clock to a synchronise, in turns: transpose, exchange,
    exchange, transpose. Returns ms a call and the calls a full run
    makes."""
    _, cap_n, _ = fabsp._plan_caps(fabsp.DAKCConfig(k=K), NUM_PES,
                                   (n_reads, 150), 1.5)
    gen = torch.Generator(device=DEV).manual_seed(18)
    tile = torch.randint(0, 1 << 62, (NUM_PES, NUM_PES, cap_n),
                         generator=gen, device=DEV)
    pes = g.pes(NUM_PES)

    def stacked():
        return tile.transpose(0, 1).reshape(NUM_PES, -1)

    def grouped():
        return rdist.exchange(tile, pes).reshape(NUM_PES, -1)

    check(torch.equal(stacked(), grouped()),
          "dist.exchange differs from the stacked transpose")
    times = {"transpose": [], "exchange": []}
    for name, fn in (("transpose", stacked), ("exchange", grouped),
                     ("exchange", grouped), ("transpose", stacked)):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(EXCHANGE_REPS):
            fn()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) / EXCHANGE_REPS * 1e3)
    # 'dual': a NORMAL word lane and a HEAVY (word, count) pair a step
    calls = n_reads // NUM_PES // 256 * 3
    log(f"  [exchange] tile ({NUM_PES}, {NUM_PES}, {cap_n}) int64, "
        f"{EXCHANGE_REPS} calls each: transpose {times['transpose']} ms, "
        f"dist.exchange {times['exchange']} ms a call; {calls} calls a "
        f"full run")
    return {"tile": [NUM_PES, NUM_PES, cap_n], "ms": times,
            "calls_a_run": calls}


def group_phase(torch, fabsp, bsp, ops, genome, n_reads, phase4):
    """Phase 18: the PEs across a one-rank NCCL process group, through the
    same `all_to_all_single`, `all_reduce` and `all_gather` calls a group
    of several ranks makes. (a) phase 4's workload through the group,
    held to phase 4's result; (b) small runs of the other paths; (c) the
    refusals. `phase4` is phase 4's (wall, per-PE sets, stats, peak).
    Returns the launches of the phase's path and its numbers."""
    import dataclasses
    import shutil

    import torch.distributed as tdist

    from repro_torch.configs import get_config
    from repro_torch.core import dist as rdist
    from repro_torch.models import convert, moe
    from repro_torch.train import compression

    shutil.rmtree(PHASE18_DIR, ignore_errors=True)
    os.makedirs(PHASE18_DIR)
    total, numbers = {}, {}
    g = rdist.init_group("nccl", "file://" + os.path.join(PHASE18_DIR,
                                                          "store"), 0, 1)
    try:
        log(f"  one-rank group: backend {g.backend}, world {g.world}, "
            f"{NUM_PES} PEs on rank 0 ({g.device})")
        # (a) phase 4's workload through the group
        log(f"[group] (a) Synthetic 26, {n_reads} reads of 150 bp, k=31, "
            f"{NUM_PES} PEs on one rank, the default DAKCConfig")
        held = torch.cuda.memory_allocated()   # phase 4's sets, kept
        launches, wall, peak, distinct, stats, sets = run_count(
            torch, fabsp, ops, genome, n_reads, K, NUM_PES, pieces=4,
            genome_bases=1 << 26, keep_sets=phase4 is not None, group=g)
        _accumulate(total, launches)
        for name in COUNT_KERNELS:
            if name not in ROW1:
                check(launches[name] > 0, f"kernel {name} did not launch on "
                      f"phase 18's path")
        check(sum(launches[name] for name in ROW1) > 0,
              "row 1 did not launch on phase 18's path")
        numbers["full"] = {"wall_s": wall, "peak_bytes": peak,
                           "distinct": distinct}
        if phase4 is not None:
            check_same_owners(torch, sets, phase4[1], "phase 18")
            for field, got, want in zip(stats._fields, stats, phase4[2]):
                check(float(got) == float(want), f"phase 18's {field} "
                      f"{got} differs from phase 4's {want}")
            log(f"  every DAKCStats field equals phase 4's")
            log(f"  [group] wall {wall:.3f} s beside phase 4's "
                f"{phase4[0]:.3f} s (stacked): {wall / phase4[0]:.4f}; "
                f"peak {peak} B, {peak - held} B above the {held} B held "
                f"before the call, beside phase 4's {phase4[3]} B")
            numbers["full"].update(phase4_wall_s=phase4[0],
                                   phase4_peak_bytes=phase4[3],
                                   held_bytes=held)
        del sets
        torch.cuda.empty_cache()
        numbers["exchange"] = exchange_times(torch, fabsp, rdist, g, n_reads)

        # (b) small runs on the same group
        small = (
            ("2d one-plan route, compact hop 2, k=31, (2, 4)", "2d", 31,
             GRID, dict(topology="2d", hop2_impl="compact")),
            ("'perhop' route, k=13, (4, 2)", "perhop", 13, (4, 2),
             dict(topology="2d", route2d_impl="perhop")),
            ("forced rehash: store_capacity 4096, k=31", "rehash", 31, None,
             dict(store_capacity=4096)),
        )
        for title, tag, k, grid, knobs in small:
            log(f"[group small] {title}, {PHASE18_SMALL_READS} reads")
            ln, _, _, _, st, _ = run_count(
                torch, fabsp, ops, genome, PHASE18_SMALL_READS, k, NUM_PES,
                pieces=1, genome_bases=1 << 16,
                cfg=fabsp.DAKCConfig(k=k, **knobs), grid=grid, group=g)
            _accumulate(total, ln)
            numbers[tag] = st._asdict()
        check(numbers["2d"]["hop2_dropped"] == 0,
              "the compact hop 2 dropped entries on the group")
        check(numbers["rehash"]["retry_store_rehash"] >= 1,
              "store_capacity 4096 forced no rehash round")

        log(f"[group small] BSP, k=31, {PHASE18_SMALL_READS} reads, "
            f"batch_reads 256")
        spec = genome.ReadSetSpec(genome_bases=1 << 16,
                                  n_reads=PHASE18_SMALL_READS, read_len=150,
                                  seed=0)
        reads = genome.sample_reads_torch(spec, DEV)
        ops.reset_launches()
        res, bst = bsp.count_kmers(reads, bsp.BSPConfig(k=K, batch_reads=256),
                                   num_pes=NUM_PES, group=g)
        _accumulate(total, ops.launch_counts())
        n_batches = PHASE18_SMALL_READS // NUM_PES // 256
        check(bst.num_global_syncs == n_batches + 1,
              f"BSP num_global_syncs {bst.num_global_syncs}")
        distinct = reference_check(torch, reads, K, res, bst, NUM_PES, 1)
        log(f"  exact against torch.unique: {distinct} distinct k-mers, "
            f"{bst.num_global_syncs} global syncs")

        log("[group small] KmerCounter, hashed super-k-mers, k=31, 8 PEs, "
            "2 updates, 2**16 queries")
        kc, kl, kn = run_counter(
            torch, fabsp, ops, genome,
            fabsp.DAKCConfig(k=K, transport_impl="superkmer",
                             minimizer_order="hashed"),
            genome.ReadSetSpec(genome_bases=1 << 16,
                               n_reads=PHASE18_SMALL_READS, read_len=150,
                               seed=2),
            NUM_PES, 2, 1 << 16, 1, "group counter", group=g)
        del kc
        _accumulate(total, kl)
        check(kn["query_launches"]["hash_lookup"] > 0,
              "the group's queries did not launch hash_lookup")

        # (b) the MoE exchange and compression's sum on the group
        base = dataclasses.replace(get_config("deepseek-moe-16b"),
                                   compute_dtype="float32")
        cfg = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, capacity_factor=8.0))
        gen = torch.Generator(device=DEV).manual_seed(21)
        p = moe.init_moe(gen, cfg, DEV)
        x = torch.randn(DAKC_TOKENS + (cfg.d_model,), generator=gen,
                        device=DEV)
        with torch.no_grad():
            yd, ad = moe.moe_block(convert.moe_expert_slice(p, 0, g.world),
                                   x, cfg=cfg, ep_shards=DAKC_SHARDS,
                                   group=g)
            yg, ag = moe.moe_block(p, x, cfg=cfg)
        err, scale = float((yd - yg).abs().max()), float(yg.abs().max())
        check(float(ad.dropped_frac) == float(ag.dropped_frac) == 0.0,
              "drops at capacity factor 8 on the group")
        check(err <= 1e-5 * scale, f"the group's DAKC MoE and GShard differ "
              f"by {err:.3e} (largest {scale:.3f})")
        log(f"  [moe] deepseek-moe-16b layer, {DAKC_SHARDS} EP shards on the "
            f"group vs GShard, {DAKC_TOKENS[0]} x {DAKC_TOKENS[1]} tokens: "
            f"max abs err {err:.3e} (largest {scale:.3f}), no drops")
        numbers["moe"] = {"err": err, "scale": scale}
        del p, x, yd, yg
        grads = {"w": torch.randn((4096, 1024), generator=gen, device=DEV)}
        out, e = compression.compress_psum(
            grads, compression.init_error_feedback(grads), frac=1.0, group=g)
        check(torch.equal(out["w"], grads["w"]) and not e["w"].any(),
              "compress_psum(group=) at frac 1.0 is not its input")
        log("  [compression] compress_psum(group=) at frac 1.0 equals its "
            "input; the residual is 0")
        del grads, out, e
        torch.cuda.empty_cache()

        # (c) the refusals, by type and message
        pg = tdist.new_group(backend="gloo")
        gg = rdist.Group(pg=pg, backend="gloo", rank=0, world=1,
                         device=torch.device("cpu"))
        try:
            rdist.exchange(torch.zeros((NUM_PES, NUM_PES, 4),
                                       dtype=torch.int64, device=DEV),
                           gg.pes(NUM_PES))
            check(False, "a gloo group took a CUDA tensor")
        except ValueError as e:
            check("takes cpu tensors" in str(e), f"gloo refusal says {e}")
            log(f"  [refusal] a CUDA tensor to a gloo group: ValueError: {e}")
        try:
            fabsp.count_kmers(reads, fabsp.DAKCConfig(k=K), num_pes=NUM_PES,
                              group=gg)
            check(False, "a gloo group counted the card's reads")
        except ValueError as e:
            check("the reads lie on cuda" in str(e),
                  f"gloo refusal says {e}")
            log(f"  [refusal] the card's reads to a gloo group: "
                f"ValueError: {e}")
        tdist.destroy_process_group(pg)

        del reads, res
    finally:
        g.destroy()
        shutil.rmtree(PHASE18_DIR, ignore_errors=True)
    for name in ("bucket_positions", "segment_accumulate", "hash_insert"):
        check(total.get(name, 0) > 0, f"kernel {name} did not launch on "
              f"phase 18's path")
    launches = {name: total.get(name, 0) for name in ops.launch_counts()}
    log(f"  launches on phase 18's path {launches}")
    log(json.dumps({"phase18": numbers}, default=str))
    return launches, numbers


# --- phase 8: the incremental counter and its queries ----------------------

def make_queries(torch, reads, k, n, seed):
    """n packed k-mer words on the card: half read windows (hits), half
    uniform random words (almost all misses)."""
    dev = reads.device
    g = torch.Generator(device=dev).manual_seed(seed)
    half = n // 2
    rows = torch.randint(0, reads.shape[0], (half,), generator=g, device=dev)
    offs = torch.randint(0, reads.shape[1] - k + 1, (half,), generator=g,
                         device=dev)
    win = reads[rows[:, None], offs[:, None]
                + torch.arange(k, device=dev)[None, :]]
    hit = torch.zeros((half,), dtype=torch.int64, device=dev)
    for j in range(k):
        hit = hit * 4 + win[:, j].to(torch.int64)
    rand = torch.randint(0, 1 << (2 * k), (n - half,), generator=g,
                         device=dev)
    return torch.cat([hit, rand])


def run_counter(torch, fabsp, ops, genome, cfg, spec, num_pes, n_updates,
                n_queries, pieces, label, grid=None, keep_sets=False,
                group=None):
    """Feed `spec`'s reads to a KmerCounter in `n_updates` equal batches,
    finalize it exactly against torch.unique, then answer `n_queries`
    point queries exactly. Returns (counter, launches, numbers); with
    `keep_sets`, numbers["sets"] holds the per-PE (k-mer, count) sets."""
    t0 = time.perf_counter()
    reads = genome.sample_reads_torch(spec, "cuda")
    torch.cuda.synchronize()
    log(f"  reads {tuple(reads.shape)} built on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    batch = spec.n_reads // n_updates
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    kc = fabsp.KmerCounter(cfg, num_pes=num_pes, grid=grid, group=group)
    walls = []
    for i in range(n_updates):
        t0 = time.perf_counter()
        st = kc.update(reads[i * batch:(i + 1) * batch])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        log(f"  update {i}: wall {walls[-1]:.3f} s, "
            f"{st.raw_kmers / walls[-1] / 1e6:.2f} M k-mer instances/s, "
            f"retry route-slack {st.retry_route_slack} store-rehash "
            f"{st.retry_store_rehash} hop2-fallback {st.retry_hop2_fallback}, "
            f"store slots per PE {kc.store_capacity}")
    t0 = time.perf_counter()
    res, stats = kc.finalize()
    torch.cuda.synchronize()
    t_fin = time.perf_counter() - t0
    update_wall = sum(walls)
    log(f"  finalize wall {t_fin:.3f} s; {n_updates} updates "
        f"{update_wall:.3f} s, {stats.raw_kmers / update_wall / 1e6:.2f} M "
        f"k-mer instances/s; lifetime stats {stats._asdict()}")
    queries = make_queries(torch, reads, cfg.k, n_queries, seed=5)
    torch.cuda.synchronize()
    before = ops.launch_counts()
    t0 = time.perf_counter()
    got = kc.count(queries)
    torch.cuda.synchronize()
    t_q = time.perf_counter() - t0
    query_launches = {name: n - before[name]
                      for name, n in ops.launch_counts().items()}
    qstats = kc.last_query_stats
    got_in = kc.contains(queries)
    peak = torch.cuda.max_memory_allocated()
    launches = ops.launch_counts()
    log(f"  count() of {n_queries} queries: wall {t_q:.3f} s, "
        f"{n_queries / t_q / 1e6:.3f} M queries/s; {qstats}")
    log(f"  max_memory_allocated {peak / 1e9:.2f} GB "
        f"(updates, finalize and queries)")
    log(f"  launches on this path {launches}")
    t0 = time.perf_counter()
    distinct, (ref_k, ref_c) = reference_check(
        torch, reads, cfg.k, res, stats, num_pes, pieces, keep=True)
    sets = per_pe_sets(torch, res, num_pes) if keep_sets else None
    del res, reads
    idx = torch.clamp(torch.searchsorted(ref_k, queries),
                      max=ref_k.numel() - 1)
    want = torch.where(ref_k[idx] == queries, ref_c[idx], 0)
    check(bool((torch.from_numpy(got).to(want.device) == want).all()),
          "a query answer differs from torch.unique")
    check(bool((torch.from_numpy(got_in).to(want.device) == (want > 0))
               .all()), "a contains() answer differs")
    check(qstats.n_hits == int((want > 0).sum()), "QueryStats.n_hits")
    log(f"  [{label}] exact against torch.unique: {distinct} distinct "
        f"k-mers, {stats.raw_kmers} instances; all {n_queries} answers "
        f"exact, {qstats.n_hits} hits ({time.perf_counter() - t0:.1f} s)")
    numbers = {"update_wall_s": update_wall, "updates": walls,
               "instances_per_s": stats.raw_kmers / update_wall,
               "finalize_s": t_fin, "query_wall_s": t_q,
               "queries_per_s": n_queries / t_q, "peak_bytes": peak,
               "query_launches": query_launches,
               "query_stats": qstats._asdict(), "stats": stats,
               "sets": sets}
    return kc, launches, numbers


def counter_phase(torch, fabsp, ops, genome):
    """Phase 8: the full-size counter, then the small cases. Returns the
    full-size counter (phase 6 times the lookup against its store), and
    the launches and numbers of each run."""
    log("[counter] Synthetic 26, 2**23 reads of 150 bp in 8 updates, k=31, "
        "hashed super-k-mers, prefix compaction, 8 PEs")
    cfg = fabsp.DAKCConfig(k=K, transport_impl="superkmer",
                           minimizer_order="hashed", compact_impl="prefix")
    spec = genome.ReadSetSpec(genome_bases=1 << 26, n_reads=1 << 23,
                              read_len=150, seed=0)
    kc, launches, numbers = run_counter(torch, fabsp, ops, genome, cfg, spec,
                                        NUM_PES, 8, 1 << 20, 4, "full size",
                                        keep_sets=True)
    for name in ("hash_lookup", "sliding_min_pair", "hash_insert",
                 "bucket_hist", "bucket_prefix", "bucket_positions",
                 "segment_accumulate"):
        check(launches[name] > 0, f"kernel {name} did not launch on the "
              f"counter's path")
    out = {"full": (launches, numbers)}
    small = (
        ("k-mer transport, k=13, 4 PEs", "kmer13",
         fabsp.DAKCConfig(k=13), 4, 1 << 16),
        ("'plain' minimizer order, k=31, 8 PEs", "plain",
         fabsp.DAKCConfig(k=K, transport_impl="superkmer"), NUM_PES, 1 << 20),
        ("a rehash round: 256-slot stores, k=31, 8 PEs", "rehash",
         fabsp.DAKCConfig(k=K, transport_impl="superkmer",
                          minimizer_order="hashed", store_capacity=256),
         NUM_PES, 1 << 16),
    )
    for title, tag, scfg, p, genome_bases in small:
        log(f"[counter small] {title}")
        sspec = genome.ReadSetSpec(genome_bases=genome_bases, n_reads=1 << 15,
                                   read_len=150, seed=2)
        skc, sl, sn = run_counter(torch, fabsp, ops, genome, scfg, sspec, p,
                                  2, 1 << 14, 1, tag)
        del skc
        out[tag] = (sl, sn)
    check(out["plain"][0]["sliding_min"] > 0,
          "sliding_min did not launch under the 'plain' order")
    # The query path takes each query k-mer's minimizer: one window of
    # w = n_pos m-mers a row, the kernel's one-output layout.
    check(out["plain"][1]["query_launches"]["sliding_min"] > 0,
          "sliding_min did not launch on the 'plain' order's query path")
    log(f"  'plain' order: sliding_min launched "
        f"{out['plain'][0]['sliding_min']} times, "
        f"{out['plain'][1]['query_launches']['sliding_min']} of them by "
        f"count()'s query k-mers")
    check(out["rehash"][1]["stats"].retry_store_rehash > 0,
          "the rehash case ran no rehash round")
    return kc, out


# --- phase 13: durability, spill and serving at full size -------------------

# The spill run: phase 8's read set in SPILL_UPDATES updates under
# spill='auto': SPILL_HEAD's reads first, the rest in near-equal multiples
# of 2048 (8 PEs x 256-read chunks). The stores start at SPILL_STORE_CAP
# slots a PE, and the rehash ladder doubles a store while it is at most
# SPILL_CEILING, so 2**22 slots is its last rung. Under the minimizer
# ownership the PEs' distinct k-mers differ by several per cent: after the
# first update they hold about 2.1M each, so some PEs overflow 2**21
# slots, one rehash round doubles the store, and the update commits in
# core; after the second about 4.1M, so some overflow 2**22 and the ladder
# gives up: the tier engages there and exports the committed pairs (about
# 16.7M). Once a PE's table is full the insert drops an absent key only
# after probing every slot, so each failed round costs its dropped items
# times the table's slots (PERF.md section 7): the heads are cut so that
# only about 150K keys overflow each time.
SPILL_UPDATES = 16
SPILL_HEAD = (159744, 217088)
SPILL_STORE_CAP = 1 << 21
SPILL_CEILING = 1 << 21
SPILL_SAVE_AT = 12
SPILL_KILL_AFTER = 40
SERVE_QUERIES = 1 << 20       # a tenant, in SERVE_REQUESTS requests
SERVE_REQUESTS = 32
PHASE13_DIR = os.path.join(HERE, "build", "chip_smoke_phase13")
# Rows 1-5 and 7: what phase 13's path must launch.
PHASE13_KERNELS = ("bucket_positions", "segment_accumulate", "hash_insert",
                   "hash_lookup", "sliding_min_pair")


def global_hist(torch, res, num_pes):
    """The (k-mer, count) pairs of a per-PE AccumResult, ascending."""
    keys, counts, _ = per_pe_sets(torch, res, num_pes)
    order = torch.argsort(keys)
    return keys[order], counts[order]


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def answers(torch, hist, queries):
    """Each query's count in the ascending histogram `hist` (0 = absent)."""
    keys, counts = hist
    idx = torch.clamp(torch.searchsorted(keys, queries), max=keys.numel() - 1)
    return torch.where(keys[idx] == queries, counts[idx], 0).to(torch.int32)


def durability_phase(torch, fabsp, ops, genome, counter, phase8, n_reads,
                     card):
    """Phase 13: phase 8's counter checkpointed and restored onto 8 and 4
    PEs; the same read set through the spill tier, engaged mid-stream; the
    kill drill (a torn segment write, restore onto 4 PEs, replay); two
    tenants served through QueryService, cold and warm; small drills.
    Every histogram and answer is checked exactly. Returns the launches of
    the phase's path."""
    import dataclasses
    import shutil

    import numpy as np
    from repro_torch import words as W
    from repro_torch.core import minimizer, query, resilience, spill
    from repro_torch.launch.kc_serve import QueryService, StoreRegistry
    from repro_torch.train import checkpoint

    shutil.rmtree(PHASE13_DIR, ignore_errors=True)
    os.makedirs(PHASE13_DIR)
    numbers = {"card": card, "n_reads": n_reads}
    sets8 = phase8["sets"]
    want8 = torch.argsort(sets8[0])
    want8 = (sets8[0][want8], sets8[1][want8])
    spec = genome.ReadSetSpec(genome_bases=1 << 26, n_reads=1 << 23,
                              read_len=150, seed=0)
    reads = genome.sample_reads_torch(spec, "cuda")[:n_reads]
    ops.reset_launches()

    def exact(res, stats, p, what, full):
        """`res` of p PEs against phase 8's histogram (`full`) or, for a
        cut read count, against torch.unique of the phase's reads."""
        if full:
            got = global_hist(torch, res, p)
            check(torch.equal(got[0], want8[0])
                  and torch.equal(got[1], want8[1]),
                  f"{what}: the histogram differs from phase 8's")
            check(int(got[1].sum()) == stats.raw_kmers,
                  f"{what}: sum(counts) != raw_kmers")
            log(f"  [{what}] exact against phase 8's histogram "
                f"({got[0].numel()} distinct k-mers)")
            return got
        distinct = reference_check(torch, reads, K, res, stats, p, 4)
        log(f"  [{what}] exact against torch.unique ({distinct} distinct)")
        return global_hist(torch, res, p)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # 1. checkpoint and restore, in place and elastic
    cfg8 = counter._cfg
    ck8 = os.path.join(PHASE13_DIR, "ckpt8")
    path, t_save = timed(lambda: counter.save(ck8, step=8))
    numbers["save_s"], numbers["save_bytes"] = t_save, dir_bytes(path)
    log(f"  [save] phase 8's counter: {numbers['save_bytes']} bytes on "
        f"disk in {t_save:.3f} s ({card})")
    r8, numbers["restore8_s"] = timed(lambda: fabsp.KmerCounter.restore(
        ck8, cfg8, num_pes=NUM_PES))
    res, st = r8.finalize()
    got = per_pe_sets(torch, res, NUM_PES)
    check(got[2] == sets8[2] and torch.equal(got[0], sets8[0])
          and torch.equal(got[1], sets8[1]),
          "the 8-PE restore's per-PE sets differ from phase 8's")
    log(f"  [restore 8 PEs] {numbers['restore8_s']:.3f} s; every PE holds "
        f"phase 8's (k-mer, count) set ({card})")
    del r8, res, got
    r4, numbers["restore4_s"] = timed(lambda: fabsp.KmerCounter.restore(
        ck8, cfg8, num_pes=4))
    res, st = r4.finalize()
    incore_hist = exact(res, st, 4, "restore 4 PEs", True)
    log(f"  [restore 4 PEs] elastic reshard {numbers['restore4_s']:.3f} s, "
        f"{r4.store_capacity} slots a PE ({card})")
    del res
    torch.cuda.empty_cache()

    # 2. the spill tier, engaged mid-stream
    full = n_reads == 1 << 23
    bins_dir = os.path.join(PHASE13_DIR, "bins")
    os.makedirs(bins_dir)
    slot = minimizer.slot_bytes(K, cfg8.minimizer_len)
    est = (n_reads * minimizer.expected_superkmers(1, 150, K,
                                                   cfg8.minimizer_len)
           * slot + int(want8[0].numel()) * 12)
    free = shutil.disk_usage(bins_dir).free
    log(f"  [spill] expect about {est / 1e9:.2f} GB of segments; "
        f"{free / 1e9:.1f} GB free under {bins_dir}")
    check(free >= 2 * est, f"phase 13 needs {2 * est} bytes free under "
          f"{bins_dir}, has {free}")
    cfg13 = dataclasses.replace(
        cfg8, store_capacity=SPILL_STORE_CAP, spill="auto",
        spill_dir=bins_dir,
        retry=resilience.RetryPolicy(store_cap_ceiling=SPILL_CEILING))
    unit = NUM_PES * cfg8.chunk_reads
    head = list(np.cumsum((0,) + SPILL_HEAD))
    n_tail = SPILL_UPDATES - len(SPILL_HEAD)
    rest = (n_reads - head[-1]) // unit
    check(rest >= n_tail, f"phase 13 needs more than {head[-1]} reads for "
          f"its spill run, got {n_reads}")
    bounds = head[:-1] + [head[-1] + unit * (rest * i // n_tail)
                          for i in range(n_tail + 1)]
    batches = [reads[lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])]
    ck13 = os.path.join(PHASE13_DIR, "ckpt_spill")
    log(f"  [spill] {SPILL_UPDATES} updates: {SPILL_HEAD} reads, then "
        f"{n_tail} of {batches[-2].shape[0]}-{batches[-1].shape[0]}; "
        f"store_capacity={SPILL_STORE_CAP}, store_cap_ceiling="
        f"{SPILL_CEILING}, spill='auto'")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kc = fabsp.KmerCounter(cfg13, num_pes=NUM_PES)
    walls, engaged, rehashed, committed = [], None, 0, 0
    for i in range(SPILL_UPDATES):
        if i == SPILL_SAVE_AT:
            kc.save(ck13, step=i)
        st, wall = timed(lambda: kc.update(batches[i]))
        walls.append(wall)
        if engaged is None and kc._spill is not None:
            engaged = i
        if engaged is None:
            rehashed += st.retry_store_rehash
            per_pe = (kc._store.keys != W.sentinel(kc._wb)).sum(1).tolist()
            committed = sum(per_pe)
            log(f"  update {i}: distinct k-mers a PE {per_pe} in "
                f"{kc.store_capacity} slots")
        log(f"  update {i}: {wall:.3f} s, {'spilled' if kc._spill else 'in '
            'core'}, spilled_bytes {st.spilled_bytes}, retries "
            f"{st.retry_route_slack}/{st.retry_store_rehash}/"
            f"{st.retry_hop2_fallback}")
    check(engaged is not None and 1 <= engaged < SPILL_SAVE_AT,
          f"the tier engaged at update {engaged}, not after an in-core "
          f"commit and before update {SPILL_SAVE_AT}")
    exported = sum(s["n"] for s in kc._spill.state()["segments"]
                   if s["kind"] == "pairs")
    check(rehashed >= 1, "no rehash round ran before the tier engaged")
    check(exported == committed > 0, f"the engage exported {exported} "
          f"pairs, the committed store held {committed}")
    log(f"  [spill] {rehashed} rehash round(s) in core; the engage exported "
        f"the {exported} committed (k-mer, count) pairs")
    (res, st), t_drain = timed(kc.finalize)
    peak = torch.cuda.max_memory_allocated()
    spill_hist = exact(res, st, NUM_PES, "spill 8 PEs", full)
    segs = kc._spill.state()["segments"]
    nonempty = len({s["bin"] for s in segs if s["n"] > 0})
    check(st.spilled_bins >= 1 and st.bins_folded == nonempty,
          f"spilled_bins {st.spilled_bins}, bins_folded {st.bins_folded}, "
          f"non-empty bins {nonempty}")
    numbers.update(
        engaged_at=engaged, rehash_rounds=rehashed, exported=exported,
        n_bins=kc._spill.n_bins, segments=len(segs),
        spilled_bytes=st.spilled_bytes, spill_update_s=sum(walls),
        spill_updates=walls, engage_update_s=walls[engaged],
        drain_s=t_drain, spill_peak_bytes=peak,
        phase8_update_s=phase8["update_wall_s"], spill_stats=st._asdict())
    log(f"  [spill] engaged at update {engaged} into {kc._spill.n_bins} bins"
        f" ({len(segs)} segments); spilled_bytes {st.spilled_bytes}; "
        f"updates {sum(walls):.3f} s, the engaging one {walls[engaged]:.3f}"
        f" s (phase 8's 8 in-core updates "
        f"{phase8['update_wall_s']:.3f} s); drain {t_drain:.3f} s; peak "
        f"{peak / 1e9:.2f} GB ({card})")
    del res, kc
    torch.cuda.empty_cache()

    # 3. the kill drill: torn segment write, restore onto 4 PEs, replay
    kf = fabsp.KmerCounter.restore(ck13, dataclasses.replace(
        cfg13, faults=resilience.FaultPlan(site="spill_write",
                                           fail_after=SPILL_KILL_AFTER)),
        num_pes=NUM_PES)
    try:
        kf.update(batches[SPILL_SAVE_AT])
        check(False, "the spill_write fault did not fire")
    except resilience.InjectedFault as e:
        log(f"  [kill] update {SPILL_SAVE_AT} died: {e}")
    del kf
    kc4, t_r = timed(lambda: fabsp.KmerCounter.restore(ck13, cfg13,
                                                       num_pes=4))
    listed = {s["file"] for s in kc4._spill.state()["segments"]}
    on_disk = {f for f in os.listdir(bins_dir) if f.endswith((".npz", ".tmp"))}
    check(on_disk == listed and kc4._n_updates == SPILL_SAVE_AT,
          "the restore did not prune to the checkpoint's manifest")
    walls = [timed(lambda: kc4.update(b))[1]
             for b in batches[SPILL_SAVE_AT:]]
    (res, st), t_drain4 = timed(kc4.finalize)
    spill_hist = exact(res, st, 4, "kill drill 4 PEs", full)
    numbers.update(kill_restore_s=t_r, kill_replay_s=sum(walls),
                   kill_drain_s=t_drain4)
    log(f"  [kill] restored onto 4 PEs in {t_r:.3f} s, replayed "
        f"{len(walls)} updates in {sum(walls):.3f} s, drain "
        f"{t_drain4:.3f} s ({card})")
    del res
    torch.cuda.empty_cache()

    # 4. serving: the in-core and the spilled tenant through QueryService
    queries = make_queries(torch, reads, K, SERVE_QUERIES, seed=13)
    q_np = W.to_numpy_words(queries, 64)
    want = {"incore": answers(torch, incore_hist, queries).cpu().numpy(),
            "spilled": answers(torch, spill_hist, queries).cpu().numpy()}
    parts = np.array_split(np.arange(SERVE_QUERIES), SERVE_REQUESTS)
    registry = StoreRegistry(num_pes=4)
    registry.register("incore", r4)
    registry.register("spilled", kc4)
    service = QueryService(registry)

    def serve(tenants, tag):
        """Every tenant's queries in SERVE_REQUESTS requests, interleaved,
        one flush; exact; returns {tenant: queries/s}."""
        order = [(t, j) for j in range(SERVE_REQUESTS) for t in tenants]
        idx = [service.submit(t, q_np[parts[j]]) for t, j in order]
        out, t_flush = timed(service.flush)
        rates = {}
        for (t, j), i in zip(order, idx):
            counts, rs = out[i]
            check(np.array_equal(counts, want[t.split("_")[0]][parts[j]]),
                  f"{tag}: a {t} answer differs")
            rates[t] = SERVE_QUERIES / rs.seconds
        log(f"  [{tag}] {len(order)} requests in one flush, {t_flush:.3f} s;"
            f" all answers exact; queries/s "
            f"{ {t: round(r, 1) for t, r in rates.items()} } ({card})")
        return rates

    numbers["cold_qps"] = serve(("incore", "spilled"), "serve cold")
    qs, cache = kc4.last_query_stats, kc4._bin_cache
    numbers["cold_query_stats"] = qs._asdict()
    numbers["cold_cache"] = [cache.hits, cache.misses, cache.evictions]
    log(f"  spilled tenant: bins_probed {qs.bins_probed}, bin_folds "
        f"{qs.bin_folds}, cache hits {cache.hits} misses {cache.misses} "
        f"evictions {cache.evictions} (budget {cfg13.query_bin_cache_bytes})")
    ck_serve = os.path.join(PHASE13_DIR, "ckpt_serve")
    kc4.save(ck_serve, step=SPILL_UPDATES)
    del kc4, cache
    warm = fabsp.KmerCounter.restore(ck_serve, dataclasses.replace(
        cfg13, query_bin_cache_bytes=1 << 40), num_pes=4)
    registry.register("spilled", warm)
    torch.cuda.empty_cache()
    rates = [serve(("spilled",), f"serve spilled, {tag}")["spilled"]
             for tag in ("folding every bin", "warm")]
    qs, cache = warm.last_query_stats, warm._bin_cache
    check(qs.bin_folds == 0 and cache.evictions == 0,
          "the warm flush folded a bin")
    numbers["warm_qps"] = {"spilled_first": rates[0], "spilled": rates[1]}
    numbers["warm_cache"] = [cache.hits, cache.misses, cache.evictions]
    log(f"  warm: bins_probed {qs.bins_probed}, bin_folds {qs.bin_folds}, "
        f"cache hits {cache.hits} misses {cache.misses}; spilled queries/s "
        f"cold {numbers['cold_qps']['spilled']:.1f}, warm {rates[1]:.1f}")
    registry.register("strict", fabsp.KmerCounter.restore(
        ck_serve, dataclasses.replace(cfg13, spill_query="refuse"),
        num_pes=4))
    i0 = service.submit("incore", q_np[parts[0]])
    i1 = service.submit("strict", q_np[parts[0]])
    i2 = service.submit("incore", q_np[parts[1]])
    out = service.flush()
    check(isinstance(out[i1], query.QueryUnavailable)
          and np.array_equal(out[i0][0], want["incore"][parts[0]])
          and np.array_equal(out[i2][0], want["incore"][parts[1]]),
          "the refusing tenant was not isolated")
    log("  [refuse] the strict tenant's requests got QueryUnavailable; "
        "the in-core tenant's answers kept")
    del registry, service, warm, r4, queries, incore_hist, spill_hist
    torch.cuda.empty_cache()

    # 5. small drills, 4096 reads
    sreads = genome.sample_reads_torch(genome.ReadSetSpec(
        genome_bases=1 << 16, n_reads=4096, read_len=150, seed=3), "cuda")
    ckd = os.path.join(PHASE13_DIR, "ckpt_small")
    half = sreads.shape[0] // 2
    kc = fabsp.KmerCounter(cfg8, num_pes=NUM_PES)
    kc.update(sreads[:half])
    kc.save(ckd, step=0)
    kc.update(sreads[half:])
    kf = fabsp.KmerCounter.restore(ckd, dataclasses.replace(
        cfg8, faults=resilience.FaultPlan(site="ckpt_write", fail_after=1)),
        num_pes=NUM_PES)
    try:
        kf.save(ckd, step=1)
        check(False, "the ckpt_write fault did not fire")
    except resilience.InjectedFault:
        pass
    check(checkpoint.latest_step(ckd) == 0, "a torn checkpoint is latest")
    kr = fabsp.KmerCounter.restore(ckd, cfg8, num_pes=NUM_PES)
    kr.update(sreads[half:])
    a, b = (per_pe_sets(torch, c.finalize()[0], NUM_PES) for c in (kr, kc))
    check(a[2] == b[2] and torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
          "the replay after a torn checkpoint differs")
    log("  [ckpt_write] torn step 1 left step 0 latest; its restore and "
        "replay are exact")
    kc = fabsp.KmerCounter(dataclasses.replace(
        cfg8, spill="always", spill_bins=4,
        spill_dir=os.path.join(PHASE13_DIR, "corrupt"),
        faults=resilience.FaultPlan(site="bin_corrupt", bin=2)),
        num_pes=NUM_PES)
    kc.update(sreads)
    try:
        kc.finalize()
        check(False, "the bin_corrupt fault did not fire")
    except spill.SpillCorrupt as e:
        check(e.bin == 2 and "bin 2" in str(e), f"SpillCorrupt names {e}")
        log(f"  [bin_corrupt] {e}")
    for title, knobs, grid in (
            ("spill on a (2, 4) grid", dict(topology="2d",
                                            hop2_impl="compact"), (2, 4)),
            ("count_kmers(spill='always')", {}, None)):
        cfg = dataclasses.replace(
            cfg8, spill="always", spill_bins=8,
            spill_dir=os.path.join(PHASE13_DIR, "small"), **knobs)
        res, st = fabsp.count_kmers(sreads, cfg, num_pes=NUM_PES, grid=grid)
        distinct = reference_check(torch, sreads, K, res, st, NUM_PES, 1)
        check(st.bins_folded == st.spilled_bins >= 1, f"{title}: bins")
        log(f"  [{title}] exact against torch.unique ({distinct} distinct, "
            f"{st.bins_folded} bins)")
    del kc, kr, res, sreads, reads, batches

    launches = ops.launch_counts()
    for name in PHASE13_KERNELS:
        check(launches[name] > 0, f"kernel {name} did not launch on phase "
              f"13's path")
    check(launches["bucket_hist"] + launches["bucket_prefix"] > 0,
          "row 1 did not launch on phase 13's path")
    log(f"  launches on phase 13's path {launches}")
    log(json.dumps({"phase13": numbers}, default=str))
    shutil.rmtree(PHASE13_DIR, ignore_errors=True)
    return launches


# --- phase 10: the sweep kernels through their entry points ----------------

def sweeps_phase(torch, ops, ref, genome, n_reads, timed):
    """Drive ops.kmer_extract, ops.radix_hist and sort.accumulate(
    boundaries_impl='kernel') over the Synthetic-26 read set, each result
    held bit-equal to its plain version and the chain exact against
    torch.unique. Returns the launches of the run and, with `timed`, the
    numbers of rows 8-10 for phase 6."""
    from repro_torch import words as W
    from repro_torch.core import sort

    spec = genome.ReadSetSpec(genome_bases=1 << 26, n_reads=n_reads,
                              read_len=150, seed=0)
    reads = genome.sample_reads_torch(spec, DEV)
    n_pos = spec.read_len - K + 1
    n_sort = min(n_reads, SWEEP_SORT_READS)
    if n_sort != SWEEP_SORT_READS:
        log(f"  CUT: the sort chain takes {n_sort} reads instead of "
            f"{SWEEP_SORT_READS}")
    words = torch.empty((n_sort, n_pos), dtype=torch.int64, device=DEV)
    block = 1 << 20
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    for lo in range(0, n_reads, block):
        piece = reads[lo:lo + block]
        for canonical in (False, True):
            got = ops.kmer_extract(piece, K, canonical=canonical)
            want = ref.kmer_extract(piece, K, 2, canonical)
            check(torch.equal(got, want), f"kmer_extract differs from its "
                  f"plain version on reads {lo}+ (canonical={canonical})")
            if canonical and lo < n_sort:
                words[lo:lo + block] = got[:n_sort - lo]
            del got, want
    torch.cuda.synchronize()
    log(f"  kmer_extract: {n_reads} reads x {n_pos} positions, forward and "
        f"canonical, in pieces of {block}: bit-equal to the plain version "
        f"({time.perf_counter() - t0:.1f} s with the checks)")

    keys = words.view(NUM_PES, -1)
    n = keys.shape[1]
    t0 = time.perf_counter()
    row_id = torch.arange(NUM_PES, device=DEV)[:, None] << SWEEP_DIGIT_BITS
    radix = 1 << SWEEP_DIGIT_BITS
    shifts = range(0, 2 * K, SWEEP_DIGIT_BITS)
    for shift in shifts:
        hist = ops.radix_hist(keys, shift, SWEEP_DIGIT_BITS, SWEEP_TILE)
        want = ref.radix_hist(keys, shift, SWEEP_DIGIT_BITS, SWEEP_TILE)
        check(torch.equal(hist, want), f"radix_hist differs at shift {shift}")
        digit = W.srl(keys, shift) & (radix - 1)
        whole = torch.bincount((row_id + digit).view(-1),
                               minlength=NUM_PES * radix).view(NUM_PES, radix)
        check(torch.equal(hist.sum(1, dtype=torch.int64), whole),
              f"radix_hist tiles do not sum to the digit's bincount at "
              f"shift {shift}")
        del hist, want, digit, whole
    torch.cuda.synchronize()
    log(f"  radix_hist: keys {tuple(keys.shape)}, {len(shifts)} digits of "
        f"{SWEEP_DIGIT_BITS} bits, tile {SWEEP_TILE}: bit-equal, "
        f"tiles sum to each digit's bincount "
        f"({time.perf_counter() - t0:.1f} s with the checks)")

    t0 = time.perf_counter()
    srt = sort.radix_sort(keys, 2 * K)
    torch.cuda.synchronize()
    t_sort = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = sort.accumulate(srt, sentinel_val=W.sentinel(64),
                          boundaries_impl="kernel")
    torch.cuda.synchronize()
    t_acc = time.perf_counter() - t0
    launches = ops.launch_counts()
    for other in ({"boundaries_impl": "inline"}, {"impl": "fused"}):
        want = sort.accumulate(srt, sentinel_val=W.sentinel(64), **other)
        for field in got._fields:
            check(torch.equal(getattr(got, field), getattr(want, field)),
                  f"accumulate {field} differs from {other}")
        del want
    log(f"  radix_sort of {NUM_PES} rows of {n}: {t_sort:.3f} s; accumulate "
        f"(boundaries_impl='kernel'): {t_acc:.3f} s; bit-equal to "
        f"boundaries_impl='inline' and to impl='fused'")
    nu = got.num_unique.tolist()
    distinct = 0
    for r in range(NUM_PES):
        ref_k, ref_c = torch.unique(keys[r], return_counts=True)
        check(torch.equal(got.unique[r, :nu[r]], ref_k)
              and torch.equal(got.counts[r, :nu[r]].to(torch.int64), ref_c),
              f"row {r}: accumulate differs from torch.unique")
        check(int(got.counts[r].sum()) == n, f"row {r}: counts do not sum "
              f"to the instance count")
        distinct += nu[r]
        del ref_k, ref_c
    log(f"  exact against torch.unique: {n_sort * n_pos} canonical k-mer "
        f"instances, {distinct} distinct within their rows "
        f"({NUM_PES} rows, {nu})")
    launches = {name: launches[name] for name in SWEEP_KERNELS}
    log(f"  launches on this path {launches}")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} did not launch on phase 10's path")
    del got
    rows = []
    if timed:
        rows = sweep_times(torch, ops, ref, reads, keys, srt)
    del reads, words, keys, srt
    torch.cuda.empty_cache()
    return launches, rows


def sweep_times(torch, ops, ref, reads, keys, srt):
    """Rows 8-10 at phase 10's shapes, CUDA events after a warm-up: the
    extraction over the whole read set in one launch (the plain version in
    pieces of 2**20 reads, the same work), the digit histogram and the
    run-start flags over the (8, n) k-mer rows."""
    from repro_torch import words as W

    n_reads, m = reads.shape
    n_pos = m - K + 1
    block = 1 << 20

    def plain_extract():
        for lo in range(0, n_reads, block):
            ref.kmer_extract(reads[lo:lo + block], K, 2, True)

    rows = [dict(
        name="kmer_extract", source="src/repro_torch/csrc/kmer_extract.cu",
        replaces="src/repro/kernels/kmer_extract.py:53",
        times=call_times(torch, lambda: ops.kmer_extract(reads, K,
                                                         canonical=True), 5),
        plain_ms=time_ms(torch, plain_extract, 2),
        nbytes=n_reads * m + n_reads * n_pos * 8, library=None,
        shape=f"codes ({n_reads}, {m}) uint8 -> ({n_reads}, {n_pos}) int64, "
              f"k={K}, canonical, one launch")]
    log("  kmer_extract library_ms: none, no PyTorch call packs a k-window "
        "into a word")

    p, n = keys.shape
    radix, n_tiles = 1 << SWEEP_DIGIT_BITS, n // SWEEP_TILE
    digit = W.srl(keys, SWEEP_TIMED_SHIFT) & (radix - 1)
    tile_key = (torch.arange(p * n_tiles, device=keys.device)
                .repeat_interleave(SWEEP_TILE).view(p, n) * radix + digit)
    del digit
    rows.append(dict(
        name="radix_hist", source="src/repro_torch/csrc/radix_hist.cu",
        replaces="src/repro/kernels/radix_hist.py:30",
        times=call_times(torch, lambda: ops.radix_hist(
            keys, SWEEP_TIMED_SHIFT, SWEEP_DIGIT_BITS, SWEEP_TILE)),
        plain_ms=time_ms(torch, lambda: ref.radix_hist(
            keys, SWEEP_TIMED_SHIFT, SWEEP_DIGIT_BITS, SWEEP_TILE), 5),
        nbytes=p * n * 8 + p * n_tiles * radix * 4,
        library=library_times(torch, lambda: torch.bincount(
            tile_key.view(-1), minlength=p * n_tiles * radix), 5),
        shape=f"keys ({p}, {n}) int64, shift {SWEEP_TIMED_SHIFT}, "
              f"digit_bits {SWEEP_DIGIT_BITS}, tile {SWEEP_TILE}"))
    del tile_key
    log("  radix_hist library_ms: torch.bincount of tile * radix + digit, "
        "the digit's extraction left out")

    sent = -1
    rows.append(dict(
        name="segment_boundaries",
        source="src/repro_torch/csrc/segment_count.cu",
        replaces="src/repro/kernels/segment_count.py:43",
        times=call_times(torch, lambda: ops.segment_boundaries(
            srt, sentinel_val=sent)),
        plain_ms=time_ms(torch, lambda: ref.segment_boundaries(srt, sent), 5),
        nbytes=p * n * (8 + 1), library=None,
        shape=f"sorted keys ({p}, {n}) int64 -> bool"))
    log("  segment_boundaries library_ms: none, no PyTorch call gives "
        "sentinel-aware run-start flags")
    torch.cuda.empty_cache()
    return rows


# --- phase 9: the LM training path -----------------------------------------

def lm_phase(torch, ops):
    """Train LM_ARCH at full width and depth for LM_STEPS steps through
    `launch.train.train`, then the two same-weights checks. Returns the
    flash launch counts of the path's runs and the phase's numbers."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipelineConfig, batch_for_step
    from repro_torch.launch import train as train_lib
    from repro_torch.models import model
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts_lib

    cfg = dataclasses.replace(get_config(LM_ARCH), attn_impl="flash_train")
    L, H, hd = cfg.num_layers, cfg.num_heads, cfg.resolved_head_dim
    log(f"[lm] {LM_ARCH} at full width and depth: {L} layers, d_model "
        f"{cfg.d_model}, {H} heads (kv {cfg.num_kv_heads}), head_dim {hd}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; {LM_STEPS} steps of "
        f"{LM_BATCH} x {LM_SEQ} tokens, attn_impl 'flash_train', "
        f"{cfg.compute_dtype} compute, f32 params and AdamW, remat "
        f"'{cfg.remat}'")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    torch.cuda.synchronize()
    out = train_lib.train(LM_ARCH, reduced=False, steps=LM_STEPS,
                          batch=LM_BATCH, seq=LM_SEQ, log_every=1,
                          device=DEV, attn_impl="flash_train")
    del out["params"], out["opt_state"]
    launches = ops.launch_counts()
    f32_launches = F32_LAUNCHES[9] = ops.f32_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses, gnorms = out["losses"], out["grad_norms"]
    check(all(math.isfinite(x) for x in losses + gnorms),
          "a loss or grad norm is not finite")
    check(losses[-1] < losses[0], f"the last loss {losses[-1]} is not below "
          f"the first {losses[0]}")
    want = {"flash_attention_fwd_lse": 2 * L * LM_STEPS,
            "flash_attention_bwd": L * LM_STEPS, "flash_attention": 0}
    for name, n in want.items():
        check(launches[name] == n, f"{name} launched {launches[name]} times "
              f"in {LM_STEPS} steps, expected {n}")
        check(f32_launches[name] == 0, f"{name}: {f32_launches[name]} of "
              f"its {n} launches ran an f32 kernel in a bf16 run")
    tokens = LM_BATCH * LM_SEQ
    steady = out["step_seconds"][1:]
    step_s = sum(steady) / len(steady)
    # Model FLOPs per step: 6 N T for the parameter products (the tied
    # embedding counted once, as the LM head), and the causal attention
    # products forward (4 hd per kept (row, col) pair) and backward (twice
    # that): 3 * 4 * hd * B * H * S (S + 1) / 2 per layer.
    flops = (6 * out["n_params"] * tokens
             + 6 * L * hd * LM_BATCH * H * LM_SEQ * (LM_SEQ + 1))
    numbers = {"losses": losses, "grad_norms": gnorms,
               "step_seconds": out["step_seconds"], "step_s": step_s,
               "tokens_per_s": tokens / step_s, "peak_bytes": peak,
               "n_params": out["n_params"], "model_flops_per_step": flops,
               "mfu": flops / step_s / BF16_FLOP_PER_S}
    log(f"  {out['n_params']} parameters; first step "
        f"{out['step_seconds'][0]:.3f} s; steps 2-{LM_STEPS}: {step_s:.3f} s "
        f"each, "
        f"{numbers['tokens_per_s']:.0f} tokens/s, model-FLOP share "
        f"{100 * numbers['mfu']:.2f} % of {BF16_FLOP_PER_S:.3g} FLOP/s "
        f"({flops:.4g} FLOP per step)")
    log(f"  max_memory_allocated {peak / 1e9:.2f} GB; flash launches "
        f"{ {k: launches[k] for k in want} }, f32 "
        f"{ {k: f32_launches[k] for k in want} }")
    out_launches = {k: launches[k] for k in want}

    # The same weights and batch through 'flash_train' and 'ref' at a length
    # where mha_ref's (S, S) scores fit.
    params = model.init_params(cfg, seed=1, device=DEV)
    tok = torch.from_numpy(batch_for_step(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, batch_size=LM_BATCH, seq_len=LM_CHECK_SEQ,
        seed=1), 0)).to(DEV)
    res = {}
    for impl in ("flash_train", "ref"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        leaves = [p.requires_grad_(True)
                  for _, p in model.named_leaves(params)]
        loss, m = ts_lib.loss_fn(params, {"tokens": tok}, c)
        grads = torch.autograd.grad(loss, leaves)
        res[impl] = (float(m["loss"]), float(opt_lib.global_norm(grads)))
        del loss, grads
    (lf, gf), (lr_, gr) = res["flash_train"], res["ref"]
    log(f"  seq {LM_CHECK_SEQ}, one step's loss and grad norm: flash_train "
        f"{lf:.6f} {gf:.6f}, ref {lr_:.6f} {gr:.6f}")
    # Both round P to bf16 before P.V, mha_ref the normalised
    # probabilities and the flash kernels the unnormalised p (and dS in the
    # backward); over 24 layers that moves the loss by well under 1e-3 and
    # the gradient norm by under 1e-2 (relative).
    check(abs(lf - lr_) <= 1e-3 * abs(lr_), "flash_train and ref losses "
          "differ by more than 1e-3 relative")
    check(abs(gf - gr) <= 1e-2 * abs(gr), "flash_train and ref grad norms "
          "differ by more than 1e-2 relative")
    numbers["ref_check"] = res

    # Kernel 11 (forward only) against kernel 12 in the model, no grad.
    tok = torch.from_numpy(batch_for_step(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, batch_size=1, seq_len=LM_SEQ, seed=2),
        0)).to(DEV)
    ops.reset_launches()
    with torch.no_grad():
        lg_flash = model.forward(params, {"tokens": tok}, dataclasses.replace(
            cfg, attn_impl="flash"))[0]
        out_launches["flash_attention"] = ops.launch_counts()[
            "flash_attention"]
        lg_train = model.forward(params, {"tokens": tok}, cfg)[0]
    check(out_launches["flash_attention"] == L,
          "the 'flash' forward did not launch kernel 11 in every layer")
    err = float((lg_flash - lg_train).abs().max())
    scale = float(lg_train.abs().max())
    log(f"  seq {LM_SEQ} no-grad forward: 'flash' against 'flash_train' "
        f"logits, max abs err {err:.3e} (largest logit {scale:.3f}); "
        f"{out_launches['flash_attention']} launches of row 11")
    # The same forward kernel in both, with and without its lse output.
    check(err <= 1e-6 * scale, "'flash' and 'flash_train' logits differ")
    numbers["flash_logits_err"] = err
    del params, lg_flash, lg_train
    torch.cuda.empty_cache()
    return out_launches, numbers


# --- phase 14: LM serving and the families ---------------------------------

# The gates (f32 compute, f32 cache): (arch, batch, text prompt, layers or
# None for the full depth). deepseek-moe-16b is cut to 4 layers: 28 layers
# of f32 master weights are about 66 GB. Its gate runs at capacity factor
# E / K, whose capacity N + 1 no expert can overflow, so the full forward
# and the cached path drop no pair (a drop depends on the batch's tokens).
SERVE_GATES = (("qwen1.5-0.5b", 2, 256, None),
               ("mamba2-370m", 2, 300, None),
               ("zamba2-1.2b", 1, 4160, None),
               ("deepseek-moe-16b", 2, 256, 4),
               ("llava-next-mistral-7b", 2, 64, None))
SERVE_DECODES = 8
SERVE_TOL = 1e-4        # of the largest logit; f32 prefill/decode vs forward
MOE_LAYERS = 4
# The timed runs (bf16 compute, bf16 cache) through launch.serve.serve.
TIMED_SERVE = (("qwen1.5-0.5b", None), ("mamba2-370m", None),
               ("zamba2-1.2b", None), ("deepseek-moe-16b", MOE_LAYERS))
TIMED_BATCH, TIMED_PROMPT, TIMED_GEN = 8, 512, 128
# One 'flash_train' step in bf16 for each new family, 2 periods deep.
FAMILY_TRAIN = ("deepseek-moe-16b", "mamba2-370m", "zamba2-1.2b",
                "llava-next-mistral-7b", "hubert-xlarge")
FAMILY_BATCH, FAMILY_SEQ = 2, 1024
# DAKC against GShard on one full-width deepseek MoE layer.
DAKC_SHARDS, DAKC_TOKENS = 8, (4, 512)
FLASH_ROWS = ("flash_attention", "flash_attention_fwd_lse",
              "flash_attention_bwd")


def _family_batch(torch, cfg, batch, seq, gen):
    """A batch of `seq` positions for cfg's inputs: tokens, llava's
    patches before its text, hubert's frames, labels and mask."""
    f = cfg.frontend
    if f.kind == "audio":
        return {"frames": torch.randn((batch, seq, f.frontend_dim),
                                      generator=gen, device=DEV),
                "labels": torch.randint(0, cfg.vocab_size, (batch, seq),
                                        generator=gen, device=DEV),
                "mask": (torch.rand((batch, seq), generator=gen, device=DEV)
                         < 0.8).float()}
    n_patch = f.num_patches if f.kind == "vision" else 0
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq - n_patch),
                                   generator=gen, device=DEV)}
    if n_patch:
        out["patches"] = torch.randn((batch, n_patch, f.frontend_dim),
                                     generator=gen, device=DEV)
    return out


def serve_gate(torch, model, params, cfg, batch, prompt, seed):
    """Prefill a prompt, then SERVE_DECODES greedy decode steps (f32
    compute and cache); the prefill's and each step's last-position logits
    against a full forward over the sequence so far. Returns the largest
    error relative to the largest logit."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    t = prompt + (cfg.frontend.num_patches
                  if cfg.frontend.kind == "vision" else 0)
    inp = _family_batch(torch, cfg, batch, t, gen)
    caches = model.init_caches(cfg, batch, t + SERVE_DECODES, torch.float32,
                               device=DEV)
    worst = 0.0

    def held(got, what):
        nonlocal worst
        x, _ = model.hidden(params, inp, cfg)
        want = model.head(params, x[:, -1:], cfg)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(err <= SERVE_TOL * scale, f"{cfg.name} {what}: logits differ "
              f"from the full forward's by {err:.3e} (largest {scale:.3f})")
        check(torch.equal(got[:, -1].argmax(-1), want[:, -1].argmax(-1)),
              f"{cfg.name} {what}: the argmax differs from the full "
              f"forward's")
        worst = max(worst, err / scale)

    with torch.no_grad():
        lg, caches = model.prefill(params, inp, caches, cfg)
        held(lg, "prefill")
        for i in range(SERVE_DECODES):
            nxt = lg[:, -1].argmax(-1, keepdim=True)
            inp["tokens"] = torch.cat([inp["tokens"], nxt], dim=1)
            lg, caches = model.decode_step(params, nxt, caches, t + i, cfg)
            held(lg, f"decode step {i + 1}")
    return worst


def dakc_gate(torch, moe, get_config):
    """One full-width deepseek MoE layer (f32): the stacked DAKC engine
    over DAKC_SHARDS EP shards against the GShard path at capacity factor
    8; then the dropped shares of both at the config's 1.25."""
    import dataclasses

    base = dataclasses.replace(get_config("deepseek-moe-16b"),
                               compute_dtype="float32")
    gen = torch.Generator(device=DEV).manual_seed(21)
    p = moe.init_moe(gen, base, DEV)
    x = torch.randn(DAKC_TOKENS + (base.d_model,), generator=gen,
                    device=DEV)
    out = {}
    for factor in (8.0, base.moe.capacity_factor):
        cfg = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, capacity_factor=factor))
        with torch.no_grad():
            yd, ad = moe.moe_block(p, x, cfg=cfg, ep_shards=DAKC_SHARDS)
            yg, ag = moe.moe_block(p, x, cfg=cfg)
        out[factor] = (float((yd - yg).abs().max()), float(yg.abs().max()),
                       float(ad.dropped_frac), float(ag.dropped_frac))
    err, scale, dd, dg = out[8.0]
    check(dd == dg == 0.0, f"drops at capacity factor 8: dakc {dd}, "
          f"gshard {dg}")
    check(err <= 1e-5 * scale, f"DAKC ({DAKC_SHARDS} EP shards) and GShard "
          f"differ by {err:.3e} (largest {scale:.3f})")
    _, _, dd, dg = out[base.moe.capacity_factor]
    log(f"  [dakc] {DAKC_SHARDS} EP shards vs GShard on {DAKC_TOKENS[0]} x "
        f"{DAKC_TOKENS[1]} tokens, one full-width layer: max abs err "
        f"{err:.3e} (largest {scale:.3f}) at capacity factor 8, no drops; "
        f"at {base.moe.capacity_factor} dropped share dakc {dd:.6f}, "
        f"gshard {dg:.6f}")
    del p, x, yd, yg
    return {"err": err, "scale": scale, "dropped_dakc": dd,
            "dropped_gshard": dg}


def serve_phase(torch, ops):
    """Phase 14: the serving gates, the DAKC gate, one train step of each
    new family and the timed serving runs. Returns the launches of rows
    11-13 on the phase's path and the phase's numbers."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import model, moe
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts_lib

    numbers = {"gates": {}, "train": {}, "timed": {}}
    ops.reset_launches()
    for i, (arch, batch, prompt, layers_) in enumerate(SERVE_GATES):
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), compute_dtype="float32",
                                  attn_impl="flash")
        if layers_ is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers_)
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
        params = model.init_params(cfg, seed=30 + i, device=DEV)
        worst = serve_gate(torch, model, params, cfg, batch, prompt, 40 + i)
        del params
        torch.cuda.empty_cache()
        numbers["gates"][arch] = worst
        depth = (f"{cfg.num_layers} layers" if layers_ is None else
                 f"CUT: {layers_} of {get_config(arch).num_layers} layers")
        log(f"  [gate] {arch} ({depth}): batch {batch},"
            f" prompt {prompt}"
            + (f" after {cfg.frontend.num_patches} patches"
               if cfg.frontend.kind == "vision" else "")
            + f", {SERVE_DECODES} decode steps: largest error "
            f"{worst:.3e} of the largest logit, argmax equal "
            f"({time.perf_counter() - t0:.1f} s)")
    numbers["dakc"] = dakc_gate(torch, moe, get_config)
    torch.cuda.empty_cache()

    for i, arch in enumerate(FAMILY_TRAIN):
        base = get_config(arch)
        cfg = dataclasses.replace(base, num_layers=2 * len(base.period),
                                  attn_impl="flash_train")
        params = model.init_params(cfg, seed=50 + i, device=DEV)
        step = ts_lib.make_train_step(cfg, ts_lib.TrainConfig(
            optimizer=opt_lib.OptimizerConfig(warmup_steps=1,
                                              total_steps=2)))
        gen = torch.Generator(device=DEV).manual_seed(60 + i)
        batch = _family_batch(torch, cfg, FAMILY_BATCH, FAMILY_SEQ, gen)
        # The same weights and batch through 'ref' (mha_ref) first, as the
        # step updates the weights in place: rows 12 and 13 at this family's
        # head dim, grouping and mask against the plain attention.
        leaves = [p.requires_grad_(True)
                  for _, p in model.named_leaves(params)]
        rloss, rm = ts_lib.loss_fn(params, batch, dataclasses.replace(
            cfg, attn_impl="ref"))
        rgrads = torch.autograd.grad(rloss, leaves, allow_unused=True)
        ref_loss = float(rm["loss"])
        ref_gnorm = float(opt_lib.global_norm(
            [g for g in rgrads if g is not None]))
        del rloss, rm, rgrads, leaves
        t0 = time.perf_counter()
        _, _, m = step(params, opt_lib.init(params), batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        aux = float(m["aux_loss"])
        wall = time.perf_counter() - t0
        check(math.isfinite(loss) and math.isfinite(gnorm),
              f"{arch}: loss {loss} or grad norm {gnorm} is not finite")
        # Phase 9's bounds: both round P to bf16 before P.V, at different
        # places (the comment there).
        check(abs(loss - ref_loss) <= 1e-3 * abs(ref_loss),
              f"{arch}: flash_train loss {loss} and ref loss {ref_loss} "
              f"differ by more than 1e-3 relative")
        check(abs(gnorm - ref_gnorm) <= 1e-2 * abs(ref_gnorm),
              f"{arch}: flash_train grad norm {gnorm} and ref grad norm "
              f"{ref_gnorm} differ by more than 1e-2 relative")
        numbers["train"][arch] = {"loss": loss, "grad_norm": gnorm,
                                  "aux": aux, "s": wall,
                                  "ref_loss": ref_loss,
                                  "ref_grad_norm": ref_gnorm}
        log(f"  [train] {arch}: CUT: {cfg.num_layers} of {base.num_layers} "
            f"layers (2 periods), "
            f"batch {FAMILY_BATCH} x {FAMILY_SEQ}, bf16 'flash_train': loss "
            f"{loss:.6f}, aux {aux:.5f}, grad norm {gnorm:.6f} "
            f"({wall:.2f} s); 'ref' loss {ref_loss:.6f}, grad norm "
            f"{ref_gnorm:.6f}")
        del params, step, batch, m
        torch.cuda.empty_cache()

    for arch, layers_ in TIMED_SERVE:
        over = {} if layers_ is None else {"num_layers": layers_}
        r = serve_lib.serve(arch, reduced=False, batch=TIMED_BATCH,
                            prompt_len=TIMED_PROMPT, gen=TIMED_GEN,
                            device=DEV, **over)
        steady = r["decode_step_s"][1:]
        step_s = sum(steady) / len(steady)
        row = {"prefill_s": r["prefill_s"], "decode_ms": 1e3 * step_s,
               "decode_tokens_per_s": TIMED_BATCH / step_s,
               "first_decode_ms": 1e3 * r["decode_step_s"][0],
               "tokens_per_s": r["tokens_per_s"],
               "peak_bytes": r["peak_bytes"]}
        numbers["timed"][arch] = row
        cut = "" if layers_ is None else f" (CUT: {layers_} layers)"
        log(f"  [serve] {arch}{cut}: batch {TIMED_BATCH}, prompt "
            f"{TIMED_PROMPT}, {TIMED_GEN} new tokens, bf16 compute and "
            f"cache: prefill {r['prefill_s']:.4f} s; decode steps 2-"
            f"{TIMED_GEN - 1} {row['decode_ms']:.3f} ms a step, "
            f"{row['decode_tokens_per_s']:.1f} tokens/s (first step "
            f"{row['first_decode_ms']:.3f} ms); {r['tokens_per_s']:.1f} "
            f"tokens/s with the prefill; peak {r['peak_bytes'] / 1e9:.2f} GB")
        torch.cuda.empty_cache()
    launches = ops.launch_counts()
    F32_LAUNCHES[14] = ops.f32_launch_counts()
    for name in FLASH_ROWS:
        check(launches[name] > 0, f"kernel {name} did not launch on phase "
              f"14's path")
    log(f"  launches on phase 14's path {launches}")
    return launches, numbers


# --- phase 15: the counter's remaining surface -----------------------------

# (a) a token corpus at qwen1.5-0.5b's vocabulary and train_4k length: the
# first NGRAM_STEPS batches of the port's token pipeline, NGRAM_BATCH rows
# each, counted by NUM_PES PEs.
NGRAM_ARCH = "qwen1.5-0.5b"
NGRAM_STEPS, NGRAM_BATCH, NGRAM_SEQ = 16, 2048, 4096
NGRAM_CHUNK_ROWS, NGRAM_TOP_K = 64, 16
NGRAM_NS = (3, 1)           # 54-bit words (the widest n that fits), 18-bit
# The store is sized by the shape-only bound (n-gram instances, at most
# vocab**n, over the PEs with the store slack: 25,153,536 slots a PE at
# n=3, 2.4 GB in all). The default 'sample' sizing inverts a uniform-pool
# model on the first chunk, which a Zipf corpus defeats: at n=3 it plans
# 131,072 slots a PE for about 6.6M distinct trigrams a PE, and each
# rehash round that follows probes a full table for every dropped key
# (ROADMAP section 2, items H and L).
NGRAM_STORE = dict(store_sizing="bound")
# (b) 128-bit k-mers over the first K128_READS reads of phase 4's set.
K128, K128_READS = 63, 1 << 22
SIGN64 = -(1 << 63)
# (d) PERF.md §5: the counting path's device busy share under the profiler
# (count_kmers at 2**20 reads, scripts/kernel_device_times.py --profile).
BUSY_SHARE_PERF = "7.7-12.2 %"
PHASE15_DIR = os.path.join(HERE, "build", "chip_smoke_phase15")
# Rows 2-7 by name (row 1: bucket_hist plus bucket_prefix).
PHASE15_KERNELS = ("bucket_positions", "segment_accumulate", "hash_insert",
                   "hash_lookup", "sliding_min", "sliding_min_pair")


def zipf_corpus(torch, vocab):
    """The pipeline's first NGRAM_STEPS batches, made on the host in
    parallel threads (numpy releases the interpreter lock in them), as one
    (rows, seq) int32 tensor on the card."""
    import concurrent.futures

    from repro_torch.data.tokens import TokenPipelineConfig, batch_for_step

    cfg = TokenPipelineConfig(vocab_size=vocab, batch_size=NGRAM_BATCH,
                              seq_len=NGRAM_SEQ, zipf_a=1.2, seed=0)
    toks = torch.empty((NGRAM_STEPS * NGRAM_BATCH, NGRAM_SEQ),
                       dtype=torch.int32, device=DEV)
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        for step, batch in enumerate(pool.map(
                lambda s: batch_for_step(cfg, s), range(NGRAM_STEPS))):
            toks[step * NGRAM_BATCH:(step + 1) * NGRAM_BATCH] = \
                torch.from_numpy(batch).to(DEV)
    return toks


def ngram_words(torch, toks, n, bits):
    """Every n-gram of the token rows packed by the smoke itself."""
    t = toks.to(torch.int64)
    seq = t.shape[1]
    w = torch.zeros((t.shape[0], seq - n + 1), dtype=torch.int64,
                    device=t.device)
    for j in range(n):
        w = (w << bits) | t[:, j:seq - n + 1 + j]
    return w.reshape(-1)


def ngram_check(torch, ngram, corpus_stats, toks, vocab, n, numbers):
    """(a) at one n: corpus_ngram_stats timed, count_ngrams for the
    histogram and its stats, both exact against torch.unique (n > 1) or
    torch.bincount (n = 1) of the smoke's own n-gram words."""
    bits = ngram.bits_for_vocab(vocab)
    rows, seq = toks.shape
    tag = f"n={n}"
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cs = corpus_stats.corpus_ngram_stats(
        toks, vocab, n, num_pes=NUM_PES, top_k=NGRAM_TOP_K,
        chunk_rows=NGRAM_CHUNK_ROWS, device=DEV, **NGRAM_STORE)
    torch.cuda.synchronize()
    wall_cs = time.perf_counter() - t0
    peak_cs = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, st = ngram.count_ngrams(toks, vocab, n, num_pes=NUM_PES,
                                 chunk_rows=NGRAM_CHUNK_ROWS, device=DEV,
                                 **NGRAM_STORE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    total = rows * (seq - n + 1)
    slots = res.unique.numel() // NUM_PES
    keys, counts, _ = per_pe_sets(torch, res, NUM_PES)
    order = torch.argsort(keys)
    keys, counts = keys[order], counts[order].to(torch.int64)
    del res, order
    if n == 1:
        ref_c = torch.bincount(toks.reshape(-1).to(torch.int64),
                               minlength=vocab)
        ref_k = torch.nonzero(ref_c).reshape(-1)
        ref_c = ref_c[ref_k]
    else:
        ref_k, ref_c = torch.unique(ngram_words(torch, toks, n, bits),
                                    return_counts=True)
    check(torch.equal(keys, ref_k) and torch.equal(counts, ref_c),
          f"[ngram {tag}] the merged histogram differs from the reference")
    check(cs.total == st.raw_kmers == total,
          f"[ngram {tag}] total {cs.total} != {total}")
    check(cs.distinct == ref_k.numel(),
          f"[ngram {tag}] distinct {cs.distinct} != {ref_k.numel()}")
    top = torch.topk(ref_c, NGRAM_TOP_K).values.tolist()
    check(cs.top_counts.tolist() == top,
          f"[ngram {tag}] top counts {cs.top_counts.tolist()} != {top}")
    shifts = [(n - 1 - j) * bits for j in range(n)]
    for gram, c in zip(cs.top_ngrams.tolist(), cs.top_counts.tolist()):
        word = sum(int(g) << s for g, s in zip(gram, shifts))
        i = int(torch.searchsorted(ref_k, torch.tensor([word], device=DEV)))
        check(int(ref_k[i]) == word and int(ref_c[i]) == c,
              f"[ngram {tag}] top n-gram {gram} does not hold count {c}")
    check(cs.compression == st.raw_kmers / max(float(st.sent_words), 1.0),
          f"[ngram {tag}] compression differs between the two runs")
    retries = (st.retry_route_slack, st.retry_store_rehash)
    numbers[tag] = dict(
        corpus_ngram_stats_s=wall_cs, count_ngrams_s=wall,
        ngrams_per_s=total / wall, total=total, distinct=cs.distinct,
        sent_words=st.sent_words, compression=cs.compression,
        store_slots_per_pe=slots,
        retry_route_slack=retries[0], retry_store_rehash=retries[1],
        peak_bytes_corpus_ngram_stats=peak_cs, peak_bytes_count_ngrams=peak,
        top_counts=top[:4])
    log(f"  [ngram {tag}] corpus_ngram_stats {wall_cs:.3f} s; count_ngrams "
        f"{wall:.3f} s, {total / wall:.4e} n-grams/s; {total} n-grams, "
        f"{cs.distinct} distinct in {slots} store slots a PE; sent_words "
        f"{st.sent_words}, compression "
        f"{cs.compression:.4f}; retries route-slack {retries[0]} "
        f"store-rehash {retries[1]}; peak {peak_cs / 1e9:.2f} / "
        f"{peak / 1e9:.2f} GB; exact against the reference, top "
        f"{NGRAM_TOP_K} counts {top[:4]}...")
    del keys, counts, ref_k, ref_c


def pairs128_reference(torch, reads, k):
    """Every k-mer of the reads as (hi, lo) lanes packed by the smoke
    itself: unfolded windows, a wrapping multiply-add per lane (bases
    0..k-33 into hi, the last 32 into lo)."""
    n_pos = reads.shape[1] - k + 1
    n_hi = k - 32
    hi = torch.empty((reads.shape[0], n_pos), dtype=torch.int64, device=DEV)
    lo = torch.empty_like(hi)
    block = 1 << 19
    for b0 in range(0, reads.shape[0], block):
        win = reads[b0:b0 + block].unfold(1, k, 1)
        h = torch.zeros(win.shape[:2], dtype=torch.int64, device=DEV)
        for j in range(n_hi):
            h = h * 4 + win[..., j].to(torch.int64)
        lw = torch.zeros_like(h)
        for j in range(n_hi, k):
            lw = lw * 4 + win[..., j].to(torch.int64)
        hi[b0:b0 + block], lo[b0:b0 + block] = h, lw
        del win, h, lw
    return hi.reshape(-1), lo.reshape(-1)


def remaining_phase(torch, ops, genome, n_reads, phase4_wall, card):
    """Phase 15: the counter's remaining surface on the card. (a) corpus
    n-gram statistics of a Zipf token corpus at qwen1.5-0.5b's vocabulary;
    (b) 128-bit k-mers at k=63 over phase 4's reads; (c) the kc_dryrun
    drills; (d) the analytical model beside phase 4's wall time. Returns
    the launches of the phase's path and its numbers."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.core import analytical_model as am
    from repro_torch.core import encoding128 as e128
    from repro_torch.core import ngram
    from repro_torch.data import corpus_stats
    from repro_torch.launch import kc_dryrun

    numbers = {"card": card}
    ops.reset_launches()

    # (a) corpus n-gram statistics
    vocab = get_config(NGRAM_ARCH).vocab_size
    t0 = time.perf_counter()
    toks = zipf_corpus(torch, vocab)
    torch.cuda.synchronize()
    log(f"  [ngram] {NGRAM_ARCH}'s vocabulary {vocab} "
        f"({ngram.bits_for_vocab(vocab)} bits a token): Zipf 1.2 tokens "
        f"{tuple(toks.shape)} ({toks.numel()} tokens) made in "
        f"{time.perf_counter() - t0:.2f} s; {NUM_PES} PEs, chunk_rows "
        f"{NGRAM_CHUNK_ROWS}")
    for n in NGRAM_NS:
        ngram_check(torch, ngram, corpus_stats, toks, vocab, n, numbers)
        torch.cuda.empty_cache()
    del toks
    torch.cuda.empty_cache()

    # (b) 128-bit k-mers
    spec = genome.ReadSetSpec(genome_bases=1 << 26, n_reads=n_reads,
                              read_len=150, seed=0)
    n128 = min(K128_READS, n_reads)
    if n128 != K128_READS:
        log(f"  CUT: the 128-bit count reads {n128} instead of {K128_READS}")
    reads = genome.sample_reads_torch(spec, DEV)[:n128].clone()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc = e128.count_kmers_serial128(reads, K128)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    nu = int(acc.num_unique)
    got = (acc.hi[:nu].clone(), acc.lo[:nu].clone(), acc.counts[:nu].clone())
    instances = acc.hi.numel()
    del acc
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    hi, lo = pairs128_reference(torch, reads, K128)
    rows = torch.stack([hi ^ SIGN64, lo ^ SIGN64], 1)
    del hi, lo
    # torch.unique orders rows signed; flipping each lane's top bit maps
    # that order onto sort128's unsigned one
    ref, ref_c = torch.unique(rows, dim=0, return_counts=True)
    del rows
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    check(ref.shape[0] == nu, f"[k128] num_unique {nu} != {ref.shape[0]}")
    check(torch.equal(got[0], ref[:, 0] ^ SIGN64)
          and torch.equal(got[1], ref[:, 1] ^ SIGN64)
          and torch.equal(got[2].to(torch.int64), ref_c),
          "[k128] a (hi, lo, count) differs from torch.unique's")
    check(int(ref_c.sum()) == instances, "[k128] sum(counts) != instances")
    numbers["k128"] = dict(k=K128, reads=n128, instances=instances,
                           distinct=nu, wall_s=wall, peak_bytes=peak,
                           reference_s=t_ref)
    log(f"  [k128] count_kmers_serial128 k={K128}: {n128} reads, "
        f"{instances} (hi, lo) instances, {nu} distinct, {wall:.3f} s "
        f"({instances / wall:.4e} k-mers/s), peak {peak / 1e9:.2f} GB; "
        f"exact against torch.unique(dim=0) ({t_ref:.1f} s)")
    del got, ref, ref_c, reads
    torch.cuda.empty_cache()

    # (c) the drills
    shutil.rmtree(PHASE15_DIR, ignore_errors=True)
    os.makedirs(PHASE15_DIR)
    drills = {}
    try:
        drills["inject"] = kc_dryrun.run_inject(device=DEV)
        drills["spill"] = kc_dryrun.run_spill(
            os.path.join(PHASE15_DIR, "spill"), device=DEV)
        for skew in ("polya", "powerlaw", "none"):
            drills["skew_" + skew] = kc_dryrun.run_skew(
                skew, "both", "prefix", device=DEV)
        drills["query"] = kc_dryrun.run_query(device=DEV)
    except SystemExit as e:
        check(False, f"[drills] {e}")
    shutil.rmtree(PHASE15_DIR, ignore_errors=True)
    log(json.dumps({"phase15_drills": {
        name: {key: (rec._asdict() if hasattr(rec, "_asdict") else rec)
               for key, rec in recs.items()}
        for name, recs in drills.items()}}, default=str))

    # (d) the paper's model on the card beside the measurement
    if phase4_wall is not None:
        w = am.Workload(n_reads=n_reads, read_len=150, k=K, num_nodes=1)
        for overlap in ("sum", "max"):
            pred = am.predict(w, am.H100_SXM, overlap)
            numbers[f"model_{overlap}"] = pred
            log(f"  [model] predict({w}, H100_SXM, {overlap!r}): total "
                f"{pred['total']:.6g} s (phase 1 {pred['phase1_total']:.6g}, "
                f"phase 2 {pred['phase2_total']:.6g}); phase 4 measured "
                f"{phase4_wall:.3f} s, {phase4_wall / pred['total']:.1f}x the "
                f"model; the path's device busy share {BUSY_SHARE_PERF} "
                f"(PERF.md §5, not measured here)")
        numbers["phase4_wall_s"] = phase4_wall

    launches = ops.launch_counts()
    for name in PHASE15_KERNELS:
        check(launches[name] > 0, f"kernel {name} did not launch on phase "
              f"15's path")
    check(launches["bucket_hist"] + launches["bucket_prefix"] > 0,
          "row 1 did not launch on phase 15's path")
    log(f"  launches on phase 15's path {launches}")
    log(json.dumps({"phase15": numbers}, default=str))
    return launches, numbers


# --- phase 16: the LM trainer's infrastructure -----------------------------

# (a) checkpoint and resume: run A saves at CKPT_EVERY and at CKPT_STEPS;
# run B resumes from A's step-CKPT_EVERY checkpoint alone.
CKPT_STEPS, CKPT_EVERY = 8, 4
PHASE16_DIR = os.path.join(HERE, "build", "chip_smoke_phase16")
# (b) the watchdog around WATCH_STEPS real steps, steps WATCH_SLOW_FROM on
# slowed by a host sleep of twice the median step.
WATCH_STEPS, WATCH_SLOW_FROM = 12, 9
# (c) the pipeline: the 24 layers as PIPE_STAGES stages, PIPE_MICRO
# microbatches of 1 x PIPE_SEQ positions, f32.
PIPE_STAGES, PIPE_MICRO, PIPE_SEQ = 4, 8, 1024
# (d) compression: COMP_SHARDS gradient trees as shards, COMP_ROUNDS
# rounds of error feedback at COMP_FRAC.
COMP_SHARDS, COMP_ROUNDS, COMP_FRAC = 4, 3, 0.01
U32 = 2.0 ** -24        # f32 unit roundoff


def _stack_trees(torch, trees):
    if isinstance(trees[0], dict):
        return {k: _stack_trees(torch, [t[k] for t in trees])
                for k in trees[0]}
    return torch.stack(trees)


def _max_leaf_diff(torch, model, a, b):
    """(largest |a - b| over the leaves, whether every leaf is bit-equal)."""
    worst, same = 0.0, True
    for (_, x), (_, y) in zip(model.named_leaves(a), model.named_leaves(b)):
        x, y = x.detach(), y.detach()
        worst = max(worst, float((x - y).abs().max()))
        same = same and bool(torch.equal(x, y))
    return worst, same


def trainer_phase(torch, ops):
    """Phase 16: the LM trainer's checkpoints and resume, its straggler
    watchdog, the GPipe schedule and gradient compression at qwen1.5-0.5b's
    full width and depth. Returns the launches of the phase's path and its
    numbers."""
    import dataclasses
    import shutil
    import statistics

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipelineConfig, batch_for_step
    from repro_torch.launch import train as train_lib
    from repro_torch.models import convert, model
    from repro_torch.train import checkpoint, compression, elastic, pipeline
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts_lib

    t_phase = time.perf_counter()
    ops.reset_launches()
    cfg = dataclasses.replace(get_config(LM_ARCH), attn_impl="flash_train")
    L = cfg.num_layers
    numbers = {}
    sync = torch.cuda.synchronize

    # (a) checkpoint and resume
    params = model.init_params(cfg, seed=0, device=DEV)
    n_params = sum(p.numel() for _, p in model.named_leaves(params))
    del params
    est = 3 * 4 * n_params          # params, mu and nu in f32
    shutil.rmtree(PHASE16_DIR, ignore_errors=True)
    dir_a = os.path.join(PHASE16_DIR, "a")
    dir_b = os.path.join(PHASE16_DIR, "b")
    os.makedirs(dir_a)
    os.makedirs(dir_b)
    free = shutil.disk_usage(PHASE16_DIR).free
    log(f"  [ckpt] a checkpoint is about {est / 1e9:.2f} GB ({n_params} f32 "
        f"parameters x 3 trees); the phase keeps 4; {free / 1e9:.1f} GB "
        f"free under {PHASE16_DIR}")
    check(free >= 4.2 * est, f"phase 16 needs {int(4.2 * est)} bytes free "
          f"under {PHASE16_DIR} for four checkpoints, has {free}")
    kw = dict(reduced=False, steps=CKPT_STEPS, batch=LM_BATCH, seq=LM_SEQ,
              log_every=CKPT_EVERY, device=DEV, attn_impl="flash_train")
    runs = {}
    for name, d, extra in (("A", dir_a, dict(ckpt_every=CKPT_EVERY)),
                           ("B", dir_b, {})):
        if name == "B":
            t0 = time.perf_counter()
            shutil.copytree(os.path.join(dir_a, f"step_{CKPT_EVERY:08d}"),
                            os.path.join(dir_b, f"step_{CKPT_EVERY:08d}"))
            numbers["copy_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        runs[name] = train_lib.train(LM_ARCH, ckpt_dir=d, **kw, **extra)
        runs[name]["peak_bytes"] = torch.cuda.max_memory_allocated()
        if name == "A":
            numbers["ckpt_bytes"] = dir_bytes(
                os.path.join(dir_a, f"step_{CKPT_EVERY:08d}"))
            # The resume's trees: the step-4 files restored onto the card
            # as `train` restores them, and back to host numpy.
            tmpl = convert.jax_template(runs["A"]["params"], cfg)
            t0 = time.perf_counter()
            restored, extra4 = checkpoint.restore(
                dir_a, CKPT_EVERY, {"params": tmpl, "opt": opt_lib.OptState(
                    step=0, mu=tmpl, nu=tmpl)})
            p4 = convert.params_from_jax(restored["params"], cfg, DEV)
            o4 = convert.opt_state_from_jax(restored["opt"], cfg, DEV)
            sync()
            numbers["restore_s"] = time.perf_counter() - t0
            back = {"params": convert.params_to_numpy(p4, cfg),
                    "opt": opt_lib.OptState(
                        **convert.opt_state_to_numpy(o4, cfg))}
            flat_f = list(model.named_leaves(restored))
            flat_b = list(model.named_leaves(back))
            check([p for p, _ in flat_f] == [p for p, _ in flat_b],
                  "the restored trees' leaves differ from the files'")
            for (path, f), (_, b) in zip(flat_f, flat_b):
                f, b = np.asarray(f), np.asarray(b)
                check(f.dtype == b.dtype and f.shape == b.shape
                      and f.tobytes() == b.tobytes(),
                      f"restored leaf {path} is not the file's, bit for bit")
            check(extra4["cursor"] == CKPT_EVERY and o4.step == CKPT_EVERY
                  and restored["opt"].step.dtype == np.int32,
                  "the step-4 checkpoint's cursor or AdamW step is wrong")
            log(f"  [ckpt] the step-{CKPT_EVERY} trees restored onto the card "
                f"equal the files bit for bit ({len(flat_f)} leaves, "
                f"{numbers['ckpt_bytes']} bytes): restore "
                f"{numbers['restore_s']:.3f} s")
            del restored, p4, o4, back, flat_f, flat_b
    a, b = runs["A"], runs["B"]
    check(a["start_step"] == 0 and len(a["losses"]) == CKPT_STEPS,
          "run A did not take its steps from 0")
    check(b["start_step"] == CKPT_EVERY
          and len(b["losses"]) == CKPT_STEPS - CKPT_EVERY,
          f"run B resumed at {b['start_step']} and took {len(b['losses'])} "
          f"steps")
    la, lb = a["losses"][CKPT_EVERY:], b["losses"]
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(lb, la))
    p_err, p_same = _max_leaf_diff(torch, model, a["params"], b["params"])
    # Each AdamW step moves a weight by at most about 2.5 lr (the clipped,
    # normalised update; tests/multidevice_checks.py's bound), so runs
    # that part at step 4 differ by at most 4 x 2.5 x 3e-4 after step 8.
    p_tol = (CKPT_STEPS - CKPT_EVERY) * 2.5 * 3e-4
    same = "equal A's bit for bit" if lb == la else "differ from A's"
    log(f"  [ckpt] B's losses at steps {CKPT_EVERY}-{CKPT_STEPS - 1} {same}"
        f" (largest relative difference {loss_rel:.3e}); step-{CKPT_STEPS} "
        f"parameters {'bit-equal' if p_same else 'differ'}, largest "
        f"|A - B| {p_err:.3e} (bound {p_tol:.1e})")
    check(loss_rel <= 1e-3, f"B's losses differ from A's by {loss_rel} "
          f"relative")
    check(p_err <= p_tol, f"B's step-{CKPT_STEPS} parameters differ from "
          f"A's by {p_err}")
    for name, r in runs.items():
        saves = {s for s, _ in r["save_seconds"]}
        plain = [t for i, t in enumerate(r["step_seconds"][1:], 1)
                 if r["start_step"] + i + 1 not in saves]
        with_save = [t for i, t in enumerate(r["step_seconds"])
                     if r["start_step"] + i + 1 in saves]
        numbers[name] = {
            "losses": r["losses"], "step_seconds": r["step_seconds"],
            "save_block_s": r["save_seconds"], "write_s": r["write_seconds"],
            "final_wait_s": r["final_wait_seconds"],
            "restore_s": r["restore_seconds"], "peak_bytes": r["peak_bytes"],
            "straggler_events": r["straggler_events"],
            "step_s_plain": sum(plain) / len(plain),
            "step_s_with_save": sum(with_save) / len(with_save)}
        n = numbers[name]
        log(f"  [ckpt] run {name}: steps {r['start_step']}-{CKPT_STEPS - 1}; "
            f"saves block the loop {r['save_seconds']} s, write "
            f"{r['write_seconds']} s on their thread, the closing wait "
            f"{r['final_wait_seconds']:.3f} s; restore "
            f"{r['restore_seconds']} s; a step {n['step_s_plain']:.3f} s "
            f"alone, {n['step_s_with_save']:.3f} s with a save; peak "
            f"{r['peak_bytes'] / 1e9:.2f} GB; straggler_events "
            f"{r['straggler_events']}")
    numbers.update(loss_rel=loss_rel, params_err=p_err, params_same=p_same,
                   losses_same=lb == la)
    del runs, a, b
    shutil.rmtree(PHASE16_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    launches = ops.launch_counts()
    want = 3 * CKPT_STEPS // 2     # A's 8 steps and B's 4
    check(launches["flash_attention_fwd_lse"] == 2 * L * want
          and launches["flash_attention_bwd"] == L * want,
          f"rows 12 and 13 launched {launches['flash_attention_fwd_lse']} "
          f"and {launches['flash_attention_bwd']} times in {want} steps")

    # (b) the watchdog around real steps
    params = model.init_params(cfg, seed=3, device=DEV)
    opt = opt_lib.init(params)
    step_fn = ts_lib.make_train_step(cfg, ts_lib.TrainConfig(
        optimizer=opt_lib.OptimizerConfig(warmup_steps=2,
                                          total_steps=WATCH_STEPS + 1)))
    pc = TokenPipelineConfig(vocab_size=cfg.vocab_size, batch_size=LM_BATCH,
                             seq_len=LM_SEQ, seed=3)
    toks = [torch.from_numpy(batch_for_step(pc, i)).to(DEV)
            for i in range(WATCH_STEPS + 1)]

    def one_step(tok):
        nonlocal params, opt
        params, opt, m = step_fn(params, opt, {"tokens": tok})
        float(m["loss"])
        sync()

    one_step(toks[0])                  # warm-up, not watched
    wd = elastic.StragglerWatchdog()
    dts, trips, sleeps = [], [], []
    for i in range(WATCH_STEPS):
        t0 = time.perf_counter()
        wd.step_start()
        one_step(toks[i + 1])
        if i >= WATCH_SLOW_FROM:
            sleeps.append(2 * statistics.median(dts[:WATCH_SLOW_FROM]))
            time.sleep(sleeps[-1])
        if wd.step_end(i):
            trips.append(i)
        dts.append(time.perf_counter() - t0)
    log(f"  [watchdog] {WATCH_STEPS} steps, the first {WATCH_SLOW_FROM} of "
        f"{min(dts[:WATCH_SLOW_FROM]):.3f}-{max(dts[:WATCH_SLOW_FROM]):.3f} "
        f"s, steps {WATCH_SLOW_FROM} on "
        f"slept {sleeps[0]:.3f} s more; flagged {wd.events}, tripped at "
        f"{trips}")
    check(not [t for t in trips if t < WATCH_SLOW_FROM],
          f"the watchdog tripped before step {WATCH_SLOW_FROM}: {trips}")
    check(trips, "the watchdog did not trip on the slowed steps")
    numbers["watchdog"] = {"step_seconds": dts, "events": wd.events,
                           "trips": trips, "sleep_s": sleeps[0]}
    del params, opt, step_fn, toks
    torch.cuda.empty_cache()

    # (c) the pipeline: 24 layers as 4 stages, f32, row 11's f32 kernel
    pcfg = dataclasses.replace(get_config(LM_ARCH), attn_impl="flash",
                               compute_dtype="float32")
    params = model.init_params(pcfg, seed=4, device=DEV)
    per = L // PIPE_STAGES
    stages = {"layers": [_stack_trees(torch, [
        params["blocks"][s * per + j] for s in range(PIPE_STAGES)])
        for j in range(per)]}
    del params
    positions = torch.arange(PIPE_SEQ, device=DEV)

    def body(sp, x):
        for p in sp["layers"]:
            x, _, _ = model._layer(p, x, kind=pcfg.period[0], cfg=pcfg,
                                   shared=None, positions=positions,
                                   cache=None, cache_index=0)
        return x

    gen = torch.Generator(device=DEV).manual_seed(4)
    x = torch.randn((PIPE_MICRO, PIPE_SEQ, pcfg.d_model), generator=gen,
                    device=DEV)
    with torch.no_grad():
        body(model.map_leaves(lambda v: v[0], stages), x[:1])   # warm-up
        sync()
        before = ops.launch_counts()["flash_attention"]
        t0 = time.perf_counter()
        y = pipeline.pipeline_forward(body, stages, x,
                                      num_microbatches=PIPE_MICRO)
        sync()
        pipe_s = time.perf_counter() - t0
        pipe_launches = ops.launch_counts()["flash_attention"] - before
        t0 = time.perf_counter()
        y_ref = pipeline.sequential_oracle(body, stages, x)
        sync()
        seq_s = time.perf_counter() - t0
    err = float((y - y_ref).abs().max())
    scale = float(y_ref.abs().max())
    ticks = PIPE_STAGES + PIPE_MICRO - 1
    bubble = pipeline.bubble_fraction(PIPE_STAGES, PIPE_MICRO)
    log(f"  [pipeline] {PIPE_STAGES} stages of {per} layers, {PIPE_MICRO} "
        f"microbatches of 1 x {PIPE_SEQ}: pipeline_forward {pipe_s:.3f} s "
        f"({ticks} ticks, {ticks * PIPE_STAGES} stage calls, "
        f"{pipe_launches} launches of row 11), sequential_oracle "
        f"{seq_s:.3f} s ({PIPE_STAGES * PIPE_MICRO} microbatch-stages); "
        f"bubble_fraction {bubble:.4f}; max |diff| {err:.3e} (largest "
        f"|output| {scale:.3f})")
    check(pipe_launches == ticks * PIPE_STAGES * per,
          f"pipeline_forward launched row 11 {pipe_launches} times")
    check(err <= 1e-5 * scale, "pipeline_forward differs from "
          "sequential_oracle by more than 1e-5 of the largest output")
    numbers["pipeline"] = {"pipeline_s": pipe_s, "sequential_s": seq_s,
                           "bubble_fraction": bubble, "max_abs_err": err,
                           "scale": scale, "row11_launches": pipe_launches}
    del stages, x, y, y_ref
    torch.cuda.empty_cache()

    # (d) compression: one step's gradients on 4 batches as 4 shards
    params = model.init_params(cfg, seed=5, device=DEV)
    leaves = [p.requires_grad_(True) for _, p in model.named_leaves(params)]
    grads = [torch.empty((COMP_SHARDS,) + p.shape, dtype=torch.float32,
                         device=DEV) for p in leaves]
    pc = TokenPipelineConfig(vocab_size=cfg.vocab_size, batch_size=LM_BATCH,
                             seq_len=LM_SEQ, seed=5)
    for s in range(COMP_SHARDS):
        tok = torch.from_numpy(batch_for_step(pc, s)).to(DEV)
        loss, _ = ts_lib.loss_fn(params, {"tokens": tok}, cfg)
        for acc, g in zip(grads, torch.autograd.grad(loss, leaves)):
            acc[s].copy_(g)
        del loss
    del params, leaves
    torch.cuda.empty_cache()
    err_fb = compression.init_error_feedback(grads)
    sent = [torch.zeros(g.shape[1:], dtype=torch.float64, device=DEV)
            for g in grads]
    call_s = []
    for _ in range(COMP_ROUNDS):
        sync()
        t0 = time.perf_counter()
        out, err_fb = compression.compress_psum(grads, err_fb, frac=COMP_FRAC,
                                                sharded=True)
        sync()
        call_s.append(time.perf_counter() - t0)
        for acc, o in zip(sent, out):
            acc.add_(o)
        del out
    # sum_s (sum_r sent_r,s + e_s) = rounds x sum_s g_s, up to the f32
    # additions of each round's g + e and of each 4-shard sum: within
    # 64 u of sum_s |g_s| at each element (they add up to about 36 u).
    worst = 0.0
    for g, acc, e in zip(grads, sent, err_fb):
        lhs = COMP_SHARDS * acc + e.double().sum(0)
        rhs = COMP_ROUNDS * g.double().sum(0)
        bound = 64 * U32 * g.double().abs().sum(0)
        over = (lhs - rhs).abs() - bound
        worst = max(worst, float(over.max()))
        check(bool((over <= 0).all()), "sent + residual differs from the "
              "summed gradient by more than 64 u of sum |g|")
    del sent, err_fb
    sync()
    t0 = time.perf_counter()
    full, _ = compression.compress_psum(
        grads, compression.init_error_feedback(grads), frac=1.0,
        sharded=True)
    sync()
    full_s = time.perf_counter() - t0
    mean_err = 0.0
    for g, f in zip(grads, full):
        d = (f - g.mean(0)).abs()
        mean_err = max(mean_err, float(d.max()))
        check(bool((d <= 8 * U32 * g.abs().sum(0) / COMP_SHARDS).all()),
              "frac=1.0 differs from the shard mean")
    shard_shapes = [torch.empty(g.shape[1:], device="meta") for g in grads]
    ratio = compression.compression_ratio(shard_shapes, COMP_FRAC)
    log(f"  [compression] {COMP_SHARDS} shards of {n_params} f32 gradients: "
        f"compress_psum at frac {COMP_FRAC} "
        f"{[round(1e3 * t, 3) for t in call_s]} ms a call, frac 1.0 "
        f"{1e3 * full_s:.3f} ms; compression_ratio "
        f"{ratio:.6f}; sent + residual within the bound (largest margin "
        f"used {worst:.3e}); frac 1.0 against the mean: max |diff| "
        f"{mean_err:.3e}")
    numbers["compression"] = {"call_ms": [1e3 * t for t in call_s],
                              "full_ms": 1e3 * full_s, "ratio": ratio,
                              "mean_err": mean_err}
    del grads, full
    torch.cuda.empty_cache()

    launches = ops.launch_counts()
    F32_LAUNCHES[16] = ops.f32_launch_counts()
    for name in ("flash_attention", "flash_attention_fwd_lse",
                 "flash_attention_bwd"):
        check(launches[name] > 0, f"kernel {name} did not launch on phase "
              f"16's path")
    numbers["wall_s"] = time.perf_counter() - t_phase
    log(f"  launches on phase 16's path {launches}")
    log(f"  phase 16 wall {numbers['wall_s']:.1f} s")
    log(json.dumps({"phase16": numbers}, default=str))
    return launches, numbers



# --- phase 17: the dry-run and its predictions against the card -----------

# --- phase 19: the counter's durability, the sharded step and the pipeline
# across a process group ------------------------------------------------------

PHASE19_DIR = os.path.join(HERE, "build", "chip_smoke_phase19")
P19_READS = 1 << 22            # phase 8's first reads, in P19_UPDATES
P19_UPDATES = 4
P19_SAVE_AFTER = 2             # updates before each checkpoint
P19_QUERIES = 1 << 20
P19_SPILL_READS = 1 << 18
# The 'auto' run's stores hold P19_OVERFLOW fewer slots than the fullest
# PE's distinct k-mers, and the ceiling is one below them: the in-core
# round drops about that many keys (each probing the whole full table,
# PERF.md section 7), and the tier engages at once.
P19_OVERFLOW = 1 << 16
P19_STEPS, P19_CKPT_EVERY = 4, 2
P19_KERNELS = ("bucket_positions", "segment_accumulate", "hash_insert",
               "hash_lookup", "sliding_min_pair", "flash_attention_fwd_lse",
               "flash_attention_bwd")


def ranks_phase(torch, fabsp, ops, genome, card):
    """Phase 19: through a one-rank NCCL group, (a) the counter's
    checkpoint, restore and spill tier, (b) the LM trainer's sharded step
    and its checkpoints on a (1, 1) mesh, (c) the pipeline. Every gate
    failure raises. Returns the launches of the phase's path and its
    numbers."""
    import dataclasses
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.core import dist as rdist
    from repro_torch.core import resilience
    from repro_torch.launch import train as train_lib
    from repro_torch.models import model
    from repro_torch.train import pipeline

    shutil.rmtree(PHASE19_DIR, ignore_errors=True)
    os.makedirs(PHASE19_DIR)
    numbers = {"card": card}
    ops.reset_launches()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    g = rdist.init_group("nccl", "file://" + os.path.join(PHASE19_DIR,
                                                          "store"), 0, 1)
    try:
        # (a) the counter: phase 8's workload, cut to P19_READS
        cfg = fabsp.DAKCConfig(k=K, transport_impl="superkmer",
                               minimizer_order="hashed",
                               compact_impl="prefix")
        spec = genome.ReadSetSpec(genome_bases=1 << 26, n_reads=1 << 23,
                                  read_len=150, seed=0)
        reads = genome.sample_reads_torch(spec, "cuda")[:P19_READS]
        step = P19_READS // P19_UPDATES
        batches = [reads[i * step:(i + 1) * step]
                   for i in range(P19_UPDATES)]
        queries = make_queries(torch, reads, K, P19_QUERIES, seed=7)
        log(f"[ranks] (a) the counter: phase 8's configuration, its first "
            f"{P19_READS} reads in {P19_UPDATES} updates, 8 PEs, "
            f"{P19_QUERIES} queries; a checkpoint after update "
            f"{P19_SAVE_AFTER}")

        def feed(kc, first, p, ckpt=None):
            """Updates `first`.. into `kc` (saving to `ckpt` after
            P19_SAVE_AFTER), then its per-PE sets, answers and stats."""
            walls = []
            for i in range(first, P19_UPDATES):
                if ckpt is not None and i == P19_SAVE_AFTER:
                    path, t = timed(lambda: kc.save(ckpt, step=i))
                    numbers.setdefault("save", []).append(
                        {"s": t, "bytes": dir_bytes(path)})
                walls.append(timed(lambda: kc.update(batches[i]))[1])
            (res, st), t_fin = timed(kc.finalize)
            sets = per_pe_sets(torch, res, p)
            got = kc.count(queries)
            del res
            return sets, got, st, walls, t_fin

        def same(got, want, what, p=NUM_PES):
            """Per-PE sets (or, on another PE count, the global histogram)
            and the answers of `got` equal `want`'s."""
            if p == NUM_PES:
                check(got[0][2] == want[0][2]
                      and torch.equal(got[0][0], want[0][0])
                      and torch.equal(got[0][1], want[0][1]),
                      f"{what}: a PE's (k-mer, count) set differs from the "
                      f"uninterrupted stacked run's")
            else:
                ok = [torch.argsort(x[0][0]) for x in (got, want)]
                check(torch.equal(got[0][0][ok[0]], want[0][0][ok[1]])
                      and torch.equal(got[0][1][ok[0]], want[0][1][ok[1]]),
                      f"{what}: the histogram differs from the "
                      f"uninterrupted stacked run's")
            check((got[1] == want[1]).all(), f"{what}: a query answer "
                  f"differs from the uninterrupted stacked run's")
            log(f"  [{what}] updates {[round(w, 3) for w in got[3]]} s, "
                f"finalize {got[4]:.3f} s; every "
                f"{'PE set' if p == NUM_PES else 'histogram entry'} and "
                f"all {P19_QUERIES} answers equal the stacked run's")

        ck_s = os.path.join(PHASE19_DIR, "ck_stacked")
        ck_g = os.path.join(PHASE19_DIR, "ck_group")
        want = feed(fabsp.KmerCounter(cfg, num_pes=NUM_PES), 0, NUM_PES,
                    ck_s)
        log(f"  [stacked] updates {[round(w, 3) for w in want[3]]} s, "
            f"finalize {want[4]:.3f} s, {sum(want[0][2])} distinct k-mers; "
            f"saved {numbers['save'][0]['bytes']} bytes in "
            f"{numbers['save'][0]['s']:.3f} s")
        got = feed(fabsp.KmerCounter(cfg, num_pes=NUM_PES, group=g), 0,
                   NUM_PES, ck_g)
        log(f"  [group save] {numbers['save'][1]['bytes']} bytes in "
            f"{numbers['save'][1]['s']:.3f} s ({card})")
        same(got, want, "group, uninterrupted")
        restores = (("group's checkpoint on the stacked path, 8 PEs", ck_g,
                     NUM_PES, None),
                    ("group's checkpoint on the stacked path, 4 PEs", ck_g,
                     4, None),
                    ("stacked checkpoint under the group, 8 PEs", ck_s,
                     NUM_PES, g))
        numbers["restore"] = []
        for what, ck, p, grp in restores:
            kc, t = timed(lambda: fabsp.KmerCounter.restore(
                ck, cfg, num_pes=p, group=grp))
            numbers["restore"].append({"what": what, "s": t})
            log(f"  [{what}] restored in {t:.3f} s ({card})")
            same(feed(kc, P19_SAVE_AFTER, p), want, what, p)
            del kc
        del got, want, batches
        torch.cuda.empty_cache()

        # the spill tier under the group, against the stacked path
        sreads = reads[:P19_SPILL_READS]
        res, _ = fabsp.count_kmers(sreads, cfg, num_pes=NUM_PES)
        ref_sets = per_pe_sets(torch, res, NUM_PES)
        cap = max(ref_sets[2]) - P19_OVERFLOW
        del res
        runs = (("always", dict(spill="always")),
                ("auto", dict(spill="auto", store_capacity=cap,
                              retry=resilience.RetryPolicy(
                                  store_cap_ceiling=cap - 1))))
        numbers["spill"] = {}
        for tag, knobs in runs:
            bins = os.path.join(PHASE19_DIR, "bins_" + tag)
            scfg = dataclasses.replace(cfg, spill_dir=bins, **knobs)
            kc = fabsp.KmerCounter(scfg, num_pes=NUM_PES, group=g)
            ust, t_up = timed(lambda: kc.update(sreads))
            (res, st), t_drain = timed(kc.finalize)
            check(st.spilled_bins > 0 and st.bins_folded > 0,
                  f"spill={tag!r} spilled nothing under the group")
            got_sets = per_pe_sets(torch, res, NUM_PES)
            check(got_sets[2] == ref_sets[2]
                  and torch.equal(got_sets[0], ref_sets[0])
                  and torch.equal(got_sets[1], ref_sets[1]),
                  f"spill={tag!r} under the group: a PE's set differs from "
                  f"the stacked in-core count's")
            numbers["spill"][tag] = {
                "update_s": t_up, "drain_s": t_drain,
                "spilled_bytes": st.spilled_bytes,
                "spilled_bins": st.spilled_bins,
                "retry_store_rehash": ust.retry_store_rehash}
            log(f"  [spill {tag!r}] {P19_SPILL_READS} reads: update "
                f"{t_up:.3f} s, drain {t_drain:.3f} s, {st.spilled_bytes} "
                f"bytes in {st.spilled_bins} bins; every PE set equals the "
                f"stacked in-core count's ({card})")
            del kc, res
        log(f"  [spill 'auto'] stores of {cap} slots, ceiling {cap - 1}: "
            f"the tier engaged at the first update")
        del reads, sreads, queries, ref_sets
        torch.cuda.empty_cache()

        # (b) the trainer: phase 9's step through the group on (1, 1)
        cfg9 = dataclasses.replace(get_config(LM_ARCH),
                                   attn_impl="flash_train")
        L = cfg9.num_layers
        kw = dict(reduced=False, steps=P19_STEPS, batch=LM_BATCH,
                  seq=LM_SEQ, log_every=1, attn_impl="flash_train")
        ck_lm = os.path.join(PHASE19_DIR, "lm")
        log(f"[ranks] (b) {LM_ARCH} at full width and depth, {P19_STEPS} "
            f"steps of {LM_BATCH} x {LM_SEQ}, 'flash_train', on a (1, 1) "
            f"mesh of the group; checkpoints every {P19_CKPT_EVERY} steps")
        flash = ("flash_attention_fwd_lse", "flash_attention_bwd")
        before = {k: ops.launch_counts()[k] for k in flash}
        torch.cuda.reset_peak_memory_stats()
        out_s = train_lib.train(LM_ARCH, ckpt_dir=ck_lm,
                                ckpt_every=P19_CKPT_EVERY, group=g,
                                model_parallel=1, **kw)
        peak_s = torch.cuda.max_memory_allocated()
        del out_s["params"], out_s["opt_state"]
        fl = {k: ops.launch_counts()[k] - before[k] for k in flash}
        check(fl["flash_attention_fwd_lse"] == 2 * L * P19_STEPS
              and fl["flash_attention_bwd"] == L * P19_STEPS,
              f"the sharded step's flash launches {fl}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out_u = train_lib.train(LM_ARCH, device=DEV, **kw)
        peak_u = torch.cuda.max_memory_allocated()
        del out_u["params"], out_u["opt_state"]
        for name, a, b, tol in (("loss", out_s["losses"], out_u["losses"],
                                 1e-3),
                                ("grad norm", out_s["grad_norms"],
                                 out_u["grad_norms"], 1e-2)):
            for i, (x, y) in enumerate(zip(a, b)):
                check(abs(x - y) <= tol * abs(y), f"step {i + 1}: the "
                      f"sharded {name} {x} and the unsharded {y} differ by "
                      f"more than {tol} relative")
        clean = [i for i in range(1, P19_STEPS)
                 if (i + 1) % P19_CKPT_EVERY]     # steps without a save
        step_s = sum(out_s["step_seconds"][i] for i in clean) / len(clean)
        step_u = sum(out_u["step_seconds"][1:]) / (P19_STEPS - 1)
        tokens = LM_BATCH * LM_SEQ
        numbers["train"] = {
            "losses": out_s["losses"], "unsharded_losses": out_u["losses"],
            "grad_norms": out_s["grad_norms"],
            "unsharded_grad_norms": out_u["grad_norms"],
            "step_seconds": out_s["step_seconds"],
            "unsharded_step_seconds": out_u["step_seconds"],
            "step_s": step_s, "unsharded_step_s": step_u,
            "tokens_per_s": tokens / step_s,
            "unsharded_tokens_per_s": tokens / step_u,
            "peak_bytes": peak_s, "unsharded_peak_bytes": peak_u,
            "collective_calls": out_s["collective_calls"],
            "collective_bytes": out_s["collective_bytes"],
            "save_seconds": out_s["save_seconds"],
            "write_seconds": out_s["write_seconds"]}
        log(f"  [sharded] losses {out_s['losses']}, unsharded "
            f"{out_u['losses']}; grad norms {out_s['grad_norms']}, "
            f"unsharded {out_u['grad_norms']}: within 1e-3 and 1e-2")
        log(f"  [sharded] step {step_s:.3f} s ({tokens / step_s:.0f} "
            f"tokens/s) beside the unsharded {step_u:.3f} s "
            f"({tokens / step_u:.0f} tokens/s); peak {peak_s / 1e9:.2f} GB "
            f"beside {peak_u / 1e9:.2f} GB; collective calls a step "
            f"{out_s['collective_calls']}, bytes a step "
            f"{out_s['collective_bytes']}; saves {out_s['save_seconds']} "
            f"({card})")
        # the sharded run's step-2 checkpoint, alone, in the unsharded
        # trainer
        ck_one = os.path.join(PHASE19_DIR, "lm_one")
        os.makedirs(ck_one)
        name = f"step_{P19_CKPT_EVERY:08d}"
        os.rename(os.path.join(ck_lm, name), os.path.join(ck_one, name))
        shutil.rmtree(ck_lm)
        out_r = train_lib.train(LM_ARCH, device=DEV, ckpt_dir=ck_one, **kw)
        del out_r["params"], out_r["opt_state"]
        check(out_r["start_step"] == P19_CKPT_EVERY, f"the unsharded "
              f"trainer resumed at {out_r['start_step']}")
        for i, (x, y) in enumerate(zip(out_r["losses"],
                                       out_s["losses"][P19_CKPT_EVERY:])):
            check(abs(x - y) <= 1e-3 * abs(y), f"step "
                  f"{P19_CKPT_EVERY + i + 1}: resumed loss {x}, sharded "
                  f"{y}")
        numbers["train"]["resumed_losses"] = out_r["losses"]
        numbers["train"]["restore_s"] = out_r["restore_seconds"]
        log(f"  [resume] the sharded step-{P19_CKPT_EVERY} checkpoint in "
            f"the unsharded trainer: losses {out_r['losses']} against "
            f"{out_s['losses'][P19_CKPT_EVERY:]}, restore "
            f"{out_r['restore_seconds']:.3f} s")
        shutil.rmtree(ck_one)
        torch.cuda.empty_cache()

        # (c) the pipeline: phase 16's 4 stages, all on the one rank
        pcfg = dataclasses.replace(get_config(LM_ARCH), attn_impl="flash",
                                   compute_dtype="float32")
        params = model.init_params(pcfg, seed=4, device=DEV)
        per = L // PIPE_STAGES
        stages = {"layers": [_stack_trees(torch, [
            params["blocks"][s * per + j] for s in range(PIPE_STAGES)])
            for j in range(per)]}
        del params
        positions = torch.arange(PIPE_SEQ, device=DEV)

        def body(sp, x):
            for p in sp["layers"]:
                x, _, _ = model._layer(p, x, kind=pcfg.period[0], cfg=pcfg,
                                       shared=None, positions=positions,
                                       cache=None, cache_index=0)
            return x

        gen = torch.Generator(device=DEV).manual_seed(4)
        x = torch.randn((PIPE_MICRO, PIPE_SEQ, pcfg.d_model), generator=gen,
                        device=DEV)
        with torch.no_grad():
            y, t_g = timed(lambda: pipeline.pipeline_forward(
                body, stages, x, num_microbatches=PIPE_MICRO, group=g))
            y_ref, t_s = timed(lambda: pipeline.pipeline_forward(
                body, stages, x, num_microbatches=PIPE_MICRO))
        err = float((y - y_ref).abs().max())
        scale = float(y_ref.abs().max())
        check(err <= 1e-5 * scale, f"pipeline_forward(group=) differs from "
              f"the stacked schedule by {err} (largest {scale})")
        numbers["pipeline"] = {"group_s": t_g, "stacked_s": t_s,
                               "max_abs_err": err, "scale": scale}
        log(f"[ranks] (c) pipeline_forward(group=), {PIPE_STAGES} stages "
            f"on the one rank, {PIPE_MICRO} microbatches of 1 x {PIPE_SEQ}: "
            f"{t_g:.3f} s beside the stacked {t_s:.3f} s, max |diff| "
            f"{err:.3e} (largest {scale:.3f})")
        del stages, x, y, y_ref
        torch.cuda.empty_cache()
    finally:
        g.destroy()
        shutil.rmtree(PHASE19_DIR, ignore_errors=True)
    launches = ops.launch_counts()
    F32_LAUNCHES[19] = ops.f32_launch_counts()
    for name in P19_KERNELS:
        check(launches[name] > 0, f"kernel {name} did not launch on phase "
              f"19's path")
    check(launches["bucket_hist"] + launches["bucket_prefix"] > 0,
          "row 1 did not launch on phase 19's path")
    log(f"  launches on phase 19's path {launches}")
    log(json.dumps({"phase19": numbers}, default=str))
    return launches, numbers


# --- phase 20: sharded serving and the families on a mesh of ranks ----------

PHASE20_DIR = os.path.join(HERE, "build", "chip_smoke_phase20")
# (a) serve_step.generate(group=) on a (1, 1) mesh of a one-rank NCCL group
# against the unsharded generate: qwen1.5-0.5b at phase 14's timed shape,
# f32 and bf16; every other decoder family at phase 14's gate widths, cuts,
# batches and prompts (SERVE_GATES), f32, P20_GEN new tokens.
P20_GEN = 8
P20_BF16_TOL = 2e-2     # of the largest logit: the bf16 first decode step
# (b) the sharded step on (1, 1) against the unsharded step from the same
# init: P20_STEPS steps of FAMILY_BATCH x FAMILY_SEQ, bf16 'flash_train'.
# deepseek-moe-16b keeps phase 14's 4 layers; llava-next-mistral-7b is cut
# to 4 of its 32 layers (its AdamW state at full depth is about 87 GB).
P20_TRAIN = (("deepseek-moe-16b", MOE_LAYERS), ("mamba2-370m", None),
             ("zamba2-1.2b", None), ("llava-next-mistral-7b", 4),
             ("hubert-xlarge", None))
P20_STEPS = 3
P20_KERNELS = ("flash_attention_fwd_lse", "flash_attention_bwd")


# the distributed decode's arithmetic on the card, in one process: phase
# 14's timed decode cache (qwen1.5-0.5b, batch 8, 512 + 128 positions) in
# P20_BLOCKS blocks, the query at P20_INDEX, so the last block is empty
P20_BLOCKS, P20_INDEX = 5, 500
P20_COMBINE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # of the largest
P20_VOCAB_BLOCKS = 4


def _decode_arithmetic(torch):
    """The sequence-sharded cache's combine (`parallel.flash_decode_combine`
    of `ref.mha_partial` blocks) against `ref.mha_ref` over the whole cache,
    f32 and bf16, and the vocab-parallel greedy's (max, lowest index) pick
    (`parallel.pick_lowest`) against torch.argmax, on the card."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.models import parallel

    cfg = get_config(LM_ARCH)
    hd = cfg.resolved_head_dim
    s_len = TIMED_PROMPT + TIMED_GEN
    n = -(-s_len // P20_BLOCKS)
    check(P20_INDEX < s_len - n, "the last block must be empty")
    gen = torch.Generator(device=DEV).manual_seed(72)
    out = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        q = torch.randn(TIMED_BATCH, cfg.num_heads, 1, hd, generator=gen,
                        device=DEV).to(dt)
        k, v = (torch.randn(TIMED_BATCH, cfg.num_kv_heads, s_len, hd,
                            generator=gen, device=DEV).to(dt)
                for _ in range(2))
        parts = [ref.mha_partial(q, k[:, :, lo:lo + n], v[:, :, lo:lo + n],
                                 q_offset=P20_INDEX, k_offset=lo)
                 for lo in range(0, s_len, n)]
        m, l, o = (torch.stack(t) for t in zip(*parts))
        check(bool(torch.isinf(m[-1]).all()), "the last block saw a key")
        got = parallel.flash_decode_combine(m, l, o).to(dt)
        want = ref.mha_ref(q, k, v, q_offset=P20_INDEX)
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        check(bool(torch.isfinite(got).all())
              and err <= P20_COMBINE_TOL[dtype] * scale,
              f"the flash-decode combine {dtype}: {err:.3e} from mha_ref "
              f"(largest {scale:.3e})")
        out[f"combine_{dtype}_err"] = err
        out[f"combine_{dtype}_scale"] = scale
    # the greedy pick over P20_VOCAB_BLOCKS blocks of the vocabulary, with
    # ties planted across blocks, within one block and at the last column
    v = cfg.vocab_size
    logits = torch.randn(TIMED_BATCH, v, generator=gen, device=DEV)
    top = float(logits.max()) + 1.0
    w = v // P20_VOCAB_BLOCKS
    logits[0, [5, v - 7]] = top
    logits[1, [w + 2, w + 3]] = top
    logits[2, v - 1] = top
    idx = logits.view(TIMED_BATCH, P20_VOCAB_BLOCKS, w).argmax(-1)
    val = logits.view(TIMED_BATCH, P20_VOCAB_BLOCKS, w).gather(
        -1, idx[..., None])[..., 0]
    glob = idx + w * torch.arange(P20_VOCAB_BLOCKS, device=DEV)
    pairs = torch.stack([val.double(), glob.double()], -1).transpose(0, 1)
    got = parallel.pick_lowest(pairs)
    want = torch.argmax(logits, -1)
    check(torch.equal(got, want) and want[0] == 5 and want[1] == w + 2,
          f"the vocab-parallel greedy pick {got.tolist()} is not argmax's "
          f"{want.tolist()}")
    out["greedy_equal"] = True
    log(f"  [decode arithmetic] {LM_ARCH}'s cache (batch {TIMED_BATCH}, "
        f"{s_len} positions) in {P20_BLOCKS} blocks, the query at "
        f"{P20_INDEX} (the last block empty): the combine within "
        f"{out['combine_float32_err']:.3e} (f32) and "
        f"{out['combine_bfloat16_err']:.3e} (bf16) of mha_ref; the greedy "
        f"pick over {P20_VOCAB_BLOCKS} vocabulary blocks equals argmax")
    return out


def sharded_phase(torch, ops, card):
    """Phase 20: through a one-rank NCCL group on a (1, 1) mesh, (a) sharded
    generate against the unsharded one, (b) the sharded step of the MoE,
    Mamba2, hybrid, VLM and audio families against the unsharded step.
    Every gate failure raises. Returns the launches of the phase's path and
    its numbers."""
    import dataclasses
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.core import dist as rdist
    from repro_torch.launch import train as train_lib
    from repro_torch.launch.mesh import mesh_group
    from repro_torch.models import model
    from repro_torch.models import sharding as shd
    from repro_torch.train import serve_step as ss

    shutil.rmtree(PHASE20_DIR, ignore_errors=True)
    os.makedirs(PHASE20_DIR)
    numbers = {"card": card, "serve": {}, "train": {}}
    numbers["decode_arithmetic"] = _decode_arithmetic(torch)
    # the phase's launches: its sharded runs', each counted from 0 just
    # before the run and read just after (not the unsharded references')
    launches = dict.fromkeys(ops.launch_counts(), 0)
    f32 = F32_LAUNCHES[20] = dict.fromkeys(ops.f32_launch_counts(), 0)

    def sharded(fn, *args, **kw):
        ops.reset_launches()
        out = fn(*args, **kw)
        for k, n in ops.launch_counts().items():
            launches[k] += n
        for k, n in ops.f32_launch_counts().items():
            f32[k] += n
        return out

    g = rdist.init_group("nccl", "file://" + os.path.join(PHASE20_DIR,
                                                          "store"), 0, 1)
    mg = mesh_group(train_lib.build_mesh(1, range(1)), g)
    try:
        def serve_pair(cfg, params, prompt, extra, gen, dtype):
            """(sharded, unsharded) generate: tokens, each step's logits,
            timings."""
            scfg = ss.ServeConfig(max_seq=prompt.shape[1] + gen + (
                cfg.frontend.num_patches if cfg.frontend.kind == "vision"
                else 0), cache_dtype=dtype)
            mine = shd.shard_params(params, mg.mesh, mg.coord)
            res = []
            for group, p in ((mg, mine), (None, params)):
                lg, tm = [], {}
                run = sharded if group is not None else (
                    lambda fn, *a, **kw: fn(*a, **kw))
                toks = run(ss.generate, p, prompt, cfg, scfg, gen,
                           group=group, extra_batch=extra, timings=tm,
                           logits=lg)
                res.append((toks, lg, tm))
                torch.cuda.empty_cache()
            return res

        # (a) qwen1.5-0.5b at phase 14's timed shape, f32 then bf16
        for dtype in ("float32", "bfloat16"):
            t0 = time.perf_counter()
            cfg = dataclasses.replace(get_config(LM_ARCH),
                                      compute_dtype=dtype)
            params = model.init_params(cfg, seed=70, device=DEV)
            gen = torch.Generator(device=DEV).manual_seed(71)
            prompt = torch.randint(0, cfg.vocab_size,
                                   (TIMED_BATCH, TIMED_PROMPT),
                                   generator=gen, device=DEV)
            (ts, ls, ms), (tu, lu, mu) = serve_pair(cfg, params, prompt,
                                                    None, TIMED_GEN, dtype)
            step_s = 1e3 * sum(ms["decode"][1:]) / (TIMED_GEN - 2)
            step_u = 1e3 * sum(mu["decode"][1:]) / (TIMED_GEN - 2)
            row = {"decode_ms": step_s, "unsharded_decode_ms": step_u,
                   "prefill_s": ms["prefill"][0],
                   "unsharded_prefill_s": mu["prefill"][0],
                   "decode_collective_calls":
                       ms["decode_collective_calls"][0],
                   "decode_collective_bytes":
                       ms["decode_collective_bytes"][0]}
            if dtype == "float32":
                check(torch.equal(ts, tu), f"{LM_ARCH} f32: the sharded "
                      f"greedy tokens differ from the unsharded generate's")
                what = "tokens equal"
            else:
                err = float((ls[1] - lu[1]).abs().max())
                scale = float(lu[1].abs().max())
                check(err <= P20_BF16_TOL * scale, f"{LM_ARCH} bf16: the "
                      f"first decode step's logits differ by {err:.3e} "
                      f"(largest {scale:.3f})")
                row.update(first_decode_err=err, scale=scale,
                           tokens_equal=bool(torch.equal(ts, tu)))
                what = (f"first decode step's logits within {err:.3e} of "
                        f"the largest {scale:.3f}; tokens "
                        f"{'equal' if row['tokens_equal'] else 'differ'}")
            numbers["serve"][f"{LM_ARCH} {dtype}"] = row
            log(f"  [serve] {LM_ARCH} {dtype} compute and cache, batch "
                f"{TIMED_BATCH}, prompt {TIMED_PROMPT}, {TIMED_GEN} tokens "
                f"on a (1, 1) mesh: {what}; decode steps 2-"
                f"{TIMED_GEN - 1} {step_s:.3f} ms a step beside the "
                f"unsharded {step_u:.3f} ms, "
                f"{row['decode_collective_calls']:.0f} collective calls "
                f"and {row['decode_collective_bytes']:.0f} B a step; "
                f"prefill {row['prefill_s']:.4f} s beside "
                f"{row['unsharded_prefill_s']:.4f} s "
                f"({time.perf_counter() - t0:.1f} s, {card})")
            del params, ts, tu, ls, lu
            torch.cuda.empty_cache()

        # (a) the other decoder families, f32, phase 14's gate shapes
        for i, (arch, batch, prompt_len, layers_) in enumerate(SERVE_GATES):
            if arch == LM_ARCH:
                continue
            t0 = time.perf_counter()
            cfg = dataclasses.replace(get_config(arch),
                                      compute_dtype="float32")
            if layers_ is not None:
                cfg = dataclasses.replace(cfg, num_layers=layers_)
            if cfg.moe is not None:
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe,
                    capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
            params = model.init_params(cfg, seed=80 + i, device=DEV)
            gen = torch.Generator(device=DEV).manual_seed(90 + i)
            inp = _family_batch(torch, cfg, batch, prompt_len + (
                cfg.frontend.num_patches if cfg.frontend.kind == "vision"
                else 0), gen)
            extra = ({"patches": inp["patches"]} if "patches" in inp
                     else None)
            (ts, ls, ms), (tu, lu, mu) = serve_pair(
                cfg, params, inp["tokens"], extra, P20_GEN, "float32")
            check(torch.equal(ts, tu), f"{arch} f32: the sharded greedy "
                  f"tokens differ from the unsharded generate's")
            err = max(float((a - b).abs().max()) for a, b in zip(ls, lu))
            numbers["serve"][arch] = {
                "max_logit_err": err,
                "decode_ms": 1e3 * sum(ms["decode"]) / (P20_GEN - 1),
                "unsharded_decode_ms": 1e3 * sum(mu["decode"])
                / (P20_GEN - 1),
                "decode_collective_calls": ms["decode_collective_calls"][0]}
            depth = (f"{cfg.num_layers} layers" if layers_ is None else
                     f"CUT: {layers_} of {get_config(arch).num_layers} "
                     f"layers")
            log(f"  [serve] {arch} ({depth}), f32, batch {batch}, prompt "
                f"{prompt_len}, {P20_GEN} tokens: tokens equal, logits "
                f"within {err:.3e}; decode "
                f"{numbers['serve'][arch]['decode_ms']:.3f} ms a step beside "
                f"{numbers['serve'][arch]['unsharded_decode_ms']:.3f} ms, "
                f"{numbers['serve'][arch]['decode_collective_calls']:.0f} "
                f"collective calls a step ({time.perf_counter() - t0:.1f} s)")
            del params, inp, ts, tu, ls, lu
            torch.cuda.empty_cache()

        # (b) the sharded step of each family against the unsharded step
        for arch, layers_ in P20_TRAIN:
            t0 = time.perf_counter()
            base = get_config(arch)
            over = dict(attn_impl="flash_train")
            if layers_ is not None:
                over["num_layers"] = layers_
            kw = dict(reduced=False, steps=P20_STEPS, batch=FAMILY_BATCH,
                      seq=FAMILY_SEQ, log_every=100, **over)
            attn = any(k != "mamba" for k in base.period)
            torch.cuda.reset_peak_memory_stats()
            out_s = sharded(train_lib.train, arch, group=g,
                            model_parallel=1, **kw)
            peak_s = torch.cuda.max_memory_allocated()
            del out_s["params"], out_s["opt_state"]
            fl = {k: ops.launch_counts()[k] for k in P20_KERNELS}
            if attn:
                check(all(fl[k] > 0 for k in P20_KERNELS),
                      f"{arch}: the sharded step's flash launches {fl}")
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            out_u = train_lib.train(arch, device=DEV, **kw)
            peak_u = torch.cuda.max_memory_allocated()
            del out_u["params"], out_u["opt_state"]
            torch.cuda.empty_cache()
            for name, a, b, tol in (
                    ("loss", out_s["losses"], out_u["losses"], 1e-3),
                    ("grad norm", out_s["grad_norms"], out_u["grad_norms"],
                     1e-2)):
                for i, (x, y) in enumerate(zip(a, b)):
                    check(math.isfinite(x) and abs(x - y) <= tol * abs(y),
                          f"{arch} step {i + 1}: the sharded {name} {x} and "
                          f"the unsharded {y} differ by more than {tol} "
                          f"relative")
            step_s = sum(out_s["step_seconds"][1:]) / (P20_STEPS - 1)
            step_u = sum(out_u["step_seconds"][1:]) / (P20_STEPS - 1)
            numbers["train"][arch] = {
                "losses": out_s["losses"],
                "unsharded_losses": out_u["losses"],
                "grad_norms": out_s["grad_norms"],
                "unsharded_grad_norms": out_u["grad_norms"],
                "aux_losses": out_s["aux_losses"],
                "step_s": step_s, "unsharded_step_s": step_u,
                "peak_bytes": peak_s, "unsharded_peak_bytes": peak_u,
                "collective_calls": out_s["collective_calls"],
                "collective_bytes": out_s["collective_bytes"],
                "flash_launches": fl}
            depth = (f"{base.num_layers} layers" if layers_ is None else
                     f"CUT: {layers_} of {base.num_layers} layers")
            log(f"  [train] {arch} ({depth}), {P20_STEPS} steps of "
                f"{FAMILY_BATCH} x {FAMILY_SEQ}, bf16 'flash_train', (1, 1) "
                f"mesh: losses {out_s['losses']} beside {out_u['losses']}, "
                f"grad norms {out_s['grad_norms']} beside "
                f"{out_u['grad_norms']}; step {step_s:.3f} s beside "
                f"{step_u:.3f} s (steps 2-{P20_STEPS}); peak "
                f"{peak_s / 1e9:.2f} GB beside {peak_u / 1e9:.2f} GB; "
                f"collective calls a step {out_s['collective_calls']}, "
                f"bytes a step {out_s['collective_bytes']}; flash launches "
                f"{fl} ({time.perf_counter() - t0:.1f} s)")
    finally:
        mg.destroy()
        g.destroy()
        shutil.rmtree(PHASE20_DIR, ignore_errors=True)
    for name in P20_KERNELS:
        check(launches[name] > 0, f"kernel {name} did not launch on phase "
              f"20's sharded runs")
    log(f"  launches on phase 20's sharded runs {launches}")
    log(json.dumps({"phase20": numbers}, default=str))
    return launches, numbers


PHASE17_DIR = os.path.join(HERE, "build", "chip_smoke_phase17")
DRYRUN_QUERIES = 1 << 20
# The counter's default lowering: Synthetic-30/8 reads after the quantum of
# 256 PEs x 2048 reads a chunk.
KC_DEFAULT_READS = 44_564_480
FLOP_RANGE = (1.0, 1.6)     # traced FLOPs over the model count (remat)
# phase 9's step taken as two microbatches of 2 x 4096, so that the traced
# step (every layer and microbatch) holds the accumulation loop too
DRYRUN_MICRO = 2


def dryrun_host_jobs():
    """Start phase 17's host half, after its card half: subprocesses that
    see no card (an empty CUDA_VISIBLE_DEVICES), each writing its output
    to a file; the dry-run traces its cells in one process a core. Returns
    {name: (Popen, start, log path)} and the record directory."""
    import shutil
    shutil.rmtree(PHASE17_DIR, ignore_errors=True)
    cells = os.path.join(PHASE17_DIR, "cells")
    os.makedirs(cells)
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    py = [sys.executable, "-m"]
    cores = min(8, len(os.sched_getaffinity(0)))
    jobs = {
        "dryrun": py + ["repro_torch.launch.dryrun", "--all", "--mesh",
                        "both", "--jobs", str(cores), "--out", cells],
        "kc": py + ["repro_torch.launch.kc_dryrun", "--stream-batches", "4",
                    "--out", os.path.join(PHASE17_DIR, "kc.json")],
        "query": py + ["repro_torch.launch.kc_dryrun", "--query",
                       str(DRYRUN_QUERIES), "--device", "cpu", "--out", ""],
    }
    started = {}
    for name, cmd in jobs.items():
        path = os.path.join(PHASE17_DIR, f"{name}.log")
        fh = open(path, "w")
        started[name] = (subprocess.Popen(cmd, env=env, cwd=HERE, stdout=fh,
                                          stderr=subprocess.STDOUT),
                         time.perf_counter(), path, fh)
    return started, cells


def dryrun_host_check(started, cells):
    """Wait for the host half and hold it to its gates."""
    from repro_torch.configs import ARCH_IDS, SHAPES, applicable_shapes
    from repro_torch.configs import get_config
    from repro_torch.launch import roofline

    ends, deadline = {}, time.perf_counter() + 600
    while len(ends) < len(started):
        check(time.perf_counter() < deadline, "the dry-run's host jobs did "
              "not end within 600 s")
        for name, (proc, _, _, _) in started.items():
            if name not in ends and proc.poll() is not None:
                ends[name] = time.perf_counter()
        time.sleep(0.2)
    for name, (proc, t_start, path, fh) in started.items():
        rc = proc.returncode
        fh.close()
        with open(path) as f:
            text = f.read()
        log(f"  host job {name}: exit {rc}, "
            f"{ends[name] - t_start:.1f} s")
        check(rc == 0, f"the dry-run's host job {name} failed:\n"
              f"{text[-3000:]}")
        started[name] = text
    n_ok = n_skip = 0
    seconds = 0.0
    for multi in (False, True):
        mname = "pod2x16x16" if multi else "pod16x16"
        for arch in ARCH_IDS:
            applicable = applicable_shapes(get_config(arch))
            for shape in SHAPES:
                with open(os.path.join(
                        cells, f"{arch}__{shape}__{mname}.json")) as f:
                    rec = json.load(f)
                ok, reason = applicable[shape]
                check("error" not in rec, f"dry-run cell {arch} {shape} "
                      f"{mname} failed: {rec.get('error')}")
                if not ok:
                    check(rec.get("skipped") == reason, f"{arch} {shape} "
                          f"{mname} skipped without its reason")
                    n_skip += 1
                    continue
                check("memory" in rec and rec["cost"]["flops"] > 0,
                      f"{arch} {shape} {mname} has no counts")
                n_ok += 1
                seconds += rec["lower_seconds"]
    log(f"  dryrun --all --mesh both: {n_ok} cells traced "
        f"({seconds:.1f} s of trace in all), {n_skip} skipped with "
        f"applicable_shapes' reason")
    log("  roofline over the records (H100: 989e12 FLOP/s, 3.35e12 B/s, "
        "NVLink 450e9 B/s a direction):")
    table = roofline.main(["--dir", cells, "--out",
                           os.path.join(PHASE17_DIR, "roofline.txt")])
    check(table.count("\n") >= n_ok, "the roofline lacks a row")
    with open(os.path.join(PHASE17_DIR, "kc.json")) as f:
        kc = json.load(f)
    inc = kc["incremental"]
    log(f"  kc_dryrun default ({kc['n_reads']} reads, 256 PEs): l3_mode "
        f"{kc['l3_mode']}, store {kc['store_capacity_per_pe']} slots a PE, "
        f"stream temp {kc['memory']['temp_gb']:.4f} GB, stacked "
        f"{kc['stacked_receiver']['memory']['temp_gb']:.4f} GB a PE: "
        f"stacked/stream {kc['receive_memory_ratio_stacked_over_stream']:.3f}"
        f"x; incremental (4 batches) temp {inc['memory']['temp_gb']:.4f} GB, "
        f"args {inc['memory']['args_gb']:.4f} GB; bound "
        f"{kc['roofline']['kmers_per_sec_per_chip_bound']:.4e} k-mers/s a "
        f"PE ({kc['roofline']['dominant']})")
    check(kc["n_reads"] == KC_DEFAULT_READS, "the default lowering's reads")
    check(kc["receive_memory_ratio_stacked_over_stream"] > 1,
          "the stacked receiver does not hold more than the stream")
    for line in started["query"].splitlines():
        if "query executable" in line or "temp=" in line:
            log("  " + line.strip())
    check("query dry-run OK" in started["query"], "the query drill failed")


def _tree_nbytes(torch, tree):
    from repro_torch.models import model
    return sum(t.numel() * t.element_size()
               for _, t in model.named_leaves(tree))


def dryrun_phase(torch, fabsp, ops, genome):
    """Phase 17. Returns the kernel launches of its runs on the card (the
    dry-run's meta traces launch nothing and count nothing, which it
    checks); every gate raises."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import dryrun, kc_dryrun, roofline
    from repro_torch.launch import train as train_lib
    from repro_torch.launch.mesh import Mesh, device_array
    from repro_torch.models import model

    card = Mesh(device_array(["abstract:0"], (1, 1)), ("data", "model"))
    ops.reset_launches()

    def no_meta_launch(before, what):
        check(ops.launch_counts() == before, f"{what} counted a launch")

    # (a1) phase 9's step
    cfg = get_config(LM_ARCH)
    cell = ShapeCell("phase9_step", LM_SEQ, LM_BATCH, "train")
    t0 = time.perf_counter()
    rec = dryrun.lower_cell(LM_ARCH, cell, card,
                            num_microbatches=DRYRUN_MICRO,
                            attn_impl="flash_train")
    no_meta_launch(dict.fromkeys(ops.launch_counts(), 0),
                   "the train step's meta trace")
    check(rec["kernels"]["flash_attention_bwd"]["calls"]
          == cfg.num_layers * DRYRUN_MICRO,
          "the trace did not reach row 13 in every layer and microbatch")
    rec["_mesh_name"] = "card1x1"
    terms = roofline.roofline_terms(rec)
    mem = rec["memory"]
    log(f"  [train] dry-run of phase 9's step ({time.perf_counter() - t0:.1f}"
        f" s): args {mem['argument_size_in_bytes']} B, temp "
        f"{mem['temp_size_in_bytes']} B, {rec['cost']['flops']:.4e} FLOP, "
        f"{rec['cost']['bytes accessed']:.4e} B accessed; bound "
        f"{terms['bound_time_s']:.4f} s ({terms['dominant']}: compute "
        f"{terms['t_compute_s']:.4f}, memory {terms['t_memory_s']:.4f})")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = train_lib.train(LM_ARCH, reduced=False, steps=3, batch=LM_BATCH,
                          seq=LM_SEQ, log_every=1, device=DEV,
                          microbatches=DRYRUN_MICRO, attn_impl="flash_train")
    peak = torch.cuda.max_memory_allocated()
    # the JAX step's arguments: parameters, AdamW moments and its 0-d int32
    # step (a host int in the port), and the int32 token batch
    held = (_tree_nbytes(torch, out["params"])
            + _tree_nbytes(torch, out["opt_state"].mu)
            + _tree_nbytes(torch, out["opt_state"].nu) + 4
            + LM_BATCH * LM_SEQ * 4)
    L, H, hd = cfg.num_layers, cfg.num_heads, cfg.resolved_head_dim
    tokens = LM_BATCH * LM_SEQ
    model_flops = (6 * out["n_params"] * tokens
                   + 6 * L * hd * LM_BATCH * H * LM_SEQ * (LM_SEQ + 1))
    step_s = min(out["step_seconds"][1:])
    ratio = rec["cost"]["flops"] / model_flops
    log(f"  [train] measured: steps {out['step_seconds']} s, "
        f"max_memory_allocated {peak} B; the trainer holds {held} B of "
        f"arguments (predicted {mem['argument_size_in_bytes']}); predicted "
        f"peak (args + temp) "
        f"{mem['argument_size_in_bytes'] + mem['temp_size_in_bytes']} B; "
        f"FLOPs {ratio:.4f} x the model count {model_flops:.4e}; bound "
        f"{terms['bound_time_s']:.4f} s against the fastest step "
        f"{step_s:.4f} s")
    check(mem["argument_size_in_bytes"] == held,
          "phase 9's predicted argument bytes differ from the trainer's")
    check(FLOP_RANGE[0] <= ratio <= FLOP_RANGE[1],
          f"phase 9's traced FLOPs are {ratio:.4f} x the model count")
    check(terms["bound_time_s"] <= step_s,
          "phase 9's roofline bound exceeds the measured step")
    del out
    torch.cuda.empty_cache()

    # (a2) one decode step of phase 14's serving
    cache_len = TIMED_PROMPT + TIMED_GEN + 8     # launch.serve's max_seq
    cell = ShapeCell("serve_decode", cache_len, TIMED_BATCH, "decode")
    before = ops.launch_counts()
    rec = dryrun.lower_cell(LM_ARCH, cell, card)
    no_meta_launch(before, "the decode step's meta trace")
    rec["_mesh_name"] = "card1x1"
    terms = roofline.roofline_terms(rec)
    mem = rec["memory"]
    params = model.init_params(cfg, seed=0, device=DEV)
    caches = model.init_caches(cfg, TIMED_BATCH, cache_len, torch.bfloat16,
                               device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (TIMED_BATCH, TIMED_PROMPT),
                           generator=gen, device=DEV)
    torch.cuda.reset_peak_memory_stats()
    steps = []
    with torch.no_grad():
        lg, caches = model.prefill(params, {"tokens": prompt}, caches, cfg)
        tok = torch.argmax(lg[:, -1], dim=-1, keepdim=True)
        for i in range(8):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, caches = model.decode_step(params, tok, caches,
                                           TIMED_PROMPT + i, cfg)
            tok = torch.argmax(lg[:, -1], dim=-1, keepdim=True)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    # the JAX step's arguments: parameters, caches, the (B, 1) int32 tokens
    # and the 0-d int32 cache index
    held = (_tree_nbytes(torch, params) + sum(
        t.numel() * t.element_size() for layer in caches
        for c in layer.values() for t in c) + TIMED_BATCH * 4 + 4)
    med = sorted(steps)[len(steps) // 2]
    log(f"  [decode] batch {TIMED_BATCH}, cache {cache_len}: predicted args "
        f"{mem['argument_size_in_bytes']} B (held {held}), peak (args + "
        f"temp) {mem['argument_size_in_bytes'] + mem['temp_size_in_bytes']} "
        f"B against max_memory_allocated {peak} B; bound "
        f"{terms['bound_time_s'] * 1e3:.4f} ms ({terms['dominant']}) "
        f"against measured steps {[round(x * 1e3, 3) for x in steps]} ms "
        f"(median {med * 1e3:.3f})")
    check(mem["argument_size_in_bytes"] == held,
          "the decode step's predicted argument bytes differ from the "
          "parameters and caches")
    check(terms["bound_time_s"] <= min(steps),
          "the decode step's roofline bound exceeds the measured step")
    del params, caches, lg
    torch.cuda.empty_cache()

    # (a3) the counter at phase 4's workload
    n_reads = 1 << 23
    pes = Mesh(np.asarray([f"abstract:{i}" for i in range(NUM_PES)],
                          dtype=object), ("pe",))
    t0 = time.perf_counter()
    before = ops.launch_counts()
    kc = kc_dryrun.lower_kc(n_reads, 150, K, pes, chunk_reads=256)
    no_meta_launch(before, "the counter's meta trace")
    log(f"  [count] lower_kc at phase 4's workload ({time.perf_counter() - t0:.1f}"
        f" s): l3_mode {kc['l3_mode']}, hop2_caps {kc['hop2_caps']}, "
        f"compact_caps {kc['compact_caps']}, store "
        f"{kc['store_capacity_per_pe']} slots a PE, temp "
        f"{kc['memory']['temp_gb']:.4f} GB and args "
        f"{kc['memory']['args_gb']:.4f} GB a PE, {kc['cost']['bytes']:.4e} "
        f"B accessed a PE, route {kc['collectives']['total_bytes']:.4e} B "
        f"a PE")
    spec = genome.ReadSetSpec(genome_bases=1 << 26, n_reads=n_reads,
                              read_len=150, seed=0)
    reads = genome.sample_reads_torch(spec, DEV)
    cfg_kc = fabsp.DAKCConfig(k=K, chunk_reads=256)
    shape = tuple(reads.shape)
    mode, cap_n, cap_h = fabsp._plan_caps(cfg_kc, NUM_PES, shape,
                                          cfg_kc.slack)
    store_cap = fabsp._resolve_store_capacity(reads, cfg_kc, NUM_PES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, stats = fabsp.count_kmers(reads, cfg_kc, num_pes=NUM_PES,
                                   device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    del res, reads
    r = kc["roofline"]
    card_bound = NUM_PES * max(r["t_compute_s"], r["t_memory_s"])
    pred_peak = NUM_PES * (kc["memory"]["temp_gb"] + kc["memory"]["args_gb"])
    log(f"  [count] planned from the reads: l3_mode {mode}, caps "
        f"({cap_n}, {cap_h}), store {store_cap} slots a PE "
        f"(count_kmers' 'sample' sizing; the dry-run, with no reads, takes "
        f"the instance bound); retries "
        f"route-slack {stats.retry_route_slack}, store-rehash "
        f"{stats.retry_store_rehash}")
    log(f"  [count] route bytes predicted "
        f"{NUM_PES * kc['collectives']['total_bytes']:.0f}, measured "
        f"DAKCStats.wire_bytes {int(stats.wire_bytes)}; peak predicted "
        f"{pred_peak:.3f} GB, measured {peak / 1e9:.3f} GB; bound "
        f"({NUM_PES} PEs on one card) {card_bound:.4f} s against the "
        f"measured wall {wall:.3f} s")
    check(mode == kc["l3_mode"], "the dry-run's l3_mode differs from the "
          "one planned from the reads")
    check(card_bound <= wall, "the counter's roofline bound exceeds the "
          "measured wall")
    launches = ops.launch_counts()
    F32_LAUNCHES[17] = ops.f32_launch_counts()
    log(f"  launches of phase 17's runs on the card: "
        f"{ {k: v for k, v in launches.items() if v} }")
    passes = 3 * DRYRUN_MICRO       # 3 steps of DRYRUN_MICRO microbatches
    check(launches["flash_attention_fwd_lse"] == 2 * cfg.num_layers * passes
          and launches["flash_attention_bwd"] == cfg.num_layers * passes,
          "phase 17's training did not launch rows 12 and 13 in every "
          "layer")
    for name in COUNT_KERNELS:
        if name not in ROW1:
            check(launches[name] > 0, f"{name} did not launch in phase "
                  f"17's count")
    torch.cuda.empty_cache()
    started, cells = dryrun_host_jobs()
    dryrun_host_check(started, cells)
    import shutil
    shutil.rmtree(PHASE17_DIR, ignore_errors=True)
    return launches


# --- phase 6: kernel times --------------------------------------------------

DEVICE_MS_TRIES = 5     # profiler windows before device_ms gives up


def time_ms(torch, fn, reps=20):
    """Per-call time: CUDA events around `reps` back-to-back calls after a
    warm-up. For a call of a few microseconds this is the host's issue
    rate, not the device's work."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@functools.cache
def port_kernel_names():
    """The __global__ functions of the imported repro_torch's csrc/*.cu
    (this tree's, or the one a script put first on the path), each in the
    sources' anonymous namespace."""
    import repro_torch

    names = set()
    csrc = os.path.join(os.path.dirname(repro_torch.__file__), "csrc")
    for f in sorted(os.listdir(csrc)):
        if f.endswith(".cu"):
            with open(os.path.join(csrc, f)) as src:
                names.update(re.findall(
                    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                    r"(\w+)\s*\(", src.read()))
    return names


def _device_records(torch, fn, reps, tries):
    """{record name: (count, device us)} of torch.profiler's CUDA records
    over `reps` calls after a warm-up, with no host time in between. On
    the card the profiler has kept too few kernel records, three at a
    window's edge: the timed calls sit between spin kernels
    (torch.cuda._sleep, left out), and a window whose records per kernel
    are not a whole multiple of the calls is measured again."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA

    def pad():
        for _ in range(SPIN_PAD):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pad()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            pad()
        recs, spins, first = {}, [], math.inf
        for e in prof.events():
            if e.device_type != cuda or e.device_time_total <= 0:
                continue
            if "spin_kernel" in e.name:
                spins.append(e.time_range.start)
                continue
            first = min(first, e.time_range.start)
            count, us = recs.get(e.name, (0, 0.0))
            recs[e.name] = (count + 1, us + e.device_time_total)
        if len(spins) != 2 * SPIN_PAD:
            before = sum(t < first for t in spins)
            log(f"  (the profiler kept {before} of the {SPIN_PAD} spin "
                f"kernels' records before the calls, "
                f"{len(spins) - before} of {SPIN_PAD} after)")
        if recs and all(c % reps == 0 for c, _ in recs.values()):
            return recs
        log(f"  (the profiler kept {sorted(c for c, _ in recs.values())} "
            f"kernel records of {reps} calls; measured again)")
    raise AssertionError(f"the profiler lost kernel records in {tries} "
                         f"windows")


def device_ms(torch, fn, reps=20, port=True, tries=DEVICE_MS_TRIES):
    """Device time per call from torch.profiler's CUDA records
    (`_device_records`), summed and divided by `reps`. `port`: the records
    of the port's kernels (any other device time of the calls is logged);
    else every device record (a library call)."""
    return port_ms(_device_records(torch, fn, reps, tries), reps, port)


def _port_kernel(key):
    """The port's kernel that a profiler record names, else None."""
    name = re.match(r"(?:void )?\(anonymous namespace\)::(\w+)", key)
    return (name.group(1) if name and name.group(1) in port_kernel_names()
            else None)


def port_ms(recs, reps, port=True):
    """Device ms a call of `_device_records`' records over `reps` calls:
    of the port's kernels (any other device time is logged), or with
    `port` False of every record."""
    mine = rest = 0.0
    for key, (_, us) in recs.items():
        if not port or _port_kernel(key):
            mine += us
        else:
            rest += us
    check(mine > 0, "the profiler recorded no device time")
    if port and rest:
        log(f"  (besides the port's kernels, {rest / reps / 1e3:.4f} ms of "
            f"PyTorch device work per call)")
    return mine / reps / 1e3


def record_ms(recs, reps):
    """{kernel: device ms a call} of `_device_records`' records over
    `reps` calls: the port's kernels by name, any other record by the
    first 90 characters of its name."""
    out = {}
    for key, (_, us) in recs.items():
        name = _port_kernel(key) or key[:90]
        out[name] = out.get(name, 0.0) + us / reps / 1e3
    return out


def whole_call(torch, fn, reps=20):
    """A call of several device operations: (ms a call, device ms a call
    of every record, device launches a call: kernels, fills and copies)."""
    ms = time_ms(torch, fn, reps)
    recs = _device_records(torch, fn, reps, DEVICE_MS_TRIES)
    return (ms, sum(us for _, us in recs.values()) / reps / 1e3,
            sum(c for c, _ in recs.values()) / reps)


def call_times(torch, fn, reps=20):
    """(ms, device_ms) of a wrapper's call: per call, and on the device."""
    return time_ms(torch, fn, reps), device_ms(torch, fn, reps)


def library_times(torch, fn, reps=20):
    """(library_ms, library_device_ms) of one PyTorch call."""
    return time_ms(torch, fn, reps), device_ms(torch, fn, reps, port=False)


def kernel_times(torch, ops, ref, launches, errs, counter, sweep_rows,
                 insert_state):
    """The `kernels` rows. `launches` is the path runs' snapshot: the calls
    timed here are not counted in it."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    rows, n, b = NUM_PES, 30720, 257          # one radix pass of one step
    ids = torch.randint(0, b, (rows, n), generator=gen,
                        dtype=torch.int32).to(dev)
    n_tiles = -(-n // ops.TILE)
    base = ops.bucket_prefix(ids, b)[0]
    out = []

    def entry(name, source, replaces, times, plain_ms, nbytes, library,
              flops=0):
        """times: (ms, device_ms) of the wrapper's call; library:
        (library_ms, library_device_ms), or None where no one PyTorch call
        computes the same function."""
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = flops / BF16_FLOP_PER_S * 1e3
        ms, dev_ms = times
        lib_ms, lib_dev_ms = library or (None, None)
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": errs[name], "ms": ms, "kernel_ms": ms,
                    "device_ms": dev_ms, "plain_ms": plain_ms,
                    "bound_ms": max(by_bytes, by_ops),
                    "bound_by": "operations" if by_ops > by_bytes
                    else "bytes", "library_ms": lib_ms,
                    "library_device_ms": lib_dev_ms,
                    "shape": shape_of[name]})
        return out[-1]

    shape_of = {
        "bucket_hist": f"ids ({rows}, {n}) int32, B={b}",
        "bucket_prefix": f"ids ({rows}, {n}) int32, B={b}",
        "bucket_positions": f"ids ({rows}, {n}) int32, B={b}",
        "segment_accumulate": f"keys ({rows}, {n}) int64, flags mode",
        "hash_insert": None,
    }
    tile_key = ref._tile_keys(ids, b, ops.TILE)[0]
    entry("bucket_hist", "src/repro_torch/csrc/radix_partition.cu",
          "src/repro/kernels/radix_partition.py:65",
          call_times(torch, lambda: ops.bucket_hist(ids, b)),
          time_ms(torch, lambda: ref.bucket_hist(ids, b, ops.TILE)),
          rows * n * 4 + rows * n_tiles * b * 4,
          library_times(torch, lambda: torch.bincount(
              tile_key, minlength=rows * n_tiles * b)))
    prefix_bytes = lambda nb: rows * n * 4 + rows * (n_tiles + 2) * nb * 4
    entry("bucket_prefix", "src/repro_torch/csrc/radix_partition.cu",
          "src/repro/kernels/radix_partition.py:65",
          call_times(torch, lambda: ops.bucket_prefix(ids, b)),
          time_ms(torch, lambda: ref.bucket_prefix(ids, b, ops.TILE)),
          prefix_bytes(b), None)
    by_b = {}
    for nb in (2, 9):
        ids_b = torch.randint(0, nb, (rows, n), generator=gen,
                              dtype=torch.int32).to(dev)
        ms, dev_ms = call_times(torch, lambda: ops.bucket_prefix(ids_b, nb))
        by_b[str(nb)] = {"ms": ms, "device_ms": dev_ms, "bound_ms":
                         prefix_bytes(nb) / HBM_BYTES_PER_S * 1e3}
        log(f"  bucket_prefix at B={nb}: {ms:.4f} ms a call, {dev_ms:.4f} "
            f"ms on the device, bound {by_b[str(nb)]['bound_ms']:.6f}")
    out[-1]["by_buckets"] = by_b
    log("  bucket_prefix library_ms: none, no one PyTorch call gives the "
        "plan's prefix (torch.bincount gives the counts alone)")
    entry("bucket_positions", "src/repro_torch/csrc/radix_partition.cu",
          "src/repro/kernels/radix_partition.py:93",
          call_times(torch, lambda: ops.bucket_positions(ids, base)),
          time_ms(torch, lambda: ref.bucket_positions(ids, base, ops.TILE)),
          rows * n * 4 * 2 + rows * n_tiles * b * 4,
          library_times(torch, lambda: torch.argsort(ids, dim=1,
                                                     stable=True)))

    dgen = torch.Generator(device=dev).manual_seed(1)
    keys, w = _sorted_runs(torch, dgen, rows, n, 15000, -1, 64, dev)
    entry("segment_accumulate", "src/repro_torch/csrc/segment_count.cu",
          "src/repro/kernels/segment_count.py:105",
          call_times(torch, lambda: ops.segment_accumulate(
              keys, w, sentinel_val=-1)),
          time_ms(torch, lambda: ref.segment_accumulate(keys, w, -1)),
          rows * n * (8 + 4) + rows * n * (1 + 1 + 4), None)
    acc = out[-1]
    ms, dev_ms = call_times(torch, lambda: ops.segment_accumulate(
        keys, None, sentinel_val=-1, compact=True))
    acc["compact"] = {"ms": ms, "device_ms": dev_ms, "bound_ms":
                      rows * n * (8 + 8 + 4) / HBM_BYTES_PER_S * 1e3}
    log(f"  segment_accumulate compacting, weights=None, at ({rows}, {n}): "
        f"{ms:.4f} ms a call (with its two fills), {dev_ms:.4f} ms on the "
        f"device (the kernel), bound {acc['compact']['bound_ms']:.6f}")
    del keys, w
    store_n = STORE_CAP
    keys, w = _sorted_runs(torch, dgen, 1, store_n, 1 << 26, -1, 64, dev)
    store = {}
    for compact in (False, True):
        ms, dev_ms = call_times(torch, lambda: ops.segment_accumulate(
            keys, w, sentinel_val=-1, compact=compact), reps=5)
        nbytes = store_n * (12 + (12 if compact else 6))
        store["compact" if compact else "flags"] = {
            "ms": ms, "device_ms": dev_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        log(f"  segment_accumulate at the store histogram's (1, {store_n}), "
            f"compact={compact}: {ms:.4f} ms a call, {dev_ms:.4f} ms on "
            f"the device, bound {nbytes / HBM_BYTES_PER_S * 1e3:.5f}")
    acc["store_row"] = store
    del keys, w
    torch.cuda.empty_cache()

    insert_rows(torch, ops, entry, out, shape_of, insert_state)
    new_kernel_times(torch, ops, ref, counter, entry, shape_of)
    flash_times(torch, ops, ref, entry, shape_of)
    for row in sweep_rows:
        shape_of[row["name"]] = row["shape"]
        entry(row["name"], row["source"], row["replaces"], row["times"],
              row["plain_ms"], row["nbytes"], row["library"])
    for e in out:
        log(f"  {e['name']}: {e['ms']:.4f} ms a call, {e['device_ms']:.4f} "
            f"ms on the device (plain {e['plain_ms']:.4f}, library "
            f"{e['library_ms']} / device {e['library_device_ms']}, bound "
            f"{e['bound_ms']:.5f}) at {e['shape']}")
    return out


def call_sites(torch, ops, snap):
    """Rows 1-3's call sites as whole calls at one scan step's shapes:
    `make_partition_plan` (a radix pass, B=257, and the route, B=9) and
    `sort.accumulate(impl='fused')` (the L3 compressor's, weights=None);
    and row 5's, `countstore.store_lookup` of phase 6's query batch
    against phase 8's store `snap`, alone and with the zeroed stats buffer
    `query_counts` gives it: ms a call, device ms a call of every device
    record, and device launches a call (kernels, fills and copies)."""
    from repro_torch import words as W
    from repro_torch.core import countstore, sort

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(3)
    out = []
    for rows, n, b in ((NUM_PES, 30720, 257), (NUM_PES, 61440, 9)):
        ids = torch.randint(0, b, (rows, n), generator=gen,
                            dtype=torch.int32).to(dev)
        out.append(("make_partition_plan", f"ids ({rows}, {n}) int32, "
                    f"B={b}", whole_call(
                        torch, lambda: ops.make_partition_plan(ids, b))))
    keys, _ = _sorted_runs(torch, torch.Generator(device=dev).manual_seed(3),
                           NUM_PES, 30720, 15000, -1, 64, dev)
    out.append(("accumulate_fused", f"keys ({NUM_PES}, 30720) int64, "
                f"weights=None", whole_call(torch, lambda: sort.accumulate(
                    keys, sentinel_val=-1, impl="fused"))))
    q, _ = lookup_queries(torch, snap.keys, W.sentinel(snap.word_bits), 6)
    shape = (f"store ({NUM_PES}, {snap.store_cap}), queries "
             f"({NUM_PES}, {q.shape[1]}), scattered")
    out.append(("store_lookup", shape, whole_call(
        torch, lambda: countstore.store_lookup(snap, q))))
    out.append(("store_lookup_stats", shape, whole_call(
        torch, lambda: countstore.store_lookup(snap, q, torch.zeros(
            (NUM_PES, 3), dtype=torch.int64, device=DEV)))))
    calls = []
    for name, shape, (ms, dev_ms, n_launch) in out:
        log(f"  {name} at {shape}: {ms:.4f} ms a call, {dev_ms:.4f} ms of "
            f"device records, {n_launch:g} device launches a call")
        calls.append({"name": name, "shape": shape, "ms": ms,
                      "device_ms": dev_ms, "device_launches": n_launch})
    return calls


# --- phase 6, row 4: the insert at the receiver's batch ---------------------

STORE_CAP = 188_743_680     # one PE's store slots on the full-size path


def insert_census(torch, fabsp, genome, n_reads):
    """The live share of each slot of the insert's batch on phase 4's path
    (k=31, 'dual', 8 PEs): count_kmers over the first `n_reads` reads with
    `countstore.store_insert` wrapped to sum, per batch column, the rows
    whose slot is not the sentinel. Returns ((width,) float live share on
    the card, steps). The share does not depend on the read count: each
    step routes the same number of reads."""
    from repro_torch.core import countstore

    spec = genome.ReadSetSpec(genome_bases=1 << 26, n_reads=n_reads,
                              read_len=150, seed=0)
    reads = genome.sample_reads_torch(spec, DEV)
    acc, calls = [], [0]
    insert = countstore.store_insert

    def census(store, words, counts=None):
        live = (words != -1).sum(0)
        if acc:
            acc[0] += live
        else:
            acc.append(live)
        calls[0] += words.shape[0]
        return insert(store, words, counts)

    countstore.store_insert = census
    try:
        fabsp.count_kmers(reads, fabsp.DAKCConfig(k=K, chunk_reads=256),
                          num_pes=NUM_PES, device=DEV)
    finally:
        countstore.store_insert = insert
    del reads
    return acc[0].double() / calls[0], calls[0] // NUM_PES


def insert_path_state(torch, fabsp, genome, count_run):
    """What the insert meets on phase 4's path: each batch slot's live
    share (a census run), the share of live items already stored, and the
    distinct k-mers a row at the end. Logs the live share of phase 4's own
    batches: its live items (`sent_words`) over its batch slots."""
    distinct, stats, inserts = count_run
    share, steps = insert_census(torch, fabsp, genome, 1 << 20)
    width = share.numel()
    hit = 1.0 - distinct / stats.sent_words
    log(f"  the insert on phase 4's path: batches of ({NUM_PES}, {width}); "
        f"{stats.sent_words} live items over {inserts} launches, "
        f"{stats.sent_words / (inserts * NUM_PES * width):.4f} of the batch "
        f"slots live; {hit:.4f} of live items already stored ({distinct} "
        f"distinct); census over {steps} steps: {float(share.mean()):.4f} "
        f"live, the share along a sender tile falling from "
        f"{float(share.max()):.4f} to {float(share.min()):.4f}")
    return share, hit, distinct // NUM_PES


def insert_table(torch, ops, rows, cap, n_fill, seed):
    """A (rows, cap) store holding `n_fill` random 62-bit keys a row,
    inserted by the kernel (weight 1); returns (keys, counts, stored)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    tk = torch.full((rows, cap), -1, dtype=torch.int64, device=DEV)
    tc = torch.zeros((rows, cap), dtype=torch.int32, device=DEV)
    dd = torch.zeros((rows,), dtype=torch.int32, device=DEV)
    stored = torch.randint(0, 1 << 62, (rows, n_fill), generator=g,
                           device=DEV)
    ones = torch.ones((rows, 1 << 22), dtype=torch.int32, device=DEV)
    for lo in range(0, n_fill, 1 << 22):
        part = stored[:, lo:lo + (1 << 22)].contiguous()
        w = ones[:, :part.shape[1]].contiguous()
        ops.hash_insert(tk, tc, part, w, None, sentinel_val=-1, dropped=dd,
                        word_bits=64)
    check(int(dd.sum()) == 0, "the pre-filled store dropped keys")
    return tk, tc, stored


def insert_batch_count(reps, tries=DEVICE_MS_TRIES):
    """Batches for one `call_times` of an insert that takes a fresh batch
    per call: time_ms's warm-up and `reps` calls, device_ms's warm-up and
    up to `tries` windows of `reps` calls."""
    return 2 + reps * (1 + tries)


def fresh_batches(keys):
    """A function that returns the next batch of `keys` at each call and
    raises once they are used up, so that no timed call inserts a batch
    again."""
    batches = iter(keys)

    def next_batch():
        batch = next(batches, None)
        if batch is None:
            raise AssertionError(f"all {keys.shape[0]} fresh batches used")
        return batch

    return next_batch


def insert_batches(torch, n_batches, live_share, hit, stored, seed):
    """(n_batches, rows, width) int64 batches: in each row, slot j is live
    where the row's uniform draw lies below live_share[j], so a sender
    tile (whose share falls along it) is a live prefix and then sentinels;
    a live slot holds one of the row's `stored` keys with probability
    `hit`, else a new random key. Returns (keys, live items, new items)
    per batch on average."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    rows = NUM_PES if stored is None else stored.shape[0]
    width = live_share.numel()
    shape = (n_batches, rows, width)
    live = (torch.rand((n_batches, rows, 1), generator=g, device=DEV)
            < live_share.to(torch.float32))
    keys = torch.randint(0, 1 << 62, shape, generator=g, device=DEV)
    fresh = live
    if hit > 0:
        idx = torch.randint(0, stored.shape[1], shape, generator=g,
                            device=DEV)
        old = stored.unsqueeze(0).expand(n_batches, -1, -1).gather(2, idx)
        take = torch.rand(shape, generator=g, device=DEV) < hit
        keys = torch.where(take, old, keys)
        fresh = live & ~take
        del idx, old, take
    keys = torch.where(live, keys, -1)
    return (keys, int(live.sum()) / n_batches, int(fresh.sum()) / n_batches)


def insert_bounds(rows, width, live, new):
    """Row 4's two bounds in bytes. Streamed: each batch slot's 8 B key and
    each live item's 4 B weight read once (a padding item's weight is not
    needed); each live item's 8 B table key and 4 B count read and written
    once. Sectors: the streamed batch, plus the 32 B sectors live items
    touch at random: a key sector and a count sector read per live item,
    the count sector written back per live item and the key sector per new
    key."""
    streamed = rows * width * 8 + live * 4
    return (streamed + live * (8 + 4) * 2,
            streamed + 32 * (2 * live + live + new))


def insert_rows(torch, ops, entry, out, shape_of, state):
    """Row 4 at the receiver's batch, (8, 138240) into 188,743,680-slot
    stores, home slots hashed in the kernel. Cold: new keys in half of each
    row, an empty store. Warm, the path's state: a store pre-filled by the
    kernel with phase 4's distinct k-mers a row, batches with phase 4's
    live share per slot and its share of live items already stored. Every
    timed call takes a fresh batch, so no call finds its slots in the L2
    cache. Beside each: the old path's `store_slots` on the same batch."""
    from repro_torch.core import countstore

    live_share, hit, n_fill = state
    width = live_share.numel()
    rows, reps = NUM_PES, 20
    n_batches = insert_batch_count(reps)
    shape_of["hash_insert"] = (f"table ({rows}, {STORE_CAP}) int64+int32, "
                               f"batch ({rows}, {width}), slots hashed in "
                               f"the kernel")
    ones = torch.ones((rows, width), dtype=torch.int32, device=DEV)
    dd = torch.zeros((rows,), dtype=torch.int32, device=DEV)
    numbers = {}
    for name in ("cold", "warm"):
        if name == "cold":
            tk = torch.full((rows, STORE_CAP), -1, dtype=torch.int64,
                            device=DEV)
            tc = torch.zeros((rows, STORE_CAP), dtype=torch.int32,
                             device=DEV)
            half = (torch.arange(width, device=DEV) < width // 2).double()
            keys, live, new = insert_batches(torch, n_batches, half, 0.0,
                                             None, 11)
        else:
            tk, tc, stored = insert_table(torch, ops, rows, STORE_CAP,
                                          n_fill, 12)
            keys, live, new = insert_batches(torch, n_batches, live_share,
                                             hit, stored, 13)
            del stored
        next_batch = fresh_batches(keys)

        def insert_next():
            ops.hash_insert(tk, tc, next_batch(), ones, None,
                            sentinel_val=-1, dropped=dd, word_bits=64)

        times = call_times(torch, insert_next, reps)
        slot_times = library_times(torch, lambda: countstore.store_slots(
            keys[0], STORE_CAP, 64))
        by_bytes, by_sectors = insert_bounds(rows, width, live, new)
        numbers[name] = dict(
            ms=times[0], device_ms=times[1], live_items=live,
            new_items=new, bound_ms=by_bytes / HBM_BYTES_PER_S * 1e3,
            sector_bound_ms=by_sectors / HBM_BYTES_PER_S * 1e3,
            store_slots_ms=slot_times[0],
            store_slots_device_ms=slot_times[1])
        log(f"  hash_insert {name}: {live:.0f} live items a batch "
            f"({live / rows / width:.4f} of the slots), {new:.0f} new; "
            f"{times[0]:.4f} ms a call, {times[1]:.4f} ms on the device; "
            f"bounds {numbers[name]['bound_ms']:.5f} ms (bytes), "
            f"{numbers[name]['sector_bound_ms']:.5f} ms (sectors); the old "
            f"path's store_slots on the batch {slot_times[0]:.4f} ms a call, "
            f"{slot_times[1]:.4f} ms on the device")
        check(int(dd.sum()) == 0, f"the {name} timing dropped keys")
        if name == "cold":
            batch0 = keys[0].cpu()
        del tk, tc, keys
        torch.cuda.empty_cache()
    small = 1 << 20
    pk = torch.full((rows, small), -1, dtype=torch.int64)
    pc = torch.zeros((rows, small), dtype=torch.int32)
    pd = torch.zeros((rows,), dtype=torch.int32)
    t0 = time.perf_counter()
    ops.hash_insert(pk, pc, batch0, ones.cpu(), None, sentinel_val=-1,
                    dropped=pd, word_bits=64)
    plain_ms = (time.perf_counter() - t0) * 1e3
    cold = numbers["cold"]
    entry("hash_insert", "src/repro_torch/csrc/hash_table.cu",
          "src/repro/kernels/hash_table.py:114",
          (cold["ms"], cold["device_ms"]), plain_ms,
          insert_bounds(rows, width, cold["live_items"],
                        cold["new_items"])[0], None)
    out[-1]["sector_bound_ms"] = cold["sector_bound_ms"]
    out[-1]["warm"] = numbers["warm"]
    out[-1]["store_slots"] = {k: numbers[k]["store_slots_device_ms"]
                              for k in numbers}
    log("  hash_insert plain_ms: the sequential CPU version, the cold "
        f"batch, {small}-slot tables per PE")
    del pk, pc


def new_kernel_times(torch, ops, ref, counter, entry, shape_of):
    """The lookup and sliding-minimum rows, at the shapes of the counter's
    path (phase 8): one scan step's m-mers, and one query batch's probes
    of the full-size store."""
    from repro_torch.core import encoding, owner
    from repro_torch.data import genome

    dev = torch.device("cuda")
    kc, runs = counter
    spec = genome.ReadSetSpec(genome_bases=1 << 26, n_reads=NUM_PES * 256,
                              read_len=150, seed=4)
    mmers = encoding.pack_kmers(genome.sample_reads_torch(spec, dev), 7)
    keys = owner.order_key(mmers, 32)
    w = K - 7 + 1
    rows, n_pos = mmers.shape
    n_out = n_pos - w + 1
    shape_of["sliding_min"] = shape_of["sliding_min_pair"] = (
        f"m-mers ({rows}, {n_pos}) int64, w={w}")
    entry("sliding_min", "src/repro_torch/csrc/minimizer.cu",
          "src/repro/kernels/minimizer.py:55",
          call_times(torch, lambda: ops.sliding_min(mmers, w)),
          time_ms(torch, lambda: ref.sliding_min(mmers, w)),
          rows * (n_pos + n_out) * 8,
          library_times(torch, lambda: mmers.unfold(1, w, 1).amin(2)))

    def library_pair():
        i = keys.unfold(1, w, 1).argmin(2, keepdim=True)
        return (keys.unfold(1, w, 1).gather(2, i),
                mmers.unfold(1, w, 1).gather(2, i))

    entry("sliding_min_pair", "src/repro_torch/csrc/minimizer.cu",
          "src/repro/kernels/minimizer.py:111",
          call_times(torch, lambda: ops.sliding_min_pair(keys, mmers, w)),
          time_ms(torch, lambda: ref.sliding_min_pair(keys, mmers, w)),
          rows * (n_pos + n_out) * 8 * 2,
          library_times(torch, library_pair))

    lookup_rows(torch, ops, ref, kc._committed, entry, shape_of,
                runs["full"][1]["query_stats"]["probe_sum"] / (1 << 20))


# --- phase 6, row 5: the lookup at one query batch of the full-size path ----

def lookup_queries(torch, tkeys, sent, seed):
    """One query batch of the full-size path as each PE probes it: 2**20
    queries spread over 8 PEs, so each PE's received batch has 8 * 131072
    slots (a 131,072-slot tile from each source PE), 131,072 of them live:
    half stored keys of the PE's table `tkeys`, half random 62-bit words.
    Returns (scattered, tiled): the live queries at random places of the
    batch (the shape phase 6 has timed since the lookup was ported), and
    the same queries laid out as `route_lanes` delivers them, each source
    tile a live prefix followed by padding."""
    n_local = (1 << 20) // NUM_PES
    n = NUM_PES * n_local
    g = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.full((NUM_PES, n), sent, dtype=torch.int64, device=DEV)
    for r in range(NUM_PES):
        stored = tkeys[r][tkeys[r] != sent]
        pick = torch.randint(0, stored.numel(), (n_local // 2,),
                             generator=g, device=DEV)
        q[r, :n_local // 2] = stored[pick]
        q[r, n_local // 2:n_local] = torch.randint(
            0, 1 << (2 * K), (n_local - n_local // 2,), generator=g,
            device=DEV)
        q[r] = q[r][torch.randperm(n, generator=g, device=DEV)]
    tiles = q.view(NUM_PES, NUM_PES, n_local)
    first = torch.sort((tiles == sent).to(torch.int8), dim=2,
                       stable=True).indices
    return q, tiles.gather(2, first).view(NUM_PES, n)


def lookup_bounds(torch, ref, q, counts, probes, cap, word_bits, sent):
    """Row 5's bounds in bytes, from one call's outputs. The stream: each
    batch slot's 8 B key read, its 4 B count and 4 B probe length written.
    Bytes: the stream, each probed 8 B table key and each hit's 4 B count
    read once. Sectors: the stream, plus 32 B for each distinct key sector
    (4 slots) the live walks touch and each distinct count sector (8
    slots) a hit reads. Also the byte count phase 6 gave the row before
    its redesign (a 4 B home slot read per batch slot, 12 B per probe
    step)."""
    rows, n = q.shape
    home = ref.home_slots(q, cap, word_bits).to(torch.int64)
    base = (torch.arange(rows, device=q.device).view(-1, 1) * cap
            ).expand_as(home)
    steps, hit = int(probes.sum()), counts > 0
    key_sec = []     # a sentinel query walks 0 steps
    for d in range(int(probes.max())):
        walked = probes > d
        key_sec.append(((home[walked] + d) % cap + base[walked]) // 4)
    last = (home + probes.to(torch.int64) - 1) % cap + base
    n_key = torch.unique(torch.cat(key_sec)).numel() if key_sec else 0
    n_count = torch.unique(last[hit] // 8).numel()
    stream = rows * n * (8 + 4 + 4)
    return (stream + steps * 8 + int(hit.sum()) * 4,
            stream + 32 * (n_key + n_count),
            rows * n * (8 + 4 + 4 + 4) + steps * (8 + 4))


def lookup_rows(torch, ops, ref, snap, entry, shape_of, path_walk):
    """Row 5 at one query batch of the full-size path (`lookup_queries`)
    against phase 8's committed store: the kernel as the path calls it
    (home slots hashed in the kernel, the batch's stats summed), at the
    scattered layout (comparable with the rows of earlier runs) and at the
    path's own tiled layout; beside it the old path, `store_slots` and the
    kernel given those slots."""
    from repro_torch import words as W
    from repro_torch.core import countstore

    sent, wb, cap = W.sentinel(snap.word_bits), snap.word_bits, snap.store_cap
    q, tiled = lookup_queries(torch, snap.keys, sent, 6)
    stats = torch.zeros((NUM_PES, 3), dtype=torch.int64, device=DEV)

    def lookup(batch, slots=None):
        return ops.hash_lookup(snap.keys, snap.counts, batch, slots,
                               sentinel_val=sent, word_bits=wb, stats=stats)

    counts, probes = lookup(q)
    check(torch.equal(stats, ref.lookup_stats(counts, probes)),
          "hash_lookup stats differ from its outputs' at the path's batch")
    live = int((q != sent).sum())
    steps, hits = int(probes.sum()), int((counts > 0).sum())
    log(f"  hash_lookup batch: {live} live queries, {hits} hits, mean walk "
        f"{steps / live:.4f} slots (the full-size path's queries: "
        f"{path_walk:.4f})")
    by_bytes, by_sectors, old_bytes = lookup_bounds(
        torch, ref, q, counts, probes, cap, wb, sent)
    del counts, probes
    shape_of["hash_lookup"] = (
        f"table ({NUM_PES}, {cap}) int64+int32, queries ({NUM_PES}, "
        f"{q.shape[1]}), {live} live, scattered; slots hashed in the kernel")
    row = entry("hash_lookup", "src/repro_torch/csrc/hash_table.cu",
                "src/repro/kernels/hash_table.py:195",
                call_times(torch, lambda: lookup(q)),
                time_ms(torch, lambda: ref.lookup_stats(*ref.hash_lookup(
                    snap.keys, snap.counts, q, ref.home_slots(q, cap, wb),
                    sent)), reps=5),
                by_bytes, None)
    row["sector_bound_ms"] = by_sectors / HBM_BYTES_PER_S * 1e3
    row["old_bound_ms"] = old_bytes / HBM_BYTES_PER_S * 1e3
    ms, dev_ms = call_times(torch, lambda: lookup(tiled))
    row["tiled"] = {"ms": ms, "device_ms": dev_ms}
    slots = countstore.store_slots(q, cap, wb)
    slot_ms, slot_dev_ms = library_times(
        torch, lambda: countstore.store_slots(q, cap, wb))
    given_ms, given_dev_ms = call_times(torch, lambda: lookup(q, slots))
    row["old_path"] = {"store_slots_ms": slot_ms,
                       "store_slots_device_ms": slot_dev_ms,
                       "kernel_ms": given_ms, "kernel_device_ms": given_dev_ms}
    log(f"  hash_lookup: {row['ms']:.4f} ms a call, {row['device_ms']:.4f} "
        f"ms on the device (scattered), {ms:.4f} / {dev_ms:.4f} ms at the "
        f"path's tiled layout; bounds {row['bound_ms']:.5f} ms (bytes), "
        f"{row['sector_bound_ms']:.5f} ms (sectors), old byte count "
        f"{row['old_bound_ms']:.5f}; the old path: store_slots {slot_ms:.4f} "
        f"ms a call, {slot_dev_ms:.4f} ms on the device, then the kernel "
        f"given the slots {given_ms:.4f} / {given_dev_ms:.4f} ms")
    log("  hash_lookup library_ms: none, no PyTorch call walks a probe "
        "sequence")
    del q, tiled, slots


def flash_times(torch, ops, ref, entry, shape_of):
    """Rows 11-13 at the training path's shape, (4, 16, 4096, 64) bf16
    causal. The bound is the causal products' FLOPs at the bf16 tensor-core
    peak (each kept (row, col) pair costs 2 hd per product: 2 products
    forward, 5 backward), against the bytes read and written once. Each
    row also gets, as `f32`, the same shape in float32 (bound at the split
    products' 165e12 FLOP/s, and `bound_cuda_core_ms` at 67e12), and as
    `by_head_dim` both dtypes at head dims 128 and 256 (no plain times).
    Fails unless the profiler's records of each call name that dtype's
    tensor-core kernels (FLASH_TC_KERNELS) and no other of the port's."""
    import torch.nn.functional as F

    b, h, s, d = FLASH_PATH
    rows = flash_shape_times(torch, ops, ref, (b, h, s, d), torch.bfloat16,
                             5)
    for name in ("flash_attention", "flash_attention_fwd_lse",
                 "flash_attention_bwd"):
        shape_of[name] = f"q/k/v ({b}, {h}, {s}, {d}) bf16, causal"
    new = {name: entry(name, source, replaces, (r["ms"], r["device_ms"]),
                       r["plain_ms"], r["nbytes"],
                       (r["library_ms"], r["library_device_ms"]),
                       flops=r["flops"])
           for (name, source, replaces), r in zip(FLASH_SOURCES,
                                                  rows.values())}
    f32 = flash_shape_times(torch, ops, ref, (b, h, s, d), torch.float32, 5)
    by_d = {str(dd): {"bf16": flash_shape_times(
        torch, ops, ref, (b, h, s, dd), torch.bfloat16, 3, plain=False),
        "f32": flash_shape_times(torch, ops, ref, (b, h, s, dd),
                                 torch.float32, 3, plain=False)}
        for dd in (128, 256)}
    for name, e in new.items():
        e["f32"] = f32[name]
        e["by_head_dim"] = {dd: {dt: r[name] for dt, r in x.items()}
                            for dd, x in by_d.items()}
    # The profiler's records name the kernels that ran: each dtype's
    # tensor-core kernels, and no other kernel of the port.
    for dt, dd, r in [("bf16", "64", rows), ("f32", "64", f32)] + [
            (dt, dd, x[dt]) for dd, x in by_d.items() for dt in x]:
        for name, row in r.items():
            ran = {k for k in row["records_ms"] if k in port_kernel_names()}
            check(ran == FLASH_TC_KERNELS[name, dt],
                  f"{name} at head dim {dd}, {dt}: the port's kernels "
                  f"{sorted(ran)} ran, not {FLASH_TC_KERNELS[name, dt]}")
    log("  rows 11-13 at head dims 64, 128, 256: the profiler recorded "
        "only the tensor-core kernels of each dtype")
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(9)
    q, k, v, do = (torch.randn((b, h, s, d), generator=gen, device=dev)
                   .to(torch.bfloat16).requires_grad_(True)
                   for _ in range(4))
    sdpa_both = time_ms(torch, lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(q, k, v, is_causal=True),
        (q, k, v), do), 5)
    log(f"  flash library_ms: scaled_dot_product_attention(is_causal=True) "
        f"bf16 forward + backward {sdpa_both:.4f} ms")
    del q, k, v, do
    torch.cuda.empty_cache()


# The kernels that rows 11-13 launch, by dtype.
FLASH_TC_KERNELS = {
    ("flash_attention", "bf16"): {"flash_fwd_tc"},
    ("flash_attention_fwd_lse", "bf16"): {"flash_fwd_tc"},
    ("flash_attention_bwd", "bf16"): {"flash_dq_tc", "flash_dkv_tc"},
    ("flash_attention", "f32"): {"flash_fwd_f32"},
    ("flash_attention_fwd_lse", "f32"): {"flash_fwd_f32"},
    ("flash_attention_bwd", "f32"): {"flash_dq_f32", "flash_dkv_f32"}}

# (name, source, replaces) of rows 11-13.
FLASH_SOURCES = (
    ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:84"),
    ("flash_attention_fwd_lse", "src/repro_torch/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:167"),
    ("flash_attention_bwd", "src/repro_torch/csrc/flash_attention_bwd.cu",
     "src/repro/kernels/flash_attention_bwd.py:138"))


def flash_shape_times(torch, ops, ref, shape, dtype, reps, plain=True):
    """Rows 11-13 on causal (b, h, s, d) inputs of `dtype`: per row its
    ms and device_ms, each device record's ms a call (`records_ms`: the
    port's kernels by name), the plain version's ms (None without
    `plain`),
    SDPA's (the forward call, or
    its backward alone: autograd.grad on a kept graph) as library_ms and
    library_device_ms, the FLOPs and bytes, and bound_ms: bf16 at the
    tensor cores' 989e12 FLOP/s, f32 at the split products' 165e12 (and
    bound_cuda_core_ms at 67e12), each against the bytes."""
    import torch.nn.functional as F

    b, h, s, d = shape
    dev = torch.device(DEV)
    gen = torch.Generator(device=dev).manual_seed(9)
    q, k, v, do = (torch.randn((b, h, s, d), generator=gen, device=dev)
                   .to(dtype) for _ in range(4))
    band = dict(causal=True, window=None, softcap=None, scale=d ** -0.5)
    pairs = b * h * s * (s + 1) // 2
    elem = b * h * s * d * q.element_size()   # one (b, h, s, d) tensor
    lse_bytes = b * h * s * 4
    o, lse = ops.flash_attention_fwd_lse(q, k, v, **band)
    sdpa_fwd = library_times(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), reps)
    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    og = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    sdpa_bwd = library_times(torch, lambda: torch.autograd.grad(
        og, (qg, kg, vg), do, retain_graph=True), reps)
    calls = {
        "flash_attention": (
            lambda: ops.flash_attention(q, k, v, **band),
            lambda: ref.flash_fwd(q, k, v, **band), 4 * elem, sdpa_fwd,
            4 * d * pairs),
        "flash_attention_fwd_lse": (
            lambda: ops.flash_attention_fwd_lse(q, k, v, **band),
            lambda: ref.flash_fwd(q, k, v, with_lse=True, **band),
            4 * elem + lse_bytes, sdpa_fwd, 4 * d * pairs),
        "flash_attention_bwd": (
            lambda: ops.flash_attention_bwd(q, k, v, o, lse, do, **band),
            lambda: ref.flash_bwd(q, k, v, o, lse, do, **band),
            8 * elem + lse_bytes, sdpa_bwd, 10 * d * pairs),
    }
    rate = (BF16_FLOP_PER_S if dtype == torch.bfloat16
            else F32_SPLIT_FLOP_PER_S)
    tag = f"({b}, {h}, {s}, {d}) {str(dtype)[6:]} causal"
    out = {}
    for name, (fn, ref_fn, nbytes, lib, flops) in calls.items():
        ms = time_ms(torch, fn, reps)
        recs = _device_records(torch, fn, reps, DEVICE_MS_TRIES)
        dev_ms = port_ms(recs, reps)
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        row = {"shape": tag, "ms": ms, "device_ms": dev_ms,
               "records_ms": record_ms(recs, reps),
               "plain_ms": time_ms(torch, ref_fn, reps) if plain else None,
               "library_ms": lib[0], "library_device_ms": lib[1],
               "flops": flops, "nbytes": nbytes,
               "bound_ms": max(by_bytes, flops / rate * 1e3)}
        if dtype == torch.float32:
            row["bound_cuda_core_ms"] = max(
                by_bytes, flops / F32_CUDA_CORE_FLOP_PER_S * 1e3)
        out[name] = row
        log(f"  {name} at {tag}: {ms:.4f} ms a call, {dev_ms:.4f} ms on the "
            f"device, plain {row['plain_ms']}, SDPA {lib[0]:.4f} / "
            f"device {lib[1]:.4f}, bound {row['bound_ms']:.5f}"
            + (f" (CUDA cores {row['bound_cuda_core_ms']:.5f})"
               if "bound_cuda_core_ms" in row else ""))
    del q, k, v, do, o, lse, qg, kg, vg, og
    torch.cuda.empty_cache()
    return out


# --- phase 7 (on request): where the time of the main path goes -------------

def profile_path(torch, fabsp, genome, n_reads):
    """torch.profiler over one count of the main path at the full widths
    and a cut read count: device time by kernel and the device's busy
    share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    spec = genome.ReadSetSpec(genome_bases=1 << 26, n_reads=n_reads,
                              read_len=150, seed=0)
    reads = genome.sample_reads_torch(spec, "cuda")
    cfg = fabsp.DAKCConfig(k=K, chunk_reads=256)
    fabsp.count_kmers(reads[:NUM_PES * 256], cfg, num_pes=NUM_PES)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fabsp.count_kmers(reads, cfg, num_pes=NUM_PES)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    launches = _log_profile(torch, prof, wall_us, f"{n_reads} reads")
    steps = n_reads // (256 * NUM_PES)
    log(f"  {launches} device kernel launches over {steps} scan steps: "
        f"{launches / steps:.2f} a step")
    return launches / steps


def _log_profile(torch, prof, wall_us, what):
    """Device time by kernel and the device's busy share of `wall_us`;
    returns the count of device kernel records."""
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    device_us = sum(r[2] for r in rows)
    log(f"  {what}: wall {wall_us / 1e3:.1f} ms under the profiler, "
        f"device busy {device_us / 1e3:.1f} ms "
        f"({100 * device_us / wall_us:.1f} %)")
    for key, count, us in rows[:15]:
        log(f"  {us / 1e3:10.2f} ms {count:8d}x  {key[:90]}")
    return sum(r[1] for r in rows)


def profile_lm_step(torch):
    """torch.profiler over one training step of phase 9's configuration,
    after one step of warm-up."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipelineConfig, batch_for_step
    from repro_torch.models import model
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts_lib

    cfg = dataclasses.replace(get_config(LM_ARCH), attn_impl="flash_train")
    params = model.init_params(cfg, seed=0, device=DEV)
    state = opt_lib.init(params)
    step = ts_lib.make_train_step(cfg, ts_lib.TrainConfig(
        optimizer=opt_lib.OptimizerConfig(warmup_steps=2,
                                          total_steps=LM_STEPS)))
    batch = {"tokens": torch.from_numpy(batch_for_step(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, batch_size=LM_BATCH, seq_len=LM_SEQ,
        seed=0), 0)).to(DEV)}
    params, state, _ = step(params, state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, _ = step(params, state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    _log_profile(torch, prof, wall_us,
                 f"one {LM_ARCH} step of {LM_BATCH} x {LM_SEQ} tokens")
    del params, state
    torch.cuda.empty_cache()


def profile_decode_step(torch, arch="qwen1.5-0.5b", steps=4):
    """torch.profiler over `steps` decode steps of phase 14's timed
    configuration (bf16, batch TIMED_BATCH, after a TIMED_PROMPT prefill
    and two warm-up steps): device time by kernel, busy share, device
    launches a step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import model

    cfg = get_config(arch)
    params = model.init_params(cfg, seed=0, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(70)
    tok = torch.randint(0, cfg.vocab_size, (TIMED_BATCH, TIMED_PROMPT),
                        generator=gen, device=DEV)
    caches = model.init_caches(cfg, TIMED_BATCH, TIMED_PROMPT + steps + 8,
                               torch.bfloat16, device=DEV)
    with torch.no_grad():
        lg, caches = model.prefill(params, {"tokens": tok}, caches, cfg)
        pos = TIMED_PROMPT

        def step():
            nonlocal lg, caches, pos
            nxt = lg[:, -1].argmax(-1, keepdim=True)
            lg, caches = model.decode_step(params, nxt, caches, pos, cfg)
            pos += 1

        for _ in range(2):
            step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    launches = _log_profile(torch, prof, wall_us,
                            f"{steps} {arch} decode steps at batch "
                            f"{TIMED_BATCH}")
    log(f"  {launches / steps:.1f} device launches a decode step")
    del params, caches
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="1,2,3,4,5,6,8,9,10,11,12,13,14,15,16,17,18,"
                            "19,20",
                    help="comma-separated; 7 (a profile) runs on request")
    ap.add_argument("--reads", type=int, default=1 << 23,
                    help="phases 4, 10, 11 and 12's read count, phase "
                         "13's spill run's and the read set phase 15 "
                         "takes its first 2**22 reads from (a cut is "
                         "printed); phase 8 always reads 2**23")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # Full f32 products in every plain version (TF32 keeps ~3 digits).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.core import bsp, fabsp
    from repro_torch.data import genome
    from repro_torch.kernels import build, ops, ref

    t_all = time.perf_counter()
    log("[device]")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(smi[0])
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count "
        f"{torch.cuda.device_count()}")

    log("[build]")
    t0 = time.perf_counter()
    libs = build.build_all(verbose=True)
    log(f"  built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")

    errs = {}
    if 3 in phases:
        t0 = time.perf_counter()
        check_kernels(torch, ops, ref, errs)
        log(f"[kernels] all match their plain versions "
            f"({time.perf_counter() - t0:.1f} s)")

    launches = {}
    count_run = phase4 = phase4_wall = None
    if 4 in phases:
        log("[full size] Synthetic 26, 150 bp reads, k=31, 8 PEs")
        if args.reads != 1 << 23:
            log(f"  CUT: n_reads {args.reads} instead of {1 << 23}")
        launches, count_wall, count_peak, distinct, stats, count_sets = \
            run_count(torch, fabsp, ops, genome, args.reads, K, NUM_PES,
                      pieces=4, genome_bases=1 << 26, keep_sets=True)
        for name in ROW1:
            check(launches[name] > 0, f"{name} did not launch on the main "
                  f"path at full size")
        count_run = (distinct, stats, launches["hash_insert"])
        phase4 = (count_wall, count_sets, stats, count_peak)
        phase4_wall = count_wall
        torch.cuda.empty_cache()

    if 5 in phases:
        for k, p in ((13, 4), (21, 2)):
            log(f"[small] k={k}, {p} PEs, 4096 reads")
            run_count(torch, fabsp, ops, genome, 4096, k, p, pieces=1,
                      genome_bases=1 << 16)

    # Phase 18 runs beside phase 4's result, before phase 8, whose counter
    # keeps its store until phase 6, and before phase 10, which profiles.
    phase18_launches = None
    if 18 in phases:
        t0 = time.perf_counter()
        log("[group] the PEs across a one-rank NCCL process group: phase 4's "
            "workload, small runs of the other paths, the refusals")
        if args.reads != 1 << 23:
            log(f"  CUT: n_reads {args.reads} instead of {1 << 23}")
        phase18_launches, _ = group_phase(torch, fabsp, bsp, ops, genome,
                                          args.reads, phase4)
        torch.cuda.empty_cache()
        log(f"[group] done ({time.perf_counter() - t0:.1f} s)")

    # Phases 11 and 12 run before phase 8, whose counter keeps its store
    # until phase 6, and before phase 10, which profiles.
    if 11 in phases:
        t0 = time.perf_counter()
        if args.reads != 1 << 23:
            log(f"  CUT: n_reads {args.reads} instead of {1 << 23}")
        topology2d_phase(torch, fabsp, ops, genome, args.reads, phase4)
        log(f"[2d] done ({time.perf_counter() - t0:.1f} s)")

    if 12 in phases:
        t0 = time.perf_counter()
        if args.reads != 1 << 23:
            log(f"  CUT: n_reads {args.reads} instead of {1 << 23}")
        bsp_phase(torch, bsp, ops, genome, args.reads, phase4)
        log(f"[bsp] done ({time.perf_counter() - t0:.1f} s)")
    phase4 = None
    torch.cuda.empty_cache()

    counter = None
    if 8 in phases:
        t0 = time.perf_counter()
        counter = counter_phase(torch, fabsp, ops, genome)
        runs = counter[1]
        launches["hash_lookup"] = runs["full"][0]["hash_lookup"]
        launches["sliding_min_pair"] = runs["full"][0]["sliding_min_pair"]
        launches["sliding_min"] = runs["plain"][0]["sliding_min"]
        log(f"[counter] done ({time.perf_counter() - t0:.1f} s)")

    # Phase 13 reads phase 8's counter and histogram, and frees what it
    # made before phase 9.
    phase13_launches = None
    if 13 in phases:
        check(counter is not None, "phase 13 needs phase 8")
        t0 = time.perf_counter()
        n13 = min(args.reads, 1 << 23)
        check(n13 % 2048 == 0 and n13 >= sum(SPILL_HEAD)
              + 2048 * (SPILL_UPDATES - len(SPILL_HEAD)),
              f"phase 13's read count {n13} does not split into "
              f"{SPILL_UPDATES} updates of 8 PEs x 256-read chunks")
        log("[durability] phase 8's counter checkpointed and restored; the "
            "same read set through the spill tier; the kill drill; "
            "two tenants served; small drills")
        if n13 != 1 << 23:
            log(f"  CUT: the spill run reads {n13} instead of {1 << 23}")
        phase13_launches = durability_phase(
            torch, fabsp, ops, genome, counter[0], counter[1]["full"][1],
            n13, smi[0])
        log(f"[durability] done ({time.perf_counter() - t0:.1f} s)")
    if counter is not None:
        counter[1]["full"][1]["sets"] = None
    torch.cuda.empty_cache()

    if 9 in phases:
        t0 = time.perf_counter()
        lm_launches, _ = lm_phase(torch, ops)
        launches.update(lm_launches)
        log(f"[lm] done ({time.perf_counter() - t0:.1f} s)")

    phase14_launches = None
    if 14 in phases:
        t0 = time.perf_counter()
        log("[serve] LM serving (prefill and decode against full forwards, "
            "f32), DAKC against GShard, one train step of each new family, "
            "timed serving in bf16")
        phase14_launches, _ = serve_phase(torch, ops)
        log(f"[serve] done ({time.perf_counter() - t0:.1f} s)")
    torch.cuda.empty_cache()

    phase15_launches = None
    if 15 in phases:
        t0 = time.perf_counter()
        log("[remaining] corpus n-gram statistics, 128-bit k-mers, the "
            "kc_dryrun drills and the analytical model")
        if args.reads != 1 << 23:
            log(f"  CUT: phase 4's read set has {args.reads} reads instead "
                f"of {1 << 23}")
        phase15_launches, _ = remaining_phase(torch, ops, genome, args.reads,
                                              phase4_wall, smi[0])
        torch.cuda.empty_cache()
        log(f"[remaining] done ({time.perf_counter() - t0:.1f} s)")

    phase16_launches = None
    if 16 in phases:
        t0 = time.perf_counter()
        log("[trainer] checkpoints and resume, the straggler watchdog, the "
            "GPipe schedule and gradient compression at full size")
        phase16_launches, _ = trainer_phase(torch, ops)
        torch.cuda.empty_cache()
        log(f"[trainer] done ({time.perf_counter() - t0:.1f} s)")

    phase17_launches = None
    if 17 in phases:
        t0 = time.perf_counter()
        log("[dryrun] every cell traced on meta tensors (host), then its "
            "predictions against real runs on the card")
        phase17_launches = dryrun_phase(torch, fabsp, ops, genome)
        torch.cuda.empty_cache()
        log(f"[dryrun] done ({time.perf_counter() - t0:.1f} s)")

    phase19_launches = None
    if 19 in phases:
        t0 = time.perf_counter()
        log("[ranks] through a one-rank NCCL group: the counter's "
            "checkpoint, restore and spill tier, the LM trainer's sharded "
            "step and checkpoints on a (1, 1) mesh, the pipeline")
        phase19_launches, _ = ranks_phase(torch, fabsp, ops, genome, smi[0])
        torch.cuda.empty_cache()
        log(f"[ranks] done ({time.perf_counter() - t0:.1f} s)")

    phase20_launches = None
    if 20 in phases:
        t0 = time.perf_counter()
        log("[sharded] through a one-rank NCCL group on a (1, 1) mesh: "
            "sharded generate of every decoder family, the sharded step of "
            "the MoE, Mamba2, hybrid, VLM and audio families")
        phase20_launches, _ = sharded_phase(torch, ops, smi[0])
        torch.cuda.empty_cache()
        log(f"[sharded] done ({time.perf_counter() - t0:.1f} s)")

    # Phase 10 comes after the phases whose wall times the records keep, as
    # it profiles its kernels for phase 6: once torch.profiler has run, the
    # process launches kernels more slowly (PERF.md §6).
    sweep_rows = []
    if 10 in phases:
        t0 = time.perf_counter()
        log("[sweeps] Synthetic 26, 150 bp reads, k=31: kmer_extract, "
            "radix_hist, radix_sort + accumulate(boundaries_impl='kernel')")
        if args.reads != 1 << 23:
            log(f"  CUT: n_reads {args.reads} instead of {1 << 23}")
        sweep_launches, sweep_rows = sweeps_phase(
            torch, ops, ref, genome, args.reads, timed=6 in phases)
        launches.update(sweep_launches)
        log(f"[sweeps] done ({time.perf_counter() - t0:.1f} s)")

    record = None
    if 6 in phases:
        check(len(launches) == len(ops.KERNELS) and errs
              and counter is not None and sweep_rows and count_run,
              "phase 6 needs phases 3, 4, 8, 9 and 10")
        insert_state = insert_path_state(torch, fabsp, genome, count_run)
        log("[times] per call: CUDA events around 20 calls after a warm-up "
            "(5 for rows 9 and 11-13); on the device: torch.profiler's "
            "kernel records of as many calls")
        record = kernel_times(torch, ops, ref, launches, errs, counter,
                              sweep_rows, insert_state)
        for e in record:
            e["launches_phase13"] = (None if phase13_launches is None
                                     else phase13_launches[e["name"]])
            e["launches_phase14"] = (None if phase14_launches is None
                                     else phase14_launches[e["name"]])
            e["launches_phase15"] = (None if phase15_launches is None
                                     else phase15_launches[e["name"]])
            e["launches_phase16"] = (None if phase16_launches is None
                                     else phase16_launches[e["name"]])
            e["launches_phase17"] = (None if phase17_launches is None
                                     else phase17_launches[e["name"]])
            e["launches_phase18"] = (None if phase18_launches is None
                                     else phase18_launches[e["name"]])
            e["launches_phase19"] = (None if phase19_launches is None
                                     else phase19_launches[e["name"]])
            e["launches_phase20"] = (None if phase20_launches is None
                                     else phase20_launches[e["name"]])
            if e["name"] in ops.f32_launch_counts():
                e["f32_launches_by_phase"] = {
                    n: f32[e["name"]] for n, f32 in F32_LAUNCHES.items()}
        calls = call_sites(torch, ops, counter[0]._committed)
        counter = None
        torch.cuda.empty_cache()

    if 7 in phases:
        log("[profile] the main path under torch.profiler")
        profile_path(torch, fabsp, genome, min(args.reads, 1 << 20))
        log("[profile] one LM training step under torch.profiler")
        profile_lm_step(torch)
        log("[profile] LM decode steps under torch.profiler")
        profile_decode_step(torch)

    log(f"[done] {time.perf_counter() - t_all:.1f} s")
    if record is not None:
        log(json.dumps({"kernels": record, "calls": calls}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
