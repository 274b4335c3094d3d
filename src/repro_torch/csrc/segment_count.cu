// Sorted-run sweeps over sorted k-mer words: run-start flags alone, and
// the fused run-boundary and run-total sweep.
//
// Replaces the TPU kernels in src/repro/kernels/segment_count.py:
//   segment_boundaries_pallas (_segment_kernel), reached through
//     sort.accumulate(boundaries_impl='kernel');
//   segment_accumulate_pallas (_segment_accum_kernel), used by every
//     accumulate on the counting path (the L3 compressors and the final
//     store histogram).
//
// Run-start flags (segment_boundaries): bound by bytes, 8 B read and 1 B
// written per element. The TPU kernel reads its tile and the tile before
// it, for the one word that precedes its first element; here each thread
// compares its word with the one before (the cache serves that read), and
// index 0 of a row compares with the sentinel. No padding and no tile.
//
// Fused sweep (segment_accumulate): bound by bytes. Per element it reads
// one 8 B word (its neighbours come from the cache) and one 4 B weight
// (none when every valid key weighs 1); it writes two 1 B flags and one
// 4 B total, or, compacting, the key and count of each run at its slot.
// The work is a compare and an add.
//
// Design: the TPU kernel carries the open run's sum from tile to tile in a
// scalar cell, which is exact only because a TPU grid runs in order. GPU
// blocks run in any order, so run totals come from a segmented scan over
// (run starts, weight since the latest start) pairs, in ONE launch with a
// decoupled look-back (single pass, Merrill and Garland):
// - A block takes its tile from a ticket, so tiles start in order and a
//   block only ever waits on tiles that started before it. The ticket
//   counter is one 64-bit word, the launch's epoch above its tickets: one
//   atomicAdd returns both, and the block that takes the launch's last
//   ticket moves the word on to the next epoch with ticket 0.
// - Each block reduces its 1024 elements (4 a thread, 16-byte loads),
//   publishes the aggregate, then warp 0 walks back over its row's earlier
//   tiles 32 at a time until it meets one that has published its
//   inclusive prefix, and publishes its own.
// - A tile's descriptor is an 8-byte tag and two 8-byte values (aggregate
//   and inclusive prefix, each a 32-bit start count and a 32-bit sum). A
//   value is written before its tag with release order and read after it
//   with acquire order, and the two values never share a word, so a
//   reader that saw a tag reads the value it names. The tag holds the
//   launch's epoch (plus one, so a zeroed tag never matches): a tag left
//   by one of the 2**32 - 1 launches before never matches, and nothing is
//   cleared between launches. The device holds all of this state, so a
//   replayed CUDA graph stays right.
// - The compacting mode (sort.accumulate(impl='fused')) writes, from the
//   same scan, a run start's key and a run end's total at slot (run starts
//   through it) - 1, and the row's last element writes the row's run count;
//   the caller fills the slots past it. The flags mode writes is_new,
//   is_end and the totals at run ends. A template argument picks the mode.
// Sums are taken as unsigned 32-bit values and wrap as int32 sums do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 1024;               // elements per tile
constexpr int kThreads = 256;
constexpr int kItems = kBlock / kThreads;  // consecutive elements a thread
constexpr int kWarps = kThreads / 32;

struct Seg {
  unsigned c;  // run starts in the span
  unsigned v;  // weight summed since the latest run start in the span
};

__device__ __forceinline__ Seg combine(Seg a, Seg b) {
  return Seg{a.c + b.c, b.c ? b.v : a.v + b.v};
}

__device__ __forceinline__ uint64_t pack(Seg s) {
  return (uint64_t)s.v << 32 | s.c;
}

__device__ __forceinline__ Seg unpack(uint64_t x) {
  return Seg{(unsigned)x, (unsigned)(x >> 32)};
}

__device__ __forceinline__ uint64_t ld_acquire(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ uint64_t ld_relaxed(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(uint64_t* p, uint64_t v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ void st_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ Seg shfl_up(Seg x, int o) {
  return Seg{__shfl_up_sync(0xffffffffu, x.c, o),
             __shfl_up_sync(0xffffffffu, x.v, o)};
}

__device__ __forceinline__ Seg shfl_xor(Seg x, int o) {
  return Seg{__shfl_xor_sync(0xffffffffu, x.c, o),
             __shfl_xor_sync(0xffffffffu, x.v, o)};
}

// Exclusive segmented scan across the block; *total gets the block's
// aggregate. Every thread of the block must call it.
__device__ Seg block_exclusive(Seg x, Seg* total) {
  __shared__ Seg warp_tot[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Seg inc = x;
  for (int o = 1; o < 32; o <<= 1) {
    const Seg y = shfl_up(inc, o);
    if (lane >= o) inc = combine(y, inc);
  }
  Seg exc = shfl_up(inc, 1);
  if (lane == 0) exc = Seg{0u, 0u};
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  Seg before{0u, 0u}, all{0u, 0u};
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before = combine(before, warp_tot[w]);
    all = combine(all, warp_tot[w]);
  }
  *total = all;
  return combine(before, exc);
}

// The (run starts, run sum) prefix of every tile of the row before tile
// `g` (a row's tiles are consecutive in g; `first` is the row's first).
// Called by warp 0 after tile g published its aggregate; the lanes read
// 32 earlier tiles at a time, nearest in lane 0. `want`: this launch's
// tag, flag bit clear.
__device__ Seg look_back(const uint64_t* tags, const uint64_t* agg,
                         const uint64_t* inc, int64_t g, int64_t first,
                         uint64_t want) {
  const int lane = threadIdx.x & 31;
  Seg excl{0u, 0u};
  for (int64_t top = g - 1;; top -= 32) {
    const int64_t p = top - lane;
    const bool in_row = p >= first;
    uint64_t tag = 0;
    bool ready;
    do {
      if (in_row) tag = ld_acquire(tags + p);
      ready = !in_row || (tag | 1) == (want | 1);
    } while (!__all_sync(0xffffffffu, ready));
    const bool done = !in_row || (tag & 1);  // an inclusive prefix
    Seg v{0u, 0u};
    if (in_row) v = unpack(ld_relaxed((done ? inc : agg) + p));
    const unsigned found = __ballot_sync(0xffffffffu, done);
    if (found && lane > __ffs(found) - 1) v = Seg{0u, 0u};
    // Lane 31 holds the earliest tile, lane 0 the latest: combine in that
    // order over the butterfly.
    for (int o = 1; o < 32; o <<= 1) {
      const Seg y = shfl_xor(v, o);
      v = (lane & o) ? combine(v, y) : combine(y, v);
    }
    excl = combine(v, excl);
    if (found) return excl;
  }
}

// keys, w (rows, n); w may be null: every valid key weighs 1. ctr: the
// epoch (high 32 bits) and the launch's tickets (low 32); tags / agg /
// inc: one per tile.
template <bool kCompact>
__global__ void __launch_bounds__(kThreads)
segment_accumulate_kernel(const int64_t* __restrict__ keys,
                          const int32_t* __restrict__ w, int64_t n,
                          int64_t sent, int n_tiles, int64_t total_tiles,
                          unsigned long long* ctr, uint64_t* tags,
                          uint64_t* agg, uint64_t* inc,
                          uint8_t* __restrict__ is_new_out,
                          uint8_t* __restrict__ is_end_out,
                          int32_t* __restrict__ run_tot_out,
                          int64_t* __restrict__ unique,
                          int32_t* __restrict__ counts,
                          int32_t* __restrict__ num_unique) {
  __shared__ unsigned long long s_ticket;
  __shared__ Seg s_prefix;
  if (threadIdx.x == 0) {
    const unsigned long long t = atomicAdd(ctr, 1ull);
    if ((unsigned)t == (unsigned)total_tiles - 1)   // the launch's last
      atomicAdd(ctr, (1ull << 32) - (unsigned long long)total_tiles);
    s_ticket = t;
  }
  __syncthreads();
  const int64_t g = (unsigned)s_ticket;
  const uint64_t tag = ((s_ticket >> 32) + 1) << 1;
  const int64_t row = g / n_tiles;
  const int tile = (int)(g - row * n_tiles);
  const int64_t i0 = (int64_t)tile * kBlock + threadIdx.x * kItems;
  const int64_t* kr = keys + row * n;
  const int32_t* wr = w ? w + row * n : nullptr;

  int64_t k[kItems];
  unsigned wt[kItems];
  const bool full = (int64_t)(tile + 1) * kBlock <= n;
  if (full && ((uintptr_t)(kr + i0) & 15) == 0 &&
      (!wr || ((uintptr_t)(wr + i0) & 15) == 0)) {
    const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(kr + i0));
    const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(kr + i0) + 1);
    k[0] = a.x, k[1] = a.y, k[2] = b.x, k[3] = b.y;
    if (wr) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(wr + i0));
      wt[0] = v.x, wt[1] = v.y, wt[2] = v.z, wt[3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const bool in = i0 + j < n;
      k[j] = in ? kr[i0 + j] : sent;
      if (wr) wt[j] = in ? (unsigned)wr[i0 + j] : 0u;
    }
  }
  if (!wr) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) wt[j] = 1u;
  }
  const int64_t prev = i0 > 0 && i0 <= n ? kr[i0 - 1] : sent;
  const int64_t next = i0 + kItems < n ? kr[i0 + kItems] : sent;
  bool is_new[kItems], is_end[kItems];
  Seg mine{0u, 0u};
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const bool valid = k[j] != sent;
    is_new[j] = valid && k[j] != (j ? k[j - 1] : prev);
    is_end[j] = valid && k[j] != (j + 1 < kItems ? k[j + 1] : next);
    if (!valid) wt[j] = 0u;
    mine = combine(mine, Seg{is_new[j] ? 1u : 0u, wt[j]});
  }
  Seg total;
  Seg run = block_exclusive(mine, &total);

  if (threadIdx.x < 32) {
    Seg excl{0u, 0u};
    if (tile == 0) {
      if (threadIdx.x == 0) {
        st_relaxed(inc + g, pack(total));
        st_release(tags + g, tag | 1);
      }
    } else {
      if (threadIdx.x == 0) {
        st_relaxed(agg + g, pack(total));
        st_release(tags + g, tag);
      }
      excl = look_back(tags, agg, inc, g, g - tile, tag);
      if (threadIdx.x == 0) {
        st_relaxed(inc + g, pack(combine(excl, total)));
        st_release(tags + g, tag | 1);
      }
    }
    if (threadIdx.x == 0) s_prefix = excl;
  }
  __syncthreads();
  run = combine(s_prefix, run);

  int32_t tot[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    run = combine(run, Seg{is_new[j] ? 1u : 0u, wt[j]});
    tot[j] = is_end[j] ? (int32_t)run.v : 0;
    if (kCompact && i0 + j < n) {
      const int64_t slot = row * n + (int64_t)run.c - 1;
      if (is_new[j]) unique[slot] = k[j];
      if (is_end[j]) counts[slot] = tot[j];
      if (i0 + j == n - 1) num_unique[row] = (int32_t)run.c;
    }
  }
  if (kCompact) return;
  const int64_t o = row * n + i0;
  if (full && ((uintptr_t)(is_new_out + o) & 3) == 0 &&
      ((uintptr_t)(run_tot_out + o) & 15) == 0) {
    uchar4 a, b;
    a.x = is_new[0], a.y = is_new[1], a.z = is_new[2], a.w = is_new[3];
    b.x = is_end[0], b.y = is_end[1], b.z = is_end[2], b.w = is_end[3];
    *reinterpret_cast<uchar4*>(is_new_out + o) = a;
    *reinterpret_cast<uchar4*>(is_end_out + o) = b;
    *reinterpret_cast<int4*>(run_tot_out + o) =
        make_int4(tot[0], tot[1], tot[2], tot[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (i0 + j < n) {
        is_new_out[o + j] = is_new[j];
        is_end_out[o + j] = is_end[j];
        run_tot_out[o + j] = tot[j];
      }
    }
  }
}

__global__ void boundaries_kernel(const int64_t* __restrict__ keys,
                                  int64_t n, int64_t sent,
                                  uint8_t* __restrict__ is_new) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t* row = keys + (int64_t)blockIdx.y * n;
  const int64_t k = row[i];
  const int64_t prev = i > 0 ? row[i - 1] : sent;
  is_new[(int64_t)blockIdx.y * n + i] = k != sent && k != prev;
}

}  // namespace

extern "C" int segment_block() { return kBlock; }

// keys (rows, n) int64 sorted per row -> is_new (rows, n) bool.
extern "C" int segment_boundaries_launch(const void* keys, int64_t rows,
                                         int64_t n, int64_t sent,
                                         void* is_new, void* stream) {
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 0x7fffffff || rows > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)rows);
  boundaries_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)keys, n, sent, (uint8_t*)is_new);
  return (int)cudaGetLastError();
}

// keys (rows, n) int64 sorted per row, w (rows, n) int32 or null (every
// valid key weighs 1); state: ctr (1,) uint64, tags / agg / inc (>= rows *
// ceil(n / block),) uint64, ctr and tags zero at first use and left
// consistent by every launch. compact = 0: is_new, is_end (rows, n) bool
// and run_tot (rows, n) int32; compact = 1: the run keys and totals at
// their slots of unique (rows, n) int64 and counts (rows, n) int32, and
// num_unique (rows,) int32 (slots past it are not written).
extern "C" int segment_accumulate_launch(const void* keys, const void* w,
                                         int64_t rows, int64_t n,
                                         int64_t sent, int compact,
                                         void* ctr, void* tags, void* agg,
                                         void* inc, void* out0, void* out1,
                                         void* out2, void* stream) {
  const int n_tiles = (int)((n + kBlock - 1) / kBlock);
  const int64_t total = rows * n_tiles;
  if (total > 0x7fffffff) return (int)cudaErrorInvalidValue;  // tickets
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t* k = (const int64_t*)keys;
  const int32_t* wt = (const int32_t*)w;
  unsigned long long* c = (unsigned long long*)ctr;
  if (compact) {
    segment_accumulate_kernel<true><<<(unsigned)total, kThreads, 0, s>>>(
        k, wt, n, sent, n_tiles, total, c, (uint64_t*)tags, (uint64_t*)agg,
        (uint64_t*)inc, nullptr, nullptr, nullptr, (int64_t*)out0,
        (int32_t*)out1, (int32_t*)out2);
  } else {
    segment_accumulate_kernel<false><<<(unsigned)total, kThreads, 0, s>>>(
        k, wt, n, sent, n_tiles, total, c, (uint64_t*)tags, (uint64_t*)agg,
        (uint64_t*)inc, (uint8_t*)out0, (uint8_t*)out1, (int32_t*)out2,
        nullptr, nullptr, nullptr);
  }
  return (int)cudaGetLastError();
}
