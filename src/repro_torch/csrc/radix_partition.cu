// Stable bucket partition: per-tile histogram (with the plan's prefix) and
// stable destination slot.
//
// Replaces the TPU kernels in src/repro/kernels/radix_partition.py:
//   bucket_hist_pallas      (_bucket_hist_kernel)
//   bucket_positions_pallas (_bucket_pos_kernel)
// on every radix-sort pass and every route of the counting path.
//
// Bound: bytes. Each element is read once by each kernel (4 B id) and one
// 4 B position is written; the histogram and its prefix are a few int32 per
// 1024 elements. There is no arithmetic to speak of, so the floor is
// device-memory bandwidth, and at the main path's shapes (tens of thousands
// of elements per launch) launch latency dominates instead: a partition
// plan is two launches, the histogram with its prefix and the ranks.
//
// Design:
// - One block per (tile of 1024 elements, row); a row is one processing
//   element, so all PEs of a step partition in one launch.
// - The histogram: 256 threads, each with one 16-byte load of 4 ids,
//   count into one shared row with shared atomics. (On the H100, at B = 2,
//   9 and 257, 512 threads of 2 ids and 1024 of 1 were slower, and so
//   were counting a warp's equal ids first, by __match_any_sync or by one
//   ballot a bucket.)
// - The prefix, in the same launch, where a row's (tiles, B) table fits
//   one block's shared memory: each block writes its tile's counts, then
//   takes a ticket on its row (a counter that atomicInc brings back to 0
//   with the row's last ticket, so no launch clears it). The block with
//   the last ticket reads the row's counts into shared memory, bucket-
//   major, and writes, in their place, each (tile, bucket)'s base: the
//   exclusive prefix in bucket-major, then tile-major order, as one scan
//   in chunks of consecutive cells per thread; and the row's per-bucket
//   totals and starts (a bucket's start is its tile-0 base). Larger rows
//   get the plain counts and the prefix in tensor code.
// - The stable rank must not come from atomics, whose order is not fixed.
//   The rank kernel covers a tile with 8 warps of 4 elements a lane: it
//   stages the tile in shared memory with 16-byte loads (and the tile's B
//   bases with cp.async, which land while it ranks), and warp w ranks
//   elements [128w, 128w + 128) in 4 passes of 32, in order. In a pass,
//   __match_any_sync groups the lanes holding the same bucket and the
//   popcount of the lower peers is the lane's rank in the pass; each warp
//   keeps a running count per bucket in its own row of an (8, B) table in
//   shared memory, so a lane's rank in its warp is that count plus its
//   rank in the pass. An exclusive scan over the 8 warps, started at the
//   tile's base, turns the table into each warp's first slot per bucket.
//   So every element's slot follows its order among equal buckets in its
//   tile, which makes the partition stable and bit-equal to a stable
//   argsort. Ids outside [0, B) are not counted, get no slot and write
//   nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;           // elements per block
constexpr int kHistThreads = 256;     // the histogram: 4 ids a thread
constexpr int kPosThreads = 256;      // the ranks: 8 warps of 4 passes
constexpr int kPosWarps = kPosThreads / 32;
constexpr int kPerWarp = kTile / kPosWarps;
constexpr int kPasses = kPerWarp / 32;
// The prefix's table: at most 48 KB less 1 KB of int32 cells (the
// wrapper's PREFIX_MAX_CELLS), so each thread loads at most this many.
constexpr int kPrefixCells = (48 - 1) * 1024 / 4;
constexpr int kPrefixLoads = (kPrefixCells + kHistThreads - 1) / kHistThreads;

// Exclusive sum across a block of kHistThreads threads; *total gets the
// block's sum. Every thread of the block must call it.
__device__ int block_exclusive_sum(int x, int* total) {
  __shared__ int warp_sums[kHistThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < kHistThreads / 32; ++w) {
    before += w < warp ? warp_sums[w] : 0;
    all += warp_sums[w];
  }
  *total = all;
  return before + inc - x;
}

// ids (rows, n) -> hist (rows, n_tiles, B): each tile's counts, or with
// kPrefix each (tile, bucket)'s base, and totals / starts (rows, B).
template <bool kPrefix>
__global__ void __launch_bounds__(kHistThreads)
bucket_hist_kernel(const int32_t* __restrict__ buckets, int64_t n,
                   int num_buckets, int n_tiles, int32_t* hist,
                   int32_t* __restrict__ totals,
                   int32_t* __restrict__ starts,
                   unsigned* __restrict__ tickets) {
  extern __shared__ int32_t cells[];  // [B] counts; then the row's [B][T]
  __shared__ bool last;
  const int64_t row = blockIdx.y;
  const int tile = blockIdx.x;
  for (int b = threadIdx.x; b < num_buckets; b += kHistThreads) cells[b] = 0;
  const int64_t first = (int64_t)tile * kTile;
  const int len = n - first < kTile ? (int)(n - first) : kTile;
  const int32_t* src = buckets + row * n + first;
  int ids[4];
  if (len == kTile && ((uintptr_t)src & 15) == 0) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(src) + threadIdx.x);
    ids[0] = v.x, ids[1] = v.y, ids[2] = v.z, ids[3] = v.w;
  } else {  // a ragged last tile, or a row that starts mid-way into 16 bytes
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 4 * threadIdx.x + j;
      ids[j] = i < len ? src[i] : -1;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if ((unsigned)ids[j] < (unsigned)num_buckets) atomicAdd(&cells[ids[j]], 1);
  __syncthreads();
  int32_t* row_hist = hist + row * n_tiles * num_buckets;
  for (int b = threadIdx.x; b < num_buckets; b += kHistThreads)
    row_hist[tile * num_buckets + b] = cells[b];
  if (!kPrefix) return;

  // Every thread's counts reach the device before its block's ticket.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicInc(&tickets[row], n_tiles - 1) == (unsigned)(n_tiles - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The row's counts, transposed to bucket-major: cell (t, b) at
  // cells[b * T + t]. Each thread issues all its loads from the L2 at
  // once (up to kPrefixLoads), and steps through (t, b) by the block's
  // stride without dividing.
  const int n_cells = n_tiles * num_buckets;
  const int step_t = kHistThreads / num_buckets;
  const int step_b = kHistThreads % num_buckets;
  const int t0 = (int)threadIdx.x / num_buckets;
  const int b0 = (int)threadIdx.x % num_buckets;
  int v[kPrefixLoads];
#pragma unroll
  for (int u = 0; u < kPrefixLoads; ++u) {
    const int c = threadIdx.x + u * kHistThreads;
    v[u] = c < n_cells ? __ldcg(row_hist + c) : 0;
  }
  int ct = t0, cb = b0;  // the (tile, bucket) of the thread's next cell
#pragma unroll
  for (int u = 0; u < kPrefixLoads; ++u) {
    if (threadIdx.x + u * kHistThreads < n_cells)
      cells[cb * n_tiles + ct] = v[u];
    ct += step_t, cb += step_b;
    if (cb >= num_buckets) cb -= num_buckets, ++ct;
  }
  __syncthreads();
  // One exclusive scan of the bucket-major sequence: thread j takes cells
  // [j * per, (j + 1) * per), an odd count so that a warp's threads read
  // 32 different banks.
  const int per = ((n_cells + kHistThreads - 1) / kHistThreads) | 1;
  const int f0 = min((int)threadIdx.x * per, n_cells);
  const int f1 = min(f0 + per, n_cells);
  int sum = 0;
  for (int f = f0; f < f1; ++f) sum += cells[f];
  int row_total;
  int run = block_exclusive_sum(sum, &row_total);
  for (int f = f0; f < f1; ++f) {
    const int c = cells[f];
    cells[f] = run;
    run += c;
  }
  __syncthreads();
  ct = t0, cb = b0;
  for (int c = threadIdx.x; c < n_cells; c += kHistThreads) {
    row_hist[c] = cells[cb * n_tiles + ct];
    ct += step_t, cb += step_b;
    if (cb >= num_buckets) cb -= num_buckets, ++ct;
  }
  for (int b = threadIdx.x; b < num_buckets; b += kHistThreads) {
    const int start = cells[b * n_tiles];
    const int next = b + 1 < num_buckets ? cells[(b + 1) * n_tiles]
                                         : row_total;
    starts[row * num_buckets + b] = start;
    totals[row * num_buckets + b] = next - start;
  }
}

__global__ void __launch_bounds__(kPosThreads)
bucket_positions_kernel(const int32_t* __restrict__ buckets,
                        const int32_t* __restrict__ base, int64_t n,
                        int num_buckets, int n_tiles,
                        int32_t* __restrict__ pos) {
  __shared__ __align__(16) int32_t ids[kTile];
  extern __shared__ int32_t table[];  // [kPosWarps][num_buckets], bases
  int32_t* tile_base = table + kPosWarps * num_buckets;
  const int64_t row = blockIdx.y;
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t first = (int64_t)tile * kTile;
  const int len = n - first < kTile ? (int)(n - first) : kTile;
  const int32_t* src = buckets + row * n + first;
  // The tile's bases are fetched first: their copy overlaps the ranking.
  const int32_t* base_src = base + (row * n_tiles + tile) * num_buckets;
  for (int b = threadIdx.x; b < num_buckets; b += kPosThreads) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(tile_base + b);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(base_src + b));
  }
  for (int j = threadIdx.x; j < kPosWarps * num_buckets; j += kPosThreads)
    table[j] = 0;
  if (len == kTile && ((uintptr_t)src & 15) == 0) {
    reinterpret_cast<int4*>(ids)[threadIdx.x] =
        __ldg(reinterpret_cast<const int4*>(src) + threadIdx.x);
  } else {  // a ragged last tile, or a row that starts mid-way into 16 bytes
    for (int j = threadIdx.x; j < kTile; j += kPosThreads)
      ids[j] = j < len ? src[j] : -1;
  }
  __syncthreads();

  int32_t* mine = table + warp * num_buckets;
  const unsigned below = (1u << lane) - 1u;
  int bucket[kPasses], rank[kPasses];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    int b = ids[warp * kPerWarp + p * 32 + lane];
    const bool live = (unsigned)b < (unsigned)num_buckets;
    if (!live) b = -1 - lane;  // a group of its own, never a real bucket
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    const unsigned lower = peers & below;
    const int before = live ? mine[b] : 0;  // this warp's earlier passes
    __syncwarp();
    if (live && lower == 0) mine[b] = before + __popc(peers);
    __syncwarp();
    bucket[p] = live ? b : -1;
    rank[p] = before + __popc(lower);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  for (int b = threadIdx.x; b < num_buckets; b += kPosThreads) {
    int run = tile_base[b];
#pragma unroll
    for (int w = 0; w < kPosWarps; ++w) {
      const int c = table[w * num_buckets + b];
      table[w * num_buckets + b] = run;
      run += c;
    }
  }
  __syncthreads();

  int32_t* dst = pos + row * n + first;
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    if (bucket[p] >= 0)
      dst[warp * kPerWarp + p * 32 + lane] = mine[bucket[p]] + rank[p];
  }
}

}  // namespace

extern "C" int partition_tile() { return kTile; }
extern "C" int partition_prefix_cells() { return kPrefixCells; }

// buckets (rows, n) int32 -> hist (rows, ceil(n / tile), num_buckets)
// int32 counts.
extern "C" int bucket_hist_launch(const void* buckets, int64_t rows,
                                  int64_t n, int num_buckets, void* hist,
                                  void* stream) {
  const int n_tiles = (int)((n + kTile - 1) / kTile);
  const dim3 grid(n_tiles, (unsigned)rows);
  const size_t smem = (size_t)num_buckets * sizeof(int32_t);
  bucket_hist_kernel<false><<<grid, kHistThreads, smem,
                              (cudaStream_t)stream>>>(
      (const int32_t*)buckets, n, num_buckets, n_tiles, (int32_t*)hist,
      nullptr, nullptr, nullptr);
  return (int)cudaGetLastError();
}

// buckets (rows, n) int32 -> base (rows, n_tiles, num_buckets), totals and
// starts (rows, num_buckets) int32; tickets: (rows,) uint32, zero between
// launches (each launch leaves them zero). A row's n_tiles * num_buckets
// int32 cells must fit the 48 KB of shared memory a launch gets without
// opting in, beside the kernel's static shared memory.
extern "C" int bucket_prefix_launch(const void* buckets, int64_t rows,
                                    int64_t n, int num_buckets, void* base,
                                    void* totals, void* starts,
                                    void* tickets, void* stream) {
  const int n_tiles = (int)((n + kTile - 1) / kTile);
  const dim3 grid(n_tiles, (unsigned)rows);
  const size_t smem = (size_t)n_tiles * num_buckets * sizeof(int32_t);
  bucket_hist_kernel<true><<<grid, kHistThreads, smem,
                             (cudaStream_t)stream>>>(
      (const int32_t*)buckets, n, num_buckets, n_tiles, (int32_t*)base,
      (int32_t*)totals, (int32_t*)starts, (unsigned*)tickets);
  return (int)cudaGetLastError();
}

// buckets (rows, n) int32, base (rows, n_tiles, num_buckets) int32
//   -> pos (rows, n) int32
extern "C" int bucket_positions_launch(const void* buckets, const void* base,
                                       int64_t rows, int64_t n,
                                       int num_buckets, void* pos,
                                       void* stream) {
  const int n_tiles = (int)((n + kTile - 1) / kTile);
  const dim3 grid(n_tiles, (unsigned)rows);
  const size_t smem = (size_t)(kPosWarps + 1) * num_buckets * sizeof(int32_t);
  bucket_positions_kernel<<<grid, kPosThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)buckets, (const int32_t*)base, n, num_buckets, n_tiles,
      (int32_t*)pos);
  return (int)cudaGetLastError();
}
