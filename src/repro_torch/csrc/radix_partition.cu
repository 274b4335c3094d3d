// Stable bucket partition: per-tile histogram and stable destination slot.
//
// Replaces the TPU kernels in src/repro/kernels/radix_partition.py:
//   bucket_hist_pallas      (_bucket_hist_kernel)
//   bucket_positions_pallas (_bucket_pos_kernel)
// on every radix-sort pass and every route of the counting path.
//
// Bound: bytes. Each element is read once by each kernel (4 B id) and one
// 4 B position is written; the histogram is a few int32 per 1024 elements.
// There is no arithmetic to speak of, so the floor is device-memory
// bandwidth, and at the main path's shapes (tens of thousands of elements
// per launch) launch latency dominates instead.
//
// Design:
// - One block per (tile of 1024 elements, row); a row is one processing
//   element, so all PEs of a step partition in one launch.
// - The histogram counts in shared memory with atomics; order does not
//   matter for a count.
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
//   argsort. Ids outside [0, B) get no slot and write nothing.
// - The (tile, bucket) base offsets (exclusive prefix, bucket-major then
//   tile-major) are computed between the two launches by plain tensor
//   code, as the TPU version leaves them to XLA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;           // elements per block
constexpr int kHistThreads = kTile;   // the histogram: one element a thread
constexpr int kPosThreads = 256;      // the ranks: 8 warps of 4 passes
constexpr int kPosWarps = kPosThreads / 32;
constexpr int kPerWarp = kTile / kPosWarps;
constexpr int kPasses = kPerWarp / 32;

__global__ void bucket_hist_kernel(const int32_t* __restrict__ buckets,
                                   int64_t n, int num_buckets, int n_tiles,
                                   int32_t* __restrict__ hist) {
  extern __shared__ int32_t counts[];
  const int64_t row = blockIdx.y;
  const int tile = blockIdx.x;
  for (int b = threadIdx.x; b < num_buckets; b += blockDim.x) counts[b] = 0;
  __syncthreads();
  const int64_t i = (int64_t)tile * kTile + threadIdx.x;
  if (i < n) {
    const int b = buckets[row * n + i];
    if ((unsigned)b < (unsigned)num_buckets) atomicAdd(&counts[b], 1);
  }
  __syncthreads();
  int32_t* out = hist + (row * n_tiles + tile) * num_buckets;
  for (int b = threadIdx.x; b < num_buckets; b += blockDim.x) out[b] = counts[b];
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

// buckets (rows, n) int32 -> hist (rows, ceil(n / tile), num_buckets) int32
extern "C" int bucket_hist_launch(const void* buckets, int64_t rows,
                                  int64_t n, int num_buckets, void* hist,
                                  void* stream) {
  const int n_tiles = (int)((n + kTile - 1) / kTile);
  const dim3 grid(n_tiles, (unsigned)rows);
  const size_t smem = (size_t)num_buckets * sizeof(int32_t);
  bucket_hist_kernel<<<grid, kHistThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)buckets, n, num_buckets, n_tiles, (int32_t*)hist);
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
