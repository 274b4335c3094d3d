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
//   Within a warp, __match_any_sync groups the lanes holding the same
//   bucket and the popcount of the lower peers is the lane's rank. The
//   lowest peer writes the warp's count per bucket to shared memory, and
//   an exclusive scan over the 32 warps turns those into warp offsets. So
//   every element's rank is its order among equal buckets in its tile,
//   which makes the partition stable and bit-equal to a stable argsort.
// - The (tile, bucket) base offsets (exclusive prefix, bucket-major then
//   tile-major) are computed between the two launches by plain tensor
//   code, as the TPU version leaves them to XLA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;           // elements per block, one per thread
constexpr int kWarps = kTile / 32;

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

__global__ void bucket_positions_kernel(const int32_t* __restrict__ buckets,
                                        const int32_t* __restrict__ base,
                                        int64_t n, int num_buckets,
                                        int n_tiles,
                                        int32_t* __restrict__ pos) {
  extern __shared__ int32_t warp_counts[];  // [kWarps][num_buckets]
  const int64_t row = blockIdx.y;
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < kWarps * num_buckets; j += blockDim.x)
    warp_counts[j] = 0;
  __syncthreads();

  const int64_t i = (int64_t)tile * kTile + threadIdx.x;
  int b = i < n ? buckets[row * n + i] : -1;
  const bool live = (unsigned)b < (unsigned)num_buckets;
  if (!live) b = -1 - lane;  // a group of its own, never a real bucket
  const unsigned peers = __match_any_sync(0xffffffffu, b);
  const unsigned lower = peers & ((1u << lane) - 1u);
  const int rank = __popc(lower);
  if (live && lower == 0) warp_counts[warp * num_buckets + b] = __popc(peers);
  __syncthreads();

  for (int bb = threadIdx.x; bb < num_buckets; bb += blockDim.x) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_counts[w * num_buckets + bb];
      warp_counts[w * num_buckets + bb] = run;
      run += c;
    }
  }
  __syncthreads();

  if (live) {
    pos[row * n + i] = base[(row * n_tiles + tile) * num_buckets + b] +
                       warp_counts[warp * num_buckets + b] + rank;
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
  bucket_hist_kernel<<<grid, kTile, smem, (cudaStream_t)stream>>>(
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
  const size_t smem = (size_t)kWarps * num_buckets * sizeof(int32_t);
  bucket_positions_kernel<<<grid, kTile, smem, (cudaStream_t)stream>>>(
      (const int32_t*)buckets, (const int32_t*)base, n, num_buckets, n_tiles,
      (int32_t*)pos);
  return (int)cudaGetLastError();
}
