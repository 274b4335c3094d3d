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
// Fused sweep (segment_accumulate): bound by bytes. Per element it reads one 8 B word (and its neighbours,
// which the cache serves) and one 4 B weight, and writes two 1 B flags and
// one 4 B total; the work is a compare and an add.
//
// Design: the TPU kernel carries the open run's sum from tile to tile in a
// scalar cell, which is exact only because a TPU grid runs in order. GPU
// blocks run in any order, so run totals come from a segmented scan over
// (is_new, weight) pairs in three launches:
//   1. each block scans its 1024 elements and writes its aggregate;
//   2. one block per row scans the block aggregates in order (inclusive);
//   3. each block scans again, combines the aggregate of all blocks before
//      it into the elements whose run began in an earlier block, and
//      writes the flags and the totals at run ends.
// Flags read their neighbours with bounds checks, so no padding is needed.
// Sums are taken as unsigned 32-bit values and wrap as int32 sums do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 1024;

struct Seg {
  int f;       // a run starts at or before this point (within the span)
  unsigned v;  // weight summed since the latest run start in the span
};

__device__ __forceinline__ Seg combine(Seg a, Seg b) {
  return Seg{a.f | b.f, b.f ? b.v : a.v + b.v};
}

// Inclusive segmented scan across the block; *total gets the block's
// aggregate. Every thread of the block must call it.
__device__ Seg block_seg_scan(Seg x, Seg* total) {
  __shared__ int sf[32];
  __shared__ unsigned sv[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int f2 = __shfl_up_sync(0xffffffffu, x.f, o);
    const unsigned v2 = __shfl_up_sync(0xffffffffu, x.v, o);
    if (lane >= o) x = combine(Seg{f2, v2}, x);
  }
  if (lane == 31) {
    sf[warp] = x.f;
    sv[warp] = x.v;
  }
  __syncthreads();
  if (warp == 0) {
    Seg y = lane < n_warps ? Seg{sf[lane], sv[lane]} : Seg{0, 0u};
    for (int o = 1; o < 32; o <<= 1) {
      const int f2 = __shfl_up_sync(0xffffffffu, y.f, o);
      const unsigned v2 = __shfl_up_sync(0xffffffffu, y.v, o);
      if (lane >= o) y = combine(Seg{f2, v2}, y);
    }
    sf[lane] = y.f;
    sv[lane] = y.v;
  }
  __syncthreads();
  if (warp > 0) x = combine(Seg{sf[warp - 1], sv[warp - 1]}, x);
  *total = Seg{sf[n_warps - 1], sv[n_warps - 1]};
  __syncthreads();  // the shared cells are reused by the next call
  return x;
}

struct Elem {
  bool is_new, is_end;
  Seg s;
};

__device__ __forceinline__ Elem load_elem(const int64_t* __restrict__ keys,
                                          const int32_t* __restrict__ w,
                                          int64_t n, int64_t i, int64_t sent) {
  Elem e{false, false, Seg{0, 0u}};
  if (i >= n) return e;
  const int64_t k = keys[i];
  const bool valid = k != sent;
  const int64_t prev = i > 0 ? keys[i - 1] : sent;
  const int64_t next = i + 1 < n ? keys[i + 1] : sent;
  e.is_new = valid && k != prev;
  e.is_end = valid && k != next;
  e.s = Seg{e.is_new ? 1 : 0, valid ? (unsigned)w[i] : 0u};
  return e;
}

__global__ void block_totals_kernel(const int64_t* __restrict__ keys,
                                    const int32_t* __restrict__ w, int64_t n,
                                    int64_t sent, int n_blocks,
                                    int32_t* __restrict__ blk_f,
                                    uint32_t* __restrict__ blk_v) {
  const int64_t row = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  const Elem e = load_elem(keys + row * n, w + row * n, n, i, sent);
  Seg total;
  block_seg_scan(e.s, &total);
  if (threadIdx.x == 0) {
    blk_f[row * n_blocks + blockIdx.x] = total.f;
    blk_v[row * n_blocks + blockIdx.x] = total.v;
  }
}

// One block per row: the block aggregates become inclusive prefixes, in
// place.
__global__ void carry_scan_kernel(int32_t* __restrict__ blk_f,
                                  uint32_t* __restrict__ blk_v,
                                  int n_blocks) {
  const int64_t off = (int64_t)blockIdx.x * n_blocks;
  Seg run{0, 0u};
  for (int start = 0; start < n_blocks; start += blockDim.x) {
    const int j = start + threadIdx.x;
    const Seg x = j < n_blocks ? Seg{blk_f[off + j], blk_v[off + j]}
                               : Seg{0, 0u};
    Seg total;
    const Seg inc = combine(run, block_seg_scan(x, &total));
    if (j < n_blocks) {
      blk_f[off + j] = inc.f;
      blk_v[off + j] = inc.v;
    }
    run = combine(run, total);
  }
}

__global__ void accumulate_kernel(const int64_t* __restrict__ keys,
                                  const int32_t* __restrict__ w, int64_t n,
                                  int64_t sent, int n_blocks,
                                  const int32_t* __restrict__ blk_f,
                                  const uint32_t* __restrict__ blk_v,
                                  uint8_t* __restrict__ is_new,
                                  uint8_t* __restrict__ is_end,
                                  int32_t* __restrict__ run_tot) {
  const int64_t row = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  const Elem e = load_elem(keys + row * n, w + row * n, n, i, sent);
  Seg total;
  Seg inc = block_seg_scan(e.s, &total);
  if (blockIdx.x > 0) {
    const int64_t prev = row * n_blocks + blockIdx.x - 1;
    inc = combine(Seg{blk_f[prev], blk_v[prev]}, inc);
  }
  if (i < n) {
    is_new[row * n + i] = e.is_new;
    is_end[row * n + i] = e.is_end;
    run_tot[row * n + i] = e.is_end ? (int32_t)inc.v : 0;
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

// keys (rows, n) int64 sorted per row, w (rows, n) int32;
// blk_f / blk_v: (rows, ceil(n / block)) int32 scratch;
// -> is_new, is_end (rows, n) bool, run_tot (rows, n) int32
extern "C" int segment_accumulate_launch(const void* keys, const void* w,
                                         int64_t rows, int64_t n,
                                         int64_t sent, void* blk_f,
                                         void* blk_v, void* is_new,
                                         void* is_end, void* run_tot,
                                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int n_blocks = (int)((n + kBlock - 1) / kBlock);
  const dim3 grid(n_blocks, (unsigned)rows);
  block_totals_kernel<<<grid, kBlock, 0, s>>>(
      (const int64_t*)keys, (const int32_t*)w, n, sent, n_blocks,
      (int32_t*)blk_f, (uint32_t*)blk_v);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  carry_scan_kernel<<<(unsigned)rows, kBlock, 0, s>>>(
      (int32_t*)blk_f, (uint32_t*)blk_v, n_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  accumulate_kernel<<<grid, kBlock, 0, s>>>(
      (const int64_t*)keys, (const int32_t*)w, n, sent, n_blocks,
      (const int32_t*)blk_f, (const uint32_t*)blk_v, (uint8_t*)is_new,
      (uint8_t*)is_end, (int32_t*)run_tot);
  return (int)cudaGetLastError();
}
