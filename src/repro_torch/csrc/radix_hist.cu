// Radix digit histogram: per-tile counts of one digit of every key.
//
// Replaces the TPU kernel in src/repro/kernels/radix_hist.py:
//   radix_hist_pallas (_radix_hist_kernel)
// hist[r, t, d] = #{i in tile t of row r : (key_i >> shift) & (2**bits - 1)
// == d}, the shift logical on the unsigned 64-bit word. A shift of 64 or
// more gives digit 0, as the JAX package's unsigned shift does; C++ leaves
// such a shift undefined, so it is tested for.
//
// Bound: bytes. Each 8 B key is read once; the output is 2**bits int32 per
// tile, a few hundredths of the input at the default 4-bit digit and
// 1024-key tile.
//
// Design: the TPU kernel sums one masked comparison per digit value over
// its tile, scatter-free, as its vector unit prefers. Here a block takes a
// chunk of at most kChunk keys of one tile (a tile above kChunk keys is
// split over several blocks) and counts with shared-memory atomics. Up to
// 256 bins every warp counts into a copy of its own, so lanes that hit one
// bin contend only within their warp; larger digits share one copy. The
// block then sums its copies and stores them; where a tile spans several
// blocks, each adds its sums into the zeroed output with one global atomic
// per bin, so those blocks need no order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 4096;           // keys per block at most
constexpr int kPerWarpBins = 256;      // largest radix with per-warp copies
// 2**13 int32 bins fill 32 KB of shared memory; equals MAX_DIGIT_BITS in
// kernels/radix_hist.py.
constexpr int kMaxBits = 13;

__global__ void __launch_bounds__(kThreads)
radix_hist_kernel(const uint64_t* __restrict__ keys, int64_t n, int shift,
                  int bits, int64_t tile, int chunks_per_tile, int copies,
                  int32_t* __restrict__ hist) {
  extern __shared__ int32_t bins[];      // [copies][radix]
  const int radix = 1 << bits;
  const int64_t row = blockIdx.y;
  const int64_t t = blockIdx.x / chunks_per_tile;
  const int64_t lo =
      t * tile + (int64_t)(blockIdx.x % chunks_per_tile) * kChunk;
  const int64_t end = (t + 1) * tile;
  const int64_t hi = lo + kChunk < end ? lo + kChunk : end;
  for (int j = threadIdx.x; j < copies * radix; j += kThreads) bins[j] = 0;
  __syncthreads();

  int32_t* mine = bins + (copies > 1 ? (threadIdx.x >> 5) * radix : 0);
  const uint64_t* src = keys + row * n;
  const uint64_t digit_mask = (uint64_t)radix - 1;
#pragma unroll 4
  for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
    const uint64_t d = shift < 64 ? (src[i] >> shift) & digit_mask : 0;
    atomicAdd(&mine[d], 1);
  }
  __syncthreads();

  int32_t* out = hist + (row * (n / tile) + t) * radix;
  for (int d = threadIdx.x; d < radix; d += kThreads) {
    int32_t total = 0;
    for (int c = 0; c < copies; ++c) total += bins[c * radix + d];
    if (chunks_per_tile == 1) {
      out[d] = total;
    } else if (total) {
      atomicAdd(&out[d], total);
    }
  }
}

}  // namespace

// keys (rows, n) 64-bit words, n % tile == 0; hist (rows, n / tile,
// 2**bits) int32, zeroed by the caller. 1 <= bits <= 13, shift >= 0.
extern "C" int radix_hist_launch(const void* keys, int64_t rows, int64_t n,
                                 int shift, int bits, int64_t tile,
                                 void* hist, void* stream) {
  if (bits < 1 || bits > kMaxBits || shift < 0 || tile < 1
      || n % tile != 0)
    return (int)cudaErrorInvalidValue;
  const int radix = 1 << bits;
  const int copies = radix <= kPerWarpBins ? kWarps : 1;
  const int64_t chunks = (tile + kChunk - 1) / kChunk;
  const int64_t blocks = (n / tile) * chunks;
  if (blocks > 0x7fffffff || rows > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)rows);
  radix_hist_kernel<<<grid, kThreads, (size_t)copies * radix * sizeof(int32_t),
                      (cudaStream_t)stream>>>(
      (const uint64_t*)keys, n, shift, bits, tile, (int)chunks, copies,
      (int32_t*)hist);
  return (int)cudaGetLastError();
}
