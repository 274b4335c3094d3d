// Shared by flash_attention.cu (forward) and flash_attention_bwd.cu
// (backward): the attention band, and the tile loads and thread layout of
// the f32 flash kernels (the bf16 kernels' tiles and fragments are in
// flash_wgmma.cuh).
//
// Every f32 flash kernel runs 16 x 16 threads. A thread owns RM rows of its
// block's row tile (rows ty * RM + i) and 4 columns of the 64-wide column
// tile (columns tx + 16 * j), so the 16 threads that share a row sit in one
// half of a warp and reduce a row with four xor shuffles. Tiles live in
// shared memory as f32 with a row stride of DP + 1 floats: DP is the head
// dimension rounded up to a power of two (zero-padded), and the odd stride
// puts the 16 rows that one load instruction reads into 16 banks.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kTx = 16;           // column lanes of a block
constexpr int kTy = 16;           // row lanes of a block
constexpr int kThreads = kTx * kTy;
constexpr int kCols = 4;          // columns per thread
constexpr int kBC = kTx * kCols;  // width of a column tile: 64
constexpr float kNegInf = -1e30f; // the TPU kernels' mask value

// Rows per thread: 4 (row tiles of 64), or 2 (of 32) at head dim 256, where
// tiles of 64 rows would not fit in shared memory.
template <int DP>
__host__ __device__ constexpr int rows_per_thread() {
  return DP >= 256 ? 2 : 4;
}

// Whether a device pointer allows 16-byte copies (the bf16 kernels' cp.async).
inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Query row `row` (absolute position, q_offset included) sees key column
// `col`: inside the keys, causal (row >= col), and inside the one-sided
// window (row - col < window), which applies with or without `causal`.
struct Band {
  int64_t skv;
  int64_t window;
  int causal;
  int has_window;
  __device__ __forceinline__ bool keep(int64_t row, int64_t col) const {
    if (col >= skv) return false;
    if (causal && row < col) return false;
    if (has_window && row - col >= window) return false;
    return true;
  }
};

// Stage rows [r0, r0 + n) of a (rows_total, d) tensor into a (n, DP) f32
// tile of row stride `stride`; rows past the end and columns past d are 0.
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const float* __restrict__ src,
                                          int64_t r0, int n,
                                          int64_t rows_total, int d) {
  const int tid = threadIdx.y * kTx + threadIdx.x;
  for (int idx = tid; idx < n * DP; idx += kThreads) {
    const int r = idx / DP, c = idx % DP;
    const int64_t row = r0 + r;
    dst[r * stride + c] =
        (row < rows_total && c < d) ? src[row * d + c] : 0.f;
  }
}

}  // namespace flash
