// Shared by flash_attention.cu (forward) and flash_attention_bwd.cu
// (backward): the attention band, the mask value and the alignment test of
// the 16-byte copies (the kernels' tiles and fragments are in
// flash_wgmma.cuh).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kNegInf = -1e30f;  // the TPU kernels' mask value

// Whether a device pointer allows 16-byte copies (cp.async of a chunk).
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

}  // namespace flash
