// Sliding-window minimum: minimizer selection of the super-k-mer transport.
//
// Replaces the TPU kernels in src/repro/kernels/minimizer.py:
//   sliding_min_pallas      (_sliding_min_kernel)       -- 'plain' order
//   sliding_min_pair_pallas (_sliding_min_pair_kernel)  -- 'hashed' order
// out[r, p] = min(vals[r, p : p + w]); the pair version takes the minimum
// by KEY and carries the value of the winning position.
//
// Bound: bytes. Each output reads w words, but neighbouring outputs share
// w - 1 of them, so the least traffic is every input word read once and
// every output word written once; the O(w) compares per output are cheap
// integer work.
//
// Design: the TPU kernel reads its position tile plus the next one and
// unrolls the w-way minimum over shifted slices. Here a block covers
// (rb rows) x (tp output positions), one thread per output:
// - the block stages the tp + w - 1 input words its outputs read, for each
//   of its rows, in shared memory (one coalesced pass over global memory);
// - each thread takes the minimum over its w staged words in order.
// Words are compared as unsigned 64-bit integers: the port carries uint64
// words in int64, and a 64-bit m-mer or a hashed key may have its top bit
// set. The pair version takes a later key only when it is strictly smaller,
// so the earliest position wins a tie, as in the plain version.
// tp and rb are chosen by the caller to fit the row length: a short row
// (a query k-mer's window) gets many rows per block, a read row many
// positions per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <bool kPair>
__global__ void sliding_min_kernel(const uint64_t* __restrict__ keys,
                                   const uint64_t* __restrict__ vals,
                                   uint64_t* __restrict__ kout,
                                   uint64_t* __restrict__ vout, int64_t rows,
                                   int64_t n_pos, int window) {
  extern __shared__ uint64_t smem[];
  const int tp = blockDim.x;
  const int span = tp + window - 1;
  const int64_t row = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  const int64_t p0 = (int64_t)blockIdx.y * tp;
  const int64_t n_out = n_pos - window + 1;
  uint64_t* sk = smem + threadIdx.y * span;
  uint64_t* sv = smem + (blockDim.y + threadIdx.y) * span;
  for (int i = threadIdx.x; i < span; i += tp) {
    const int64_t p = p0 + i;
    const bool in = row < rows && p < n_pos;
    sk[i] = in ? keys[row * n_pos + p] : ~0ull;
    if (kPair) sv[i] = in ? vals[row * n_pos + p] : 0ull;
  }
  __syncthreads();
  const int64_t p = p0 + threadIdx.x;
  if (row >= rows || p >= n_out) return;
  uint64_t best = sk[threadIdx.x];
  uint64_t carried = kPair ? sv[threadIdx.x] : 0ull;
  for (int j = 1; j < window; ++j) {
    const uint64_t k = sk[threadIdx.x + j];
    if (k < best) {
      best = k;
      if (kPair) carried = sv[threadIdx.x + j];
    }
  }
  kout[row * n_out + p] = best;
  if (kPair) vout[row * n_out + p] = carried;
}

}  // namespace

// keys, vals (rows, n_pos) 64-bit words; kout, vout (rows, n_pos - w + 1).
// vals and vout are read and written only by the pair version (pair != 0).
// The block is (tp, rb) threads with rb * (tp + w - 1) words of dynamic
// shared memory per lane (two lanes for the pair); the caller keeps that
// within 48 KB and the position tiles within the grid's y limit.
extern "C" int sliding_min_launch(const void* keys, const void* vals,
                                  void* kout, void* vout, int64_t rows,
                                  int64_t n_pos, int window, int pair, int tp,
                                  int rb, void* stream) {
  const int64_t n_out = n_pos - window + 1;
  const dim3 block(tp, rb);
  const dim3 grid((unsigned)((rows + rb - 1) / rb),
                  (unsigned)((n_out + tp - 1) / tp));
  const size_t smem =
      (pair ? 2 : 1) * (size_t)rb * (tp + window - 1) * sizeof(uint64_t);
  if (pair) {
    sliding_min_kernel<true><<<grid, block, smem, (cudaStream_t)stream>>>(
        (const uint64_t*)keys, (const uint64_t*)vals, (uint64_t*)kout,
        (uint64_t*)vout, rows, n_pos, window);
  } else {
    sliding_min_kernel<false><<<grid, block, smem, (cudaStream_t)stream>>>(
        (const uint64_t*)keys, nullptr, (uint64_t*)kout, nullptr, rows, n_pos,
        window);
  }
  return (int)cudaGetLastError();
}
