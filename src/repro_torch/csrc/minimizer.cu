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
// every output word written once; the compares are cheap integer work.
// Words are compared as unsigned 64-bit integers: the port carries uint64
// words in int64, and a 64-bit m-mer or a hashed key may have its top bit
// set.
//
// 'plain' order (sliding_min_kernel), van Herk / Gil-Werman:
// - A block's input is one flat range of memory: whole rows (seg_rows
//   consecutive rows, when a row is short) or one position tile of one
//   row (tp outputs and the w - 1 words after them, when it is long). The
//   block stages it in shared memory with 16-byte cp.async copies; the
//   range may start or end half-way into a 16-byte unit (row0 * n_pos
//   odd, or a view), and the single words there are copied on their own.
// - Each segment (a row, or the tile) is cut into chunks of w positions.
//   One thread per chunk takes the running minimum forward (g) and
//   backward (h, in place); then out[p] = min(h[p], g[p + w - 1]): three
//   compares per output instead of w - 1.
// - When a segment has one output (w = n_pos: the query path's windows),
//   a group of lanes takes each segment's minimum with a shuffle
//   reduction instead.
// 'hashed' order (sliding_min_pair_kernel): a block covers (rb rows) x
// (tp output positions), one thread per output; the block stages the
// tp + w - 1 words its outputs read, for each of its rows, and each
// thread walks its w staged keys in order, taking a later key only when
// it is strictly smaller, so the earliest position wins a tie.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // the 'plain' kernel's block

__device__ __forceinline__ uint64_t umin(uint64_t a, uint64_t b) {
  return b < a ? b : a;
}

__device__ __forceinline__ void cp_async16(uint64_t* dst, const uint64_t* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// Copy words [src, src + len) into shared memory at `smem` (16-byte
// aligned, len + 1 words) and return where word 0 landed: one word in
// when src is not 16-byte aligned, so that a word's shared address is
// 16-byte aligned exactly when its global address is.
__device__ uint64_t* stage(const uint64_t* __restrict__ src, int len,
                           uint64_t* smem) {
  const int head = (int)(((uintptr_t)src >> 3) & 1);
  uint64_t* x = smem + head;
  const int h = min(head, len);
  const int pairs = (len - h) >> 1;
  for (int j = threadIdx.x; j < pairs; j += blockDim.x)
    cp_async16(x + h + 2 * j, src + h + 2 * j);
  if (threadIdx.x == 0) {
    if (h) x[0] = src[0];
    if ((len - h) & 1) x[len - 1] = src[len - 1];
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  return x;
}

__global__ void __launch_bounds__(kThreads)
sliding_min_kernel(const uint64_t* __restrict__ vals,
                   uint64_t* __restrict__ out, int64_t rows, int64_t n_pos,
                   int window, int seg_rows, int tp) {
  extern __shared__ __align__(16) uint64_t staged[];
  const int64_t n_out = n_pos - window + 1;
  int nseg, seg_len, q;
  int64_t first, out0;
  if (tp == 0) {  // whole rows
    const int64_t r0 = (int64_t)blockIdx.x * seg_rows;
    nseg = (int)(rows - r0 < seg_rows ? rows - r0 : seg_rows);
    seg_len = (int)n_pos;
    q = (int)n_out;
    first = r0 * n_pos;
    out0 = r0 * n_out;
  } else {  // one position tile of one row
    const int64_t tiles = (n_out + tp - 1) / tp;
    const int64_t row = blockIdx.x / tiles;
    const int64_t p0 = (blockIdx.x - row * tiles) * tp;
    nseg = 1;
    q = (int)(n_out - p0 < tp ? n_out - p0 : tp);
    seg_len = q + window - 1;
    first = row * n_pos + p0;
    out0 = row * n_out + p0;
  }
  const int span = nseg * seg_len;
  uint64_t* x = stage(vals + first, span, staged);
  uint64_t* dst = out + out0;

  if (q == 1) {  // one window a segment: g lanes, then a shuffle reduction
    int g = 1;
    while (g < 32 && 4 * g < seg_len) g <<= 1;
    const int lane = threadIdx.x & (g - 1);
    for (int s0 = 0; s0 < nseg; s0 += kThreads / g) {
      const int s = s0 + threadIdx.x / g;
      uint64_t m = ~0ull;
      if (s < nseg)
        for (int i = lane; i < seg_len; i += g) m = umin(m, x[s * seg_len + i]);
      for (int off = g >> 1; off; off >>= 1)
        m = umin(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (s < nseg && lane == 0) dst[s] = m;
    }
    return;
  }

  uint64_t* gmin = staged + span + 1;  // past the staged words
  const int chunks = (seg_len + window - 1) / window;
  for (int t = threadIdx.x; t < nseg * chunks; t += kThreads) {
    const int s = t / chunks;
    const int c = t - s * chunks;
    const int lo = s * seg_len + c * window;
    const int hi = s * seg_len + min(seg_len, (c + 1) * window);
    uint64_t run = ~0ull;
#pragma unroll 4
    for (int i = lo; i < hi; ++i) {
      run = umin(run, x[i]);
      gmin[i] = run;
    }
    run = ~0ull;
#pragma unroll 4
    for (int i = hi - 1; i >= lo; --i) {
      run = umin(run, x[i]);
      x[i] = run;
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < nseg * q; o += kThreads) {
    const int s = o / q;
    const int i = s * seg_len + (o - s * q);
    dst[o] = umin(x[i], gmin[i + window - 1]);
  }
}

__global__ void sliding_min_pair_kernel(const uint64_t* __restrict__ keys,
                                        const uint64_t* __restrict__ vals,
                                        uint64_t* __restrict__ kout,
                                        uint64_t* __restrict__ vout,
                                        int64_t rows, int64_t n_pos,
                                        int window) {
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
    sv[i] = in ? vals[row * n_pos + p] : 0ull;
  }
  __syncthreads();
  const int64_t p = p0 + threadIdx.x;
  if (row >= rows || p >= n_out) return;
  uint64_t best = sk[threadIdx.x];
  uint64_t carried = sv[threadIdx.x];
  for (int j = 1; j < window; ++j) {
    const uint64_t k = sk[threadIdx.x + j];
    if (k < best) {
      best = k;
      carried = sv[threadIdx.x + j];
    }
  }
  kout[row * n_out + p] = best;
  vout[row * n_out + p] = carried;
}

}  // namespace

// vals (rows, n_pos) 64-bit words -> out (rows, n_pos - w + 1). tp == 0:
// blocks of seg_rows whole rows; tp > 0: blocks of tp positions of one
// row. The caller keeps the staged words within the block's shared memory
// (sliding_min_kernel takes up to 227 KB).
extern "C" int sliding_min_launch(const void* vals, void* out, int64_t rows,
                                  int64_t n_pos, int window, int seg_rows,
                                  int tp, void* stream) {
  const int64_t n_out = n_pos - window + 1;
  int64_t blocks, span;
  if (tp == 0) {
    blocks = (rows + seg_rows - 1) / seg_rows;
    span = (int64_t)seg_rows * n_pos;
  } else {
    blocks = rows * ((n_out + tp - 1) / tp);
    span = (tp < n_out ? tp : n_out) + window - 1;
  }
  const size_t smem =
      (size_t)(n_out == 1 ? span + 2 : 2 * span + 2) * sizeof(uint64_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sliding_min_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sliding_min_kernel<<<(unsigned)blocks, kThreads, smem,
                       (cudaStream_t)stream>>>(
      (const uint64_t*)vals, (uint64_t*)out, rows, n_pos, window, seg_rows,
      tp);
  return (int)cudaGetLastError();
}

// keys, vals (rows, n_pos) 64-bit words; kout, vout (rows, n_pos - w + 1).
// The block is (tp, rb) threads with 2 * rb * (tp + w - 1) words of dynamic
// shared memory; the caller keeps that within 48 KB and the position tiles
// within the grid's y limit.
extern "C" int sliding_min_pair_launch(const void* keys, const void* vals,
                                       void* kout, void* vout, int64_t rows,
                                       int64_t n_pos, int window, int tp,
                                       int rb, void* stream) {
  const int64_t n_out = n_pos - window + 1;
  const dim3 block(tp, rb);
  const dim3 grid((unsigned)((rows + rb - 1) / rb),
                  (unsigned)((n_out + tp - 1) / tp));
  const size_t smem = 2 * (size_t)rb * (tp + window - 1) * sizeof(uint64_t);
  sliding_min_pair_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const uint64_t*)keys, (const uint64_t*)vals, (uint64_t*)kout,
      (uint64_t*)vout, rows, n_pos, window);
  return (int)cudaGetLastError();
}
