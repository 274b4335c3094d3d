// k-mer extraction: every length-k window of a read packed into one word.
//
// Replaces the TPU kernel in src/repro/kernels/kmer_extract.py:
//   kmer_extract_pallas (_kmer_extract_kernel)
// out[r, p] = sum_j codes[r, p + j] << b (k - 1 - j), or with `canonical`
// (2-bit DNA) min(forward, reverse complement), where base j of the window
// complements to c ^ 3 at bit 2j of the reverse-complement word.
//
// Bound: bytes. Each 1 B code is read once and each 8 B word written once,
// so the output dominates (8 B per position against about 1.25 B of input
// for 150 bp reads and k = 31).
//
// Design: the TPU kernel rebuilds every window from k shifted slices, k
// shift-ors per output, which its vector unit does for free. Here that
// would be k 64-bit shift-ors per output, and integer work, not bytes,
// would bound the kernel. So each thread rolls the window along kPos
// consecutive positions, the paper's `kmer = (kmer << b) | c`: k - 1 + kPos
// steps for kPos outputs, each a shift, an or and a mask (for the
// canonical form also a shift right and an or into the reverse
// complement, whose newest base enters at bit 2 (k - 1)). A block covers
// rb rows x tp positions:
// - the codes its windows read, rb x (tp + k - 1) bytes, are staged in
//   shared memory in one coalesced pass;
// - thread c rolls row c % rb, positions (c / rb) * kPos onwards, so the
//   lanes of a warp read and write different rows; both staged rows have
//   an odd stride in 32-bit (codes) or 64-bit (words) units, which keeps
//   those accesses free of bank conflicts;
// - the block writes its word tile out as 8-byte stores, neighbouring
//   threads on neighbouring words (a tile's rows are contiguous in memory
//   when tp covers the row, as it does for reads up to 4 kb).
// Codes are taken to be below 2**b, as in the JAX package: a larger code
// would spill into its neighbour's bits, which the rolling mask and a
// from-scratch shift-or treat differently.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPos = 16;                       // positions rolled per thread
constexpr size_t kSmemBytes = 48 * 1024;

__host__ __device__ inline int word_stride(int tp) { return tp | 1; }
__host__ __device__ inline int code_stride(int span) {
  return (((span + 3) / 4) | 1) * 4;
}
inline size_t smem_bytes(int tp, int rb, int k) {
  return (size_t)rb * word_stride(tp) * sizeof(uint64_t)
         + (size_t)rb * code_stride(tp + k - 1);
}

template <int B, bool kCanonical>
__global__ void __launch_bounds__(kThreads)
kmer_extract_kernel(const uint8_t* __restrict__ codes,
                    uint64_t* __restrict__ out, int64_t rows, int64_t m,
                    int k, int tp, int rb) {
  extern __shared__ uint64_t smem[];
  const int64_t n_pos = m - k + 1;
  const int span = tp + k - 1;
  const int ws = word_stride(tp), cs = code_stride(span);
  uint64_t* tile = smem;
  uint8_t* s = reinterpret_cast<uint8_t*>(smem + (size_t)rb * ws);
  const int64_t r0 = (int64_t)blockIdx.x * rb;
  const int64_t p0 = (int64_t)blockIdx.y * tp;

  // Stage the codes: element i of the rb x span tile, (r, j) kept without
  // a division per element.
  for (int r = threadIdx.x / span, j = threadIdx.x % span; r < rb;) {
    const int64_t row = r0 + r, col = p0 + j;
    s[r * cs + j] = row < rows && col < m ? codes[row * m + col] : 0;
    for (j += kThreads; j >= span; j -= span) ++r;
  }
  __syncthreads();

  const uint64_t mask = (~0ull) >> (64 - B * k);
  const int rc_top = 2 * (k - 1);
  const int chunks = (tp + kPos - 1) / kPos;
  for (int c = threadIdx.x; c < rb * chunks; c += kThreads) {
    const int r = c % rb;
    const int p = (c / rb) * kPos;
    const int n_here = min(kPos, tp - p);
    const uint8_t* w = s + r * cs + p;
    uint64_t* dst = tile + r * ws + p;
    uint64_t fwd = 0, rc = 0;
    for (int t = 0; t < k - 1; ++t) {
      const uint64_t sym = w[t];
      fwd = (fwd << B) | sym;
      if (kCanonical) rc = (rc >> 2) | ((sym ^ 3ull) << rc_top);
    }
    for (int t = 0; t < n_here; ++t) {
      const uint64_t sym = w[k - 1 + t];
      fwd = ((fwd << B) | sym) & mask;
      if (kCanonical) {
        rc = (rc >> 2) | ((sym ^ 3ull) << rc_top);
        dst[t] = fwd < rc ? fwd : rc;
      } else {
        dst[t] = fwd;
      }
    }
  }
  __syncthreads();

  const int width = (int)(n_pos - p0 < tp ? n_pos - p0 : tp);
  for (int r = threadIdx.x / tp, p = threadIdx.x % tp; r < rb;) {
    const int64_t row = r0 + r;
    if (row < rows && p < width) out[row * n_pos + p0 + p] = tile[r * ws + p];
    for (p += kThreads; p >= tp; p -= tp) ++r;
  }
}

template <int B, bool kCanonical>
cudaError_t launch(const uint8_t* codes, uint64_t* out, int64_t rows,
                   int64_t m, int k, cudaStream_t stream) {
  const int64_t n_pos = m - k + 1;
  // tp covers the row up to kThreads * kPos positions; rb fills the block
  // with rows and is halved until both tiles fit in shared memory.
  const int tp = (int)(n_pos < kThreads * kPos ? n_pos : kThreads * kPos);
  int rb = kThreads / ((tp + kPos - 1) / kPos);
  if (rb < 1) rb = 1;
  if (rb > rows) rb = (int)rows;
  while (rb > 1 && smem_bytes(tp, rb, k) > kSmemBytes) rb /= 2;
  const int64_t pos_tiles = (n_pos + tp - 1) / tp;
  if (pos_tiles > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)((rows + rb - 1) / rb), (unsigned)pos_tiles);
  kmer_extract_kernel<B, kCanonical>
      <<<grid, kThreads, smem_bytes(tp, rb, k), stream>>>(codes, out, rows, m,
                                                          k, tp, rb);
  return cudaGetLastError();
}

}  // namespace

// codes (rows, m) uint8 -> out (rows, m - k + 1) 64-bit words.
// 1 <= bits <= 8, 1 <= k <= m, k * bits <= 62; canonical only with
// bits == 2. rows >= 1.
extern "C" int kmer_extract_launch(const void* codes, void* out, int64_t rows,
                                   int64_t m, int k, int bits, int canonical,
                                   void* stream) {
  const uint8_t* c = (const uint8_t*)codes;
  uint64_t* o = (uint64_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (k < 1 || k > m || k * bits > 62) return (int)cudaErrorInvalidValue;
  if (canonical) {
    if (bits != 2) return (int)cudaErrorInvalidValue;
    return (int)launch<2, true>(c, o, rows, m, k, s);
  }
  switch (bits) {
    case 1: return (int)launch<1, false>(c, o, rows, m, k, s);
    case 2: return (int)launch<2, false>(c, o, rows, m, k, s);
    case 3: return (int)launch<3, false>(c, o, rows, m, k, s);
    case 4: return (int)launch<4, false>(c, o, rows, m, k, s);
    case 5: return (int)launch<5, false>(c, o, rows, m, k, s);
    case 6: return (int)launch<6, false>(c, o, rows, m, k, s);
    case 7: return (int)launch<7, false>(c, o, rows, m, k, s);
    case 8: return (int)launch<8, false>(c, o, rows, m, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
