// Flash attention forward: online-softmax attention, with an optional
// per-row logsumexp for the backward pass.
//
// Replaces the TPU kernels in src/repro/kernels/flash_attention.py:
//   flash_attention_pallas  (_flash_kernel)      -- lse == nullptr
//   flash_attention_fwd_lse (_flash_lse_kernel)  -- lse != nullptr
// o[b, h, i] = softmax_j(s_ij) v[b, h / group, j] over the kept columns j,
// s_ij = scale * q_i . k_j (then cap * tanh(s / cap) with a softcap);
// lse[b, h, i] = log sum_j exp(s_ij). Masking, causal (top-left aligned,
// row = q_offset + i), the one-sided window and GQA by index are as in the
// TPU kernel; a fully masked row gives o = 0 and lse = -1e30.
//
// Bound: operations. A causal (4, 16, 4096, 64) call does 1.4e11 FLOP on
// 34 MB, far above the card's ridge point.
//
// Design, first version (simple and right): one block per (batch * head,
// tile of 64 query rows; 32 at head dim 256). The q tile stays in shared
// memory while the block walks the 64-wide k/v tiles of its band, skipping
// tiles wholly outside the causal or window band (there p = 0 and the
// rescale factor is 1, so the result is unchanged). Scores, the running max
// and sum, P and the P.V product are f32 on the CUDA cores, as the TPU
// kernel multiplies P by V in f32; a tensor-core version would round P to
// bf16 and is later work. Each thread holds a 4 x 4 block of scores and
// 4 rows x (DP / 16) columns of the output accumulator in registers.

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

struct FwdArgs {
  const void* q;  // (B, hq, sq, d)
  const void* k;  // (B, hkv, skv, d)
  const void* v;  // (B, hkv, skv, d)
  void* o;        // (B, hq, sq, d), q's dtype
  float* lse;     // (B, hq, sq) or nullptr
  int hq, hkv, d;
  int64_t sq, q_offset;
  float scale, softcap;
  int has_softcap;
  Band band;
};

template <int DP>
constexpr size_t fwd_smem_floats() {
  constexpr int BR = kTy * rows_per_thread<DP>();
  return (size_t)BR * (DP + 1) + (size_t)kBC * (DP + 1) + (size_t)kBC * DP +
         (size_t)BR * (kBC + 1);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FwdArgs a) {
  constexpr int RM = rows_per_thread<DP>();
  constexpr int BR = kTy * RM;  // rows of the q tile
  constexpr int S = DP + 1;     // row stride of the q and k tiles
  constexpr int PS = kBC + 1;   // row stride of the p tile
  constexpr int DJ = DP / kTx;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + BR * S;
  float* vs = ks + kBC * S;
  float* ps = vs + kBC * DP;

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / a.hq, h = bh % a.hq;
  const int64_t kvh = b * a.hkv + h / (a.hq / a.hkv);
  const int64_t sq = a.sq, skv = a.band.skv;
  const int d = a.d;
  const int64_t r0 = (int64_t)blockIdx.y * BR;
  const T* q = static_cast<const T*>(a.q) + bh * sq * d;
  const T* k = static_cast<const T*>(a.k) + kvh * skv * d;
  const T* v = static_cast<const T*>(a.v) + kvh * skv * d;

  load_tile<T, DP>(qs, S, q, r0, BR, sq, d);

  float m[RM], l[RM], acc[RM][DJ];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
  }

  // The k/v tiles that can hold a kept column for some row of this tile.
  const int64_t last = r0 + BR < sq ? r0 + BR : sq;
  const int64_t row_lo = a.q_offset + r0, row_hi = a.q_offset + last - 1;
  int64_t c_begin = 0, c_end = skv;
  if (a.band.has_window && row_lo - a.band.window + 1 > 0)
    c_begin = row_lo - a.band.window + 1;
  if (a.band.causal && row_hi + 1 < c_end) c_end = row_hi + 1;
  c_begin -= c_begin % kBC;

  for (int64_t c0 = c_begin; c0 < c_end; c0 += kBC) {
    __syncthreads();  // the last tile's P.V is done with ks, vs and ps
    load_tile<T, DP>(ks, S, k, c0, kBC, skv, d);
    load_tile<T, DP>(vs, DP, v, c0, kBC, skv, d);
    __syncthreads();

    float s[RM][kCols];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < DP; ++dd) {
      float qa[RM], kb[kCols];
#pragma unroll
      for (int i = 0; i < RM; ++i) qa[i] = qs[(ty * RM + i) * S + dd];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kb[j] = ks[(tx + kTx * j) * S + dd];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int64_t row = a.q_offset + r0 + ty * RM + i;
      bool kept[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        float x = s[i][j] * a.scale;
        if (a.has_softcap) x = a.softcap * tanhf(x / a.softcap);
        kept[j] = a.band.keep(row, c0 + tx + kTx * j);
        s[i][j] = kept[j] ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = kTx / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = kept[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty * RM + i) * PS + tx + kTx * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = kTx / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBC; ++c) {
      float p[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) p[i] = ps[(ty * RM + i) * PS + c];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const float vv = vs[c * DP + tx + kTx * jj];
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][jj] = fmaf(p[i], vv, acc[i][jj]);
      }
    }
  }

  T* o = static_cast<T*>(a.o) + bh * sq * d;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int64_t r = r0 + ty * RM + i;
    if (r >= sq) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int c = tx + kTx * jj;
      if (c < d) store(&o[r * d + c], acc[i][jj] / ls);
    }
    if (a.lse != nullptr && tx == 0) a.lse[bh * sq + r] = m[i] + logf(ls);
  }
}

template <typename T, int DP>
cudaError_t launch(const FwdArgs& a, int64_t bh, cudaStream_t stream) {
  constexpr int BR = kTy * rows_per_thread<DP>();
  const size_t smem = fwd_smem_floats<DP>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)bh, (unsigned)((a.sq + BR - 1) / BR));
  flash_fwd_kernel<T, DP><<<grid, dim3(kTx, kTy), smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const FwdArgs& a, int64_t bh, cudaStream_t stream) {
  if (a.d <= 16) return launch<T, 16>(a, bh, stream);
  if (a.d <= 32) return launch<T, 32>(a, bh, stream);
  if (a.d <= 64) return launch<T, 64>(a, bh, stream);
  if (a.d <= 128) return launch<T, 128>(a, bh, stream);
  if (a.d <= 256) return launch<T, 256>(a, bh, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (batch, hq, sq, d); k, v (batch, hkv, skv, d), hq a multiple of hkv;
// o like q; lse (batch, hq, sq) f32 or null. All contiguous, f32 or bf16
// (is_bf16), d <= 256. window is read when has_window, softcap when
// has_softcap. Returns the cudaError_t of the launch.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, void* lse, int64_t batch, int64_t hq,
                                int64_t hkv, int64_t sq, int64_t skv,
                                int64_t d, float scale, int causal,
                                int has_window, int64_t window,
                                int has_softcap, float softcap,
                                int64_t q_offset, int is_bf16, void* stream) {
  FwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = static_cast<float*>(lse);
  a.hq = (int)hq;
  a.hkv = (int)hkv;
  a.d = (int)d;
  a.sq = sq;
  a.q_offset = q_offset;
  a.scale = scale;
  a.softcap = softcap;
  a.has_softcap = has_softcap;
  a.band.skv = skv;
  a.band.window = window;
  a.band.causal = causal;
  a.band.has_window = has_window;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t bh = batch * hq;
  return (int)(is_bf16 ? dispatch<__nv_bfloat16>(a, bh, s)
                       : dispatch<float>(a, bh, s));
}
