// Flash attention backward: dq, dk and dv, recomputing P from the forward's
// logsumexp.
//
// Replaces the TPU kernel in src/repro/kernels/flash_attention_bwd.py:
//   flash_attention_bwd_pallas (_dq_kernel, _dkv_kernel)
// Per query row i and key column j of the band, with D_i = dO_i . O_i
// (computed by the caller):
//   p_ij = exp(s_ij - lse_i);  dv_j = sum_i p_ij dO_i;
//   ds_ij = p_ij (dO_i . v_j - D_i), times 1 - (s_ij / cap)^2 with a softcap;
//   dq_i = scale sum_j ds_ij k_j;  dk_j = scale sum_i ds_ij q_i.
// Heads are at the full query-head count (the caller expands GQA and sums
// dk, dv over each group). Rows past sq and columns outside the band get
// p = 0, which is what the TPU wrapper's padding (lse 1, D 0) amounts to.
//
// Bound: operations. The five products of a causal (4, 16, 4096, 64) call
// are 3.4e11 FLOP on about 70 MB.
//
// Design, first version (simple and right), as the TPU kernel splits it:
// - dq: one block per (batch * head, tile of 64 query rows; 32 at head dim
//   256) walks the k/v tiles of its band; S and dO.V^T come from one pass
//   over the head dimension, dS goes through shared memory, and dq stays
//   in registers.
// - dk, dv: one block per (batch * head, tile of 64 key rows; 32 at head
//   dim 256) walks the q tiles of its band; P^T and dS^T go through shared
//   memory, and dk, dv stay in registers.
// All arithmetic is f32 on the CUDA cores; tiles wholly outside the causal
// or window band are skipped (their p is 0).

#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

struct BwdArgs {
  const void* q;     // (B*H, sq, d)
  const void* k;     // (B*H, skv, d)
  const void* v;     // (B*H, skv, d)
  const void* dout;  // (B*H, sq, d), q's dtype
  const float* lse;  // (B*H, sq)
  const float* dsum; // (B*H, sq): rowsum(dO * O)
  void* dq;          // like q
  void* dk;          // like k
  void* dv;          // like v
  int d;
  int64_t sq, q_offset;
  float scale, softcap;
  int has_softcap;
  Band band;
};

// The scaled score and, with a softcap, the capped one.
__device__ __forceinline__ float cap_score(const BwdArgs& a, float dot) {
  const float x = dot * a.scale;
  return a.has_softcap ? a.softcap * tanhf(x / a.softcap) : x;
}

// scale * ds for one kept (row, column): p (dp - D), through the softcap.
__device__ __forceinline__ float scaled_ds(const BwdArgs& a, float p,
                                           float dp, float dsum, float x) {
  float ds = p * (dp - dsum);
  if (a.has_softcap) {
    const float t = x / a.softcap;
    ds *= 1.f - t * t;
  }
  return ds * a.scale;
}

template <int DP>
constexpr size_t dq_smem_floats() {
  constexpr int BR = kTy * rows_per_thread<DP>();
  return 2 * (size_t)BR * (DP + 1) + 2 * (size_t)kBC * (DP + 1) +
         (size_t)BR * (kBC + 1);
}

template <int DP>
constexpr size_t dkv_smem_floats() {
  constexpr int BR = kTy * rows_per_thread<DP>();
  return 2 * (size_t)BR * (DP + 1) + 2 * (size_t)kBC * (DP + 1) +
         2 * (size_t)BR * (kBC + 1) + 2 * (size_t)kBC;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(BwdArgs a) {
  constexpr int RM = rows_per_thread<DP>();
  constexpr int BR = kTy * RM;
  constexpr int S = DP + 1;
  constexpr int PS = kBC + 1;
  constexpr int DJ = DP / kTx;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + BR * S;
  float* ks = dos + BR * S;
  float* vs = ks + kBC * S;
  float* dss = vs + kBC * S;

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t bh = blockIdx.x;
  const int64_t sq = a.sq, skv = a.band.skv;
  const int d = a.d;
  const int64_t r0 = (int64_t)blockIdx.y * BR;
  const T* q = static_cast<const T*>(a.q) + bh * sq * d;
  const T* dout = static_cast<const T*>(a.dout) + bh * sq * d;
  const T* k = static_cast<const T*>(a.k) + bh * skv * d;
  const T* v = static_cast<const T*>(a.v) + bh * skv * d;

  load_tile<T, DP>(qs, S, q, r0, BR, sq, d);
  load_tile<T, DP>(dos, S, dout, r0, BR, sq, d);
  float lse[RM], dsum[RM], acc[RM][DJ];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int64_t r = r0 + ty * RM + i;
    lse[i] = r < sq ? a.lse[bh * sq + r] : 0.f;
    dsum[i] = r < sq ? a.dsum[bh * sq + r] : 0.f;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.f;
  }

  const int64_t last = r0 + BR < sq ? r0 + BR : sq;
  const int64_t row_lo = a.q_offset + r0, row_hi = a.q_offset + last - 1;
  int64_t c_begin = 0, c_end = skv;
  if (a.band.has_window && row_lo - a.band.window + 1 > 0)
    c_begin = row_lo - a.band.window + 1;
  if (a.band.causal && row_hi + 1 < c_end) c_end = row_hi + 1;
  c_begin -= c_begin % kBC;

  for (int64_t c0 = c_begin; c0 < c_end; c0 += kBC) {
    __syncthreads();  // the last tile's dS.K is done with ks and dss
    load_tile<T, DP>(ks, S, k, c0, kBC, skv, d);
    load_tile<T, DP>(vs, S, v, c0, kBC, skv, d);
    __syncthreads();

    float s[RM][kCols], dp[RM][kCols];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < DP; ++dd) {
      float qa[RM], oa[RM], kb[kCols], vb[kCols];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        qa[i] = qs[(ty * RM + i) * S + dd];
        oa[i] = dos[(ty * RM + i) * S + dd];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        kb[j] = ks[(tx + kTx * j) * S + dd];
        vb[j] = vs[(tx + kTx * j) * S + dd];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int64_t r = r0 + ty * RM + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int64_t col = c0 + tx + kTx * j;
        const float x = cap_score(a, s[i][j]);
        const bool keep = r < sq && a.band.keep(a.q_offset + r, col);
        const float p = keep ? expf(x - lse[i]) : 0.f;
        dss[(ty * RM + i) * PS + tx + kTx * j] =
            keep ? scaled_ds(a, p, dp[i][j], dsum[i], x) : 0.f;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBC; ++c) {
      float ds[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) ds[i] = dss[(ty * RM + i) * PS + c];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const float kk = ks[c * S + tx + kTx * jj];
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][jj] = fmaf(ds[i], kk, acc[i][jj]);
      }
    }
  }

  T* dq = static_cast<T*>(a.dq) + bh * sq * d;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int64_t r = r0 + ty * RM + i;
    if (r >= sq) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int c = tx + kTx * jj;
      if (c < d) store(&dq[r * d + c], acc[i][jj]);
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(BwdArgs a) {
  constexpr int RM = rows_per_thread<DP>();
  constexpr int BK = kTy * RM;  // key rows of this block
  constexpr int S = DP + 1;
  constexpr int PS = kBC + 1;
  constexpr int DJ = DP / kTx;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + BK * S;
  float* qs = vs + BK * S;
  float* dos = qs + kBC * S;
  float* pts = dos + kBC * S;    // P^T tile (BK, 64)
  float* dsts = pts + BK * PS;   // scale * dS^T tile (BK, 64)
  float* lses = dsts + BK * PS;  // (64,)
  float* dsums = lses + kBC;     // (64,)

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTx + tx;
  const int64_t bh = blockIdx.x;
  const int64_t sq = a.sq, skv = a.band.skv;
  const int d = a.d;
  const int64_t c0 = (int64_t)blockIdx.y * BK;
  const T* q = static_cast<const T*>(a.q) + bh * sq * d;
  const T* dout = static_cast<const T*>(a.dout) + bh * sq * d;
  const T* k = static_cast<const T*>(a.k) + bh * skv * d;
  const T* v = static_cast<const T*>(a.v) + bh * skv * d;

  load_tile<T, DP>(ks, S, k, c0, BK, skv, d);
  load_tile<T, DP>(vs, S, v, c0, BK, skv, d);
  float dk[RM][DJ], dv[RM][DJ];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) dk[i][jj] = dv[i][jj] = 0.f;

  // The q tiles whose rows can see a column of this block.
  const int64_t col_hi = (c0 + BK < skv ? c0 + BK : skv) - 1;
  int64_t r_begin = 0, r_end = sq;
  if (a.band.causal && c0 - a.q_offset > 0) r_begin = c0 - a.q_offset;
  if (a.band.has_window && col_hi + a.band.window - a.q_offset < r_end)
    r_end = col_hi + a.band.window - a.q_offset;
  r_begin -= r_begin % kBC;

  for (int64_t r0 = r_begin; r0 < r_end; r0 += kBC) {
    __syncthreads();  // the last tile's products are done with the tiles
    load_tile<T, DP>(qs, S, q, r0, kBC, sq, d);
    load_tile<T, DP>(dos, S, dout, r0, kBC, sq, d);
    for (int idx = tid; idx < kBC; idx += kThreads) {
      const int64_t r = r0 + idx;
      lses[idx] = r < sq ? a.lse[bh * sq + r] : 0.f;
      dsums[idx] = r < sq ? a.dsum[bh * sq + r] : 0.f;
    }
    __syncthreads();

    // s[i][j]: key row ty * RM + i against query row tx + 16 j of the tile.
    float s[RM][kCols], dp[RM][kCols];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < DP; ++dd) {
      float ka[RM], va[RM], qb[kCols], ob[kCols];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        ka[i] = ks[(ty * RM + i) * S + dd];
        va[i] = vs[(ty * RM + i) * S + dd];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        qb[j] = qs[(tx + kTx * j) * S + dd];
        ob[j] = dos[(tx + kTx * j) * S + dd];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(ka[i], qb[j], s[i][j]);
          dp[i][j] = fmaf(va[i], ob[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int64_t col = c0 + ty * RM + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int qr = tx + kTx * j;
        const int64_t r = r0 + qr;
        const float x = cap_score(a, s[i][j]);
        const bool keep = r < sq && a.band.keep(a.q_offset + r, col);
        const float p = keep ? expf(x - lses[qr]) : 0.f;
        pts[(ty * RM + i) * PS + qr] = p;
        dsts[(ty * RM + i) * PS + qr] =
            keep ? scaled_ds(a, p, dp[i][j], dsums[qr], x) : 0.f;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < kBC; ++r) {
      float pt[RM], dst[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        pt[i] = pts[(ty * RM + i) * PS + r];
        dst[i] = dsts[(ty * RM + i) * PS + r];
      }
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const float oo = dos[r * S + tx + kTx * jj];
        const float qq = qs[r * S + tx + kTx * jj];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          dv[i][jj] = fmaf(pt[i], oo, dv[i][jj]);
          dk[i][jj] = fmaf(dst[i], qq, dk[i][jj]);
        }
      }
    }
  }

  T* dkg = static_cast<T*>(a.dk) + bh * skv * d;
  T* dvg = static_cast<T*>(a.dv) + bh * skv * d;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int64_t c = c0 + ty * RM + i;
    if (c >= skv) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int col = tx + kTx * jj;
      if (col < d) {
        store(&dkg[c * d + col], dk[i][jj]);
        store(&dvg[c * d + col], dv[i][jj]);
      }
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const BwdArgs& a, int64_t bh, cudaStream_t stream) {
  constexpr int BR = kTy * rows_per_thread<DP>();
  const dim3 block(kTx, kTy);
  const size_t dq_smem = dq_smem_floats<DP>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dq_smem);
  if (err != cudaSuccess) return err;
  flash_dq_kernel<T, DP>
      <<<dim3((unsigned)bh, (unsigned)((a.sq + BR - 1) / BR)), block,
         dq_smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t dkv_smem = dkv_smem_floats<DP>() * sizeof(float);
  err = cudaFuncSetAttribute(flash_dkv_kernel<T, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dkv_smem);
  if (err != cudaSuccess) return err;
  flash_dkv_kernel<T, DP>
      <<<dim3((unsigned)bh, (unsigned)((a.band.skv + BR - 1) / BR)), block,
         dkv_smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const BwdArgs& a, int64_t bh, cudaStream_t stream) {
  if (a.d <= 16) return launch<T, 16>(a, bh, stream);
  if (a.d <= 32) return launch<T, 32>(a, bh, stream);
  if (a.d <= 64) return launch<T, 64>(a, bh, stream);
  if (a.d <= 128) return launch<T, 128>(a, bh, stream);
  if (a.d <= 256) return launch<T, 256>(a, bh, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, dout (bh, sq, d); k, v (bh, skv, d); lse, dsum (bh, sq) f32; dq, dk,
// dv like q, k, v. All contiguous, f32 or bf16 (is_bf16), d <= 256. Launches
// the dq kernel, then the dk/dv kernel, on `stream`; returns the first
// cudaError_t that is not cudaSuccess.
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* dsum, void* dq, void* dk,
                                void* dv, int64_t bh, int64_t sq, int64_t skv,
                                int64_t d, float scale, int causal,
                                int has_window, int64_t window,
                                int has_softcap, float softcap,
                                int64_t q_offset, int is_bf16, void* stream) {
  BwdArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.dsum = static_cast<const float*>(dsum);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
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
  return (int)(is_bf16 ? dispatch<__nv_bfloat16>(a, bh, s)
                       : dispatch<float>(a, bh, s));
}
