// Flash attention backward: dq, dk and dv, recomputing P from the forward's
// logsumexp.
//
// Replaces the TPU kernel in src/repro/kernels/flash_attention_bwd.py:
//   flash_attention_bwd_pallas (_dq_kernel, _dkv_kernel)
// Per query row i and key column j of the band, with D_i = dO_i . O_i
// (computed by the caller, as the TPU wrapper does):
//   p_ij = exp(s_ij - lse_i);  dv_j = sum_i p_ij dO_i;
//   ds_ij = p_ij (dO_i . v_j - D_i), times 1 - (s_ij / cap)^2 with a softcap;
//   dq_i = scale sum_j ds_ij k_j;  dk_j = scale sum_i ds_ij q_i.
// Heads are at the full query-head count (the caller expands GQA and sums
// dk, dv over each group). Rows past sq and columns outside the band get
// p = 0, which is what the TPU wrapper's padding (lse 1, D 0) amounts to.
//
// Bound: operations. The five products of a causal (4, 16, 4096, 64) call
// are 3.4e11 FLOP on about 70 MB: 0.35 ms at the 989 TFLOP/s bf16 peak.
//
// Both dtypes keep the TPU kernel's split into a dq kernel and a dk/dv
// kernel: no atomics, no f32 scratch for dq, deterministic results, at
// the cost of 7 products per (row, column) pair where the bound counts 5
// (S and dP are computed in both kernels).
//
// bf16 (flash_dq_tc, flash_dkv_tc): the tensor-core kernels. Every
// product is wgmma with f32 accumulators (flash_wgmma.cuh); tiles come
// through cp.async in the 128-byte swizzle, the walked tiles through a
// 2-stage ring that fills while the previous tile computes. Blocks are
// one warpgroup per 64 rows; at head dim 64 one warpgroup, three blocks
// to an SM, so that one block's products overlap another's elementwise
// work; at 128 two warpgroups on 128 rows; at 256 see below.
// - dq: one block per (batch * head, q tile), q tiles longest first. Per
//   k/v tile: S = Q K^T and dP = dO V^T in two commit groups; P = exp(S -
//   lse) times the softcap factor while dP is still on the tensor cores,
//   then dS = P (dP - D) in the accumulators; dS rounded to bf16 in
//   registers is the A operand of dQ += dS K, K read through the
//   transpose bit.
// - dk, dv: one block per (batch * head, k/v tile); at head dim 256 a
//   tile of 64 key rows whose two warpgroups split dk's and dv's columns
//   (each recomputes S^T and dP^T). Per q tile: S^T = K Q^T and dP^T =
//   V dO^T in two commit groups, lse and D of the tile's rows staged
//   beside Q; P^T goes to bf16 A fragments as it is made and dV += P^T dO
//   starts while dP^T still runs; then dS^T = P^T (dP^T - D), rounded to
//   bf16, and dK += dS^T Q, both products with the transposed B operand.
// P for dS stays f32; dq and dk are scaled after their products. The
// plain version (ref.flash_bwd) rounds at the same places. Tiles wholly
// outside the band are skipped; each tile's elementwise loop is compiled
// with and without the mask and the softcap (by_case), and the mask runs
// only on tiles that cross the band's edge.
//
// f32 (flash_dq_kernel, flash_dkv_kernel): the first-version kernels,
// kept for f32 inputs (the tensor cores would round them; the f32 checks
// hold the kernels to 5e-5). All arithmetic is f32 on the CUDA cores: a
// block per 64 rows (32 at head dim 256), S and dO.V^T from one pass over
// the head dimension, dS and P^T through shared memory.
//
// The dtype picks the kernels (flash_bwd_launch); neither falls back.

#include <math.h>

#include "flash_common.cuh"
#include "flash_wgmma.cuh"

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

template <int DP>
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
  const float* q = static_cast<const float*>(a.q) + bh * sq * d;
  const float* dout = static_cast<const float*>(a.dout) + bh * sq * d;
  const float* k = static_cast<const float*>(a.k) + bh * skv * d;
  const float* v = static_cast<const float*>(a.v) + bh * skv * d;

  load_tile<DP>(qs, S, q, r0, BR, sq, d);
  load_tile<DP>(dos, S, dout, r0, BR, sq, d);
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
    load_tile<DP>(ks, S, k, c0, kBC, skv, d);
    load_tile<DP>(vs, S, v, c0, kBC, skv, d);
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

  float* dq = static_cast<float*>(a.dq) + bh * sq * d;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int64_t r = r0 + ty * RM + i;
    if (r >= sq) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int c = tx + kTx * jj;
      if (c < d) dq[r * d + c] = acc[i][jj];
    }
  }
}

template <int DP>
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
  const float* q = static_cast<const float*>(a.q) + bh * sq * d;
  const float* dout = static_cast<const float*>(a.dout) + bh * sq * d;
  const float* k = static_cast<const float*>(a.k) + bh * skv * d;
  const float* v = static_cast<const float*>(a.v) + bh * skv * d;

  load_tile<DP>(ks, S, k, c0, BK, skv, d);
  load_tile<DP>(vs, S, v, c0, BK, skv, d);
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
    load_tile<DP>(qs, S, q, r0, kBC, sq, d);
    load_tile<DP>(dos, S, dout, r0, kBC, sq, d);
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

  float* dkg = static_cast<float*>(a.dk) + bh * skv * d;
  float* dvg = static_cast<float*>(a.dv) + bh * skv * d;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int64_t c = c0 + ty * RM + i;
    if (c >= skv) continue;
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int col = tx + kTx * jj;
      if (col < d) {
        dkg[c * d + col] = dk[i][jj];
        dvg[c * d + col] = dv[i][jj];
      }
    }
  }
}

template <int DP>
cudaError_t launch(const BwdArgs& a, int64_t bh, cudaStream_t stream) {
  constexpr int BR = kTy * rows_per_thread<DP>();
  const dim3 block(kTx, kTy);
  const size_t dq_smem = dq_smem_floats<DP>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dq_smem);
  if (err != cudaSuccess) return err;
  flash_dq_kernel<DP>
      <<<dim3((unsigned)bh, (unsigned)((a.sq + BR - 1) / BR)), block,
         dq_smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t dkv_smem = dkv_smem_floats<DP>() * sizeof(float);
  err = cudaFuncSetAttribute(flash_dkv_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dkv_smem);
  if (err != cudaSuccess) return err;
  flash_dkv_kernel<DP>
      <<<dim3((unsigned)bh, (unsigned)((a.band.skv + BR - 1) / BR)), block,
         dkv_smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch(const BwdArgs& a, int64_t bh, cudaStream_t stream) {
  if (a.d <= 16) return launch<16>(a, bh, stream);
  if (a.d <= 32) return launch<32>(a, bh, stream);
  if (a.d <= 64) return launch<64>(a, bh, stream);
  if (a.d <= 128) return launch<128>(a, bh, stream);
  if (a.d <= 256) return launch<256>(a, bh, stream);
  return cudaErrorInvalidValue;
}

// --- bf16: the tensor-core kernels -----------------------------------------

namespace tc = flash_tc;

template <int DP>
struct DqTc {
  // Warpgroups of 64 q rows, and the blocks an SM holds: at head dim 64,
  // three independent one-warpgroup blocks, whose products and
  // elementwise work interleave.
  static constexpr int kWgs = DP == 128 ? 2 : 1;
  static constexpr int kMinBlocks = DP <= 64 ? 3 : 1;
  static constexpr int BR = tc::kRows * kWgs;     // q rows of a block
  static constexpr int BC = tc::kRows;            // rows of a k/v tile
  static constexpr int kThreads = tc::kWarpgroup * kWgs;
  static constexpr int kQBytes = BR * DP * 2;    // Q or dO
  static constexpr int kKvBytes = BC * DP * 2;   // one stage of K or of V
  static constexpr size_t kSmem = 1024 + 2 * kQBytes + 4 * (size_t)kKvBytes;
};

template <int DP>
struct DkvTc {
  // Warpgroups on different key rows, warpgroups splitting dk's and dv's
  // columns, and the blocks an SM holds (as DqTc's).
  static constexpr int kKvWgs = DP == 128 ? 2 : 1;
  static constexpr int kColWgs = DP == 256 ? 2 : 1;
  static constexpr int kMinBlocks = DP <= 64 ? 3 : 1;
  static constexpr int BK = tc::kRows * kKvWgs;     // key rows of a block
  static constexpr int BQ = tc::kRows;              // rows of a q tile
  static constexpr int kThreads = tc::kWarpgroup * kKvWgs * kColWgs;
  static constexpr int kKBytes = BK * DP * 2;    // K or V
  static constexpr int kQBytes = BQ * DP * 2;    // one stage of Q or of dO
  static constexpr int kRowBytes = 2 * BQ * 4;   // one stage of lse and D
  static constexpr size_t kSmem =
      1024 + 2 * (size_t)kKBytes + 4 * (size_t)kQBytes + 2 * kRowBytes;
};

// The capped score x of a raw score, and dS's softcap factor
// 1 - (x / cap)^2 (1 without a softcap, kCap false): dS = p f (dP - D),
// and the caller scales dq and dk after their products.
template <bool kCap>
__device__ __forceinline__ float tc_score(const BwdArgs& a, float raw,
                                          float& f) {
  const float x = raw * a.scale;
  f = 1.f;
  if (!kCap) return x;
  const float c = a.softcap * tanhf(x / a.softcap), t = c / a.softcap;
  f = 1.f - t * t;
  return c;
}

template <int DP>
__global__ void __launch_bounds__(DqTc<DP>::kThreads, DqTc<DP>::kMinBlocks)
    flash_dq_tc(BwdArgs a, int vec) {
  using C = DqTc<DP>;
  constexpr int BR = C::BR, BC = C::BC, NT = C::kThreads, NB = DP / 64;
  extern __shared__ uint8_t dq_smem[];
  const uint32_t s_q = (tc::smem_addr(dq_smem) + 1023) & ~1023u;
  const uint32_t s_do = s_q + C::kQBytes;
  const uint32_t s_k = s_do + C::kQBytes;      // 2 stages
  const uint32_t s_v = s_k + 2 * C::kKvBytes;  // 2 stages

  const int tid = threadIdx.x, wg = tid / tc::kWarpgroup;
  const int warp = (tid % tc::kWarpgroup) / 32, g = (tid % 32) / 4;
  const int t = tid % 4;
  const int64_t bh = blockIdx.x;
  const int64_t sq = a.sq, skv = a.band.skv;
  const int d = a.d;
  const int64_t r0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * BR;
  const tc::bf16* q = static_cast<const tc::bf16*>(a.q) + bh * sq * d;
  const tc::bf16* dout = static_cast<const tc::bf16*>(a.dout) + bh * sq * d;
  const tc::bf16* k = static_cast<const tc::bf16*>(a.k) + bh * skv * d;
  const tc::bf16* v = static_cast<const tc::bf16*>(a.v) + bh * skv * d;

  const int64_t last = r0 + BR < sq ? r0 + BR : sq;
  const int64_t row_lo = a.q_offset + r0, row_hi = a.q_offset + last - 1;
  int64_t c_begin = 0, c_end = skv;
  if (a.band.has_window && row_lo - a.band.window + 1 > 0)
    c_begin = row_lo - a.band.window + 1;
  if (a.band.causal && row_hi + 1 < c_end) c_end = row_hi + 1;
  c_begin -= c_begin % BC;
  const int n_tiles =
      c_end > c_begin ? (int)((c_end - c_begin + BC - 1) / BC) : 0;

  tc::load_tile<BR, DP, NT>(s_q, q, r0, sq, d, vec);
  tc::load_tile<BR, DP, NT>(s_do, dout, r0, sq, d, vec);
  if (n_tiles > 0) {
    tc::load_tile<BC, DP, NT>(s_k, k, c_begin, skv, d, vec);
    tc::load_tile<BC, DP, NT>(s_v, v, c_begin, skv, d, vec);
  }
  tc::cp_async_commit();

  const int wr = tc::kRows * wg;
  const int64_t wrow = a.q_offset + r0 + wr;
  float lse2[2], dsum[2], dq[NB][32];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int64_t r = r0 + wr + 16 * warp + g + 8 * hh;
    lse2[hh] = r < sq ? a.lse[bh * sq + r] * tc::kLog2e : 0.f;
    dsum[hh] = r < sq ? a.dsum[bh * sq + r] : 0.f;
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[nb][i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int64_t c0 = c_begin + (int64_t)it * BC;
    const int st = it & 1;
    if (it + 1 < n_tiles) {
      tc::load_tile<BC, DP, NT>(s_k + (st ^ 1) * C::kKvBytes, k, c0 + BC, skv,
                                d, vec);
      tc::load_tile<BC, DP, NT>(s_v + (st ^ 1) * C::kKvBytes, v, c0 + BC, skv,
                                d, vec);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    tc::fence_async_smem();
    __syncthreads();
    const uint32_t kt = s_k + st * C::kKvBytes, vt = s_v + st * C::kKvBytes;

    // S = Q K^T and dP = dO V^T, in two commit groups, so that P is
    // computed while dP is still on the tensor cores.
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    tc::pin(s);
    tc::pin(dp);
    tc::wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd)
      tc::mma_ss<0>(s, tc::sw128_desc(s_q + tc::desc_offset<BR>(wr, 16 * kd)),
                    tc::sw128_desc(kt + tc::desc_offset<BC>(0, 16 * kd)),
                    kd > 0);
    tc::wgmma_commit();
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd)
      tc::mma_ss<0>(dp,
                    tc::sw128_desc(s_do + tc::desc_offset<BR>(wr, 16 * kd)),
                    tc::sw128_desc(vt + tc::desc_offset<BC>(0, 16 * kd)),
                    kd > 0);
    tc::wgmma_commit();
    tc::wgmma_wait<1>();
    tc::pin(s);

    // s <- p f (0 outside the band), then, with dP, dS = p f (dP - D).
    const bool edge =
        c0 + BC > skv || (a.band.causal && c0 + BC - 1 > wrow) ||
        (a.band.has_window && wrow + tc::kRows - 1 - c0 >= a.band.window);
    tc::by_case(edge, a.has_softcap, [&](auto kEdge, auto kCap) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1;
        float f;
        const float x = tc_score<decltype(kCap)::value>(a, s[i], f);
        const bool keep =
            !decltype(kEdge)::value ||
            a.band.keep(wrow + 16 * warp + g + 8 * hh,
                        c0 + 8 * (i >> 2) + 2 * t + (i & 1));
        s[i] = keep ? tc::exp2_approx(fmaf(x, tc::kLog2e, -lse2[hh])) * f
                    : 0.f;
      }
    });
    tc::wgmma_wait<0>();
    tc::pin(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= dp[i] - dsum[(i >> 1) & 1];

    // dQ += dS K: dS rounded to bf16 in registers, K (keys, d) read as
    // the MN-major B operand.
    uint32_t dsa[4][4];
    tc::to_a_frags(s, dsa);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) tc::pin(dq[nb]);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        tc::mma_rs<1>(dq[nb], dsa[kk],
                      tc::sw128_desc(kt + tc::desc_offset<BC>(16 * kk,
                                                              64 * nb)));
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) tc::pin(dq[nb]);
    __syncthreads();
  }

  tc::bf16* dqg = static_cast<tc::bf16*>(a.dq) + bh * sq * d;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int64_t r = r0 + wr + 16 * warp + g + 8 * hh;
    if (r >= sq) continue;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        tc::store_pair(dqg, r, 64 * nb + 8 * j + 2 * t, d,
                       dq[nb][4 * j + 2 * hh] * a.scale,
                       dq[nb][4 * j + 2 * hh + 1] * a.scale);
  }
}

template <int DP>
__global__ void __launch_bounds__(DkvTc<DP>::kThreads,
                                  DkvTc<DP>::kMinBlocks)
    flash_dkv_tc(BwdArgs a, int vec) {
  using C = DkvTc<DP>;
  constexpr int BK = C::BK, BQ = C::BQ, NT = C::kThreads;
  constexpr int NB = DP / 64 / C::kColWgs;  // 64-column blocks of dk, dv
  extern __shared__ uint8_t dkv_smem[];
  const uint32_t s_base = tc::smem_addr(dkv_smem);
  const uint32_t s_k = (s_base + 1023) & ~1023u;
  const uint32_t s_v = s_k + C::kKBytes;
  const uint32_t s_q = s_v + C::kKBytes;        // 2 stages
  const uint32_t s_do = s_q + 2 * C::kQBytes;   // 2 stages
  const uint32_t s_rows = s_do + 2 * C::kQBytes;  // 2 stages of lse, D
  const float* rows_f =
      reinterpret_cast<const float*>(dkv_smem + (s_rows - s_base));

  const int tid = threadIdx.x, wg = tid / tc::kWarpgroup;
  const int warp = (tid % tc::kWarpgroup) / 32, g = (tid % 32) / 4;
  const int t = tid % 4;
  const int kr = tc::kRows * (wg / C::kColWgs);  // first key row in the tile
  const int nb0 = (wg % C::kColWgs) * NB;        // first column block
  const int64_t bh = blockIdx.x;
  const int64_t sq = a.sq, skv = a.band.skv;
  const int d = a.d;
  const int64_t c0 = (int64_t)blockIdx.y * BK;  // the first tiles are longest
  const int64_t kcol = c0 + kr;                 // this warpgroup's first key
  const tc::bf16* q = static_cast<const tc::bf16*>(a.q) + bh * sq * d;
  const tc::bf16* dout = static_cast<const tc::bf16*>(a.dout) + bh * sq * d;
  const tc::bf16* k = static_cast<const tc::bf16*>(a.k) + bh * skv * d;
  const tc::bf16* v = static_cast<const tc::bf16*>(a.v) + bh * skv * d;
  const float* lse = a.lse + bh * sq;
  const float* dsg = a.dsum + bh * sq;

  // The q tiles whose rows can see a column of this block.
  const int64_t col_hi = (c0 + BK < skv ? c0 + BK : skv) - 1;
  int64_t r_begin = 0, r_end = sq;
  if (a.band.causal && c0 - a.q_offset > 0) r_begin = c0 - a.q_offset;
  if (a.band.has_window && col_hi + a.band.window - a.q_offset < r_end)
    r_end = col_hi + a.band.window - a.q_offset;
  r_begin -= r_begin % BQ;
  const int n_tiles =
      r_end > r_begin ? (int)((r_end - r_begin + BQ - 1) / BQ) : 0;

  tc::load_tile<BK, DP, NT>(s_k, k, c0, skv, d, vec);
  tc::load_tile<BK, DP, NT>(s_v, v, c0, skv, d, vec);
  if (n_tiles > 0) {
    tc::load_tile<BQ, DP, NT>(s_q, q, r_begin, sq, d, vec);
    tc::load_tile<BQ, DP, NT>(s_do, dout, r_begin, sq, d, vec);
    tc::load_floats<NT>(s_rows, lse + r_begin, BQ, sq - r_begin);
    tc::load_floats<NT>(s_rows + 4 * BQ, dsg + r_begin, BQ, sq - r_begin);
  }
  tc::cp_async_commit();

  float dk[NB][32], dv[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[nb][i] = dv[nb][i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int64_t r0 = r_begin + (int64_t)it * BQ;
    const int st = it & 1;
    if (it + 1 < n_tiles) {
      const int64_t r1 = r0 + BQ;
      const int ns = st ^ 1;
      tc::load_tile<BQ, DP, NT>(s_q + ns * C::kQBytes, q, r1, sq, d, vec);
      tc::load_tile<BQ, DP, NT>(s_do + ns * C::kQBytes, dout, r1, sq, d, vec);
      tc::load_floats<NT>(s_rows + ns * C::kRowBytes, lse + r1, BQ, sq - r1);
      tc::load_floats<NT>(s_rows + ns * C::kRowBytes + 4 * BQ, dsg + r1, BQ,
                          sq - r1);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    tc::fence_async_smem();
    __syncthreads();
    const uint32_t qt = s_q + st * C::kQBytes, dot = s_do + st * C::kQBytes;
    const float* lse_t = rows_f + st * 2 * BQ;  // lse of the tile's rows
    const float* dsum_t = lse_t + BQ;           // and rowsum(dO * O)

    // S^T = K Q^T and dP^T = V dO^T for this warpgroup's 64 keys, in two
    // commit groups: P^T and dV's product start while dP^T still runs.
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    tc::pin(s);
    tc::pin(dp);
    tc::wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd)
      tc::mma_ss<0>(s, tc::sw128_desc(s_k + tc::desc_offset<BK>(kr, 16 * kd)),
                    tc::sw128_desc(qt + tc::desc_offset<BQ>(0, 16 * kd)),
                    kd > 0);
    tc::wgmma_commit();
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd)
      tc::mma_ss<0>(dp, tc::sw128_desc(s_v + tc::desc_offset<BK>(kr, 16 * kd)),
                    tc::sw128_desc(dot + tc::desc_offset<BQ>(0, 16 * kd)),
                    kd > 0);
    tc::wgmma_commit();
    tc::wgmma_wait<1>();
    tc::pin(s);

    // Element i: key kcol + 16 warp + g + 8 hh, query row r0 + qc. P^T
    // goes to bf16 A fragments for dV as it is made; s keeps p f.
    const bool edge =
        r0 + BQ > sq || kcol + tc::kRows > skv ||
        (a.band.causal && kcol + tc::kRows - 1 > a.q_offset + r0) ||
        (a.band.has_window &&
         a.q_offset + r0 + BQ - 1 - kcol >= a.band.window);
    uint32_t pa[4][4];
    tc::by_case(edge, a.has_softcap, [&](auto kEdge, auto kCap) {
      auto prob = [&](int i) {
        const int qc = 8 * (i >> 2) + 2 * t + (i & 1);
        float f;
        const float x = tc_score<decltype(kCap)::value>(a, s[i], f);
        const bool keep =
            !decltype(kEdge)::value ||
            (r0 + qc < sq &&
             a.band.keep(a.q_offset + r0 + qc,
                         kcol + 16 * warp + g + 8 * ((i >> 1) & 1)));
        const float p =
            keep ? tc::exp2_approx(fmaf(x, tc::kLog2e,
                                        -lse_t[qc] * tc::kLog2e))
                 : 0.f;
        s[i] = p * f;
        return p;
      };
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const float p0 = prob(i), p1 = prob(i + 1);
        pa[i >> 3][(i >> 1) & 3] = tc::pack_bf16(p0, p1);
      }
    });

    // dV += P^T dO, P^T rounded to bf16, dO (rows, d) read as the MN-major
    // B operand.
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      tc::pin(dk[nb]);
      tc::pin(dv[nb]);
    }
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        tc::mma_rs<1>(dv[nb], pa[kk],
                      tc::sw128_desc(dot + tc::desc_offset<BQ>(
                                               16 * kk, 64 * (nb0 + nb))));
    tc::wgmma_commit();

    // dS^T = p f (dP^T - D), then dK += dS^T Q with dS^T rounded to bf16.
    tc::wgmma_wait<1>();
    tc::pin(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      s[i] *= dp[i] - dsum_t[8 * (i >> 2) + 2 * t + (i & 1)];
    uint32_t dsa[4][4];
    tc::to_a_frags(s, dsa);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        tc::mma_rs<1>(dk[nb], dsa[kk],
                      tc::sw128_desc(qt + tc::desc_offset<BQ>(
                                              16 * kk, 64 * (nb0 + nb))));
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      tc::pin(dk[nb]);
      tc::pin(dv[nb]);
    }
    __syncthreads();
  }

  tc::bf16* dkg = static_cast<tc::bf16*>(a.dk) + bh * skv * d;
  tc::bf16* dvg = static_cast<tc::bf16*>(a.dv) + bh * skv * d;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int64_t c = kcol + 16 * warp + g + 8 * hh;
    if (c >= skv) continue;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * (nb0 + nb) + 8 * j + 2 * t;
        tc::store_pair(dkg, c, col, d, dk[nb][4 * j + 2 * hh] * a.scale,
                       dk[nb][4 * j + 2 * hh + 1] * a.scale);
        tc::store_pair(dvg, c, col, d, dv[nb][4 * j + 2 * hh],
                       dv[nb][4 * j + 2 * hh + 1]);
      }
  }
}

template <int DP>
cudaError_t launch_tc(const BwdArgs& a, int64_t bh, int vec,
                      cudaStream_t stream) {
  using Q = DqTc<DP>;
  using K = DkvTc<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_tc<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Q::kSmem);
  if (err != cudaSuccess) return err;
  flash_dq_tc<DP><<<dim3((unsigned)bh, (unsigned)((a.sq + Q::BR - 1) / Q::BR)),
                    Q::kThreads, Q::kSmem, stream>>>(a, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_dkv_tc<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)K::kSmem);
  if (err != cudaSuccess) return err;
  flash_dkv_tc<DP>
      <<<dim3((unsigned)bh, (unsigned)((a.band.skv + K::BK - 1) / K::BK)),
         K::kThreads, K::kSmem, stream>>>(a, vec);
  return cudaGetLastError();
}

cudaError_t dispatch_tc(const BwdArgs& a, int64_t bh, int vec,
                        cudaStream_t stream) {
  if (a.d <= 64) return launch_tc<64>(a, bh, vec, stream);
  if (a.d <= 128) return launch_tc<128>(a, bh, vec, stream);
  if (a.d <= 256) return launch_tc<256>(a, bh, vec, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, dout (bh, sq, d); k, v (bh, skv, d); lse, dsum (bh, sq) f32; dq, dk,
// dv like q, k, v. All contiguous, f32 or bf16 (is_bf16), d <= 256. Launches
// the dq kernel, then the dk/dv kernel, on `stream` (the tensor-core
// kernels for bf16, the first-version kernels for f32); returns the first
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
  if (!is_bf16) return (int)dispatch(a, bh, s);
  const int vec = d % 8 == 0 && flash::aligned16(q) && flash::aligned16(k) &&
                  flash::aligned16(v) && flash::aligned16(dout);
  return (int)dispatch_tc(a, bh, vec, s);
}
