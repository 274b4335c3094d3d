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
// 34 MB, far above the card's ridge point: 0.139 ms at the 989 TFLOP/s
// bf16 tensor-core peak.
//
// bf16 (flash_fwd_tc): the tensor-core kernel. One block per (batch *
// head, tile of 128 query rows), two warpgroups of 64 rows each, two
// blocks to an SM at head dim 64; q tiles are launched longest first,
// which evens out the causal triangle. The q tile is staged once; the
// 64-row k/v tiles of the band go through a 2-stage ring in shared
// memory, filled by cp.async while the previous tile computes, in the
// 128-byte swizzle that wgmma reads (flash_wgmma.cuh). Per k/v tile and
// warpgroup: S = Q K^T on wgmma, f32 accumulators; the online softmax in
// those registers (scale, softcap, and the mask only on tiles that cross
// the band's edge, each case compiled on its own; a row reduces over its
// quad; exp2 on the special-function unit); P rounded to bf16 in
// registers becomes the A operand of O += P V, with V read through the
// transpose bit. The row sum l is that of the f32 p. So P is rounded
// against the running max, where the plain version (ref.flash_fwd) rounds
// it against the final one. Tiles wholly outside the band are skipped.
//
// f32 (flash_fwd_kernel): the first-version kernel, kept for f32 inputs,
// where the tensor cores would round (TF32) and the f32 checks hold the
// kernel to 1e-5. Scores, the running max and sum, P and the P.V product
// are f32 on the CUDA cores; one block per (batch * head, tile of 64
// query rows; 32 at head dim 256) walks the 64-wide k/v tiles of its
// band, each thread holding a 4 x 4 block of scores and 4 rows x
// (DP / 16) columns of the output.
//
// The dtype picks the kernel (flash_fwd_launch): bf16 always runs
// flash_fwd_tc, f32 always flash_fwd_kernel; neither falls back.

#include <math.h>

#include "flash_common.cuh"
#include "flash_wgmma.cuh"

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

template <int DP>
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
  const float* q = static_cast<const float*>(a.q) + bh * sq * d;
  const float* k = static_cast<const float*>(a.k) + kvh * skv * d;
  const float* v = static_cast<const float*>(a.v) + kvh * skv * d;

  load_tile<DP>(qs, S, q, r0, BR, sq, d);

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
    load_tile<DP>(ks, S, k, c0, kBC, skv, d);
    load_tile<DP>(vs, DP, v, c0, kBC, skv, d);
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

  float* o = static_cast<float*>(a.o) + bh * sq * d;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int64_t r = r0 + ty * RM + i;
    if (r >= sq) continue;
    const float ls = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int jj = 0; jj < DJ; ++jj) {
      const int c = tx + kTx * jj;
      if (c < d) o[r * d + c] = acc[i][jj] / ls;
    }
    if (a.lse != nullptr && tx == 0) a.lse[bh * sq + r] = m[i] + logf(ls);
  }
}

template <int DP>
cudaError_t launch(const FwdArgs& a, int64_t bh, cudaStream_t stream) {
  constexpr int BR = kTy * rows_per_thread<DP>();
  const size_t smem = fwd_smem_floats<DP>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)bh, (unsigned)((a.sq + BR - 1) / BR));
  flash_fwd_kernel<DP><<<grid, dim3(kTx, kTy), smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch(const FwdArgs& a, int64_t bh, cudaStream_t stream) {
  if (a.d <= 16) return launch<16>(a, bh, stream);
  if (a.d <= 32) return launch<32>(a, bh, stream);
  if (a.d <= 64) return launch<64>(a, bh, stream);
  if (a.d <= 128) return launch<128>(a, bh, stream);
  if (a.d <= 256) return launch<256>(a, bh, stream);
  return cudaErrorInvalidValue;
}

// --- bf16: the tensor-core kernel ------------------------------------------

namespace tc = flash_tc;

template <int DP>
struct FwdTc {
  static constexpr int kWgs = 2;               // warpgroups of 64 q rows
  static constexpr int BR = tc::kRows * kWgs;  // q rows of a block
  static constexpr int BC = tc::kRows;         // rows of a k/v tile
  static constexpr int kThreads = tc::kWarpgroup * kWgs;
  static constexpr int kQBytes = BR * DP * 2;
  static constexpr int kKvBytes = BC * DP * 2;  // one stage of K or of V
  static constexpr size_t kSmem = 1024 + kQBytes + 4 * (size_t)kKvBytes;
  // At head dim 64 two blocks share an SM (at most 128 registers a
  // thread), so one block's softmax overlaps the other's products.
  static constexpr int kMinBlocks = DP <= 64 ? 2 : 1;
};

template <int DP>
__global__ void __launch_bounds__(FwdTc<DP>::kThreads, FwdTc<DP>::kMinBlocks)
    flash_fwd_tc(FwdArgs a, int vec) {
  using C = FwdTc<DP>;
  constexpr int BR = C::BR, BC = C::BC, NT = C::kThreads, NB = DP / 64;
  extern __shared__ uint8_t fwd_smem[];
  const uint32_t s_q = (tc::smem_addr(fwd_smem) + 1023) & ~1023u;
  const uint32_t s_k = s_q + C::kQBytes;       // 2 stages
  const uint32_t s_v = s_k + 2 * C::kKvBytes;  // 2 stages

  const int tid = threadIdx.x, wg = tid / tc::kWarpgroup;
  const int warp = (tid % tc::kWarpgroup) / 32, g = (tid % 32) / 4;
  const int t = tid % 4;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / a.hq, h = bh % a.hq;
  const int64_t kvh = b * a.hkv + h / (a.hq / a.hkv);
  const int64_t sq = a.sq, skv = a.band.skv;
  const int d = a.d;
  // Longest q tiles first: under the causal mask the last tile is longest.
  const int64_t r0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * BR;
  const tc::bf16* q = static_cast<const tc::bf16*>(a.q) + bh * sq * d;
  const tc::bf16* k = static_cast<const tc::bf16*>(a.k) + kvh * skv * d;
  const tc::bf16* v = static_cast<const tc::bf16*>(a.v) + kvh * skv * d;

  // The k/v tiles that can hold a kept column for some row of this block.
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
  if (n_tiles > 0) {
    tc::load_tile<BC, DP, NT>(s_k, k, c_begin, skv, d, vec);
    tc::load_tile<BC, DP, NT>(s_v, v, c_begin, skv, d, vec);
  }
  tc::cp_async_commit();

  // This warpgroup's rows: wr .. wr + 63 of the tile; this thread's are
  // wr + 16 warp + g and that + 8 (accumulator halves hh = 0, 1).
  const int wr = tc::kRows * wg;
  const int64_t wrow = a.q_offset + r0 + wr;  // absolute row of the first
  float o[NB][32], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[nb][i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int64_t c0 = c_begin + (int64_t)it * BC;
    const int st = it & 1;
    if (it + 1 < n_tiles) {  // the next tile into the other stage
      tc::load_tile<BC, DP, NT>(s_k + (st ^ 1) * C::kKvBytes, k, c0 + BC, skv,
                                d, vec);
      tc::load_tile<BC, DP, NT>(s_v + (st ^ 1) * C::kKvBytes, v, c0 + BC, skv,
                                d, vec);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // this tile (and the q tile) has landed
    tc::fence_async_smem();
    __syncthreads();
    const uint32_t kt = s_k + st * C::kKvBytes, vt = s_v + st * C::kKvBytes;

    // S = Q K^T for this warpgroup's 64 rows.
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    tc::pin(s);
    tc::wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd)
      tc::mma_ss<0>(s, tc::sw128_desc(s_q + tc::desc_offset<BR>(wr, 16 * kd)),
                    tc::sw128_desc(kt + tc::desc_offset<BC>(0, 16 * kd)),
                    kd > 0);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    tc::pin(s);

    // Scale, softcap and (on tiles that cross the band's edge) mask; a
    // masked score is -inf, so its p is 0, while the running max starts
    // at -1e30 as the TPU kernel's does.
    const bool edge =
        c0 + BC > skv || (a.band.causal && c0 + BC - 1 > wrow) ||
        (a.band.has_window && wrow + tc::kRows - 1 - c0 >= a.band.window);
    float mx[2] = {kNegInf, kNegInf};
    tc::by_case(edge, a.has_softcap, [&](auto kEdge, auto kCap) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1;
        float x = s[i] * a.scale;
        if (decltype(kCap)::value) x = a.softcap * tanhf(x / a.softcap);
        if (decltype(kEdge)::value &&
            !a.band.keep(wrow + 16 * warp + g + 8 * hh,
                         c0 + 8 * (i >> 2) + 2 * t + (i & 1)))
          x = -INFINITY;
        s[i] = x;
        mx[hh] = fmaxf(mx[hh], x);
      }
    });
    float alpha[2], mb[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float m_new = fmaxf(m[hh], tc::quad_max(mx[hh]));
      alpha[hh] = tc::exp2_approx((m[hh] - m_new) * tc::kLog2e);
      m[hh] = m_new;
      mb[hh] = m_new * tc::kLog2e;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      const float p = tc::exp2_approx(fmaf(s[i], tc::kLog2e, -mb[hh]));
      s[i] = p;
      rs[hh] += p;  // this thread's part of the row sum, of the f32 p
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + rs[hh];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[nb][i] *= alpha[(i >> 1) & 1];

    // O += P V: P rounded to bf16 in registers, V (keys, d) read as the
    // MN-major B operand.
    uint32_t pa[4][4];
    tc::to_a_frags(s, pa);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) tc::pin(o[nb]);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BC / 16; ++kk)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        tc::mma_rs<1>(o[nb], pa[kk],
                      tc::sw128_desc(vt + tc::desc_offset<BC>(16 * kk,
                                                              64 * nb)));
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) tc::pin(o[nb]);
    __syncthreads();  // every warpgroup is done with this stage
  }

  tc::bf16* out = static_cast<tc::bf16*>(a.o) + bh * sq * d;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float lsum = tc::quad_sum(l[hh]);
    const float ls = lsum == 0.f ? 1.f : lsum;
    const int64_t r = r0 + wr + 16 * warp + g + 8 * hh;
    if (r >= sq) continue;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        tc::store_pair(out, r, 64 * nb + 8 * j + 2 * t, d,
                       o[nb][4 * j + 2 * hh] / ls,
                       o[nb][4 * j + 2 * hh + 1] / ls);
    if (a.lse != nullptr && t == 0) a.lse[bh * sq + r] = m[hh] + logf(ls);
  }
}

template <int DP>
cudaError_t launch_tc(const FwdArgs& a, int64_t bh, int vec,
                      cudaStream_t stream) {
  using C = FwdTc<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)bh, (unsigned)((a.sq + C::BR - 1) / C::BR));
  flash_fwd_tc<DP><<<grid, C::kThreads, C::kSmem, stream>>>(a, vec);
  return cudaGetLastError();
}

cudaError_t dispatch_tc(const FwdArgs& a, int64_t bh, int vec,
                        cudaStream_t stream) {
  if (a.d <= 64) return launch_tc<64>(a, bh, vec, stream);
  if (a.d <= 128) return launch_tc<128>(a, bh, vec, stream);
  if (a.d <= 256) return launch_tc<256>(a, bh, vec, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (batch, hq, sq, d); k, v (batch, hkv, skv, d), hq a multiple of hkv;
// o like q; lse (batch, hq, sq) f32 or null. All contiguous, f32 or bf16
// (is_bf16), d <= 256. window is read when has_window, softcap when
// has_softcap. bf16 runs the tensor-core kernel, f32 the first-version
// kernel. Returns the cudaError_t of the launch.
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
  if (!is_bf16) return (int)dispatch(a, bh, s);
  const int vec = d % 8 == 0 && flash::aligned16(q) && flash::aligned16(k) &&
                  flash::aligned16(v);
  return (int)dispatch_tc(a, bh, vec, s);
}
