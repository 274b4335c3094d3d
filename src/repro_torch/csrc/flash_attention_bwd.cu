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
// are 3.4e11 FLOP on about 70 MB (bf16; 140 MB in f32): 0.35 ms at the
// 989 TFLOP/s bf16 peak; in f32, at six bf16 products a product, 2.08 ms
// at 165 TFLOP/s effective.
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
// f32 (flash_dq_f32, flash_dkv_f32): the same products on the tensor
// cores at f32 accuracy, each f32 operand split into three bf16 parts and
// each product taken as six bf16 products (flash_wgmma.cuh; the forward's
// note says why not TF32). A block is one warpgroup of 64 rows. Its own
// rows (Q and dO for dq, K and V for dk/dv) are staged split once; the
// walked tiles stream through 64-column chunks, each copied by cp.async
// into an f32 staging area a step ahead and split into one of two slots
// while the previous chunk's products run. Per walked tile:
// - dq: K's column blocks (S), V's (dP), then K's again (each a block of
//   dQ += dS K, dS split in registers);
// - dk, dv: Q's blocks (S^T), dO's (dP^T; at the block's own column
//   blocks also dV += P^T dO, P^T split in registers), then Q's own blocks
//   (dK += dS^T Q). A block computes two 64-column blocks of dk and dv
//   (one at head dim 64); at head dim 256 the two blocks of a key tile
//   (grid z) each recompute S^T and dP^T, so that a block's accumulators
//   stay within its registers.
// Each chunk's product goes into a fresh accumulator and is added to its
// sum in f32 on the CUDA cores; p = exp(s - lse) with expf, as the plain
// version computes it. The walked tiles are 32 rows (m64n32k16 for the
// scores) in dq at head dim 256, where two split 64-row tiles of 256
// columns fill 192 KB of shared memory, and in dk/dv from head dim 128,
// where they halve the registers of the scores and of P^T's fragments.
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

// --- f32: the split tensor-core kernels -------------------------------------

// The score x of a raw f32 score, and p = exp(x - lse) f (0 outside the
// band) with dS's softcap factor f, as the plain version computes them.
template <bool kCap>
__device__ __forceinline__ float f32_prob(const BwdArgs& a, float raw,
                                          float lse, bool keep, float& p) {
  float f;
  const float x = tc_score<kCap>(a, raw, f);
  p = keep ? expf(x - lse) : 0.f;
  return p * f;
}

template <int DP>
struct DqF32 {
  static constexpr int NB = DP / 64;
  static constexpr int BR = tc::kRows;          // q rows: one warpgroup
  static constexpr int BC = DP == 256 ? 32 : 64;  // rows of a k/v tile
  static constexpr int NT = tc::kWarpgroup;
  static constexpr uint32_t kQPart = BR * DP * 2;      // a part of Q or dO
  static constexpr uint32_t kChunkPart = BC * 64 * 2;  // a part of a chunk
  static constexpr uint32_t kSlot = 3 * kChunkPart;
  static constexpr size_t kSmem =
      1024 + 6 * (size_t)kQPart + 2 * (size_t)kSlot + BC * 64 * 4;
};

template <int DP>
struct DkvF32 {
  static constexpr int NB = DP / 64;
  static constexpr int NC = NB < 2 ? NB : 2;      // column blocks a block
  static constexpr int BK = tc::kRows;            // key rows: one warpgroup
  static constexpr int BQ = DP >= 128 ? 32 : 64;  // rows of a q tile
  static constexpr int NT = tc::kWarpgroup;
  static constexpr uint32_t kKPart = BK * DP * 2;      // a part of K or V
  static constexpr uint32_t kChunkPart = BQ * 64 * 2;  // a part of a chunk
  static constexpr uint32_t kSlot = 3 * kChunkPart;
  static constexpr size_t kSmem =
      1024 + 6 * (size_t)kKPart + 2 * (size_t)kSlot + BQ * 64 * 4;
};

// Rows [r0, r0 + 64) of a (rows, d) f32 matrix, split, into the 64-row
// tile at `dst` (parts `part` bytes apart), through the staging area in
// R-row chunks.
template <int DP, int R, int NT>
__device__ __forceinline__ void stage_rows(uint32_t dst, uint32_t part,
                                           uint32_t stg, const float* src,
                                           int64_t r0, int64_t rows, int d,
                                           bool vec) {
#pragma unroll 1
  for (int cb = 0; cb < DP / 64; ++cb)
#pragma unroll 1
    for (int rr = 0; rr < tc::kRows; rr += R) {
      tc::stage_chunk<R, NT>(stg, src, r0 + rr, rows, 64 * cb, d, vec);
      tc::cp_async_commit();
      tc::cp_async_wait<0>();
      tc::split_chunk<R, tc::kRows, NT>(dst, part, stg, rr, cb);
    }
}

template <int DP>
__global__ void __launch_bounds__(DqF32<DP>::NT, 1)
    flash_dq_f32(BwdArgs a, int vec) {
  using C = DqF32<DP>;
  constexpr int NB = C::NB, BR = C::BR, BC = C::BC, NT = C::NT;
  constexpr int KS = BC / 16;  // k-steps of dS K
  extern __shared__ uint8_t dq_f32_smem[];
  const uint32_t s_q = (tc::smem_addr(dq_f32_smem) + 1023) & ~1023u;
  const uint32_t s_do = s_q + 3 * C::kQPart;
  const uint32_t s_slot = s_do + 3 * C::kQPart;  // 2 slots
  const uint32_t s_stg = s_slot + 2 * C::kSlot;

  const int tid = threadIdx.x, warp = tid / 32, g = (tid % 32) / 4;
  const int t = tid % 4;
  const int64_t bh = blockIdx.x;
  const int64_t sq = a.sq, skv = a.band.skv;
  const int d = a.d;
  const int64_t r0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * BR;
  const float* q = static_cast<const float*>(a.q) + bh * sq * d;
  const float* dout = static_cast<const float*>(a.dout) + bh * sq * d;
  const float* k = static_cast<const float*>(a.k) + bh * skv * d;
  const float* v = static_cast<const float*>(a.v) + bh * skv * d;

  const int64_t last = r0 + BR < sq ? r0 + BR : sq;
  const int64_t row_lo = a.q_offset + r0, row_hi = a.q_offset + last - 1;
  int64_t c_begin = 0, c_end = skv;
  if (a.band.has_window && row_lo - a.band.window + 1 > 0)
    c_begin = row_lo - a.band.window + 1;
  if (a.band.causal && row_hi + 1 < c_end) c_end = row_hi + 1;
  c_begin -= c_begin % BC;
  const int n_tiles =
      c_end > c_begin ? (int)((c_end - c_begin + BC - 1) / BC) : 0;
  // Chunk ci: k/v tile ci / (3 NB); j = ci % (3 NB): K's column block j
  // (S += Q K^T over it), V's block j - NB (dP += dO V^T), K's block
  // j - 2 NB (dQ's columns of that block += dS K).
  const int n_chunks = n_tiles * 3 * NB;
  auto stage = [&](int ci) {
    const int j = ci % (3 * NB);
    tc::stage_chunk<BC, NT>(s_stg, j >= NB && j < 2 * NB ? v : k,
                            c_begin + (int64_t)(ci / (3 * NB)) * BC, skv,
                            64 * (j % NB), d, vec);
    tc::cp_async_commit();
  };

  stage_rows<DP, BC, NT>(s_q, C::kQPart, s_stg, q, r0, sq, d, vec);
  stage_rows<DP, BC, NT>(s_do, C::kQPart, s_stg, dout, r0, sq, d, vec);
  if (n_chunks > 0) {
    stage(0);
    tc::cp_async_wait<0>();
    tc::split_chunk<BC, BC, NT>(s_slot, C::kChunkPart, s_stg, 0, 0);
    if (n_chunks > 1) stage(1);
  }

  const int64_t wrow = a.q_offset + r0;
  float lse[2], dsum[2], dq[NB][32], s[BC / 2], dp[BC / 2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int64_t r = r0 + 16 * warp + g + 8 * hh;
    lse[hh] = r < sq ? a.lse[bh * sq + r] : 0.f;
    dsum[hh] = r < sq ? a.dsum[bh * sq + r] : 0.f;
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[nb][i] = 0.f;
#pragma unroll
  for (int i = 0; i < BC / 2; ++i) s[i] = dp[i] = 0.f;
  uint32_t dsa[3][KS][4];

  // The chunk loop, unrolled over a tile's chunks so that j, and with it
  // every accumulator's index, is known at compile time.
#pragma unroll 1
  for (int it = 0; it < n_tiles; ++it) {
    const int64_t c0 = c_begin + (int64_t)it * BC;
#pragma unroll
    for (int j = 0; j < 3 * NB; ++j) {
      const int ci = it * 3 * NB + j;
      const uint32_t slot = s_slot + (ci & 1) * C::kSlot;
      tc::fence_async_smem();
      __syncthreads();

      // A score chunk (sc) or an output block (acc), fresh: the first
      // product of each starts the sum.
      float sc[BC / 2], acc[32];
      if (j < 2 * NB) {  // Q K^T or dO V^T over column block j % NB
        const uint32_t s_a = j < NB ? s_q : s_do;
        tc::wgmma_fence();
        tc::mma_ss_split<0, 4>(
            sc,
            [&](int p, int kd) {
              return tc::sw128_desc(s_a + p * C::kQPart +
                                    tc::desc_offset<BR>(0, 64 * (j % NB) +
                                                               16 * kd));
            },
            [&](int p, int kd) {
              return tc::sw128_desc(slot + p * C::kChunkPart +
                                    tc::desc_offset<BC>(0, 16 * kd));
            });
      } else {  // dS K, K (keys, d) read as the MN-major B operand
        tc::wgmma_fence();
        tc::mma_rs_split<1, KS>(acc, dsa, [&](int p, int kk) {
          return tc::sw128_desc(slot + p * C::kChunkPart +
                                tc::desc_offset<BC>(16 * kk, 0));
        });
      }
      tc::wgmma_commit();
      if (ci + 1 < n_chunks) {
        tc::cp_async_wait<0>();
        tc::split_chunk<BC, BC, NT>(s_slot + ((ci + 1) & 1) * C::kSlot,
                                    C::kChunkPart, s_stg, 0, 0);
        if (ci + 2 < n_chunks) stage(ci + 2);
      }
      tc::wgmma_wait<0>();
      if (j < 2 * NB) {
        tc::pin(sc);
      } else {
        tc::pin(acc);
        tc::pin(dsa);
      }

      if (j >= 2 * NB) {
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          if (nb == j - 2 * NB)
#pragma unroll
            for (int i = 0; i < 32; ++i) dq[nb][i] += acc[i];
        continue;
      }
      if (j < NB) {
#pragma unroll
        for (int i = 0; i < BC / 2; ++i) s[i] = j == 0 ? sc[i] : s[i] + sc[i];
        if (j == NB - 1) {  // s <- p f, 0 outside the band
          const bool edge =
              c0 + BC > skv || (a.band.causal && c0 + BC - 1 > wrow) ||
              (a.band.has_window && wrow + tc::kRows - 1 - c0 >= a.band.window);
          tc::by_case(edge, a.has_softcap, [&](auto kEdge, auto kCap) {
#pragma unroll
            for (int i = 0; i < BC / 2; ++i) {
              const int hh = (i >> 1) & 1;
              const bool keep =
                  !decltype(kEdge)::value ||
                  a.band.keep(wrow + 16 * warp + g + 8 * hh,
                              c0 + 8 * (i >> 2) + 2 * t + (i & 1));
              float p;
              s[i] = f32_prob<decltype(kCap)::value>(a, s[i], lse[hh], keep,
                                                     p);
            }
          });
        }
        continue;
      }
#pragma unroll
      for (int i = 0; i < BC / 2; ++i)
        dp[i] = j == NB ? sc[i] : dp[i] + sc[i];
      if (j == 2 * NB - 1) {  // dS = p f (dP - D), split for dS K
#pragma unroll
        for (int i = 0; i < BC / 2; ++i) s[i] *= dp[i] - dsum[(i >> 1) & 1];
        tc::to_a_frags3(s, dsa);
      }
    }
  }

  float* dqg = static_cast<float*>(a.dq) + bh * sq * d;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int64_t r = r0 + 16 * warp + g + 8 * hh;
    if (r >= sq) continue;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        tc::store_pair(dqg, r, 64 * nb + 8 * jj + 2 * t, d,
                       dq[nb][4 * jj + 2 * hh] * a.scale,
                       dq[nb][4 * jj + 2 * hh + 1] * a.scale);
  }
}

// dk and dv of NC 64-column blocks (from NC blockIdx.z) of one tile of 64
// keys. At head dim 256 the two blocks of a tile each recompute S^T and
// dP^T, which keeps a block's accumulators within its registers.
template <int DP>
__global__ void __launch_bounds__(DkvF32<DP>::NT, 1)
    flash_dkv_f32(BwdArgs a, int vec) {
  using C = DkvF32<DP>;
  constexpr int NB = C::NB, NC = C::NC, BK = C::BK, BQ = C::BQ;
  constexpr int NT = C::NT;
  constexpr int KS = BQ / 16;  // k-steps of P^T dO and dS^T Q
  extern __shared__ uint8_t dkv_f32_smem[];
  const uint32_t s_k = (tc::smem_addr(dkv_f32_smem) + 1023) & ~1023u;
  const uint32_t s_v = s_k + 3 * C::kKPart;
  const uint32_t s_slot = s_v + 3 * C::kKPart;  // 2 slots
  const uint32_t s_stg = s_slot + 2 * C::kSlot;

  const int tid = threadIdx.x, warp = tid / 32, g = (tid % 32) / 4;
  const int t = tid % 4;
  const int cb = NC * blockIdx.z;  // the first column block of dk and dv
  const int64_t bh = blockIdx.x;
  const int64_t sq = a.sq, skv = a.band.skv;
  const int d = a.d;
  const int64_t c0 = (int64_t)blockIdx.y * BK;  // the first tiles are longest
  const float* q = static_cast<const float*>(a.q) + bh * sq * d;
  const float* dout = static_cast<const float*>(a.dout) + bh * sq * d;
  const float* k = static_cast<const float*>(a.k) + bh * skv * d;
  const float* v = static_cast<const float*>(a.v) + bh * skv * d;
  const float* lse = a.lse + bh * sq;
  const float* dsg = a.dsum + bh * sq;

  const int64_t col_hi = (c0 + BK < skv ? c0 + BK : skv) - 1;
  int64_t r_begin = 0, r_end = sq;
  if (a.band.causal && c0 - a.q_offset > 0) r_begin = c0 - a.q_offset;
  if (a.band.has_window && col_hi + a.band.window - a.q_offset < r_end)
    r_end = col_hi + a.band.window - a.q_offset;
  r_begin -= r_begin % BQ;
  const int n_tiles =
      r_end > r_begin ? (int)((r_end - r_begin + BQ - 1) / BQ) : 0;
  // Chunk ci: q tile ci / (2 NB + NC); j = ci % (2 NB + NC): Q's column
  // block j (S^T += K Q^T over it), dO's block j - NB (dP^T += V dO^T;
  // at the blocks cb + x also dV's x-th += P^T dO), and last Q's blocks cb
  // + x (dK's x-th += dS^T Q).
  constexpr int kPer = 2 * NB + NC;
  const int n_chunks = n_tiles * kPer;
  auto stage = [&](int ci) {
    const int j = ci % kPer;
    tc::stage_chunk<BQ, NT>(s_stg, j >= NB && j < 2 * NB ? dout : q,
                            r_begin + (int64_t)(ci / kPer) * BQ, sq,
                            64 * (j >= 2 * NB ? cb + j - 2 * NB : j % NB), d,
                            vec);
    tc::cp_async_commit();
  };

  stage_rows<DP, BQ, NT>(s_k, C::kKPart, s_stg, k, c0, skv, d, vec);
  stage_rows<DP, BQ, NT>(s_v, C::kKPart, s_stg, v, c0, skv, d, vec);
  if (n_chunks > 0) {
    stage(0);
    tc::cp_async_wait<0>();
    tc::split_chunk<BQ, BQ, NT>(s_slot, C::kChunkPart, s_stg, 0, 0);
    if (n_chunks > 1) stage(1);
  }

  float dk[NC][32], dv[NC][32], s[BQ / 2], dp[BQ / 2];
#pragma unroll
  for (int x = 0; x < NC; ++x)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[x][i] = dv[x][i] = 0.f;
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;
  uint32_t pa[3][KS][4], dsa[3][KS][4];

  // The chunk loop, unrolled over a tile's chunks so that j is known at
  // compile time.
#pragma unroll 1
  for (int it = 0; it < n_tiles; ++it) {
    const int64_t r0 = r_begin + (int64_t)it * BQ;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int ci = it * kPer + j;
      const uint32_t slot = s_slot + (ci & 1) * C::kSlot;
      auto b_desc = [&](int p, int kk) {  // the chunk as the MN-major B
        return tc::sw128_desc(slot + p * C::kChunkPart +
                              tc::desc_offset<BQ>(16 * kk, 0));
      };
      tc::fence_async_smem();
      __syncthreads();

      // A score chunk (sc) or an output block (acc), fresh: the first
      // product of each starts the sum.
      float sc[BQ / 2], acc[32];
      if (j < 2 * NB) {  // K Q^T or V dO^T over column block j % NB
        const uint32_t s_a = j < NB ? s_k : s_v;
        tc::wgmma_fence();
        tc::mma_ss_split<0, 4>(
            sc,
            [&](int p, int kd) {
              return tc::sw128_desc(s_a + p * C::kKPart +
                                    tc::desc_offset<BK>(0, 64 * (j % NB) +
                                                               16 * kd));
            },
            [&](int p, int kd) {
              return tc::sw128_desc(slot + p * C::kChunkPart +
                                    tc::desc_offset<BQ>(0, 16 * kd));
            });
      } else {  // dS^T Q
        tc::wgmma_fence();
        tc::mma_rs_split<1, KS>(acc, dsa, b_desc);
      }
      tc::wgmma_commit();
      if (ci + 1 < n_chunks) {
        tc::cp_async_wait<0>();
        tc::split_chunk<BQ, BQ, NT>(s_slot + ((ci + 1) & 1) * C::kSlot,
                                    C::kChunkPart, s_stg, 0, 0);
        if (ci + 2 < n_chunks) stage(ci + 2);
      }
      tc::wgmma_wait<0>();
      if (j < 2 * NB) {
        tc::pin(sc);
      } else {
        tc::pin(acc);
        tc::pin(dsa);
      }

      if (j >= 2 * NB) {
#pragma unroll
        for (int x = 0; x < NC; ++x)
          if (x == j - 2 * NB)
#pragma unroll
            for (int i = 0; i < 32; ++i) dk[x][i] += acc[i];
        continue;
      }
      if (j < NB) {
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) s[i] = j == 0 ? sc[i] : s[i] + sc[i];
        if (j == NB - 1) {
          // Element i: key c0 + 16 warp + g + 8 hh, query row r0 + qc. P^T's
          // parts become A fragments for dV; s keeps p f.
          const bool edge =
              r0 + BQ > sq || c0 + tc::kRows > skv ||
              (a.band.causal && c0 + tc::kRows - 1 > a.q_offset + r0) ||
              (a.band.has_window &&
               a.q_offset + r0 + BQ - 1 - c0 >= a.band.window);
          float pf[BQ / 2];
          tc::by_case(edge, a.has_softcap, [&](auto kEdge, auto kCap) {
#pragma unroll
            for (int i = 0; i < BQ / 2; ++i) {
              const int qc = 8 * (i >> 2) + 2 * t + (i & 1);
              const bool keep =
                  !decltype(kEdge)::value ||
                  (r0 + qc < sq &&
                   a.band.keep(a.q_offset + r0 + qc,
                               c0 + 16 * warp + g + 8 * ((i >> 1) & 1)));
              const float l = r0 + qc < sq ? lse[r0 + qc] : 0.f;
              float p;
              pf[i] = f32_prob<decltype(kCap)::value>(a, s[i], l, keep, p);
              s[i] = p;
            }
          });
          tc::to_a_frags3(s, pa);
#pragma unroll
          for (int i = 0; i < BQ / 2; ++i) s[i] = pf[i];
        }
        continue;
      }
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i)
        dp[i] = j == NB ? sc[i] : dp[i] + sc[i];
#pragma unroll
      for (int x = 0; x < NC; ++x) {
        if (j - NB != cb + x) continue;
        // dV's x-th block += P^T dO over this chunk, dO read MN-major
        tc::wgmma_fence();
        tc::mma_rs_split<1, KS>(acc, pa, b_desc);
        tc::wgmma_commit();
        tc::wgmma_wait<0>();
        tc::pin(acc);
        tc::pin(pa);
#pragma unroll
        for (int i = 0; i < 32; ++i) dv[x][i] += acc[i];
      }
      if (j == 2 * NB - 1) {  // dS^T = p f (dP^T - D), split for dS^T Q
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) {
          const int qc = 8 * (i >> 2) + 2 * t + (i & 1);
          s[i] *= dp[i] - (r0 + qc < sq ? dsg[r0 + qc] : 0.f);
        }
        tc::to_a_frags3(s, dsa);
      }
    }
  }

  float* dkg = static_cast<float*>(a.dk) + bh * skv * d;
  float* dvg = static_cast<float*>(a.dv) + bh * skv * d;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int64_t c = c0 + 16 * warp + g + 8 * hh;
    if (c >= skv) continue;
#pragma unroll
    for (int x = 0; x < NC; ++x)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = 64 * (cb + x) + 8 * jj + 2 * t;
        tc::store_pair(dkg, c, col, d, dk[x][4 * jj + 2 * hh] * a.scale,
                       dk[x][4 * jj + 2 * hh + 1] * a.scale);
        tc::store_pair(dvg, c, col, d, dv[x][4 * jj + 2 * hh],
                       dv[x][4 * jj + 2 * hh + 1]);
      }
  }
}

template <int DP>
cudaError_t launch_f32(const BwdArgs& a, int64_t bh, int vec,
                       cudaStream_t stream) {
  using Q = DqF32<DP>;
  using K = DkvF32<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_f32<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Q::kSmem);
  if (err != cudaSuccess) return err;
  flash_dq_f32<DP>
      <<<dim3((unsigned)bh, (unsigned)((a.sq + Q::BR - 1) / Q::BR)), Q::NT,
         Q::kSmem, stream>>>(a, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_dkv_f32<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)K::kSmem);
  if (err != cudaSuccess) return err;
  flash_dkv_f32<DP>
      <<<dim3((unsigned)bh, (unsigned)((a.band.skv + K::BK - 1) / K::BK),
              (unsigned)(K::NB / K::NC)),
         K::NT, K::kSmem, stream>>>(a, vec);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const BwdArgs& a, int64_t bh, int vec,
                         cudaStream_t stream) {
  if (a.d <= 64) return launch_f32<64>(a, bh, vec, stream);
  if (a.d <= 128) return launch_f32<128>(a, bh, vec, stream);
  if (a.d <= 256) return launch_f32<256>(a, bh, vec, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, dout (bh, sq, d); k, v (bh, skv, d); lse, dsum (bh, sq) f32; dq, dk,
// dv like q, k, v. All contiguous, f32 or bf16 (is_bf16), d <= 256. Launches
// the dq kernel, then the dk/dv kernel, on `stream` (flash_dq_tc and
// flash_dkv_tc for bf16, flash_dq_f32 and flash_dkv_f32 for f32); returns
// the first cudaError_t that is not cudaSuccess.
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
  const bool aligned = flash::aligned16(q) && flash::aligned16(k) &&
                       flash::aligned16(v) && flash::aligned16(dout);
  if (!is_bf16) return (int)dispatch_f32(a, bh, d % 4 == 0 && aligned, s);
  return (int)dispatch_tc(a, bh, d % 8 == 0 && aligned, s);
}
