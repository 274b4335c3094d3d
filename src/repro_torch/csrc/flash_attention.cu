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
// 34 MB (bf16; 69 MB in f32), far above the card's ridge point: 0.139 ms
// at the 989 TFLOP/s bf16 tensor-core peak; in f32, whose products take
// six bf16 products each (below), 0.833 ms at 165 TFLOP/s effective.
//
// bf16 (flash_fwd_tc): one block per (batch * head, tile of 128 query
// rows), two warpgroups of 64 rows each, two blocks to an SM at head dim
// 64; q tiles are launched longest first, which evens out the causal
// triangle. The q tile is staged once; the 64-row k/v tiles of the band
// go through a 2-stage ring in shared memory, filled by cp.async while
// the previous tile computes, in the 128-byte swizzle that wgmma reads
// (flash_wgmma.cuh). Per k/v tile and warpgroup: S = Q K^T on wgmma, f32
// accumulators; the online softmax in those registers (scale, softcap,
// and the mask only on tiles that cross the band's edge, each case
// compiled on its own; a row reduces over its quad; exp2 on the
// special-function unit); P rounded to bf16 in registers becomes the A
// operand of O += P V, with V read through the transpose bit. The row sum
// l is that of the f32 p. So P is rounded against the running max, where
// the plain version (ref.flash_fwd) rounds it against the final one.
// Tiles wholly outside the band are skipped.
//
// f32 (flash_fwd_f32): the same tensor cores at f32 accuracy. Every f32
// operand is split into three bf16 parts (hi + mid + lo, exact) and every
// product taken as six bf16 products into fresh f32 accumulators, the
// small terms first (flash_wgmma.cuh); TF32 would keep 10 bits and miss
// the f32 checks' 1e-5, and wgmma's TF32 form reads its operands K-major
// only, where V in P V is MN-major. Three parts cost 6 bytes an element
// in shared memory, so a block is one warpgroup of 64 q rows: the q tile
// is staged split once (24 KB per 64 columns), and the k/v tiles stream
// through 64-column chunks: each chunk is copied by cp.async into an f32
// staging area a step ahead, split into one of two slots while the
// previous chunk's products run, and read by wgmma from there (per k/v
// tile: K's column blocks, summing S, then V's, one block of O each). A
// chunk's product goes into a fresh accumulator and is added to S, or to
// alpha O, in f32 on the CUDA cores, so the tensor cores' additions only
// ever sum one chunk. The softmax is f32 with expf, P split in registers
// into three sets of A fragments. At head dim 64 two blocks share an SM
// (89 KB of shared memory each). Neither kernel falls back to the other:
// the dtype picks the kernel (flash_fwd_launch).

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

// --- f32: the split tensor-core kernel --------------------------------------

template <int DP>
struct FwdF32 {
  static constexpr int NB = DP / 64;           // column blocks of a row
  static constexpr int BR = tc::kRows;         // q rows: one warpgroup
  static constexpr int BC = tc::kRows;         // rows of a k/v tile
  static constexpr int NT = tc::kWarpgroup;
  static constexpr uint32_t kQPart = BR * DP * 2;      // a part of the q tile
  static constexpr uint32_t kChunkPart = BC * 64 * 2;  // a part of a chunk
  static constexpr uint32_t kSlot = 3 * kChunkPart;
  static constexpr size_t kSmem =
      1024 + 3 * (size_t)kQPart + 2 * (size_t)kSlot + BC * 64 * 4;
};

template <int DP>
__global__ void __launch_bounds__(FwdF32<DP>::NT, 1)
    flash_fwd_f32(FwdArgs a, int vec) {
  using C = FwdF32<DP>;
  constexpr int NB = C::NB, BR = C::BR, BC = C::BC, NT = C::NT;
  extern __shared__ uint8_t fwd_f32_smem[];
  const uint32_t s_q = (tc::smem_addr(fwd_f32_smem) + 1023) & ~1023u;
  const uint32_t s_slot = s_q + 3 * C::kQPart;  // 2 slots of a split chunk
  const uint32_t s_stg = s_slot + 2 * C::kSlot;  // f32 staging

  const int tid = threadIdx.x, warp = tid / 32, g = (tid % 32) / 4;
  const int t = tid % 4;
  const int64_t bh = blockIdx.x;
  const int64_t b = bh / a.hq, h = bh % a.hq;
  const int64_t kvh = b * a.hkv + h / (a.hq / a.hkv);
  const int64_t sq = a.sq, skv = a.band.skv;
  const int d = a.d;
  const int64_t r0 = (int64_t)(gridDim.y - 1 - blockIdx.y) * BR;
  const float* q = static_cast<const float*>(a.q) + bh * sq * d;
  const float* k = static_cast<const float*>(a.k) + kvh * skv * d;
  const float* v = static_cast<const float*>(a.v) + kvh * skv * d;

  const int64_t last = r0 + BR < sq ? r0 + BR : sq;
  const int64_t row_lo = a.q_offset + r0, row_hi = a.q_offset + last - 1;
  int64_t c_begin = 0, c_end = skv;
  if (a.band.has_window && row_lo - a.band.window + 1 > 0)
    c_begin = row_lo - a.band.window + 1;
  if (a.band.causal && row_hi + 1 < c_end) c_end = row_hi + 1;
  c_begin -= c_begin % BC;
  const int n_tiles =
      c_end > c_begin ? (int)((c_end - c_begin + BC - 1) / BC) : 0;
  // Chunk ci of the stream: k/v tile ci / (2 NB); j = ci % (2 NB) < NB is
  // K's column block j (S += Q K^T over it), else V's block j - NB
  // (O's columns of that block).
  const int n_chunks = n_tiles * 2 * NB;
  auto stage = [&](int ci) {
    const int j = ci % (2 * NB);
    tc::stage_chunk<BC, NT>(s_stg, j < NB ? k : v,
                            c_begin + (int64_t)(ci / (2 * NB)) * BC, skv,
                            64 * (j % NB), d, vec);
    tc::cp_async_commit();
  };

  // The q tile, split, one column block at a time; then the first chunk.
#pragma unroll 1
  for (int cb = 0; cb < NB; ++cb) {
    tc::stage_chunk<BR, NT>(s_stg, q, r0, sq, 64 * cb, d, vec);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    tc::split_chunk<BR, BR, NT>(s_q, C::kQPart, s_stg, 0, cb);
  }
  if (n_chunks > 0) {
    stage(0);
    tc::cp_async_wait<0>();
    tc::split_chunk<BC, BC, NT>(s_slot, C::kChunkPart, s_stg, 0, 0);
    if (n_chunks > 1) stage(1);
  }

  const int64_t wrow = a.q_offset + r0;  // absolute row of the first
  float o[NB][32], s[32], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float alpha[2] = {1.f, 1.f};
  uint32_t pa[3][4][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[nb][i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;

  // The chunk loop, unrolled over a tile's chunks so that j, and with it
  // every accumulator's index, is known at compile time.
#pragma unroll 1
  for (int it = 0; it < n_tiles; ++it) {
    const int64_t c0 = c_begin + (int64_t)it * BC;
#pragma unroll
    for (int j = 0; j < 2 * NB; ++j) {
      const int ci = it * 2 * NB + j;
      const uint32_t slot = s_slot + (ci & 1) * C::kSlot;
      tc::fence_async_smem();
      __syncthreads();  // chunk ci (and the q tile) split; slot ci ^ 1 free

      // This chunk's product into a fresh accumulator (its first product
      // starts the sum); the next chunk is split while it runs.
      float acc[32];
      tc::wgmma_fence();
      if (j < NB) {
        tc::mma_ss_split<0, 4>(
            acc,
            [&](int p, int kd) {
              return tc::sw128_desc(s_q + p * C::kQPart +
                                    tc::desc_offset<BR>(0, 64 * j + 16 * kd));
            },
            [&](int p, int kd) {
              return tc::sw128_desc(slot + p * C::kChunkPart +
                                    tc::desc_offset<BC>(0, 16 * kd));
            });
      } else {
        tc::mma_rs_split<1, 4>(acc, pa, [&](int p, int kk) {
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
      tc::pin(acc);
      tc::pin(pa);

      if (j >= NB) {  // O's block j - NB: o = alpha o + P V, rounded in f32
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          if (nb == j - NB)
#pragma unroll
            for (int i = 0; i < 32; ++i)
              o[nb][i] = fmaf(o[nb][i], alpha[(i >> 1) & 1], acc[i]);
        continue;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = j == 0 ? acc[i] : s[i] + acc[i];
      if (j != NB - 1) continue;

      // S is whole: scale, softcap and (on tiles that cross the band's
      // edge) mask, then the online softmax in f32 (expf), as the plain
      // version computes it; P's three parts become the A fragments of P V.
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
      float m_new[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        m_new[hh] = fmaxf(m[hh], tc::quad_max(mx[hh]));
        alpha[hh] = expf(m[hh] - m_new[hh]);
        m[hh] = m_new[hh];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1;
        const float p = expf(s[i] - m_new[hh]);
        s[i] = p;
        rs[hh] += p;
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + rs[hh];
      tc::to_a_frags3(s, pa);
    }
  }

  float* out = static_cast<float*>(a.o) + bh * sq * d;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float lsum = tc::quad_sum(l[hh]);
    const float ls = lsum == 0.f ? 1.f : lsum;
    const int64_t r = r0 + 16 * warp + g + 8 * hh;
    if (r >= sq) continue;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        tc::store_pair(out, r, 64 * nb + 8 * jj + 2 * t, d,
                       o[nb][4 * jj + 2 * hh] / ls,
                       o[nb][4 * jj + 2 * hh + 1] / ls);
    if (a.lse != nullptr && t == 0) a.lse[bh * sq + r] = m[hh] + logf(ls);
  }
}

template <int DP>
cudaError_t launch_f32(const FwdArgs& a, int64_t bh, int vec,
                       cudaStream_t stream) {
  using C = FwdF32<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)bh, (unsigned)((a.sq + C::BR - 1) / C::BR));
  flash_fwd_f32<DP><<<grid, C::NT, C::kSmem, stream>>>(a, vec);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const FwdArgs& a, int64_t bh, int vec,
                         cudaStream_t stream) {
  if (a.d <= 64) return launch_f32<64>(a, bh, vec, stream);
  if (a.d <= 128) return launch_f32<128>(a, bh, vec, stream);
  if (a.d <= 256) return launch_f32<256>(a, bh, vec, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (batch, hq, sq, d); k, v (batch, hkv, skv, d), hq a multiple of hkv;
// o like q; lse (batch, hq, sq) f32 or null. All contiguous, f32 or bf16
// (is_bf16), d <= 256. window is read when has_window, softcap when
// has_softcap. bf16 runs flash_fwd_tc, f32 flash_fwd_f32. Returns the
// cudaError_t of the launch.
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
  const bool aligned =
      flash::aligned16(q) && flash::aligned16(k) && flash::aligned16(v);
  if (!is_bf16) return (int)dispatch_f32(a, bh, d % 4 == 0 && aligned, s);
  return (int)dispatch_tc(a, bh, d % 8 == 0 && aligned, s);
}
