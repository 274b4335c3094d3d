// Hopper building blocks of the flash kernels (flash_attention.cu,
// flash_attention_bwd.cu): cp.async copies into 128-byte-swizzled shared
// tiles, wgmma descriptors, the m64n64k16 and m64n32k16 tensor-core
// products, the accumulator's fragment layout, and the three-way bf16 split
// of f32 operands. PTX is written inline, so the sources need no header
// beyond the CUDA runtime's and build in seconds.
//
// Shared tiles. A tile of R rows (R a multiple of 8) by DP bf16 columns
// (DP a multiple of 64) is stored as DP / 64 column blocks of R x 64, one
// after another. A row of a block is 128 bytes; its eight 16-byte chunks
// are permuted by the 128-byte swizzle, chunk c of row r at c ^ (r % 8).
// This is the canonical SW128 layout, which wgmma reads both as a K-major
// operand (rows along M or N, columns along K: Q and K in Q K^T) and as an
// MN-major B operand (rows along K, columns along N: V in P V, read with
// the transpose bit), with 1024 bytes between groups of 8 rows. Every
// tile starts on a 1024-byte boundary, so the swizzle, which the hardware
// applies to address bits, lines up with the tile's rows.
//
// Products. Every product is wgmma.m64n64k16 (or m64n32k16 for a 32-wide
// score tile) with f32 accumulators: a 64 x 16 A slice (from shared
// memory, or from registers) times a 16 x N B slice from shared memory. A
// product over K = 16 n is n such instructions; a 64-column output block
// of a wider result is one more accumulator. A descriptor addresses row
// `r` (a multiple of 8), column `c` (a multiple of 16) of a tile by its
// unswizzled offset (desc_offset).
//
// Accumulators. A 64 x 64 f32 result lives in the 128 threads of a
// warpgroup, 32 floats each: warp w holds rows 16 w to 16 w + 15, and lane
// l (g = l / 4, t = l % 4) holds, for each 8-column block j, acc[4 j + e]
// at row 16 w + g + 8 (e / 2), column 8 j + 2 t + e % 2 (a 64 x 32 result:
// the first 16 of those floats). A row lives in the four threads of a
// quad. Packed in pairs to bf16, the same registers are the A fragments of
// a register-A product whose K runs over those columns: k-step kk takes
// blocks j = 2 kk and 2 kk + 1 (to_a_frags).
//
// f32 operands (the split). An f32 value x is carried as three bf16
// parts, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid). Both
// differences are exact in f32 and lo holds the last 8 of x's 24 bits, so
// hi + mid + lo == x exactly wherever no part falls below bf16's normal
// range (|x| >= 2^-110). A product x y becomes six bf16 products into f32
// accumulators (split_pair): hi lo, lo hi, mid mid, hi mid, mid hi, then hi
// hi; the three left out (mid lo, lo mid, lo lo) are below 2^-24 |x y|.
// The small terms come first, into a fresh accumulator, so that the tensor
// cores' additions round them while the sum is small; the big one last.
// A split tile is three tiles as above (hi, mid, lo), a fixed number of
// bytes apart. f32 rows reach it through a staging area: cp.async of a
// chunk of R rows x 64 columns (stage_chunk), then a pass that splits each
// thread's own staged values into the three parts (split_chunk).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace flash_tc {

typedef __nv_bfloat16 bf16;

constexpr int kWarpgroup = 128;  // threads of a warpgroup
constexpr int kRows = 64;        // rows of a warpgroup's tile, and of a
                                 // k/v or q tile that a block walks
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Unswizzled byte offset of (row r, column c) in an R-row tile: the start
// address that a descriptor gives for a slice beginning there.
template <int R>
__device__ __forceinline__ uint32_t desc_offset(int r, int c) {
  return (uint32_t)((c >> 6) * R * 128 + r * 128 + (c & 63) * 2);
}

// Swizzled byte offset of the 16-byte chunk holding columns c .. c + 7
// (c a multiple of 8) of row r.
template <int R>
__device__ __forceinline__ uint32_t chunk_offset(int r, int c) {
  return (uint32_t)((c >> 6) * R * 128 + r * 128 +
                    ((((c >> 3) & 7) ^ (r & 7)) << 4));
}

// Rows [r0, r0 + R) of a (rows, d) row-major bf16 matrix into the R x DP
// tile at shared address `dst`; rows past `rows` and columns past d are 0.
// With `vec` (d % 8 == 0 and src 16-byte aligned) each 16-byte chunk is
// one cp.async, to be waited for with cp_async_wait; otherwise elements
// are loaded one by one and stored at once.
template <int R, int DP, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const bf16* __restrict__ src,
                                          int64_t r0, int64_t rows, int d,
                                          bool vec) {
  constexpr int kChunks = DP / 8;
  for (int i = threadIdx.x; i < R * kChunks; i += NT) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const int64_t row = r0 + r;
    const uint32_t at = dst + chunk_offset<R>(r, c);
    if (vec) {
      const bool in = row < rows && c < d;
      const bf16* p = in ? src + row * d + c : src;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(at),
                   "l"(p), "r"(in ? 16 : 0)
                   : "memory");
    } else {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t lo = 0, hi = 0;
        if (row < rows && c + 2 * e < d)
          lo = __bfloat16_as_ushort(src[row * d + c + 2 * e]);
        if (row < rows && c + 2 * e + 1 < d)
          hi = __bfloat16_as_ushort(src[row * d + c + 2 * e + 1]);
        w[e] = lo | (hi << 16);
      }
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(at),
                   "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                   : "memory");
    }
  }
}

// n floats src[0 .. n) into shared `dst`, 0 past `valid`; one 4-byte
// cp.async each (the rows of lse and rowsum(dO * O) of a q tile).
template <int NT>
__device__ __forceinline__ void load_floats(uint32_t dst,
                                            const float* __restrict__ src,
                                            int n, int64_t valid) {
  for (int i = threadIdx.x; i < n; i += NT) {
    const bool in = i < valid;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     dst + 4 * i),
                 "l"(in ? src + i : src), "r"(in ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Make this thread's finished copies and shared stores visible to the
// async proxy, through which wgmma reads shared memory. A barrier follows.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Descriptor of a slice of a 128-byte-swizzled tile at shared address
// `addr`: 1024 bytes between 8-row groups (SBO); the leading offset is
// unused, as no instruction's slice spans two 64-column blocks.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous products that own it.
template <int N>
__device__ __forceinline__ void pin(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

#define FLASH_TC_ACC32(d)                                                     \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])

#define FLASH_TC_REGS32                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "    \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "     \
  "%26, %27, %28, %29, %30, %31}"

// acc = A B (accumulate 0) or acc += A B: A a 64 x 16 K-major slice and B
// a 16 x 64 slice, K-major (kTransB 0) or MN-major (kTransB 1), both in
// shared memory.
template <int kTransB>
__device__ __forceinline__ void mma_ss(float (&acc)[32], uint64_t a,
                                       uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FLASH_TC_REGS32
      ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : FLASH_TC_ACC32(acc)
      : "l"(a), "l"(b), "r"(accumulate), "n"(kTransB));
}

// acc += A B (acc = A B with accumulate 0) with A a 64 x 16 slice in
// registers (to_a_frags).
template <int kTransB>
__device__ __forceinline__ void mma_rs(float (&acc)[32],
                                       const uint32_t (&a)[4], uint64_t b,
                                       int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FLASH_TC_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : FLASH_TC_ACC32(acc)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(kTransB));
}

// The 64 x 32 form of mma_ss (B a 16 x 32 slice): a score tile of 32
// columns.
template <int kTransB>
__device__ __forceinline__ void mma_ss(float (&acc)[16], uint64_t a,
                                       uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3]), "+f"(acc[4]),
        "+f"(acc[5]), "+f"(acc[6]), "+f"(acc[7]), "+f"(acc[8]), "+f"(acc[9]),
        "+f"(acc[10]), "+f"(acc[11]), "+f"(acc[12]), "+f"(acc[13]),
        "+f"(acc[14]), "+f"(acc[15])
      : "l"(a), "l"(b), "r"(accumulate), "n"(kTransB));
}

#undef FLASH_TC_ACC32
#undef FLASH_TC_REGS32

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragments of the four k-steps over a 64 x 64 accumulator's
// columns, rounded to bf16.
__device__ __forceinline__ void to_a_frags(const float (&acc)[32],
                                           uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(acc[8 * kk + 0], acc[8 * kk + 1]);  // row g
    a[kk][1] = pack_bf16(acc[8 * kk + 2], acc[8 * kk + 3]);  // row g + 8
    a[kk][2] = pack_bf16(acc[8 * kk + 4], acc[8 * kk + 5]);  // row g, +8
    a[kk][3] = pack_bf16(acc[8 * kk + 6], acc[8 * kk + 7]);  // row g + 8, +8
  }
}

// 2^x on the special-function unit; results below 2^-126 flush to 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Calls f(edge, cap) with both flags as compile-time constants
// (std::integral_constant), so that a tile's per-element loop is compiled
// without the mask or the softcap where the tile needs neither.
template <class F>
__device__ __forceinline__ void by_case(bool edge, bool cap, F&& f) {
  using Y = std::true_type;
  using N = std::false_type;
  if (edge) {
    if (cap) f(Y{}, Y{}); else f(Y{}, N{});
  } else {
    if (cap) f(N{}, Y{}); else f(N{}, N{});
  }
}

// Max and sum over the four threads of a quad (one accumulator row).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Store row `row` (< rows) of an accumulator-layout result: the pairs
// (x0, x1) at columns col, col + 1, both when d is even, else one by one.
__device__ __forceinline__ void store_pair(bf16* __restrict__ out, int64_t row,
                                           int col, int d, float x0,
                                           float x1) {
  if (col >= d) return;
  bf16* p = out + row * d + col;
  if ((d & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
  } else {
    p[0] = __float2bfloat16(x0);
    if (col + 1 < d) p[1] = __float2bfloat16(x1);
  }
}

// --- f32 operands: three bf16 parts ---------------------------------------

// The parts of the pair (x0, x1), each packed as a bf16 pair (x0 low).
__device__ __forceinline__ void split3(float x0, float x1, uint32_t (&w)[3]) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;  // exact
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(r0 - mf.x, r1 - mf.y);
  w[0] = *reinterpret_cast<const uint32_t*>(&h);
  w[1] = *reinterpret_cast<const uint32_t*>(&m);
  w[2] = *reinterpret_cast<const uint32_t*>(&l);
}

// The six (A part, B part) pairs of a split product (parts 0 hi, 1 mid,
// 2 lo), small terms first: hi lo, lo hi, mid mid, hi mid, mid hi, hi hi.
__host__ __device__ constexpr int pair_a(int i) {
  return i == 1 ? 2 : (i == 2 || i == 4) ? 1 : 0;
}
__host__ __device__ constexpr int pair_b(int i) {
  return i == 0 ? 2 : (i == 2 || i == 3) ? 1 : 0;
}

// acc = A B over KS k-steps, both split tiles in shared memory: da(p, kd)
// and db(p, kd) give the descriptors of part p's k-step kd.
template <int kTransB, int KS, int N, class DA, class DB>
__device__ __forceinline__ void mma_ss_split(float (&acc)[N], DA da, DB db) {
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int kd = 0; kd < KS; ++kd)
      mma_ss<kTransB>(acc, da(pair_a(i), kd), db(pair_b(i), kd), i + kd > 0);
}

// acc = A B over KS k-steps, A's three parts in registers (to_a_frags3),
// B a split tile in shared memory (db as for mma_ss_split).
template <int kTransB, int KS, class DB>
__device__ __forceinline__ void mma_rs_split(float (&acc)[32],
                                             const uint32_t (&a)[3][KS][4],
                                             DB db) {
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      mma_rs<kTransB>(acc, a[pair_a(i)][kk], db(pair_b(i), kk), i + kk > 0);
}

// The three parts' A fragments of the k-steps over an accumulator's
// columns (N / 8 k-steps: 4 for 64 columns, 2 for 32), as to_a_frags.
template <int N>
__device__ __forceinline__ void to_a_frags3(const float (&acc)[N],
                                            uint32_t (&a)[3][N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t w[3];
      split3(acc[8 * kk + 2 * e], acc[8 * kk + 2 * e + 1], w);
#pragma unroll
      for (int p = 0; p < 3; ++p) a[p][kk][e] = w[p];
    }
}

// Keep the A fragments of a register-A product alive, and in place, until
// the wgmma_wait that retires it.
template <int KS>
__device__ __forceinline__ void pin(uint32_t (&a)[3][KS][4]) {
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        asm volatile("" : "+r"(a[p][kk][e])::"memory");
}

// Rows [r0, r0 + R) and columns [c0, c0 + 64) of a (rows, d) row-major f32
// matrix into the staging area `stg` by cp.async; rows past `rows` and
// columns past d read as 0. Unit u (row u / 8, columns c0 + 8 (u % 8) ..
// + 7) belongs to thread u % NT, which alone stages and splits it: its
// first four floats at stg + 16 u, its last four at stg + 16 (8 R + u).
// With `vec` (d % 4 == 0 and src 16-byte aligned) 16-byte copies, else
// 4-byte ones. To be waited for with cp_async_wait.
template <int R, int NT>
__device__ __forceinline__ void stage_chunk(uint32_t stg,
                                            const float* __restrict__ src,
                                            int64_t r0, int64_t rows, int c0,
                                            int d, bool vec) {
  constexpr int kUnits = 8 * R;
  static_assert(kUnits % NT == 0, "a chunk's units divide among the threads");
#pragma unroll
  for (int j = 0; j < kUnits / NT; ++j) {
    const int u = (int)threadIdx.x % NT + j * NT;
    const int64_t row = r0 + u / 8;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const uint32_t at = stg + 16 * (u + hf * kUnits);
      const int c = c0 + 8 * (u % 8) + 4 * hf;
      if (vec) {
        const bool in = row < rows && c < d;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                         at),
                     "l"(in ? src + row * d + c : src), "r"(in ? 16 : 0)
                     : "memory");
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = row < rows && c + e < d;
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                           at + 4 * e),
                       "l"(in ? src + row * d + c + e : src), "r"(in ? 4 : 0)
                       : "memory");
        }
      }
    }
  }
}

// This thread's staged units of an R-row chunk (stage_chunk, waited for)
// split into rows row0 .. row0 + R - 1, column block cb, of the RT-row
// split tile at `dst`, whose parts lie `part` bytes apart.
template <int R, int RT, int NT>
__device__ __forceinline__ void split_chunk(uint32_t dst, uint32_t part,
                                            uint32_t stg, int row0, int cb) {
  constexpr int kUnits = 8 * R;
#pragma unroll
  for (int j = 0; j < kUnits / NT; ++j) {
    const int u = (int)threadIdx.x % NT + j * NT;
    float x[8];
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(x[0]), "=f"(x[1]), "=f"(x[2]), "=f"(x[3])
                 : "r"(stg + 16 * u)
                 : "memory");
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(x[4]), "=f"(x[5]), "=f"(x[6]), "=f"(x[7])
                 : "r"(stg + 16 * (u + kUnits))
                 : "memory");
    uint32_t w[3][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      uint32_t v[3];
      split3(x[2 * e], x[2 * e + 1], v);
#pragma unroll
      for (int p = 0; p < 3; ++p) w[p][e] = v[p];
    }
    const uint32_t at =
        dst + chunk_offset<RT>(row0 + u / 8, 64 * cb + 8 * (u % 8));
#pragma unroll
    for (int p = 0; p < 3; ++p)
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                       at + p * part),
                   "r"(w[p][0]), "r"(w[p][1]), "r"(w[p][2]), "r"(w[p][3])
                   : "memory");
  }
}

// Store row `row` (< rows) of an f32 accumulator-layout result: the pairs
// (x0, x1) at columns col, col + 1, as one 8-byte store when d is even.
__device__ __forceinline__ void store_pair(float* __restrict__ out,
                                           int64_t row, int col, int d,
                                           float x0, float x1) {
  if (col >= d) return;
  float* p = out + row * d + col;
  if ((d & 1) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
  } else {
    p[0] = x0;
    if (col + 1 < d) p[1] = x1;
  }
}

}  // namespace flash_tc
