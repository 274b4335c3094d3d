// k-mer extraction: every length-k window of a read packed into one word.
//
// Replaces the TPU kernel in src/repro/kernels/kmer_extract.py:
//   kmer_extract_pallas (_kmer_extract_kernel)
// out[r, p] = sum_j codes[r, p + j] << b (k - 1 - j), or with `canonical`
// (2-bit DNA) min(forward, reverse complement), where base j of the window
// complements to c ^ 3 at bit 2j of the reverse-complement word.
// Codes are taken to be below 2**b, as in the JAX package: a larger code
// would spill into its neighbour's bits.
//
// Bound: bytes. Each 1 B code is read once and each 8 B word written once,
// so the output dominates (8 B per position against about 1.25 B of input
// for 150 bp reads and k = 31). Rolling a window costs k - 1 warm-up steps
// per run of outputs, about 50 integer operations per word at k = 31, more
// than the card's integer rate allows within the byte bound; so no window
// is rolled here.
//
// Design: a tile is a flat range of the codes (whole rows, or a piece of
// one long row) and the flat range of words its windows give.
// - The block stages the tile's codes with 16-byte cp.async copies into one
//   of two shared buffers: while it works on one tile, the next tile's
//   codes arrive in the other. The range starts at the 16-byte boundary
//   below its first code, `off0` bytes early.
// - It packs the staged bytes once into 64-bit words, most significant
//   symbol first (F: symbol s at stream bit s b), and for `canonical` also
//   least significant symbol first (L: symbol s at bit 2 s). For b = 2 four
//   codes of one 32-bit load become one byte with one multiply
//   (x * 0x40100401 >> 24, and x * 0x01041040 >> 24 for L), and byte
//   permutes assemble the words.
// - The window at staged position x is then bits [x b, x b + k b) of F:
//   since k b <= 62, one funnel shift of the two words F[x b / 64] and the
//   next, and a shift right by 64 - k b. Its reverse complement is bits
//   [2 x, 2 x + 2 k) of L, complemented: the LSB-first packing of a window
//   is the reverse-complement order of its symbols. No warm-up, a constant
//   count of integer operations per word.
// - Thread t writes the tile's words 2 t, 2 t + 1, then 2 t + 2 kThreads
//   and so on, as 16-byte streaming stores (8-byte ones where a tile starts
//   at an odd word), neighbouring threads on neighbouring words; the row
//   and position of each word follow by adding a fixed step.
// - The grid is persistent: as many blocks as fit on the card walk the
//   tiles.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileOut = 8192;     // words per tile, at most
constexpr int kTileCodes = 16384;  // codes of whole rows per tile, at most

struct Tiling {
  int64_t rows, m, n_pos;
  int k;
  int rb;                 // rows per tile (1 for long rows)
  int tw;                 // words a tile row: n_pos, or kTileOut (long rows)
  int64_t tiles_per_row;  // 1 for whole rows
  int64_t n_tiles;
  int buf_bytes;          // one code buffer, a multiple of 16
  int n_words;            // packed words of the longest tile
  bool out_aligned;       // the output is 16-byte aligned
};

struct Tile {
  int64_t g0;    // first code (flat index)
  int64_t len;   // words
  int64_t o0;    // first word (flat index)
  int off0;      // bytes staged before g0
  int nchunks;   // 16-byte chunks staged
};

__device__ __forceinline__ Tile tile_of(const Tiling& tl, const uint8_t* codes,
                                        int64_t t) {
  Tile ti;
  int64_t g1;
  if (tl.tiles_per_row == 1) {
    const int64_t r0 = t * tl.rb;
    const int64_t r1 = r0 + tl.rb < tl.rows ? r0 + tl.rb : tl.rows;
    ti.g0 = r0 * tl.m;
    g1 = r1 * tl.m;
    ti.o0 = r0 * tl.n_pos;
    ti.len = (r1 - r0) * tl.n_pos;
  } else {
    const int64_t r = t / tl.tiles_per_row;
    const int64_t p0 = (t % tl.tiles_per_row) * tl.tw;
    ti.len = tl.n_pos - p0 < tl.tw ? tl.n_pos - p0 : tl.tw;
    ti.g0 = r * tl.m + p0;
    g1 = ti.g0 + ti.len + tl.k - 1;
    ti.o0 = r * tl.n_pos + p0;
  }
  const uintptr_t a = (uintptr_t)(codes + ti.g0);
  ti.off0 = (int)(a & 15);
  ti.nchunks = (int)((ti.off0 + (g1 - ti.g0) + 15) / 16);
  return ti;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src));
}

// The tile's chunks into `buf`: 16-byte copies, or byte by byte (zeros
// outside the array) for a chunk that crosses either end of the array.
__device__ __forceinline__ void stage(const Tiling& tl, const uint8_t* codes,
                                      int64_t t, uint8_t* buf) {
  const Tile ti = tile_of(tl, codes, t);
  const uint8_t* base = codes + ti.g0 - ti.off0;
  const uint8_t* end = codes + tl.rows * tl.m;
  for (int c = threadIdx.x; c < ti.nchunks; c += kThreads) {
    const uint8_t* src = base + 16 * c;
    if (src >= codes && src + 16 <= end) {
      cp_async16(buf + 16 * c, src);
    } else {
      for (int j = 0; j < 16; ++j)
        buf[16 * c + j] = src + j >= codes && src + j < end ? src[j] : 0;
    }
  }
  asm volatile("cp.async.commit_group;");
}

// Word w of the packed stream of `nchunks` staged chunks (zeros past them).
template <int B, bool kCanonical>
__device__ __forceinline__ void pack(const uint8_t* buf, int nchunks,
                                     uint64_t* packed, int nw) {
  for (int w = threadIdx.x; w < nw; w += kThreads) {
    if (B == 2) {
      uint32_t x[8];
      const uint4 zero = make_uint4(0, 0, 0, 0);
      const uint4 a = 2 * w < nchunks
          ? *reinterpret_cast<const uint4*>(buf + 32 * w) : zero;
      const uint4 b = 2 * w + 1 < nchunks
          ? *reinterpret_cast<const uint4*>(buf + 32 * w + 16) : zero;
      x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
      x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
      uint32_t f[8];
#pragma unroll
      for (int g = 0; g < 8; ++g) f[g] = x[g] * 0x40100401u;
      // The top byte of f[g] is codes 4g..4g+3, the first most significant.
      const uint32_t fhi = __byte_perm(__byte_perm(f[0], f[1], 0x3700),
                                       __byte_perm(f[2], f[3], 0x0037),
                                       0x3254);
      const uint32_t flo = __byte_perm(__byte_perm(f[4], f[5], 0x3700),
                                       __byte_perm(f[6], f[7], 0x0037),
                                       0x3254);
      const uint64_t fw = ((uint64_t)fhi << 32) | flo;
      if (kCanonical) {
        uint32_t l[8];
#pragma unroll
        for (int g = 0; g < 8; ++g) l[g] = x[g] * 0x01041040u;
        // The top byte of l[g] is codes 4g..4g+3, the first least
        // significant; byte g of the word.
        const uint32_t llo = __byte_perm(__byte_perm(l[0], l[1], 0x0073),
                                         __byte_perm(l[2], l[3], 0x0073),
                                         0x5410);
        const uint32_t lhi = __byte_perm(__byte_perm(l[4], l[5], 0x0073),
                                         __byte_perm(l[6], l[7], 0x0073),
                                         0x5410);
        reinterpret_cast<ulonglong2*>(packed)[w] =
            make_ulonglong2(fw, ((uint64_t)lhi << 32) | llo);
      } else {
        packed[w] = fw;
      }
    } else {
      const int nbytes = 16 * nchunks;
      const int lo = 64 * w;
      uint64_t v = 0;
      for (int s = lo / B; s <= (lo + 63) / B; ++s) {
        const uint64_t c = s < nbytes ? buf[s] : 0;
        const int sh = 64 - B - (s * B - lo);
        v |= sh >= 0 ? c << sh : c >> -sh;
      }
      packed[w] = v;
    }
  }
}

// The top 64 bits of (a:b) << o and the low 64 bits of (b:a) >> o, for
// 0 <= o < 64.
__device__ __forceinline__ uint64_t shl2(uint64_t a, uint64_t b, int o) {
  return (a << o) | ((b >> 1) >> (63 - o));
}
__device__ __forceinline__ uint64_t shr2(uint64_t a, uint64_t b, int o) {
  return (a >> o) | ((b << 1) << (63 - o));
}

template <int B, bool kCanonical>
__device__ __forceinline__ uint64_t window(const uint64_t* packed, int x,
                                           int kb, uint64_t mask) {
  const int bit = x * B;
  const int w = bit >> 6, o = bit & 63;
  if (kCanonical) {
    const ulonglong2 p0 = reinterpret_cast<const ulonglong2*>(packed)[w];
    const ulonglong2 p1 = reinterpret_cast<const ulonglong2*>(packed)[w + 1];
    const uint64_t fwd = shl2(p0.x, p1.x, o) >> (64 - kb);
    const uint64_t rc = ~shr2(p0.y, p1.y, o) & mask;
    return fwd < rc ? fwd : rc;
  }
  return shl2(packed[w], packed[w + 1], o) >> (64 - kb);
}

__device__ __forceinline__ void store2(uint64_t* dst, uint64_t a,
                                       uint64_t b) {
  asm volatile("st.global.cs.v2.u64 [%0], {%1, %2};" ::"l"(dst), "l"(a),
               "l"(b)
               : "memory");
}
__device__ __forceinline__ void store1(uint64_t* dst, uint64_t a) {
  asm volatile("st.global.cs.u64 [%0], %1;" ::"l"(dst), "l"(a) : "memory");
}

template <int B, bool kCanonical>
__global__ void __launch_bounds__(kThreads)
kmer_extract_kernel(const uint8_t* __restrict__ codes,
                    uint64_t* __restrict__ out, const Tiling tl) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint64_t* packed = reinterpret_cast<uint64_t*>(smem + 2 * tl.buf_bytes);
  const int kb = B * tl.k;
  const uint64_t mask = (~0ull) >> (64 - kb);
  const int T = tl.tw;
  const int row_skip = (int)(tl.m - T);   // whole rows: k - 1
  // Thread t's first word is 2t of each tile, its next 2 kThreads later.
  const int rt0 = 2 * threadIdx.x / T, p0 = 2 * threadIdx.x % T;
  const int step_r = 2 * kThreads / T, step_p = 2 * kThreads % T;

  int64_t t = blockIdx.x;
  if (t >= tl.n_tiles) return;
  stage(tl, codes, t, smem);
  for (int it = 0; t < tl.n_tiles; ++it, t += gridDim.x) {
    if (t + gridDim.x < tl.n_tiles) {
      stage(tl, codes, t + gridDim.x, smem + ((it + 1) & 1) * tl.buf_bytes);
    } else {
      asm volatile("cp.async.commit_group;");
    }
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncthreads();
    const Tile ti = tile_of(tl, codes, t);
    const int nw = (ti.nchunks * 16 * B + 63) / 64 + 1;
    pack<B, kCanonical>(smem + (it & 1) * tl.buf_bytes, ti.nchunks, packed,
                        nw);
    __syncthreads();
    const bool pairs = tl.out_aligned && !(ti.o0 & 1);
    uint64_t* dst = out + ti.o0;
    int rt = rt0, p = p0;
    for (int64_t e = 2 * threadIdx.x; e < ti.len; e += 2 * kThreads) {
      const int x = ti.off0 + rt * (int)tl.m + p;
      const uint64_t v0 = window<B, kCanonical>(packed, x, kb, mask);
      if (e + 1 < ti.len) {
        const int x1 = p + 1 == T ? x + 1 + row_skip : x + 1;
        const uint64_t v1 = window<B, kCanonical>(packed, x1, kb, mask);
        if (pairs) {
          store2(dst + e, v0, v1);
        } else {
          store1(dst + e, v0);
          store1(dst + e + 1, v1);
        }
      } else {
        store1(dst + e, v0);
      }
      p += step_p;
      rt += step_r;
      if (p >= T) {
        p -= T;
        ++rt;
      }
    }
    __syncthreads();
  }
}

template <int B, bool kCanonical>
cudaError_t launch(const uint8_t* codes, uint64_t* out, int64_t rows,
                   int64_t m, int k, cudaStream_t stream) {
  Tiling tl;
  tl.rows = rows;
  tl.m = m;
  tl.k = k;
  tl.n_pos = m - k + 1;
  int64_t max_len;
  if (tl.n_pos <= kTileOut) {
    int64_t rb = kTileOut / tl.n_pos;
    if (kTileCodes / m < rb) rb = kTileCodes / m;
    if (rb > 1) rb &= ~1ll;               // even: tiles start at even words
    if (rb < 1) rb = 1;
    if (rb > rows) rb = rows;
    tl.rb = (int)rb;
    tl.tw = (int)tl.n_pos;
    tl.tiles_per_row = 1;
    tl.n_tiles = (rows + rb - 1) / rb;
    max_len = rb * m;
  } else {
    tl.rb = 1;
    tl.tw = kTileOut;
    tl.tiles_per_row = (tl.n_pos + kTileOut - 1) / kTileOut;
    tl.n_tiles = rows * tl.tiles_per_row;
    max_len = kTileOut + k - 1;
  }
  tl.buf_bytes = (int)((max_len + 15 + 15) / 16 * 16);
  tl.n_words = (tl.buf_bytes * B + 63) / 64 + 1;
  tl.out_aligned = ((uintptr_t)out & 15) == 0;
  const size_t smem = 2 * (size_t)tl.buf_bytes
                      + (size_t)tl.n_words * (kCanonical ? 16 : 8);
  auto kernel = kmer_extract_kernel<B, kCanonical>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)   // above 48 KB for b = 8 and long tiles
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t fill = (int64_t)sms * per_sm;
  const unsigned grid = (unsigned)(tl.n_tiles < fill ? tl.n_tiles : fill);
  kernel<<<grid, kThreads, smem, stream>>>(codes, out, tl);
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
  if (k < 1 || k > m || k * bits > 62 || rows < 1)
    return (int)cudaErrorInvalidValue;
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
