// Open-addressing insert-or-add, and its read-only lookup: the streaming
// receiver's count store and the query path's probe of it.
//
// Replaces the TPU kernels in src/repro/kernels/hash_table.py:
//   hash_insert_pallas (_hash_insert_kernel)
// which folds every received (k-mer, count) pair into the per-PE table, and
//   hash_lookup_pallas (_hash_lookup_kernel)
// which reads each query's count (0 = miss) and probe-walk length.
//
// INSERT.
//
// Bound: on the counting path, random DRAM sectors. Each batch slot
// streams its 8 B key; a live item also its 4 B weight (and, given
// explicit slots, a 4 B home slot), and it touches one 8 B table key and
// one 4 B table count at a random place in a table far larger than the 50 MB L2 cache (18 GB at
// full size): a key sector and a count sector, read from DRAM, and the
// count sector (the key sector too for a new key) written back. The
// sector bound counts those 32-byte sectors plus the streamed batch; the
// byte bound (each byte read once) is far below it.
//
// What the sweep on the card found (scripts/hash_insert_sweep.py, PERF.md
// section 6): the time does not change from 1 to 18 GB tables (no TLB limit),
// and grows with the random transfers per item: about 10 us for each
// transfer of the path's 245,760 live items (a read-only lookup of new
// keys, 1 transfer, 0.016 ms; the insert of new keys, 4, 0.046 ms; of 93 %
// stored keys, about 3, 0.034 ms). Those transfers, not exposed latency,
// are the limit: 2 or 4 items a thread with their loads issued together
// (which serialises a thread's CASes) and an L2 prefetch of the count
// line (a transfer of its own) were each slower. So the body keeps one
// item a thread and nothing beyond the transfers an item needs, and the
// gain is outside it: the home slot is hashed here, where the old path ran
// 32 PyTorch launches over the batch (0.13 ms on the device a step, four
// times the kernel).
//
// Home slots. With `slots` NULL the kernel hashes each key itself,
// `umod(slot_hash(key), cap)` as `countstore.store_slots` computes it:
// for `word_bits` 32 the murmur3 finalizer of the low 32 bits, salted with
// 0x9E3779B9 and mixed again; for 64 the splitmix64 finalizer, salted
// with 0x9E3779B97F4A7C15 and mixed again; then the exact unsigned
// remainder by cap, from a multiply by the host's 64-bit inverse of cap
// and one correction (`home_slot`), in place of the compiler's 64-bit
// division routine. 1 <= cap < 2**31. The lookup kernel shares
// `home_slot`.
// Given explicit int32 slots, the kernel probes from them as before.
//
// Design: the TPU kernel is sequential, one item after another, so its
// slot layout is exactly that of the sequential plain version. Here every
// item probes on its own:
// - linearly from its home slot, wrapping within its row's table (one row
//   per processing element);
// - an empty slot (the sentinel) is claimed with one 64-bit atomicCAS; if
//   the CAS returns the thread's own key, another thread inserted the same
//   key first and the slot matches;
// - the weight is added to the matching slot's count with a
//   fire-and-forget atomicAdd;
// - after `cap` probes without an empty or matching slot the item is
//   dropped and the row's drop counter is incremented atomically;
// - a warp whose items are all padding (the sentinel) returns after its
//   key loads: on the path each sender tile is a live prefix and then
//   sentinels.
// Keys only ever change from the sentinel to a key, so a stale read can
// only show a sentinel where a key now is, and the CAS corrects it. The
// (key, count) set is the sequential version's; the slots may differ, which
// the store histogram (a sort of the table) does not see. A row drops an
// item exactly when its table cannot hold every distinct key.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 2;  // lookup queries a thread

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

__device__ __forceinline__ unsigned long long mix64(unsigned long long x) {
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ull;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// umod(slot_hash(key), cap) of `countstore.store_slots`. The remainder
// takes m = floor((2**64 - 1) / cap) from the host (`cap_inverse`) in
// place of a division: for h < 2**64, q = floor(h * m / 2**64) lies in
// [floor(h / cap) - 1, floor(h / cap)], as h * m / 2**64 > h / cap - 1,
// so h - q * cap lies in [0, 2 cap) and one subtraction makes it exact.
template <int kWordBits>
__device__ __forceinline__ int64_t home_slot(unsigned long long key,
                                             int64_t cap,
                                             unsigned long long m) {
  const unsigned long long h =
      kWordBits == 32 ? (unsigned long long)mix32(mix32((uint32_t)key) ^
                                                  0x9E3779B9u)
                      : mix64(mix64(key) ^ 0x9E3779B97F4A7C15ull);
  const unsigned long long c = (unsigned long long)cap;
  const unsigned long long r = h - __umul64hi(h, m) * c;
  return (int64_t)(r >= c ? r - c : r);
}

unsigned long long cap_inverse(int64_t cap) {
  return ~0ull / (unsigned long long)cap;
}

// kWordBits: 0 = explicit slots, 32 or 64 = hash the key in the kernel.
template <int kWordBits>
__global__ void __launch_bounds__(kThreads)
hash_insert_kernel(unsigned long long* __restrict__ tkeys,
                   int32_t* __restrict__ tcounts, int64_t cap,
                   const int64_t* __restrict__ keys,
                   const int32_t* __restrict__ weights,
                   const int32_t* __restrict__ slots, int64_t n,
                   int64_t sent, unsigned long long cap_m,
                   int32_t* __restrict__ dropped) {
  const int64_t row = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const unsigned long long s = (unsigned long long)sent;
  const unsigned long long k =
      i < n ? (unsigned long long)keys[row * n + i] : s;
  if (!__any_sync(0xffffffffu, k != s)) return;   // a warp of padding
  if (k == s) return;
  const int32_t w = weights[row * n + i];
  if (w <= 0) return;
  int64_t slot = kWordBits ? home_slot<kWordBits>(k, cap, cap_m)
                           : (int64_t)slots[row * n + i];
  if (slot < 0 || slot >= cap) {  // never produced by store_slots
    atomicAdd(dropped + row, 1);
    return;
  }
  unsigned long long* tk = tkeys + row * cap;
  int32_t* tc = tcounts + row * cap;
  for (int64_t j = 0; j < cap; ++j) {
    unsigned long long cur = __ldcg(tk + slot);
    if (cur == s) cur = atomicCAS(tk + slot, s, k);
    if (cur == s || cur == k) {
      atomicAdd(tc + slot, w);
      return;
    }
    slot = slot + 1 == cap ? 0 : slot + 1;
  }
  atomicAdd(dropped + row, 1);
}

// LOOKUP.
//
// Bound: on the query path, random DRAM sectors beside a streamed batch.
// Each batch slot streams its 8 B key in and its 4 B count and 4 B probe
// length out; a live query also reads the 32-byte key sectors its walk
// touches (a walk of 1.5 slots on the path's 36 %-full store mostly stays
// in one sector) and, at a hit, one count sector, at random places in a
// table far larger than the L2 cache. The sector bound counts those
// sectors beside the stream; the byte bound (each byte read once) is
// below it.
//
// Design: the TPU kernel walks the queries one after another. Nothing is
// written to the table, so the walks are independent and no CAS
// serialises them (unlike the insert): a thread takes kPer queries of its
// row, strided by the block's width so each load and store of a warp
// covers whole 128-byte lines, and walks them in lockstep, the table reads
// of all its live walks issued together and then the count reads of its
// hits, so more random reads are in flight per thread. Each walk goes
// linearly from the home slot (hashed here from the key when `slots` is
// NULL, as the insert does; else the explicit int32 slot), wrapping
// within its row's table, and stops at the sentinel (a miss), at its key
// (a hit) or after `cap` steps (a miss). A sentinel query (batch padding)
// reads nothing and reports count 0 and 0 probes. The result is the plain
// version's exactly, on any table, full tables and wrap-around included.
//
// On the query path each source tile of the received batch is a live
// prefix followed by padding, so most blocks hold only padding: such a
// block writes its zeros with 16-byte stores and returns. With `stats`
// given, each block sums its live queries' hits (count > 0) and probe
// lengths and takes their longest walk, reduced within warps by shuffles
// and across the block's warps in shared memory, then adds them to its
// row's (hits, probe sum, probe max) with three atomics: the query path's
// stats need no PyTorch reduction over the batch.
//
// What the timings on the card found (PERF.md section 6): where one query
// in eight is live at a random place, 2 queries a thread were fastest, 1
// (twice the blocks, so twice the stats atomics on one row's three words)
// and 4 slower; where the batch is tiled as the path delivers it, the
// three were within 4 %, and no faster than the old one-query kernel: the
// stream and the random sectors are the limit there. So kPer is 2. Larger
// blocks, one stats atomic a warp (the same words hit by every warp) and a
// warp-level exit for padding were slower or no faster; none was kept.

// Zeros over p[0, len), the block's threads together; 16-byte stores where
// p is 16-byte aligned.
__device__ __forceinline__ void zero_span(int32_t* p, int64_t len) {
  int64_t j = threadIdx.x;
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const int64_t vec = len / 4;
    int4* v = reinterpret_cast<int4*>(p);
    for (; j < vec; j += kThreads) v[j] = make_int4(0, 0, 0, 0);
    j = vec * 4 + threadIdx.x;
  }
  for (; j < len; j += kThreads) p[j] = 0;
}

// kWordBits: 0 = explicit slots, 32 or 64 = hash the key in the kernel.
// A thread's queries lie at i0 + q * kThreads for q < kPer.
template <int kWordBits>
__global__ void __launch_bounds__(kThreads)
hash_lookup_kernel(const int64_t* __restrict__ tkeys,
                   const int32_t* __restrict__ tcounts, int64_t cap,
                   const int64_t* __restrict__ keys,
                   const int32_t* __restrict__ slots, int64_t n,
                   int64_t sent, unsigned long long cap_m,
                   int32_t* __restrict__ counts,
                   int32_t* __restrict__ probes,
                   unsigned long long* __restrict__ stats) {
  const int64_t row = blockIdx.y;
  const int64_t lo = (int64_t)blockIdx.x * kThreads * kPer;
  const int64_t i0 = lo + threadIdx.x;
  const int64_t* tk = tkeys + row * cap;
  int64_t key[kPer], slot[kPer];
  int32_t steps[kPer], count[kPer];
  bool walk[kPer], live_any = false;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int64_t i = i0 + q * kThreads;
    key[q] = i < n ? keys[row * n + i] : sent;
    walk[q] = key[q] != sent;
    live_any |= walk[q];
    steps[q] = count[q] = 0;
  }
  if (!__syncthreads_or(live_any)) {   // a block of padding
    const int64_t len = (n - lo < kThreads * kPer) ? n - lo
                                                    : kThreads * kPer;
    zero_span(counts + row * n + lo, len);
    zero_span(probes + row * n + lo, len);
    return;
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    if (!walk[q]) continue;
    slot[q] = kWordBits ? home_slot<kWordBits>(key[q], cap, cap_m)
                        : (int64_t)slots[row * n + i0 + q * kThreads];
    if (slot[q] < 0 || slot[q] >= cap) walk[q] = false;  // never produced
  }
  bool hit[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) hit[q] = false;
  // Lockstep: every live walk has taken `s` steps at the top of the loop.
  for (int64_t s = 0; s < cap; ++s) {
    int64_t cur[kPer];
    bool any = false;
#pragma unroll
    for (int q = 0; q < kPer; ++q)
      if (walk[q]) cur[q] = tk[slot[q]];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      if (!walk[q]) continue;
      ++steps[q];
      if (cur[q] == key[q]) {
        hit[q] = true;
        walk[q] = false;
      } else if (cur[q] == sent) {
        walk[q] = false;
      } else {
        slot[q] = slot[q] + 1 == cap ? 0 : slot[q] + 1;
      }
      any |= walk[q];
    }
    if (!any) break;
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q)
    if (hit[q]) count[q] = tcounts[row * cap + slot[q]];
  int hits = 0, pmax = 0;
  unsigned long long psum = 0;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int64_t i = i0 + q * kThreads;
    if (i < n) {
      counts[row * n + i] = count[q];
      probes[row * n + i] = steps[q];
    }
    hits += count[q] > 0;
    psum += (unsigned)steps[q];
    pmax = max(pmax, steps[q]);
  }
  if (stats == nullptr) return;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    hits += __shfl_down_sync(0xffffffffu, hits, d);
    psum += __shfl_down_sync(0xffffffffu, psum, d);
    pmax = max(pmax, __shfl_down_sync(0xffffffffu, pmax, d));
  }
  __shared__ unsigned long long part[3][kThreads / 32];
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    part[0][warp] = (unsigned)hits;
    part[1][warp] = psum;
    part[2][warp] = (unsigned)pmax;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long h = 0, ps = 0, pm = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      h += part[0][w];
      ps += part[1][w];
      pm = pm > part[2][w] ? pm : part[2][w];
    }
    unsigned long long* st = stats + row * 3;
    if (h) atomicAdd(st, h);
    if (ps) atomicAdd(st + 1, ps);
    if (pm) atomicMax(st + 2, pm);
  }
}

}  // namespace

// table keys (rows, cap) int64, counts (rows, cap) int32, updated in place;
// batch keys (rows, n) int64, weights (rows, n) int32, and home slots
// (rows, n) int32 or NULL: then the kernel hashes each key as a
// `word_bits`-bit word (32 or 64); dropped (rows,) int32 is incremented by
// the items this batch drops. 1 <= cap < 2**31.
extern "C" int hash_insert_launch(void* tkeys, void* tcounts, int64_t rows,
                                  int64_t cap, const void* keys,
                                  const void* weights, const void* slots,
                                  int64_t n, int64_t sent, int word_bits,
                                  void* dropped, void* stream) {
  if (cap < 1 || cap >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads), (unsigned)rows);
  const cudaStream_t st = (cudaStream_t)stream;
  auto* tk = (unsigned long long*)tkeys;
  auto* tc = (int32_t*)tcounts;
  auto* k = (const int64_t*)keys;
  auto* w = (const int32_t*)weights;
  auto* sl = (const int32_t*)slots;
  auto* d = (int32_t*)dropped;
  const unsigned long long m = cap_inverse(cap);
  if (slots != nullptr) {
    hash_insert_kernel<0><<<grid, kThreads, 0, st>>>(tk, tc, cap, k, w, sl,
                                                     n, sent, m, d);
  } else if (word_bits == 32) {
    hash_insert_kernel<32><<<grid, kThreads, 0, st>>>(tk, tc, cap, k, w, sl,
                                                      n, sent, m, d);
  } else if (word_bits == 64) {
    hash_insert_kernel<64><<<grid, kThreads, 0, st>>>(tk, tc, cap, k, w, sl,
                                                      n, sent, m, d);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// table keys (rows, cap) int64 and counts (rows, cap) int32, read only;
// queries (rows, n) int64 with home slots (rows, n) int32, or slots NULL:
// then the kernel hashes each key as a `word_bits`-bit word (32 or 64);
// counts and probes (rows, n) int32 are written; stats (rows, 3) int64, or
// NULL, gets each row's hits, probe sum (added) and longest walk (maxed).
// 1 <= cap < 2**31.
extern "C" int hash_lookup_launch(const void* tkeys, const void* tcounts,
                                  int64_t rows, int64_t cap, const void* keys,
                                  const void* slots, int64_t n, int64_t sent,
                                  int word_bits, void* counts, void* probes,
                                  void* stats, void* stream) {
  if (cap < 1 || cap >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const int64_t span = (int64_t)kThreads * kPer;
  const dim3 grid((unsigned)((n + span - 1) / span), (unsigned)rows);
  const cudaStream_t st = (cudaStream_t)stream;
  auto* tk = (const int64_t*)tkeys;
  auto* tc = (const int32_t*)tcounts;
  auto* k = (const int64_t*)keys;
  auto* sl = (const int32_t*)slots;
  auto* c = (int32_t*)counts;
  auto* p = (int32_t*)probes;
  auto* sts = (unsigned long long*)stats;
  const unsigned long long m = cap_inverse(cap);
  if (slots != nullptr) {
    hash_lookup_kernel<0><<<grid, kThreads, 0, st>>>(tk, tc, cap, k, sl, n,
                                                     sent, m, c, p, sts);
  } else if (word_bits == 32) {
    hash_lookup_kernel<32><<<grid, kThreads, 0, st>>>(tk, tc, cap, k, sl, n,
                                                      sent, m, c, p, sts);
  } else if (word_bits == 64) {
    hash_lookup_kernel<64><<<grid, kThreads, 0, st>>>(tk, tc, cap, k, sl, n,
                                                      sent, m, c, p, sts);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
