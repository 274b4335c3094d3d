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
// 0x9E3779B9 and mixed again, then the unsigned 32-bit `%` by cap; for 64
// the splitmix64 finalizer, salted with 0x9E3779B97F4A7C15 and mixed
// again, then the unsigned 64-bit `%` of `unsigned long long` by cap (an
// exact remainder, the compiler's division routine). 1 <= cap < 2**31.
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

// umod(slot_hash(key), cap) of `countstore.store_slots`.
template <int kWordBits>
__device__ __forceinline__ int64_t home_slot(unsigned long long key,
                                             int64_t cap) {
  if (kWordBits == 32) {
    const uint32_t h = mix32(mix32((uint32_t)key) ^ 0x9E3779B9u);
    return (int64_t)(h % (uint32_t)cap);
  }
  const unsigned long long h = mix64(mix64(key) ^ 0x9E3779B97F4A7C15ull);
  return (int64_t)(h % (unsigned long long)cap);
}

// kWordBits: 0 = explicit slots, 32 or 64 = hash the key in the kernel.
template <int kWordBits>
__global__ void __launch_bounds__(kThreads)
hash_insert_kernel(unsigned long long* __restrict__ tkeys,
                   int32_t* __restrict__ tcounts, int64_t cap,
                   const int64_t* __restrict__ keys,
                   const int32_t* __restrict__ weights,
                   const int32_t* __restrict__ slots, int64_t n,
                   int64_t sent, int32_t* __restrict__ dropped) {
  const int64_t row = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const unsigned long long s = (unsigned long long)sent;
  const unsigned long long k =
      i < n ? (unsigned long long)keys[row * n + i] : s;
  if (!__any_sync(0xffffffffu, k != s)) return;   // a warp of padding
  if (k == s) return;
  const int32_t w = weights[row * n + i];
  if (w <= 0) return;
  int64_t slot = kWordBits ? home_slot<kWordBits>(k, cap)
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

// LOOKUP. Bound: bytes, and memory latency as for the insert: each query
// reads its 8 B key and 4 B home slot, writes a 4 B count and a 4 B probe
// length, and reads one 8 B table key per probe step (plus the 4 B count
// at a hit), at a random place in the table.
//
// Design: the TPU kernel walks the queries one after another. Nothing is
// written to the table, so the walks are independent: one thread per
// query, one launch for every row (processing element) of the batch. The
// thread walks linearly from the home slot, wrapping within its row's
// table, and stops at the sentinel (a miss), at its key (a hit) or after
// `cap` steps (a miss). A sentinel query (batch padding) reads nothing and
// reports count 0 and 0 probes. The result is the plain version's exactly,
// on any table, full tables and wrap-around included.
__global__ void hash_lookup_kernel(const int64_t* __restrict__ tkeys,
                                   const int32_t* __restrict__ tcounts,
                                   int64_t cap,
                                   const int64_t* __restrict__ keys,
                                   const int32_t* __restrict__ slots,
                                   int64_t n, int64_t sent,
                                   int32_t* __restrict__ counts,
                                   int32_t* __restrict__ probes) {
  const int64_t row = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t key = keys[row * n + i];
  int32_t count = 0;
  int64_t steps = 0;
  if (key != sent) {
    const int64_t* tk = tkeys + row * cap;
    int64_t slot = slots[row * n + i];
    while (steps < cap && slot >= 0 && slot < cap) {
      const int64_t cur = tk[slot];
      ++steps;
      if (cur == key) {
        count = tcounts[row * cap + slot];
        break;
      }
      if (cur == sent) break;
      slot = slot + 1 == cap ? 0 : slot + 1;
    }
  }
  counts[row * n + i] = count;
  probes[row * n + i] = (int32_t)steps;
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
  if (slots != nullptr) {
    hash_insert_kernel<0><<<grid, kThreads, 0, st>>>(tk, tc, cap, k, w, sl,
                                                     n, sent, d);
  } else if (word_bits == 32) {
    hash_insert_kernel<32><<<grid, kThreads, 0, st>>>(tk, tc, cap, k, w, sl,
                                                      n, sent, d);
  } else if (word_bits == 64) {
    hash_insert_kernel<64><<<grid, kThreads, 0, st>>>(tk, tc, cap, k, w, sl,
                                                      n, sent, d);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// table keys (rows, cap) int64 and counts (rows, cap) int32, read only;
// queries (rows, n) int64 with home slots (rows, n) int32; counts and
// probes (rows, n) int32 are written.
extern "C" int hash_lookup_launch(const void* tkeys, const void* tcounts,
                                  int64_t rows, int64_t cap, const void* keys,
                                  const void* slots, int64_t n, int64_t sent,
                                  void* counts, void* probes, void* stream) {
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads), (unsigned)rows);
  hash_lookup_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)tkeys, (const int32_t*)tcounts, cap,
      (const int64_t*)keys, (const int32_t*)slots, n, sent, (int32_t*)counts,
      (int32_t*)probes);
  return (int)cudaGetLastError();
}
