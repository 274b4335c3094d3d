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
// Bound: bytes, and in practice memory latency. Each item reads its 8 B
// key, 4 B weight and 4 B home slot once and touches at least one 8 B
// table key and one 4 B table count, at a random place in a table far
// larger than the L2 cache.
//
// Design: the TPU kernel is sequential, one item after another, so its
// slot layout is exactly that of the sequential plain version. Here every
// item has a thread of its own:
// - the thread probes linearly from its home slot, wrapping within its
//   row's table (one row per processing element);
// - an empty slot (the sentinel) is claimed with a 64-bit atomicCAS; if the
//   CAS returns the thread's own key, another thread inserted the same key
//   first and the slot matches;
// - the weight is added to the matching slot's count with atomicAdd;
// - after `cap` probes without an empty or matching slot the item is
//   dropped and the row's drop counter is incremented atomically.
// Keys only ever change from the sentinel to a key, so a stale read can
// only show a sentinel where a key now is, and the CAS corrects it. The
// (key, count) set is the sequential version's; the slots may differ, which
// the store histogram (a sort of the table) does not see. A row drops an
// item exactly when its table cannot hold every distinct key.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void hash_insert_kernel(unsigned long long* __restrict__ tkeys,
                                   int32_t* __restrict__ tcounts, int64_t cap,
                                   const int64_t* __restrict__ keys,
                                   const int32_t* __restrict__ weights,
                                   const int32_t* __restrict__ slots,
                                   int64_t n, int64_t sent,
                                   int32_t* __restrict__ dropped) {
  const int64_t row = blockIdx.y;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t key = keys[row * n + i];
  const int32_t w = weights[row * n + i];
  if (key == sent || w <= 0) return;
  unsigned long long* tk = tkeys + row * cap;
  int32_t* tc = tcounts + row * cap;
  const unsigned long long k = (unsigned long long)key;
  const unsigned long long s = (unsigned long long)sent;
  int64_t slot = slots[row * n + i];
  if (slot < 0 || slot >= cap) {  // never produced by store_slots
    atomicAdd(dropped + row, 1);
    return;
  }
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
// batch keys (rows, n) int64, weights and home slots (rows, n) int32;
// dropped (rows,) int32 is incremented by the items this batch drops.
extern "C" int hash_insert_launch(void* tkeys, void* tcounts, int64_t rows,
                                  int64_t cap, const void* keys,
                                  const void* weights, const void* slots,
                                  int64_t n, int64_t sent, void* dropped,
                                  void* stream) {
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads), (unsigned)rows);
  hash_insert_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (unsigned long long*)tkeys, (int32_t*)tcounts, cap,
      (const int64_t*)keys, (const int32_t*)weights, (const int32_t*)slots, n,
      sent, (int32_t*)dropped);
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
