// The keyed backend's row plane: per-key values with a presence byte and an
// optional TTL clock, and keep-first admission over it.
//
// Replaces the XLA programs of flink_tpu/state/tpu_backend.py:
//  * dedup_first_launch: _dedup_first (:189). Lookup-or-insert of the
//    valid rows; a row is the first of its slot in the batch when it has
//    the lowest row index there; `was` = presence and (ts - last_ts <= ttl)
//    as they stood before the batch; fresh = ok and not was and first;
//    presence := 1 for every ok row, last_ts := ts for the fresh rows; the
//    overflow flag and the table's occupancy. The reference filled a
//    [capacity + 1] int32 array every call to find the first rows.
//  * row_set_launch: _rows_set (:111). The last row of a slot in the batch
//    writes its value, presence := 1 and last_ts := now (a scalar or a
//    row's own); the reference's [capacity + 1] last-position array again.
//  * row_get_launch: _rows_get (:127), with its lookup fused: the value at
//    the key's slot (slot 0's where the key is absent, as the reference's
//    gather at max(slot, 0)), present = found and presence and (now -
//    last_ts <= ttl).
//  * row_unset_launch: _rows_unset (:157), with its lookup fused:
//    presence := 0 at each found key's slot, the slots (-1: absent) for
//    the caller's dirty marking.
// The probe is probe.cuh's, shared with the other sources; every key is
// sanitised here (EMPTY_KEY, int64 max, becomes int64 max - 1), as the
// backend sanitises before the reference's programs.
//
// Ordering across the grid. dedup_first must read presence and the clock
// as they stood before the batch for every row, and must write nothing of
// them when a row of the batch found no slot: the backend then grows the
// table and runs the batch again, and a presence byte written by the
// failed attempt would make the retry drop that key's admission. So a call
// is two launches on one stream:
//  1. dedup_resolve_kernel: each valid row's slot (claimed if new), its
//     row index folded into its slot's entry of the first-row scratch by
//     atomicMin, and `was` read into the fresh buffer; the failed rows and
//     the claims counted by warp ballots into a status word each. Nothing
//     of the planes is written.
//  2. dedup_admit_kernel: after every row's read, and only when no row
//     failed: presence, the clock of the fresh rows, the slot's dirty
//     block; fresh rows counted. Either way a slot's first row restores
//     its scratch entry to kNone. (A later row of the slot reads either the
//     first row's index or kNone: neither is its own index.)
// On an overflow the table keeps the claims of the failed attempt: keys of
// valid rows of the batch, with presence 0 (absent to every reader), which
// the retry claims anyway; the planes are as they were.
//
// The first-row scratch is the backend's [capacity] int32 array, kNone in
// every entry between calls: a call restores the entries it touched, so it
// costs O(batch), not O(capacity) (the reference's array was 64 MiB a call
// at 2^24 slots). row_set uses the same array for its last rows, as n - 1
// - i under atomicMin.
//
// The table's occupancy after a successful call is the backend's count
// before it plus this call's claims (the table only ever gains keys), which
// is the reference's count of the whole table after each batch without the
// read of 2^24 slots.
//
// Bound on the H100: random 32-byte sectors. A row of a 10M-key batch
// touches its key's table sector, its presence and clock sectors and its
// scratch sector, each at a random address.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "probe.cuh"

namespace {

using probe_table::kEmpty;
using ull = unsigned long long;

constexpr int kThreads = 256;
constexpr int kNone = INT_MAX;     // a scratch entry no row holds
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ ull sanitise(long long key) {
  const ull k = (ull)key;
  return k == kEmpty ? kEmpty - 1 : k;
}

// ts - last <= ttl in the wrapping int64 arithmetic of the reference
__device__ __forceinline__ bool within_ttl(long long ts, long long last,
                                           long long ttl) {
  return (long long)((ull)ts - (ull)last) <= ttl;
}

// one atomic a warp for a count of flagged lanes
__device__ __forceinline__ void warp_count(bool flag, ull* counter) {
  const unsigned b = __ballot_sync(kFull, flag);
  if ((threadIdx.x & 31) == 0 && b) atomicAdd(counter, (ull)__popc(b));
}

// status: [0] valid rows that found no slot, [1] slots claimed,
// [2] fresh rows (all zero at the launch's start)
__global__ void dedup_resolve_kernel(ull* __restrict__ table, ull mask,
                                     const long long* __restrict__ keys,
                                     const uint8_t* __restrict__ valid,
                                     const long long* __restrict__ ts,
                                     const int8_t* __restrict__ presence,
                                     const long long* __restrict__ last_ts,
                                     long long ttl, long long n,
                                     int* __restrict__ slots,
                                     int* __restrict__ scratch,
                                     uint8_t* __restrict__ fresh,
                                     ull* __restrict__ status) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  bool claimed = false, failed = false;
  if (live) {
    int s = -1;
    bool was = false;
    if (valid == nullptr || valid[i]) {
      s = probe_table::probe_claim(table, mask, sanitise(keys[i]), true,
                                   claimed);
      if (s < 0) {
        failed = true;
      } else {
        atomicMin(scratch + s, (int)i);
        was = presence[s] > 0;
        if (was && last_ts != nullptr) was = within_ttl(ts[i], last_ts[s], ttl);
      }
    }
    slots[i] = s;
    fresh[i] = was;   // `was` until the admit launch
  }
  warp_count(failed, status);
  warp_count(claimed, status + 1);
}

__global__ void dedup_admit_kernel(const int* __restrict__ slots,
                                   int* __restrict__ scratch,
                                   uint8_t* __restrict__ fresh,
                                   int8_t* __restrict__ presence,
                                   long long* __restrict__ last_ts,
                                   const long long* __restrict__ ts,
                                   uint8_t* __restrict__ dirty,
                                   int dirty_shift, long long n,
                                   ull* __restrict__ status) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool overflow = status[0] != 0;
  bool f = false;
  if (i < n) {
    const int s = slots[i];
    if (s >= 0) {
      const bool first = scratch[s] == (int)i;
      if (first) scratch[s] = kNone;
      if (!overflow) {
        f = first && !fresh[i];
        presence[s] = 1;
        if (f && last_ts != nullptr) last_ts[s] = ts[i];
        dirty[s >> dirty_shift] = 1;
      }
    }
    fresh[i] = f;
  }
  warp_count(f, status + 2);
}

__global__ void row_set_mark_kernel(const int* __restrict__ slots,
                                    int* __restrict__ scratch, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int s = slots[i];
  if (s >= 0) atomicMin(scratch + s, (int)(n - 1 - i));
}

template <typename T>
__device__ __forceinline__ void copy_elem(void* dst, long long d,
                                          const void* src, long long s) {
  static_cast<T*>(dst)[d] = static_cast<const T*>(src)[s];
}

__device__ __forceinline__ void copy_value(void* dst, long long d,
                                           const void* src, long long s,
                                           int esize) {
  switch (esize) {
    case 1: copy_elem<uint8_t>(dst, d, src, s); break;
    case 2: copy_elem<uint16_t>(dst, d, src, s); break;
    case 4: copy_elem<uint32_t>(dst, d, src, s); break;
    default: copy_elem<ull>(dst, d, src, s); break;
  }
}

__global__ void row_set_write_kernel(const int* __restrict__ slots,
                                     int* __restrict__ scratch,
                                     void* vals, const void* new_vals,
                                     int esize, int8_t* __restrict__ presence,
                                     long long* __restrict__ last_ts,
                                     const long long* __restrict__ now_rows,
                                     long long now, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int s = slots[i];
  if (s < 0 || scratch[s] != (int)(n - 1 - i)) return;
  scratch[s] = kNone;
  copy_value(vals, s, new_vals, i, esize);
  presence[s] = 1;
  if (last_ts != nullptr) last_ts[s] = now_rows != nullptr ? now_rows[i] : now;
}

__global__ void row_get_kernel(ull* __restrict__ table, ull mask,
                               const long long* __restrict__ keys,
                               long long n, const void* vals, int esize,
                               const int8_t* __restrict__ presence,
                               const long long* __restrict__ last_ts,
                               long long now, long long ttl, void* out_vals,
                               uint8_t* __restrict__ present) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int s = probe_table::probe(table, mask, sanitise(keys[i]), false);
  const int sc = s < 0 ? 0 : s;
  copy_value(out_vals, i, vals, sc, esize);
  bool p = s >= 0 && presence[sc] > 0;
  if (p && last_ts != nullptr) p = within_ttl(now, last_ts[sc], ttl);
  present[i] = p;
}

__global__ void row_unset_kernel(ull* __restrict__ table, ull mask,
                                 const long long* __restrict__ keys,
                                 long long n, int8_t* __restrict__ presence,
                                 int* __restrict__ slots) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int s = probe_table::probe(table, mask, sanitise(keys[i]), false);
  if (s >= 0) presence[s] = 0;
  slots[i] = s;
}

unsigned grid_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// One keep-first admission over n rows (module comment). valid may be
// null (every row valid), last_ts null (no TTL).
// status: int64 [3], zeroed here.
extern "C" int dedup_first_launch(void* table, long long capacity,
                                  const void* keys, const void* valid,
                                  const void* ts, long long n,
                                  void* presence, void* last_ts,
                                  long long ttl, void* scratch, void* dirty,
                                  int dirty_shift, void* slots, void* fresh,
                                  void* status, void* stream) {
  if (n > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(status, 0, 3 * sizeof(ull), st);
  if (err != cudaSuccess || n <= 0) return (int)err;
  dedup_resolve_kernel<<<grid_for(n), kThreads, 0, st>>>(
      (ull*)table, (ull)(capacity - 1), (const long long*)keys,
      (const uint8_t*)valid, (const long long*)ts, (const int8_t*)presence,
      (const long long*)last_ts, ttl, n, (int*)slots, (int*)scratch,
      (uint8_t*)fresh, (ull*)status);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dedup_admit_kernel<<<grid_for(n), kThreads, 0, st>>>(
      (const int*)slots, (int*)scratch, (uint8_t*)fresh, (int8_t*)presence,
      (long long*)last_ts, (const long long*)ts, (uint8_t*)dirty,
      dirty_shift, n, (ull*)status);
  return (int)cudaGetLastError();
}

// The last row of each slot (slot -1: no write) writes new_vals[i] (esize
// bytes, the plane's dtype) to vals, presence := 1 and, with last_ts,
// now_rows[i] (or now when now_rows is null).
extern "C" int row_set_launch(const void* slots, long long n, void* vals,
                              const void* new_vals, int esize,
                              void* presence, void* last_ts,
                              const void* now_rows, long long now,
                              void* scratch, void* stream) {
  if (n > INT_MAX || (esize != 1 && esize != 2 && esize != 4 && esize != 8))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  row_set_mark_kernel<<<grid_for(n), kThreads, 0, st>>>(
      (const int*)slots, (int*)scratch, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  row_set_write_kernel<<<grid_for(n), kThreads, 0, st>>>(
      (const int*)slots, (int*)scratch, vals, new_vals, esize,
      (int8_t*)presence, (long long*)last_ts, (const long long*)now_rows, now,
      n);
  return (int)cudaGetLastError();
}

extern "C" int row_get_launch(void* table, long long capacity,
                              const void* keys, long long n,
                              const void* vals, int esize,
                              const void* presence, const void* last_ts,
                              long long now, long long ttl, void* out_vals,
                              void* present, void* stream) {
  if (esize != 1 && esize != 2 && esize != 4 && esize != 8)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  row_get_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (ull*)table, (ull)(capacity - 1), (const long long*)keys, n, vals,
      esize, (const int8_t*)presence, (const long long*)last_ts, now, ttl,
      out_vals, (uint8_t*)present);
  return (int)cudaGetLastError();
}

extern "C" int row_unset_launch(void* table, long long capacity,
                                const void* keys, long long n,
                                void* presence, void* slots, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  row_unset_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (ull*)table, (ull)(capacity - 1), (const long long*)keys, n,
      (int8_t*)presence, (int*)slots);
  return (int)cudaGetLastError();
}

extern "C" const char* row_state_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
