// The earlier dedup_first and row_set (flink_tpu_torch/csrc/row_state.cu
// before the batch map), kept buildable so that one call can time them
// beside the package's kernels: tools/row_designs.py builds this file with the
// package's flags (-I flink_tpu_torch/csrc) and binds
// dedup_first_earlier_launch and row_set_earlier_launch.
//
// Each is two launches on one stream over a [capacity] int32 scratch of
// INT_MAX kept by the caller and restored by each call:
//  * dedup_first: a memset of the status; dedup_resolve_earlier_kernel
//    probes and claims each valid row's slot, folds its row index into the
//    slot's scratch entry by atomicMin and reads `was` (presence and the
//    clock) into the fresh buffer, counting failed rows and claims; after
//    it, only when no row failed, dedup_admit_earlier_kernel rereads each
//    row's slot and scratch entry and writes presence, the fresh clock and
//    the dirty byte of every ok row; a slot's first row restores its
//    scratch entry.
//  * row_set: row_set_mark_earlier_kernel folds n - 1 - i into each slot's
//    scratch entry by atomicMin; row_set_write_earlier_kernel has the last
//    row of each slot write its value, presence and clock and restore the
//    entry.
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
__global__ void dedup_resolve_earlier_kernel(
    ull* __restrict__ table, ull mask, const long long* __restrict__ keys,
    const uint8_t* __restrict__ valid, const long long* __restrict__ ts,
    const int8_t* __restrict__ presence, const long long* __restrict__ last_ts,
    long long ttl, long long n, int* __restrict__ slots,
    int* __restrict__ scratch, uint8_t* __restrict__ fresh,
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
        if (was && last_ts != nullptr)
          was = within_ttl(ts[i], last_ts[s], ttl);
      }
    }
    slots[i] = s;
    fresh[i] = was;   // `was` until the admit launch
  }
  warp_count(failed, status);
  warp_count(claimed, status + 1);
}

__global__ void dedup_admit_earlier_kernel(
    const int* __restrict__ slots, int* __restrict__ scratch,
    uint8_t* __restrict__ fresh, int8_t* __restrict__ presence,
    long long* __restrict__ last_ts, const long long* __restrict__ ts,
    uint8_t* __restrict__ dirty, int dirty_shift, long long n,
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

__global__ void row_set_mark_earlier_kernel(
    const int* __restrict__ slots, int* __restrict__ scratch, long long n) {
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

__global__ void row_set_write_earlier_kernel(
    const int* __restrict__ slots, int* __restrict__ scratch, void* vals,
    const void* new_vals, int esize, int8_t* __restrict__ presence,
    long long* __restrict__ last_ts, const long long* __restrict__ now_rows,
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

unsigned grid_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// One keep-first admission over n rows (the file's comment). valid may be
// null (every row valid), last_ts null (no TTL).
// status: int64 [3], zeroed here.
extern "C" int dedup_first_earlier_launch(
    void* table, long long capacity, const void* keys, const void* valid,
    const void* ts, long long n, void* presence, void* last_ts, long long ttl,
    void* scratch, void* dirty, int dirty_shift, void* slots, void* fresh,
    void* status, void* stream) {
  if (n > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(status, 0, 3 * sizeof(ull), st);
  if (err != cudaSuccess || n <= 0) return (int)err;
  dedup_resolve_earlier_kernel<<<grid_for(n), kThreads, 0, st>>>(
      (ull*)table, (ull)(capacity - 1), (const long long*)keys,
      (const uint8_t*)valid, (const long long*)ts, (const int8_t*)presence,
      (const long long*)last_ts, ttl, n, (int*)slots, (int*)scratch,
      (uint8_t*)fresh, (ull*)status);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dedup_admit_earlier_kernel<<<grid_for(n), kThreads, 0, st>>>(
      (const int*)slots, (int*)scratch, (uint8_t*)fresh, (int8_t*)presence,
      (long long*)last_ts, (const long long*)ts, (uint8_t*)dirty,
      dirty_shift, n, (ull*)status);
  return (int)cudaGetLastError();
}

// The last row of each slot (slot -1: no write) writes new_vals[i] (esize
// bytes, the plane's dtype) to vals, presence := 1 and, with last_ts,
// now_rows[i] (or now when now_rows is null).
extern "C" int row_set_earlier_launch(
    const void* slots, long long n, void* vals, const void* new_vals,
    int esize, void* presence, void* last_ts, const void* now_rows,
    long long now, void* scratch, void* stream) {
  if (n > INT_MAX || (esize != 1 && esize != 2 && esize != 4 && esize != 8))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  row_set_mark_earlier_kernel<<<grid_for(n), kThreads, 0, st>>>(
      (const int*)slots, (int*)scratch, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  row_set_write_earlier_kernel<<<grid_for(n), kThreads, 0, st>>>(
      (const int*)slots, (int*)scratch, vals, new_vals, esize,
      (int8_t*)presence, (long long*)last_ts, (const long long*)now_rows, now,
      n);
  return (int)cudaGetLastError();
}

extern "C" const char* row_earlier_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
