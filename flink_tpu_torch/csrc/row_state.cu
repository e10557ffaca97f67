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
// The batch map. dedup_first and row_set find each slot's first (last) row
// of the batch in a map of the batch's own size, not of the table's: a
// power-of-two array of 8-byte entries, at least 2n of them (8 MiB at 2^19
// rows, so it stays in L2 across the grid barrier; ops/row_state.py gives
// a batch of more than one block's rows and at most 2^16 min(16n, 2^17)
// entries, which shortens the longest probe chain such a latency-bound
// call waits on), every entry
// kNoEntry between calls. A row folds slot << 32 | row into the entry at
// the slot's low bits, probing linearly: a CAS from kNoEntry claims a free
// entry, and an entry that holds the row's slot keeps the lower word by a
// 64-bit atomicMin (row_set folds n - 1 - row: the last row wins). An
// entry's slot never changes within a call, so a probe chain is never cut,
// and there are at least as many free entries as rows.
//
// Both are one cooperative launch (a thread an entry of the map, at most
// the blocks the card holds at once, walking the batch and then the map),
// one grid barrier; a call of at most 256 rows (a ValueState's one key) is
// one ordinary launch of one block, __syncthreads its barrier, which
// saves the cooperative launch's cost (tools/row_designs.py):
//  1. dedup_first: each valid row's slot (claimed if new) folded into the
//     map; the failed rows and the claims counted by warp ballots into
//     the block's shared counts, which one thread adds to the head. Nothing
//     of the planes is written, so `was` is read after the barrier as it
//     stood before the batch. row_set: each row's slot folded.
//  2. The grid walks the map's entries: each live entry is a slot and its
//     first (last) row, and is set back to kNoEntry by its walker (no row
//     probes the map after the barrier). dedup_first, only when no row
//     failed: the walker reads the slot's presence (and clock, where
//     present), writes presence := 1, the fresh clock and the dirty byte
//     where the slot is fresh, flags its row fresh and counts it. A slot
//     that was present with presence 1 is left unwritten and its block
//     unmarked: nothing of it changes. So each slot's presence and clock
//     are read and written once, by one thread. row_set: the walker writes
//     the last row's value, presence and clock.
// On an overflow (a valid row found no slot) presence and the clock are
// left as they were: the backend grows the table and runs the batch again,
// and a presence byte written by the failed attempt would make the retry
// drop that key's admission. The table keeps the failed attempt's claims:
// keys of valid rows of the batch, with presence 0 (absent to every
// reader), which the retry claims anyway.
//
// The counts. The map's buffer starts with kHead words, zero between
// calls: the failed rows, the claims, the fresh rows and a block ticket.
// The last block to finish phase 2 moves the three counts to the caller's
// status and zeroes the four words, so a call needs no memset. The
// table's occupancy after a successful call is the backend's count before
// it plus this call's claims (the table only ever gains keys).
//
// Bound on the H100: random 32-byte sectors. A distinct key of a 10M-key
// batch touches its table sector and its presence sector, and its clock
// sector when present or fresh, each at a random address in HBM; its map
// entry is in L2.
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "probe.cuh"

namespace {

namespace cg = cooperative_groups;
using probe_table::kEmpty;
using ull = unsigned long long;

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr ull kNoEntry = ~0ull;   // a free map entry
// the map buffer's head words: [failed, claims, fresh, ticket]
// (MAP_HEAD in ops/row_state.py)
constexpr int kHead = 4;
constexpr int kFailed = 0, kClaims = 1, kFresh = 2, kTicket = 3;

__device__ __forceinline__ ull sanitise(long long key) {
  const ull k = (ull)key;
  return k == kEmpty ? kEmpty - 1 : k;
}

// ts - last <= ttl in the wrapping int64 arithmetic of the reference
__device__ __forceinline__ bool within_ttl(long long ts, long long last,
                                           long long ttl) {
  return (long long)((ull)ts - (ull)last) <= ttl;
}

// a warp's flagged lanes added to its block's count in shared memory (the
// block's thread 0 adds the count to the head word after a __syncthreads)
__device__ __forceinline__ void warp_count(bool flag, unsigned* count) {
  const unsigned b = __ballot_sync(kFull, flag);
  if ((threadIdx.x & 31) == 0 && b) atomicAdd(count, (unsigned)__popc(b));
}

// slot << 32 | word into the batch map: the entry of `slot` keeps the
// lowest word (module comment). False only when every entry holds another
// slot, which a map at rest with at least 2n entries never does: the
// probe is bounded so that a map left dirty fails the call, not hangs it.
__device__ __forceinline__ bool map_fold(ull* __restrict__ map, ull mask,
                                         int slot, unsigned word) {
  const ull mine = ((ull)(unsigned)slot << 32) | word;
  ull h = (ull)(unsigned)slot & mask;
  for (ull p = 0; p <= mask; ++p, h = (h + 1) & mask) {
    ull cur = __ldcg(map + h);
    if (cur == kNoEntry) {
      cur = atomicCAS(map + h, kNoEntry, mine);
      if (cur == kNoEntry) return true;
    }
    if ((cur >> 32) == (ull)(unsigned)slot) {
      if (mine < cur) atomicMin(map + h, mine);
      return true;
    }
  }
  return false;
}

// The last block to arrive moves the counts to status and zeroes the head
// words (thread 0 added this block's counts, so its fence orders them
// before its ticket).
__device__ __forceinline__ void finish(ull* __restrict__ head,
                                       ull* __restrict__ status) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(head + kTicket, 1ull) == (ull)gridDim.x - 1;
  }
  __syncthreads();
  if (last && threadIdx.x < kHead) {
    const ull v = atomicExch(head + threadIdx.x, 0ull);
    if (threadIdx.x < kTicket) status[threadIdx.x] = v;
  }
}

struct DedupArgs {
  ull* table;
  ull mask;
  const long long* keys;
  const uint8_t* valid;    // null: every row valid
  const long long* ts;
  int8_t* presence;
  long long* last_ts;      // null: no clock
  long long ttl;
  long long n;
  uint8_t* dirty;
  int dirty_shift;
  int* slots;
  uint8_t* fresh;
  ull* status;             // [failed, claims, fresh]
  ull* head;               // the map buffer's head words
  ull* map;
  ull map_mask;            // entries - 1
};

// 1. resolve each row's slot and fold it into the map
__device__ __forceinline__ void dedup_resolve(const DedupArgs& a,
                                              long long first,
                                              long long stride) {
  __shared__ unsigned failed_b, claims_b;
  if (threadIdx.x == 0) failed_b = claims_b = 0u;
  __syncthreads();
  for (long long base = first; base < a.n; base += stride) {
    const long long i = base + threadIdx.x;
    bool claimed = false, failed = false;
    if (i < a.n) {
      int s = -1;
      if (a.valid == nullptr || a.valid[i]) {
        s = probe_table::probe_claim(a.table, a.mask, sanitise(a.keys[i]),
                                     true, claimed);
        failed = s < 0 || !map_fold(a.map, a.map_mask, s, (unsigned)i);
      }
      a.slots[i] = s;
      a.fresh[i] = 0;
    }
    warp_count(failed, &failed_b);
    warp_count(claimed, &claims_b);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (failed_b) atomicAdd(a.head + kFailed, (ull)failed_b);
    if (claims_b) atomicAdd(a.head + kClaims, (ull)claims_b);
  }
}

// 2. walk the map: each slot's first row admits it or not
__device__ __forceinline__ void dedup_admit(const DedupArgs& a,
                                            long long first,
                                            long long stride) {
  __shared__ unsigned fresh_b;
  if (threadIdx.x == 0) fresh_b = 0u;
  __syncthreads();
  const bool overflow = __ldcg(a.head + kFailed) != 0ull;
  const long long m = (long long)a.map_mask + 1;
  for (long long base = first; base < m; base += stride) {
    const long long e = base + threadIdx.x;
    bool f = false;
    if (e < m) {
      const ull v = __ldcg(a.map + e);
      if (v != kNoEntry) {
        a.map[e] = kNoEntry;
        if (!overflow) {
          const int s = (int)(v >> 32);
          const long long i = (long long)(unsigned)v;
          const int8_t p = a.presence[s];
          bool was = p > 0;
          long long t = 0;
          if (a.last_ts != nullptr) {
            t = a.ts[i];
            if (was) was = within_ttl(t, a.last_ts[s], a.ttl);
          }
          if (!was) {
            a.presence[s] = 1;
            if (a.last_ts != nullptr) a.last_ts[s] = t;
            a.fresh[i] = 1;
            f = true;
          } else if (p != 1) {
            a.presence[s] = 1;
          }
          if (!was || p != 1) a.dirty[s >> a.dirty_shift] = 1;
        }
      }
    }
    warp_count(f, &fresh_b);
  }
  __syncthreads();
  if (threadIdx.x == 0 && fresh_b) atomicAdd(a.head + kFresh, (ull)fresh_b);
  finish(a.head, a.status);
}

// the barrier between the phases: the grid's (a cooperative launch), or a
// single block's
template <bool kGrid>
__device__ __forceinline__ void phase_barrier() {
  if constexpr (kGrid)
    cg::this_grid().sync();
  else
    __syncthreads();
}

template <bool kGrid>
__global__ void __launch_bounds__(kThreads)
    dedup_first_kernel(DedupArgs a) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads;
  dedup_resolve(a, first, stride);
  phase_barrier<kGrid>();
  dedup_admit(a, first, stride);
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

struct SetArgs {
  const int* slots;
  long long n;
  void* vals;
  const void* new_vals;
  int esize;
  int8_t* presence;
  long long* last_ts;       // null: no clock
  const long long* now_rows;  // null: `now` for every row
  long long now;
  ull* map;
  ull map_mask;
};

// 1. each row's slot folded as n - 1 - row: the last row keeps the entry
__device__ __forceinline__ void row_set_mark(const SetArgs& a,
                                             long long first,
                                             long long stride) {
  for (long long i = first + threadIdx.x; i < a.n; i += stride) {
    const int s = a.slots[i];
    if (s >= 0) (void)map_fold(a.map, a.map_mask, s, (unsigned)(a.n - 1 - i));
  }
}

// 2. walk the map: each slot's last row writes it
__device__ __forceinline__ void row_set_write(const SetArgs& a,
                                              long long first,
                                              long long stride) {
  const long long m = (long long)a.map_mask + 1;
  for (long long e = first + threadIdx.x; e < m; e += stride) {
    const ull v = __ldcg(a.map + e);
    if (v == kNoEntry) continue;
    a.map[e] = kNoEntry;
    const int s = (int)(v >> 32);
    const long long i = a.n - 1 - (long long)(unsigned)v;
    copy_value(a.vals, s, a.new_vals, i, a.esize);
    a.presence[s] = 1;
    if (a.last_ts != nullptr)
      a.last_ts[s] = a.now_rows != nullptr ? a.now_rows[i] : a.now;
  }
}

template <bool kGrid>
__global__ void __launch_bounds__(kThreads) row_set_kernel(SetArgs a) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads;
  row_set_mark(a, first, stride);
  phase_barrier<kGrid>();
  row_set_write(a, first, stride);
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

// Blocks of `kernel` the card holds at once (cached a kernel per device).
cudaError_t resident_blocks(const void* kernel, int& most, int& most_dev) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || most_dev == dev) return e;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, 0);
  if (e != cudaSuccess) return e;
  most = per_sm * sms;
  most_dev = dev;
  return cudaSuccess;
}

// The cooperative grid for n threads, at most `most` blocks.
unsigned coop_grid(long long n, int most) {
  const long long want = grid_for(n);
  return (unsigned)(want < most ? want : most);
}

// A map of `entries` entries serves n rows.
bool map_fits(long long entries, long long n) {
  return entries >= 2 * n && (entries & (entries - 1)) == 0 &&
         entries <= (1ll << 32);
}

}  // namespace

// Rows a call takes in one ordinary block; ops/row_state.py sizes the
// batch map of a larger call by it.
extern "C" int row_state_block_rows() { return kThreads; }

// One keep-first admission over n rows, one launch (module comment).
// valid may be null (every row valid), last_ts null (no TTL).
// batch_map: kHead head words (ops/row_state.py's MAP_HEAD), zero, then
// map_entries entries (a power of two, at least 2n), kNoEntry, as every
// call leaves them. status: int64 [3].
extern "C" int dedup_first_launch(void* table, long long capacity,
                                  const void* keys, const void* valid,
                                  const void* ts, long long n,
                                  void* presence, void* last_ts,
                                  long long ttl, void* batch_map,
                                  long long map_entries, void* dirty,
                                  int dirty_shift, void* slots, void* fresh,
                                  void* status, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaMemsetAsync(status, 0, 3 * sizeof(ull), st);
  if (n > (1ll << 30) || !map_fits(map_entries, n))
    return (int)cudaErrorInvalidValue;
  ull* head = (ull*)batch_map;
  DedupArgs a{(ull*)table,           (ull)(capacity - 1),
              (const long long*)keys, (const uint8_t*)valid,
              (const long long*)ts,   (int8_t*)presence,
              (long long*)last_ts,    ttl,
              n,                      (uint8_t*)dirty,
              dirty_shift,            (int*)slots,
              (uint8_t*)fresh,        (ull*)status,
              head,                   head + kHead,
              (ull)(map_entries - 1)};
  if (n <= kThreads) {
    dedup_first_kernel<false><<<1, kThreads, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  static int most = 0, most_dev = -1;
  cudaError_t e = resident_blocks((const void*)dedup_first_kernel<true>,
                                  most, most_dev);
  if (e != cudaSuccess) return (int)e;
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)dedup_first_kernel<true>,
                                  dim3(coop_grid(map_entries, most)),
                                  dim3(kThreads), params, 0, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The last row of each slot (slot -1: no write) writes new_vals[i] (esize
// bytes, the plane's dtype) to vals, presence := 1 and, with last_ts,
// now_rows[i] (or now when now_rows is null). One launch; batch_map as
// dedup_first's (its head words unused).
extern "C" int row_set_launch(const void* slots, long long n, void* vals,
                              const void* new_vals, int esize,
                              void* presence, void* last_ts,
                              const void* now_rows, long long now,
                              void* batch_map, long long map_entries,
                              void* stream) {
  if (esize != 1 && esize != 2 && esize != 4 && esize != 8)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  if (n > (1ll << 30) || !map_fits(map_entries, n))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  SetArgs a{(const int*)slots, n, vals, new_vals, esize, (int8_t*)presence,
            (long long*)last_ts, (const long long*)now_rows, now,
            (ull*)batch_map + kHead, (ull)(map_entries - 1)};
  if (n <= kThreads) {
    row_set_kernel<false><<<1, kThreads, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  static int most = 0, most_dev = -1;
  cudaError_t e = resident_blocks((const void*)row_set_kernel<true>, most,
                                  most_dev);
  if (e != cudaSuccess) return (int)e;
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)row_set_kernel<true>,
                                  dim3(coop_grid(map_entries, most)),
                                  dim3(kThreads), params, 0, st);
  if (e != cudaSuccess) return (int)e;
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
