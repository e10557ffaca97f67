// The earlier list_append and list_prune (flink_tpu_torch/csrc/
// device_lists.cu as it stood before the tile summary), kept buildable so
// that one call can time them beside the package's kernels:
// tools/list_designs.py builds this file with the package's flags (-I
// flink_tpu_torch/csrc) and binds list_append_earlier_launch and
// list_prune_earlier_launch.
//
// list_append_earlier_launch: five kernels and a memset. The first claims
// each row's slot, takes its arrival index in hits[slot] and zeroes a
// claimed slot's list; the second finishes a slot of one row (row written,
// count bumped, hits reset); three grid-stride kernels rank, write and
// finish the rows of slots of more than one row through per-slot
// segments. list_prune_earlier_launch: one thread a slot reads every count
// and each live list's ts, and a list that must move goes to a work list
// (in the zero scratch hits) that a warp an item partitions through
// shared memory. Neither keeps the tile summary.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "probe.cuh"

namespace {

using probe_table::probe;
using probe_table::probe_claim;
constexpr int kThreads = 256;
constexpr int kStrideBlocks = 2048;  // grid of the grid-stride kernels
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kInt64Max = LLONG_MAX;
// flags of an append: list full, insert failed, keys inserted, rows of
// slots of more than one row, segment words allocated
enum Flag { kListFull = 0, kInsertFailed = 1, kInserted = 2, kDups = 3,
            kCursor = 4, kFlags = 5 };

__device__ __forceinline__ unsigned long long sanitize(long long k) {
  return (unsigned long long)(k == kInt64Max ? kInt64Max - 1 : k);
}

__device__ __forceinline__ void copy_row(long long* dst,
                                         const long long* src, int C) {
  for (int e = 0; e < C; ++e) dst[e] = src[e];
}

// 1. Claim each row's slot; arrival index in the slot; zero a claimed
// slot's list; count the keys inserted. The warp zeroes its claimed
// lists together, one list at a time, a lane to each 16 bytes (8 for an
// odd list width), so each store instruction writes whole lines (a
// thread writing its own list spreads each store over 32 lists).
__global__ void __launch_bounds__(kThreads)
list_resolve_kernel(unsigned long long* table, unsigned long long mask,
                    long long* rows, long long lc,
                    unsigned long long* hits, const long long* keys,
                    long long n, int* slot_out, int* arr_out,
                    uint8_t* failed, unsigned long long* flags) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  bool inserted = false;
  int s = -1;
  if (i < n) {
    s = probe_claim(table, mask, sanitize(keys[i]), true, inserted);
    slot_out[i] = s;
    failed[i] = s < 0 ? 1 : 0;
    if (s < 0) {
      flags[kInsertFailed] = 1ull;
      arr_out[i] = 0;
    } else {
      arr_out[i] = (int)atomicAdd(hits + s, 1ull);
    }
  }
  unsigned b = __ballot_sync(kFull, inserted);
  if (lane == 0 && b)
    atomicAdd(flags + kInserted, (unsigned long long)__popc(b));
  while (b) {
    const int src = __ffs(b) - 1;
    b &= b - 1;
    long long* r = rows + (long long)__shfl_sync(kFull, s, src) * lc;
    if ((lc & 1) == 0) {  // an even list keeps 16-byte alignment
      longlong2* r2 = reinterpret_cast<longlong2*>(r);
      for (long long e = lane; e < lc / 2; e += 32)
        r2[e] = make_longlong2(0, 0);
    } else {
      for (long long e = lane; e < lc; e += 32) r[e] = 0;
    }
  }
}

// 2. A slot of one row: write it and finish. A slot of more: its first
// arrival allocates the segment (hits[slot] = base << 32 | k; the low
// word stays k for every reader), and each row joins the list of
// duplicate rows.
__global__ void __launch_bounds__(kThreads)
list_single_kernel(long long* rows, int L, int C, int* counts,
                   unsigned long long* hits, const long long* packed,
                   long long n, const int* slot_in, const int* arr_in,
                   int* dup, unsigned long long* flags) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= n) return;
  const int s = slot_in[i];
  if (s < 0) return;
  const unsigned long long h = hits[s];
  const unsigned k = (unsigned)h;
  if (k == 1u) {
    const int c = counts[s];
    if (c < L) {
      copy_row(rows + ((long long)s * L + c) * C, packed + i * C, C);
      counts[s] = c + 1;
    } else {
      flags[kListFull] = 1ull;
    }
    hits[s] = 0ull;
    return;
  }
  if (arr_in[i] == 0) {
    const unsigned long long base =
        atomicAdd(flags + kCursor, (unsigned long long)k);
    hits[s] = (base << 32) | k;
  }
  dup[atomicAdd(flags + kDups, 1ull)] = (int)i;
}

// 3. Each duplicate row writes its batch index at its arrival index in
// its slot's segment.
__global__ void __launch_bounds__(kThreads)
list_segment_kernel(const unsigned long long* hits, const int* slot_in,
                    const int* arr_in, const int* dup, int* seg,
                    const unsigned long long* flags) {
  const long long nd = (long long)flags[kDups];
  for (long long t = blockIdx.x * (long long)kThreads + threadIdx.x; t < nd;
       t += (long long)gridDim.x * kThreads) {
    const int i = dup[t];
    seg[(hits[slot_in[i]] >> 32) + arr_in[i]] = i;
  }
}

// 4. Each duplicate row's rank: the batch indices below its own in the
// segment; the row is written at counts + rank when that is below L.
__global__ void __launch_bounds__(kThreads)
list_rank_kernel(long long* rows, int L, int C, const int* counts,
                 const unsigned long long* hits, const long long* packed,
                 const int* slot_in, const int* dup, const int* seg,
                 unsigned long long* flags) {
  const long long nd = (long long)flags[kDups];
  for (long long t = blockIdx.x * (long long)kThreads + threadIdx.x; t < nd;
       t += (long long)gridDim.x * kThreads) {
    const int i = dup[t];
    const int s = slot_in[i];
    const unsigned long long h = hits[s];
    const int* g = seg + (h >> 32);
    const unsigned k = (unsigned)h;
    int rank = 0;
    for (unsigned u = 0; u < k; ++u) rank += g[u] < i;
    const long long pos = (long long)counts[s] + rank;
    if (pos < L)
      copy_row(rows + ((long long)s * L + pos) * C, packed + (long long)i * C,
               C);
    else
      flags[kListFull] = 1ull;
  }
}

// 5. The first arrival of each duplicated slot bumps its count by the
// rows that fit and resets hits.
__global__ void __launch_bounds__(kThreads)
list_finish_kernel(int L, int* counts, unsigned long long* hits,
                   const int* slot_in, const int* arr_in, const int* dup,
                   const unsigned long long* flags) {
  const long long nd = (long long)flags[kDups];
  for (long long t = blockIdx.x * (long long)kThreads + threadIdx.x; t < nd;
       t += (long long)gridDim.x * kThreads) {
    const int i = dup[t];
    if (arr_in[i] != 0) continue;
    const int s = slot_in[i];
    const long long k = (long long)(unsigned)hits[s];
    const int c = counts[s];
    if (c < L) counts[s] = (int)(c + k < L ? c + k : L);
    hits[s] = 0ull;
  }
}

__device__ __forceinline__ long long block_sum(long long v, long long* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  long long s = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  return s;
}

// Prune, pass 1: one thread a slot. A live list reads its rows' ts; a
// list whose kept rows are already first gets its new count here, one
// that must move goes to the work list (in the zero scratch `work`).
// result: [0] keys left with a live row (one atomic a block: one a warp
// and iteration serialised on that word, 1.13 ms against 0.24 at 2^25
// slots on an H100 80GB HBM3), [1] work items.
__global__ void __launch_bounds__(kThreads)
list_prune_scan_kernel(const long long* rows, int L, int C, int* counts,
                       long long capacity, long long horizon, int ts_col,
                       long long* work, unsigned long long* result) {
  __shared__ long long red[kThreads / 32];
  const long long stride = (long long)gridDim.x * kThreads;
  long long live = 0;
  for (long long s = blockIdx.x * (long long)kThreads + threadIdx.x;
       s < capacity; s += stride) {
    const int c = counts[s];
    if (c == 0) continue;
    const long long* r = rows + s * L * C + ts_col;
    int kept = 0;
    bool dropped = false, move = false;
    for (int j = 0; j < c; ++j) {
      if (r[(long long)j * C] >= horizon) {
        ++kept;
        move |= dropped;
      } else {
        dropped = true;
      }
    }
    live += kept > 0;
    if (move)
      work[atomicAdd(result + 1, 1ull)] = s;
    else if (kept != c)
      counts[s] = kept;
  }
  const long long total = block_sum(live, red);
  if (threadIdx.x == 0 && total)
    atomicAdd(result, (unsigned long long)total);
}

// Prune, pass 2: a warp a work item. The list's live rows go to shared
// memory; one ballot a 32 rows gives the keep mask; each element is
// written to its row's place in the stable partition; the work word is
// reset to zero.
__global__ void list_prune_move_kernel(long long* rows, int L, int C,
                                       int* counts, long long horizon,
                                       int ts_col, long long* work,
                                       const unsigned long long* result) {
  extern __shared__ long long smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int chunks = (L + 31) / 32;
  long long* stage = smem + (long long)warp * ((long long)L * C + chunks);
  long long* meta = stage + (long long)L * C;
  const long long nw = (long long)result[1];
  for (long long w = (long long)blockIdx.x * warps + warp; w < nw;
       w += (long long)gridDim.x * warps) {
    const long long s = work[w];
    __syncwarp();
    if (lane == 0) work[w] = 0;
    const int c = counts[s];
    long long* r = rows + s * L * C;
    const int ce = c * C;
    for (int e = lane; e < ce; e += 32) stage[e] = r[e];
    __syncwarp();
    int kept = 0;
    for (int ch = 0; ch * 32 < c; ++ch) {
      const int j = ch * 32 + lane;
      const bool keep = j < c && stage[(long long)j * C + ts_col] >= horizon;
      const unsigned b = __ballot_sync(kFull, keep);
      if (lane == 0) meta[ch] = ((long long)kept << 32) | b;
      kept += __popc(b);
    }
    __syncwarp();
    for (int e = lane; e < ce; e += 32) {
      const int j = e / C, col = e - j * C;
      const long long mt = meta[j >> 5];
      const unsigned b = (unsigned)mt;
      const int bit = j & 31;
      const int kb = (int)(mt >> 32) + __popc(b & ((1u << bit) - 1u));
      const int d = ((b >> bit) & 1u) ? kb : kept + (j - kb);
      r[(long long)d * C + col] = stage[e];
    }
    if (lane == 0) counts[s] = kept;
    __syncwarp();
  }
}

inline long long blocks_for(long long n) {
  return (n + kThreads - 1) / kThreads;
}

inline unsigned stride_grid(long long n) {
  const long long b = blocks_for(n);
  return (unsigned)(b < kStrideBlocks ? (b > 0 ? b : 1) : kStrideBlocks);
}
}  // namespace

// Append n packed rows ([n, C] int64) under keys [n] int64. scratch: 4n
// int32 words (slot, arrival, duplicate list, segments); failed: [n]
// bytes, 1 where the insert failed; flags: kFlags int64 words, zeroed
// here (list full, insert failed, keys inserted, duplicate rows, segment
// words).
extern "C" int list_append_earlier_launch(void* table, long long capacity,
                                          void* rows, int L, int C,
                                          void* counts, void* hits,
                                          const void* keys,
                                          const void* packed, long long n,
                                          void* scratch, void* failed,
                                          void* flags, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(flags, 0, kFlags * sizeof(long long), st);
  if (e != cudaSuccess) return (int)e;
  if (n <= 0) return (int)cudaSuccess;
  if (L <= 0 || C <= 0 || capacity <= 0 || n > INT_MAX)
    return (int)cudaErrorInvalidValue;
  int* slot = (int*)scratch;
  int* arr = slot + n;
  int* dup = arr + n;
  int* seg = dup + n;
  unsigned long long* f = (unsigned long long*)flags;
  unsigned long long* h = (unsigned long long*)hits;
  const unsigned blocks = (unsigned)blocks_for(n);
  list_resolve_kernel<<<blocks, kThreads, 0, st>>>(
      (unsigned long long*)table, (unsigned long long)(capacity - 1),
      (long long*)rows, (long long)L * C, h, (const long long*)keys, n, slot,
      arr, (uint8_t*)failed, f);
  list_single_kernel<<<blocks, kThreads, 0, st>>>(
      (long long*)rows, L, C, (int*)counts, h, (const long long*)packed, n,
      slot, arr, dup, f);
  const unsigned g = stride_grid(n);
  list_segment_kernel<<<g, kThreads, 0, st>>>(h, slot, arr, dup, seg, f);
  list_rank_kernel<<<g, kThreads, 0, st>>>(
      (long long*)rows, L, C, (const int*)counts, h, (const long long*)packed,
      slot, dup, seg, f);
  list_finish_kernel<<<g, kThreads, 0, st>>>(L, (int*)counts, h, slot, arr,
                                             dup, f);
  return (int)cudaGetLastError();
}

// Bytes of shared memory the prune's move pass takes a warp.
extern "C" long long list_prune_earlier_smem_per_warp(int L, int C) {
  return ((long long)L * C + (L + 31) / 32) * (long long)sizeof(long long);
}

// Prune every list to its rows with ts (column ts_col) >= horizon. work:
// the [capacity] int64 zero scratch (hits), zero again after; result: 2
// int64 words, zeroed here: keys left with a live row, lists moved.
extern "C" int list_prune_earlier_launch(void* rows, int L, int C,
                                         void* counts, long long capacity,
                                         long long horizon, int ts_col,
                                         void* work, void* result,
                                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(result, 0, 2 * sizeof(long long), st);
  if (e != cudaSuccess) return (int)e;
  if (L <= 0 || C <= 0 || ts_col < 0 || ts_col >= C || capacity <= 0)
    return (int)cudaErrorInvalidValue;
  const long long per_warp = list_prune_earlier_smem_per_warp(L, C);
  int max_smem = 0, dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&max_smem,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (per_warp > max_smem) return (int)cudaErrorInvalidValue;
  long long warps = (48 << 10) / per_warp;
  warps = warps < 1 ? 1 : (warps > 8 ? 8 : warps);
  const long long smem = warps * per_warp;
  if (smem > (48 << 10)) {
    e = cudaFuncSetAttribute(list_prune_move_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  unsigned long long* res = (unsigned long long*)result;
  list_prune_scan_kernel<<<stride_grid(capacity), kThreads, 0, st>>>(
      (const long long*)rows, L, C, (int*)counts, capacity, horizon, ts_col,
      (long long*)work, res);
  list_prune_move_kernel<<<kStrideBlocks, (unsigned)(warps * 32),
                           (size_t)smem, st>>>(
      (long long*)rows, L, C, (int*)counts, horizon, ts_col,
      (long long*)work, res);
  return (int)cudaGetLastError();
}

extern "C" const char* list_earlier_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
