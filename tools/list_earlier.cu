// The earlier list_append, list_prune and list_probe (flink_tpu_torch/
// csrc/device_lists.cu as it stood before the tile summary and the
// one-launch probe), kept buildable so that one call can time them beside
// the package's kernels: tools/list_designs.py builds this file with the
// package's flags (-I flink_tpu_torch/csrc) and binds
// list_append_earlier_launch, list_prune_earlier_launch and the probe's
// list_probe_earlier_count_launch and list_probe_earlier_write_launch.
//
// list_append_earlier_launch: five kernels and a memset. The first claims
// each row's slot, takes its arrival index in hits[slot] and zeroes a
// claimed slot's list; the second finishes a slot of one row (row written,
// count bumped, hits reset); three grid-stride kernels rank, write and
// finish the rows of slots of more than one row through per-slot
// segments. list_prune_earlier_launch: one thread a slot reads every count
// and each live list's ts, and a list that must move goes to a work list
// (in the zero scratch hits) that a warp an item partitions through
// shared memory. Neither keeps the tile summary. The probe: three
// kernels, a thread a row counting its matches (a block's total), one
// block scanning the block totals, and (after the host reads the total to
// size the output) a thread a row writing its matches, each list read
// again.
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

// Probe, pass 1: each row's matches (its key's live rows with ts in the
// row's range; every live row when ts is null) and its slot; a block's
// total into block_off[block].
__global__ void __launch_bounds__(kThreads)
list_probe_earlier_count_kernel(unsigned long long* table, unsigned long long mask,
                        const long long* rows, int L, int C,
                        const int* counts, const long long* keys, long long n,
                        const long long* ts, long long lo_off,
                        long long hi_off, int* m_out, int* slot_out,
                        long long* block_off) {
  __shared__ long long red[kThreads / 32];
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  long long m = 0;
  if (i < n) {
    const int s = probe(table, mask, sanitize(keys[i]), false);
    if (s >= 0) {
      const int c = counts[s];
      if (ts == nullptr) {
        m = c;
      } else {
        const long long lo = ts[i] + lo_off, hi = ts[i] + hi_off;
        const long long* r = rows + (long long)s * L * C;
        for (int j = 0; j < c; ++j) {
          const long long t = r[(long long)j * C];
          m += (t >= lo) & (t <= hi);
        }
      }
    }
    m_out[i] = (int)m;
    slot_out[i] = s;
  }
  const long long total = block_sum(m, red);
  if (threadIdx.x == 0) block_off[blockIdx.x] = total;
}

// Probe, pass 2 (one block): exclusive scan of the block totals in place;
// the grand total into block_off[nb].
__global__ void __launch_bounds__(1024)
list_probe_earlier_scan_kernel(long long* block_off, long long nb) {
  __shared__ long long warp_sums[32];
  __shared__ long long carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (long long base = 0; base < nb; base += 1024) {
    const long long j = base + threadIdx.x;
    const long long v = j < nb ? block_off[j] : 0;
    long long x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      long long w = warp_sums[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const long long y = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w += y;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    const long long incl = x + (warp > 0 ? warp_sums[warp - 1] : 0) + carry;
    if (j < nb) block_off[j] = incl - v;
    __syncthreads();
    if (threadIdx.x == 1023) carry = incl;
    __syncthreads();
  }
  if (threadIdx.x == 0) block_off[nb] = carry;
}

// Probe, pass 3: each row's output offset (its block's offset and the
// block's exclusive scan of the counts), then its matches in list order.
__global__ void __launch_bounds__(kThreads)
list_probe_earlier_write_kernel(const long long* rows, int L, int C,
                        const int* counts, long long n, const long long* ts,
                        long long lo_off, long long hi_off, const int* m_in,
                        const int* slot_in, const long long* block_off,
                        long long* out_idx, long long* out_packed) {
  __shared__ long long warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  const long long m = i < n ? m_in[i] : 0;
  long long x = m;
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  long long before = 0;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  if (m == 0) return;
  long long off = block_off[blockIdx.x] + before + x - m;
  const int s = slot_in[i];
  const int c = counts[s];
  const long long* r = rows + (long long)s * L * C;
  const long long lo = ts ? ts[i] + lo_off : 0, hi = ts ? ts[i] + hi_off : 0;
  for (int j = 0; j < c; ++j) {
    const long long* row = r + (long long)j * C;
    if (ts != nullptr && (row[0] < lo || row[0] > hi)) continue;
    out_idx[off] = i;
    copy_row(out_packed + off * C, row, C);
    ++off;
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

// Entries of a probe's block_off: one a block of kThreads rows, and the
// total.
extern "C" int list_probe_earlier_blocks(long long n) {
  return (int)blocks_for(n);
}

// Probe, passes 1 and 2: per row its matches m [n] int32 and slot [n]
// int32 (-1: absent); block_off [blocks + 1] int64 gets each block's
// output offset and the total at [blocks]. ts null: every live row
// matches.
extern "C" int list_probe_earlier_count_launch(void* table, long long capacity,
                                       const void* rows, int L, int C,
                                       const void* counts, const void* keys,
                                       long long n, const void* ts,
                                       long long lo_off, long long hi_off,
                                       void* m, void* slots, void* block_off,
                                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0)
    return (int)cudaMemsetAsync(block_off, 0, sizeof(long long), st);
  if (L <= 0 || C <= 0 || n > INT_MAX) return (int)cudaErrorInvalidValue;
  const long long nb = blocks_for(n);
  list_probe_earlier_count_kernel<<<(unsigned)nb, kThreads, 0, st>>>(
      (unsigned long long*)table, (unsigned long long)(capacity - 1),
      (const long long*)rows, L, C, (const int*)counts,
      (const long long*)keys, n, (const long long*)ts, lo_off, hi_off,
      (int*)m, (int*)slots, (long long*)block_off);
  list_probe_earlier_scan_kernel<<<1, 1024, 0, st>>>((long long*)block_off, nb);
  return (int)cudaGetLastError();
}

// Probe, pass 3: the matches, out_idx [total] int64 (batch row) and
// out_packed [total, C] int64, in (batch row, list position) order.
extern "C" int list_probe_earlier_write_launch(const void* rows, int L, int C,
                                       const void* counts, long long n,
                                       const void* ts, long long lo_off,
                                       long long hi_off, const void* m,
                                       const void* slots,
                                       const void* block_off, void* out_idx,
                                       void* out_packed, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  list_probe_earlier_write_kernel<<<(unsigned)blocks_for(n), kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const long long*)rows, L, C, (const int*)counts, n,
      (const long long*)ts, lo_off, hi_off, (const int*)m,
      (const int*)slots, (const long long*)block_off, (long long*)out_idx,
      (long long*)out_packed);
  return (int)cudaGetLastError();
}
extern "C" const char* list_earlier_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
