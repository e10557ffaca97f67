// Device hash table probe (int64 key -> dense slot, find-or-claim) and the
// fused ingest step of the slice-window operator built on it.
//
// Replaces:
//  * hash_probe_launch: flink_tpu/ops/hash_table.py::lookup_or_insert and
//    ::lookup. On the TPU these were XLA while-loops (no Pallas kernel):
//    each round gathered an 8-slot probe window for every unresolved key
//    and claimed empty slots with a scatter-min. Eager PyTorch has no loop
//    on the device, so a port in torch ops would wait on the host once per
//    probe round; this kernel resolves a whole batch in one launch.
//  * ingest_step_launch: flink_tpu/runtime/operators/device_window.py::
//    _step_body, the one XLA program per micro-batch: pane assignment, the
//    late mask, key sanitising, lookup-or-insert, and one scatter fold per
//    aggregate plane (flink_tpu/ops/segment_ops.py::scatter_fold) into the
//    [ring, capacity] planes. XLA fused it; eager PyTorch issued some 25
//    launches around the probe, so here the probe is a probe that folds.
//
// Bound on the H100: device memory, by random access. The probe reads each
// 8-byte key, one random 32-byte table sector per key new to the table
// (the backend keeps the load factor under 0.6, so most keys resolve at
// their first probe) and writes a 4-byte slot and a 1-byte flag. The step
// reads ts, key and the value columns once, one table sector per probing
// row (a present key's too) and a claim per new key, and reads and writes
// one 32-byte sector per distinct (ring row, key) pair of each plane. An
// H100 80GB HBM3 at 700 W serves such sectors at 13.6 to 23.0 G/s
// (tools/sector_rate.cu, 2^19 accesses at Q5-10M's footprints), far below
// the 105 G/s of 3.35 TB/s; in address order the rate rises 1.11x to
// 1.17x for spans of 2^14 slots, 1.15x to 1.33x fully sorted. This step
// fed a Q5-10M batch in address order runs 18% to 25% faster, but every
// pass that puts the batch in that order (a second launch that partitions
// the rows by home slot) cost more than it saved: 0.139 to 0.172 ms
// against 0.116 (tools/ingest_designs.py). So the rows stay in batch
// order.
//
// Design: one thread per row. A thread issues the loads of its row's ts,
// key and value columns before any dependent work; a warp's loads are
// consecutive, so each is one coalesced request. (Four rows per thread,
// with the table reads and then the claims of all four issued together,
// measured slower on the H100: fewer warps hide less latency; two rows a
// thread with both home slots read together did too.)
// The probe (probe.cuh, shared with session_window.cu) is linear, with
// 64-bit atomicCAS claims. The slot layout differs from the reference's
// scatter-min (the winner among racing keys is whoever's CAS lands
// first); the set of keys, key -> slot consistency and the ok contract
// are the same. Rows that do not probe get slot -1; a key that exhausts
// MAX_PROBES gets -1.
// The step folds with one atomic per plane and row: atomicAdd for sums and
// counts (int64 through unsigned long long), atomicMin/atomicMax for
// int32/int64, a CAS loop for float min/max (NaN propagates, as in torch's
// scatter_reduce) and for uint8. (The eager fold takes no bool plane: a
// bool plane has no min/max identity and its sum promotes to int64.) Late
// and dropped rows are summed over the warp and added with one atomic each.
//
// Three optional parts of the step, each off when its pointer is null, so a
// launch without them keeps its form and its cost:
//  * The counted form (the mesh's sharded step, flink_tpu/parallel/
//    sharded_window.py:122-190): the rows are a destination shard's
//    buffer from the keyBy exchange (exchange.cu), S segments of seg_len
//    rows, one a source block, and row i is a row only when
//    i % seg_len < seg_counts[(i / seg_len) * seg_stride], the count the
//    exchange left on the card. The reference loops capacity rounds with
//    the deepest bucket's count read across the mesh; here the buffer is
//    sized for the worst case, so the step needs no round loop and no
//    read of the counts on the host.
//  * Dirty marking (device_window.py:150-151, the incremental snapshot's
//    capture): every row that folds sets the byte of its slot's block,
//    dirty[slot >> dirty_shift], to 1: an idempotent plain store into a
//    [n_blocks] bitmap (32 KiB at 2^24 slots), made only when a read
//    through L1 finds the byte 0. Only blocks really written are marked
//    (the reference also marks block 0 for every row that does not fold).
//  * The deferred-spill split (device_window.py:106-130, under an HBM
//    budget), a kernel of its own (ingest_spill_kernel): the row's key
//    group (the murmur of core/keygroups.py, as key_groups_device computes
//    it) reads the [maxp] spilled mask; only fresh rows of resident groups
//    probe and fold, and fresh rows of spilled groups or whose insert
//    failed go to staging buffers for the host tier: key, ring row, and
//    each plane's value, at the positions the reference's cumsum gives
//    them (batch order), so a stage that overflows keeps and drops the
//    reference's rows; rows past its capacity count into `dropped`. The
//    per-group LRU clock touch[g] = max(batch_no) is taken through a
//    bitmap of the tile's groups in shared memory, one OR per distinct
//    word of a warp, and one thread per group after the tile.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "keygroup.cuh"
#include "probe.cuh"

namespace {

using keygroup::key_group;
using probe_table::kEmpty;
using probe_table::probe;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the dirty form's blocks an SM: 40 registers a thread, so 1536 rows of a
// batch in flight on an SM. ptxas left to itself gives 32 registers and a
// stack frame, 2048 rows in flight, and the step measured 1% to 6% slower
// at the Q5 shapes; fewer rows in flight (a grid that loops over the
// batch) measured slower still.
constexpr int kStepBlocks = 6;
constexpr int kMaxPlanes = 8;
constexpr int kMaxCols = 7;
constexpr unsigned kFull = 0xffffffffu;
// the spill form's look-back words: flag in the top two bits, value below
constexpr unsigned long long kFlagAggregate = 1ull << 62;
constexpr unsigned long long kFlagPrefix = 2ull << 62;
constexpr unsigned long long kValueMask = (1ull << 62) - 1;

enum Dtype { kI64 = 0, kI32 = 1, kF32 = 2, kF64 = 3, kU8 = 4, kBool = 5 };
enum Kind { kSum = 0, kMin = 1, kMax = 2 };  // a count plane folds +1 as kSum

__device__ __forceinline__ unsigned long long load_one(const void* p,
                                                       int code, long long i) {
  switch (code) {
    case kI64:
    case kF64:
      return __ldg(static_cast<const unsigned long long*>(p) + i);
    case kI32:
    case kF32:
      return __ldg(static_cast<const unsigned int*>(p) + i);
    default:
      return __ldg(static_cast<const unsigned char*>(p) + i);
  }
}

template <typename T>
__device__ __forceinline__ T value_as(unsigned long long raw, int code) {
  switch (code) {
    case kI64: return (T)(long long)raw;
    case kI32: return (T)(int)(unsigned)raw;
    case kF32: return (T)__uint_as_float((unsigned)raw);
    case kF64: return (T)__longlong_as_double((long long)raw);
    case kU8: return (T)(unsigned char)raw;
    default: return (T)(raw != 0ull);
  }
}

__device__ __forceinline__ bool better(double v, double cur, int kind) {
  // NaN wins and stays, as in torch's scatter_reduce amin/amax
  if (cur != cur) return false;
  return v != v || (kind == kMax ? v > cur : v < cur);
}

__device__ __forceinline__ void fold_f32(float* a, float v, int kind) {
  if (kind == kSum) {
    atomicAdd(a, v);
    return;
  }
  unsigned* w = reinterpret_cast<unsigned*>(a);
  unsigned old = __ldcg(w), assumed;
  do {
    assumed = old;
    if (!better(v, __uint_as_float(assumed), kind)) return;
    old = atomicCAS(w, assumed, __float_as_uint(v));
  } while (old != assumed);
}

__device__ __forceinline__ void fold_f64(double* a, double v, int kind) {
  if (kind == kSum) {
    atomicAdd(a, v);
    return;
  }
  unsigned long long* w = reinterpret_cast<unsigned long long*>(a);
  unsigned long long old = __ldcg(w), assumed;
  do {
    assumed = old;
    if (!better(v, __longlong_as_double((long long)assumed), kind)) return;
    old = atomicCAS(w, assumed, (unsigned long long)__double_as_longlong(v));
  } while (old != assumed);
}

// uint8 planes: the byte is updated through its aligned word
__device__ __forceinline__ void fold_u8(unsigned char* a, unsigned v,
                                        int kind) {
  unsigned* w = reinterpret_cast<unsigned*>((uintptr_t)a & ~(uintptr_t)3);
  const int sh = (int)((uintptr_t)a & 3) * 8;
  unsigned old = __ldcg(w), assumed;
  do {
    assumed = old;
    const unsigned cur = (assumed >> sh) & 0xFFu;
    const unsigned nv = kind == kSum ? (cur + v) & 0xFFu
                        : kind == kMin ? (v < cur ? v : cur)
                                       : (v > cur ? v : cur);
    if (nv == cur) return;
    old = atomicCAS(w, assumed, (assumed & ~(0xFFu << sh)) | (nv << sh));
  } while (old != assumed);
}

struct StepPlane {
  void* data;  // [ring, cap] of `dtype`
  int kind;
  int dtype;
  int col;     // index into StepArgs::cols; -1: the count plane (+1)
};

struct StepCol {
  const void* data;  // [n] of `dtype`
  int dtype;
};

// data[pos] = the value, converted to `dtype` as numpy's astype does
__device__ __forceinline__ void store_as(void* data, long long pos, int dtype,
                                         unsigned long long raw, int code) {
  switch (dtype) {
    case kI64:
      static_cast<long long*>(data)[pos] = value_as<long long>(raw, code);
      break;
    case kI32: static_cast<int*>(data)[pos] = value_as<int>(raw, code); break;
    case kF32:
      static_cast<float*>(data)[pos] = value_as<float>(raw, code);
      break;
    case kF64:
      static_cast<double*>(data)[pos] = value_as<double>(raw, code);
      break;
    default:
      static_cast<unsigned char*>(data)[pos] =
          value_as<unsigned char>(raw, code);
      break;
  }
}

struct StepArgs {
  unsigned long long* table;
  unsigned long long mask;  // capacity - 1
  long long cap;
  const long long* ts;
  const void* keys;
  int key_dtype;
  long long n;
  long long pane, offset, first_open, ring;
  // non-null: first_open is read from this device scalar instead (a graph
  // replays frozen by-value arguments, so per-batch scalars live there)
  const long long* first_open_at;
  unsigned long long* late;
  unsigned long long* dropped;
  int n_planes;
  StepPlane planes[kMaxPlanes];
  StepCol cols[kMaxCols];
  // dirty marking: non-null -> dirty[slot >> dirty_shift] = 1 per fold
  uint8_t* dirty;
  int dirty_shift;
  // deferred-spill split: on when maxp > 0
  int maxp;
  const uint8_t* spilled;          // [maxp] bool
  long long* touch;                // [maxp] int64 LRU clock, or null
  long long batch_no;
  long long* stage_count;          // int64 scalar, added to
  long long stage_cap;
  long long* stage_keys;           // [stage_cap]
  int* stage_ring;                 // [stage_cap]
  void* stage_vals[kMaxPlanes];    // plane q's [stage_cap] column, or null
  unsigned long long* status;      // [n_tiles] look-back words, zeroed
  unsigned int* tile_counter;      // zeroed
  long long n_tiles;
  // the counted form: non-null -> row i is in only when
  // i % seg_len < seg_counts[(i / seg_len) * seg_stride]
  const long long* seg_counts;
  long long seg_len, seg_stride;
};

// acc op= value, `raw` holding the value's bits as a column of dtype `code`
__device__ __forceinline__ void fold(const StepPlane& pl, long long idx,
                                     unsigned long long raw, int code) {
  switch (pl.dtype) {
    case kI64: {
      long long* a = static_cast<long long*>(pl.data) + idx;
      const long long v = value_as<long long>(raw, code);
      if (pl.kind == kSum)
        atomicAdd(reinterpret_cast<unsigned long long*>(a),
                  (unsigned long long)v);
      else if (pl.kind == kMin)
        atomicMin(a, v);
      else
        atomicMax(a, v);
      break;
    }
    case kI32: {
      int* a = static_cast<int*>(pl.data) + idx;
      const int v = value_as<int>(raw, code);
      if (pl.kind == kSum)
        atomicAdd(a, v);
      else if (pl.kind == kMin)
        atomicMin(a, v);
      else
        atomicMax(a, v);
      break;
    }
    case kF32:
      fold_f32(static_cast<float*>(pl.data) + idx, value_as<float>(raw, code),
               pl.kind);
      break;
    case kF64:
      fold_f64(static_cast<double*>(pl.data) + idx,
               value_as<double>(raw, code), pl.kind);
      break;
    default:
      fold_u8(static_cast<unsigned char*>(pl.data) + idx,
              value_as<unsigned char>(raw, code), pl.kind);
      break;
  }
}

__global__ void __launch_bounds__(kThreads)
hash_probe_kernel(unsigned long long* __restrict__ table,
                  unsigned long long mask, const unsigned long long* keys,
                  const uint8_t* valid, long long n, int insert,
                  int32_t* __restrict__ slots, uint8_t* __restrict__ ok) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long key = keys[i];
  const bool on = valid == nullptr || valid[i];
  const int slot = on ? probe(table, mask, key, insert != 0) : -1;
  slots[i] = slot;
  if (ok != nullptr) ok[i] = slot >= 0 ? 1 : 0;
}

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  const long long q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// The row's loads, issued before any dependent work: ts, the key and the
// value columns (a warp's loads are consecutive: one coalesced request
// each). Filled field by field, so the values stay in registers.
template <int NC>
struct RowIn {
  long long ts;
  unsigned long long kr;
  unsigned long long cv[NC > 0 ? NC : 1];
};

template <int NC>
__device__ __forceinline__ RowIn<NC> load_row(const StepArgs& a, long long i,
                                              bool in) {
  RowIn<NC> r;
  r.ts = in ? __ldg(a.ts + i) : 0;
  r.kr = in ? load_one(a.keys, a.key_dtype, i) : 0ull;
#pragma unroll
  for (int c = 0; c < NC; ++c)
    r.cv[c] = in ? load_one(a.cols[c].data, a.cols[c].dtype, i) : 0ull;
  return r;
}

// The row's pane (wrapping like torch's int64 subtraction, floored as
// torch.div(..., rounding_mode="floor") does) and its sanitized key.
__device__ __forceinline__ long long row_pane(const StepArgs& a, long long ts) {
  const long long d = (long long)((unsigned long long)ts -
                                  (unsigned long long)a.offset);
  return floor_div(d, a.pane);
}

__device__ __forceinline__ long long row_key(const StepArgs& a,
                                             unsigned long long kr) {
  const long long k = value_as<long long>(kr, a.key_dtype);
  return k == (long long)kEmpty ? (long long)kEmpty - 1 : k;
}

__device__ __forceinline__ long long first_open_of(const StepArgs& a) {
  return a.first_open_at != nullptr ? __ldg(a.first_open_at) : a.first_open;
}

// The dirty byte of the slot's block: read before it is stored (after its
// first row a block's byte reads 1, and 2^19 stores into a few KiB would
// queue on the same L2 lines), and read through L1: the bitmap only goes
// from 0 to 1 during a step, so a stale 0 costs one more idempotent store,
// and the reads no longer queue on the bitmap's few L2 lines.
__device__ __forceinline__ void mark_dirty(const StepArgs& a, int slot) {
  if (a.dirty != nullptr && __ldca(a.dirty + (slot >> a.dirty_shift)) == 0)
    a.dirty[slot >> a.dirty_shift] = 1;
}

// The row's dirty byte, then one fold per plane into its cell of its
// ring row.
template <int NC>
__device__ __forceinline__ void fold_row(const StepArgs& a,
                                         const StepPlane* planes, int slot,
                                         long long row, RowIn<NC> r) {
  mark_dirty(a, slot);
  const long long idx = row * a.cap + slot;
  for (int q = 0; q < a.n_planes; ++q) {
    if (planes[q].col < 0) fold(planes[q], idx, 1ull, kI64);
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    for (int q = 0; q < a.n_planes; ++q) {
      if (planes[q].col == c) fold(planes[q], idx, r.cv[c],
                                   a.cols[c].dtype);
    }
  }
}

// The plane table (and the stage's columns) go to shared memory once per
// block, so the fold loop can index them at run time without a local copy
// of the parameters.
__device__ __forceinline__ void copy_planes(const StepArgs& a,
                                            StepPlane* planes,
                                            void** stage_vals) {
  if (threadIdx.x < kMaxPlanes) {
#pragma unroll
    for (int q = 0; q < kMaxPlanes; ++q) {
      if (q == (int)threadIdx.x) {
        planes[q] = a.planes[q];
        if (stage_vals != nullptr) stage_vals[q] = a.stage_vals[q];
      }
    }
  }
}

// The step without the spill split (the form of every step of the main
// paths, with or without dirty marking): one row a thread, no barrier
// after the plane table.
template <int NC>
__global__ void __launch_bounds__(kThreads, kStepBlocks)
ingest_step_kernel(StepArgs a) {
  __shared__ StepPlane planes[kMaxPlanes];
  copy_planes(a, planes, nullptr);
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  bool in = i < a.n;
  if (in && a.seg_counts != nullptr)
    in = i % a.seg_len < __ldg(a.seg_counts + (i / a.seg_len) * a.seg_stride);
  const RowIn<NC> r = load_row<NC>(a, i, in);
  const long long pane = row_pane(a, r.ts);
  const bool fresh = in && pane >= first_open_of(a);
  const long long k = row_key(a, r.kr);
  const int slot =
      fresh ? probe(a.table, a.mask, (unsigned long long)k, true) : -1;
  if (slot >= 0) {
    long long row = pane % a.ring;
    if (row < 0) row += a.ring;
    fold_row<NC>(a, planes, slot, row, r);
  }
  // every lane gets here (no early return above), so the warp-wide calls
  // are legal
  const unsigned late = __reduce_add_sync(kFull, (in && !fresh) ? 1u : 0u);
  const unsigned dropped =
      __reduce_add_sync(kFull, (fresh && slot < 0) ? 1u : 0u);
  if ((threadIdx.x & 31) == 0) {
    if (late) atomicAdd(a.late, (unsigned long long)late);
    if (dropped) atomicAdd(a.dropped, (unsigned long long)dropped);
  }
}

// The spill form: tiles of kThreads rows in batch order, taken from an
// atomic tile counter so a tile only waits on tiles that already started.
// A row of a spilled group does not probe; it and a failed insert stage
// at the position its batch order gives it (the reference's cumsum): the
// block ranks its staged rows by ballot, and a decoupled look-back by the
// whole block (thread k reads the status of tile - 1 - k, 256 at a time)
// finds the staged rows of the tiles before. Tile 0 reads the stage
// count into its prefix, and the last tile writes the count back, so the
// count needs no atomic. The groups of the tile's rows go to a bitmap in
// shared memory, one OR a distinct word a warp; after the tile one
// thread a group raises its clock (read first: nearly every group is
// already at batch_no after the first tiles).
template <int NC>
__global__ void __launch_bounds__(kThreads)
ingest_spill_kernel(StepArgs a) {
  __shared__ StepPlane planes[kMaxPlanes];
  __shared__ void* stage_vals[kMaxPlanes];
  __shared__ unsigned warp_staged[kWarps];
  __shared__ int warp_stop[kWarps];
  __shared__ unsigned long long warp_sum[kWarps];
  __shared__ long long tile_s, tile_base;
  extern __shared__ unsigned touched[];  // the tile's groups, one bit each
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const bool clock = a.touch != nullptr;
  const int words = clock ? (a.maxp + 31) >> 5 : 0;
  if (tid == 0) tile_s = atomicAdd(a.tile_counter, 1u);
  for (int w = tid; w < words; w += kThreads) touched[w] = 0u;
  copy_planes(a, planes, stage_vals);
  __syncthreads();
  const long long tile = tile_s;
  const long long i = tile * kThreads + tid;
  const bool in = i < a.n;
  const RowIn<NC> r = load_row<NC>(a, i, in);
  const long long pane = row_pane(a, r.ts);
  const bool fresh = in && pane >= first_open_of(a);
  const long long k = row_key(a, r.kr);
  const int g = in ? key_group((unsigned long long)k, a.maxp) : 0;
  const bool spilled_row = in && a.spilled[g] != 0;
  if (clock) {
    // one OR a distinct bitmap word of the warp's groups
    const int w = g >> 5;
    unsigned pending = __ballot_sync(kFull, in);
    while (pending != 0u) {
      const int lead = __ffs(pending) - 1;
      const int lw = __shfl_sync(kFull, w, lead);
      const bool mine = in && w == lw;
      const unsigned bits =
          __reduce_or_sync(kFull, mine ? 1u << (g & 31) : 0u);
      if (lane == lead) atomicOr(&touched[lw], bits);
      pending &= ~__ballot_sync(kFull, mine);
    }
  }
  const int slot = fresh && !spilled_row
                       ? probe(a.table, a.mask, (unsigned long long)k, true)
                       : -1;
  long long row = pane % a.ring;
  if (row < 0) row += a.ring;
  if (slot >= 0) fold_row<NC>(a, planes, slot, row, r);
  // a spilled group's row or a failed insert: ranked in batch order
  const bool to_host = fresh && slot < 0;
  const unsigned staged = __ballot_sync(kFull, to_host);
  if (lane == 0) warp_staged[warp] = __popc(staged);
  __syncthreads();
  unsigned before_warp = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned v = warp_staged[w];
    before_warp += w < warp ? v : 0u;
    total += v;
  }
  volatile unsigned long long* st = a.status;
  if (tile == 0) {
    if (tid == 0) {
      const long long base = __ldcg(a.stage_count);
      st[0] = kFlagPrefix | ((unsigned long long)base + total);
      tile_base = base;
    }
  } else {
    if (tid == 0) st[tile] = kFlagAggregate | total;
    unsigned long long before = 0;
    for (long long j0 = tile - 1;; j0 -= kThreads) {
      const long long j = j0 - tid;
      unsigned long long v = kFlagPrefix;  // before tile 0: no tile
      if (j >= 0) {
        do {
          v = st[j];
        } while ((v >> 62) == 0ull);  // not published yet
      }
      const unsigned prefixes = __ballot_sync(kFull, (v >> 62) == 2ull);
      if (lane == 0)
        warp_stop[warp] = prefixes ? 32 * warp + __ffs(prefixes) - 1
                                   : kThreads;
      __syncthreads();
      int stop = kThreads;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        stop = warp_stop[w] < stop ? warp_stop[w] : stop;
      unsigned long long part = tid <= stop ? (v & kValueMask) : 0ull;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_down_sync(kFull, part, o);
      if (lane == 0) warp_sum[warp] = part;
      __syncthreads();
#pragma unroll
      for (int w = 0; w < kWarps; ++w) before += warp_sum[w];
      __syncthreads();  // warp_stop and warp_sum are read before reuse
      if (stop < kThreads) break;
    }
    if (tid == 0) {
      st[tile] = kFlagPrefix | (before + total);
      tile_base = (long long)before;
    }
  }
  __syncthreads();
  if (tid == 0 && tile == a.n_tiles - 1)
    *a.stage_count = tile_base + (long long)total;
  bool drop = false;
  if (to_host) {
    const long long pos =
        tile_base + (long long)(before_warp + __popc(staged & lt));
    if (pos < a.stage_cap) {
      a.stage_keys[pos] = k;
      a.stage_ring[pos] = (int)row;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        for (int q = 0; q < a.n_planes; ++q) {
          if (planes[q].col == c && stage_vals[q] != nullptr)
            store_as(stage_vals[q], pos, planes[q].dtype, r.cv[c],
                     a.cols[c].dtype);
        }
      }
    } else {
      drop = true;
    }
  }
  const unsigned late = __reduce_add_sync(kFull, (in && !fresh) ? 1u : 0u);
  const unsigned dropped = __reduce_add_sync(kFull, drop ? 1u : 0u);
  if (lane == 0) {
    if (late) atomicAdd(a.late, (unsigned long long)late);
    if (dropped) atomicAdd(a.dropped, (unsigned long long)dropped);
  }
  // the tile's group bits are complete: the look-back's barriers follow
  // the last OR
  for (int gg = tid; clock && gg < a.maxp; gg += kThreads) {
    if (((touched[gg >> 5] >> (gg & 31)) & 1u) &&
        __ldca(a.touch + gg) < a.batch_no)
      atomicMax(a.touch + gg, a.batch_no);
  }
}

template <int NC>
cudaError_t launch_step(const StepArgs& a, cudaStream_t stream) {
  const long long blocks = (a.n + kThreads - 1) / kThreads;
  if (a.maxp == 0) {
    ingest_step_kernel<NC><<<(unsigned)blocks, kThreads, 0, stream>>>(a);
    return cudaGetLastError();
  }
  const size_t smem = a.touch != nullptr
                          ? (size_t)((a.maxp + 31) >> 5) * sizeof(unsigned)
                          : 0;
  cudaError_t err = cudaMemsetAsync(
      a.status, 0, (size_t)(a.n_tiles + 1) * sizeof(unsigned long long),
      stream);
  if (err != cudaSuccess) return err;
  ingest_spill_kernel<NC><<<(unsigned)blocks, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// table: [capacity] int64 (power of two), updated in place when insert != 0.
// keys: [n] int64. valid: [n] bytes or null. slots: [n] int32 out.
// ok: [n] bytes out or null. Returns cudaGetLastError.
extern "C" int hash_probe_launch(void* table, long long capacity,
                                 const void* keys, const void* valid,
                                 long long n, int insert, void* slots,
                                 void* ok, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const long long blocks = (n + kThreads - 1) / kThreads;
  hash_probe_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (unsigned long long*)table, (unsigned long long)(capacity - 1),
      (const unsigned long long*)keys, (const uint8_t*)valid, n, insert,
      (int32_t*)slots, (uint8_t*)ok);
  return (int)cudaGetLastError();
}

// One ingest step over n rows: ts [n] int64, keys [n] of key_dtype, value
// columns col_data[c] [n] of col_dtype[c]. Plane q is a [ring, capacity]
// buffer of plane_dtype[q] (not bool) folded by plane_kind[q] with column
// plane_col[q] (-1: +1, the count plane). late and dropped: int64
// counters, added to. first_open_at: null, or an int64 device scalar read
// in place of first_open.
// dirty: null, or [capacity >> dirty_shift] bytes set to 1 per folded
// slot's block. maxp > 0 turns on the spill split: spilled [maxp] bool,
// touch [maxp] int64 (or null) maxed with batch_no, stage_count an int64
// counter, stage_keys [stage_cap] int64, stage_ring [stage_cap] int32 and
// stage_vals[q] plane q's [stage_cap] column of its dtype (null: none, as
// for the count plane); in that form `dropped` counts the rows the stage
// could not hold, failed inserts stage instead, the rows stage in batch
// order, and scratch holds ingest_step_scratch_words(n) int64 words (the
// launch zeroes them first). seg_counts non-null turns on the counted form
// (not with the spill split): the n rows are segments of seg_len rows and
// segment j holds seg_counts[j * seg_stride] rows at its front.
// Dtype codes: 0 int64, 1 int32, 2 float32, 3 float64, 4 uint8, 5 bool.
// Kind codes: 0 sum (and count), 1 min, 2 max. Returns cudaGetLastError.
extern "C" int ingest_step_launch(
    void* table, long long capacity, const void* ts, const void* keys,
    int key_dtype, long long n, long long pane, long long offset,
    long long first_open, const void* first_open_at, long long ring,
    void* late, void* dropped,
    int n_planes, void* const* plane_data, const int* plane_kind,
    const int* plane_dtype, const int* plane_col, int n_cols,
    const void* const* col_data, const int* col_dtype, void* dirty,
    int dirty_shift, int maxp, const void* spilled, void* touch,
    long long batch_no, void* stage_count, long long stage_cap,
    void* stage_keys, void* stage_ring, void* const* stage_vals,
    void* scratch, const void* seg_counts, long long seg_len,
    long long seg_stride, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (n_planes < 1 || n_planes > kMaxPlanes || n_cols < 0 ||
      n_cols > kMaxCols || pane <= 0 || ring <= 0 || key_dtype == kF32 ||
      key_dtype == kF64 || key_dtype < 0 || key_dtype > kBool ||
      dirty_shift < 0 || dirty_shift > 30 || maxp < 0 ||
      (maxp > 0 && (spilled == nullptr || stage_count == nullptr ||
                    stage_keys == nullptr || stage_ring == nullptr ||
                    scratch == nullptr || stage_cap < 0)) ||
      (seg_counts != nullptr && (seg_len <= 0 || maxp > 0)))
    return (int)cudaErrorInvalidValue;
  StepArgs a{};
  a.table = (unsigned long long*)table;
  a.mask = (unsigned long long)(capacity - 1);
  a.cap = capacity;
  a.ts = (const long long*)ts;
  a.keys = keys;
  a.key_dtype = key_dtype;
  a.n = n;
  a.pane = pane;
  a.offset = offset;
  a.first_open = first_open;
  a.first_open_at = (const long long*)first_open_at;
  a.ring = ring;
  a.late = (unsigned long long*)late;
  a.dropped = (unsigned long long*)dropped;
  a.n_planes = n_planes;
  for (int q = 0; q < n_planes; ++q) {
    if (plane_kind[q] < kSum || plane_kind[q] > kMax || plane_dtype[q] < 0 ||
        plane_dtype[q] > kU8 || plane_col[q] < -1 ||
        plane_col[q] >= n_cols)
      return (int)cudaErrorInvalidValue;
    a.planes[q] = StepPlane{plane_data[q], plane_kind[q], plane_dtype[q],
                            plane_col[q]};
  }
  for (int c = 0; c < n_cols; ++c) {
    if (col_dtype[c] < 0 || col_dtype[c] > kBool)
      return (int)cudaErrorInvalidValue;
    a.cols[c] = StepCol{col_data[c], col_dtype[c]};
  }
  a.dirty = (uint8_t*)dirty;
  a.dirty_shift = dirty_shift;
  a.seg_counts = (const long long*)seg_counts;
  a.seg_len = seg_len;
  a.seg_stride = seg_stride;
  a.maxp = maxp;
  if (maxp > 0) {
    a.spilled = (const uint8_t*)spilled;
    a.touch = (long long*)touch;
    a.batch_no = batch_no;
    a.stage_count = (long long*)stage_count;
    a.stage_cap = stage_cap;
    a.stage_keys = (long long*)stage_keys;
    a.stage_ring = (int*)stage_ring;
    for (int q = 0; q < n_planes; ++q)
      a.stage_vals[q] = stage_vals != nullptr ? stage_vals[q] : nullptr;
    a.n_tiles = (n + kThreads - 1) / kThreads;
    a.status = (unsigned long long*)scratch;
    a.tile_counter = (unsigned int*)(a.status + a.n_tiles);
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (n_cols) {
    case 0: return (int)launch_step<0>(a, s);
    case 1: return (int)launch_step<1>(a, s);
    case 2: return (int)launch_step<2>(a, s);
    case 3: return (int)launch_step<3>(a, s);
    case 4: return (int)launch_step<4>(a, s);
    case 5: return (int)launch_step<5>(a, s);
    case 6: return (int)launch_step<6>(a, s);
    default: return (int)launch_step<7>(a, s);
  }
}

// Loads every kernel of this library now, so a first launch inside a CUDA
// graph capture never has to load a module (lazy loading). Returns
// cudaGetLastError.
template <int NC>
void load_step(cudaFuncAttributes* attr) {
  cudaFuncGetAttributes(attr, ingest_step_kernel<NC>);
  cudaFuncGetAttributes(attr, ingest_spill_kernel<NC>);
}

extern "C" int hash_table_load() {
  cudaFuncAttributes attr;
  cudaFuncGetAttributes(&attr, hash_probe_kernel);
  load_step<0>(&attr);
  load_step<1>(&attr);
  load_step<2>(&attr);
  load_step<3>(&attr);
  load_step<4>(&attr);
  load_step<5>(&attr);
  load_step<6>(&attr);
  load_step<7>(&attr);
  return (int)cudaGetLastError();
}

// int64 words of the spill form's scratch for n rows: one look-back word
// per tile of kThreads rows and the tile counter.
extern "C" int ingest_step_scratch_words(long long n) {
  return (int)((n + kThreads - 1) / kThreads + 1);
}

extern "C" const char* hash_probe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
