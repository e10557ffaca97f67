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
// reads ts, key and the value columns once, one table sector and one claim
// per new key, and reads and writes one 32-byte sector per distinct
// (ring row, key) pair of each plane.
//
// Design: one thread per row. A thread issues the loads of its row's ts,
// key and value columns before any dependent work; a warp's loads are
// consecutive, so each is one coalesced request. (Four rows per thread,
// with the table reads and then the claims of all four issued together,
// measured slower on the H100: fewer warps hide less latency.)
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
// Two optional parts of the step, each off when its pointer is null, so a
// launch without them keeps its form and its cost:
//  * Dirty marking (device_window.py:150-151, the incremental snapshot's
//    capture): every row that folds sets the byte of its slot's block,
//    dirty[slot >> dirty_shift], to 1: an idempotent plain store into a
//    [n_blocks] bitmap (32 KiB at 2^24 slots: it stays in L2), made only
//    when an L2 read finds the byte 0. Only blocks really written are
//    marked (the reference also marks block 0 for every row that does not
//    fold).
//  * The deferred-spill split (device_window.py:106-130, under an HBM
//    budget): the row's key group (the murmur of core/keygroups.py, as
//    key_groups_device computes it) reads the [maxp] spilled mask; only
//    fresh rows of resident groups probe and fold, and fresh rows of
//    spilled groups or whose insert failed go to staging buffers for the
//    host tier: key, ring row, and each plane's value. Positions come from
//    one warp-aggregated atomicAdd on the stage count, so the stage fills
//    in atomic order, not batch order; rows past its capacity count into
//    `dropped`. The per-group LRU clock touch[g] = max(batch_no) is taken
//    through a bitmap of the block's groups in shared memory and one global
//    atomicMax per touched group per block, skipped when the clock already
//    holds batch_no (2^19 rows on 128 addresses would serialise as per-row
//    atomics).
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "probe.cuh"

namespace {

using probe_table::kEmpty;
using probe_table::probe;
constexpr int kThreads = 256;
constexpr int kMaxPlanes = 8;
constexpr int kMaxCols = 7;
constexpr unsigned kFull = 0xffffffffu;

enum Dtype { kI64 = 0, kI32 = 1, kF32 = 2, kF64 = 3, kU8 = 4, kBool = 5 };
enum Kind { kSum = 0, kMin = 1, kMax = 2 };  // a count plane folds +1 as kSum

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// key group of an int64 key: core/keygroups.py's murmur_mix of the
// Long.hashCode fold, abs with INT_MIN -> 0, modulo max_parallelism
__device__ __forceinline__ int key_group(unsigned long long u, int maxp) {
  uint32_t k = (uint32_t)(u ^ (u >> 32));
  k *= 0xCC9E2D51u;
  k = rotl32(k, 15);
  k *= 0x1B873593u;
  uint32_t h = rotl32(k, 13);
  h = h * 5u + 0xE6546B64u;
  h ^= 4u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  int v = (int)h;
  v = v == INT_MIN ? 0 : (v < 0 ? -v : v);
  return v % maxp;
}

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
  unsigned long long* stage_count; // int64 scalar, added to
  long long stage_cap;
  long long* stage_keys;           // [stage_cap]
  int* stage_ring;                 // [stage_cap]
  void* stage_vals[kMaxPlanes];    // plane q's [stage_cap] column, or null
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

template <int NC>
__global__ void __launch_bounds__(kThreads) ingest_step_kernel(StepArgs a) {
  // the plane table goes to shared memory once per block, so the fold loop
  // can index it at run time without a local copy of the parameters
  __shared__ StepPlane planes[kMaxPlanes];
  __shared__ void* stage_vals[kMaxPlanes];
  // spill form with a clock: bit g set when a row of the block is in group g
  extern __shared__ unsigned touched[];
  const bool spill = a.maxp > 0;
  const bool clock = spill && a.touch != nullptr;
  const int words = clock ? (a.maxp + 31) >> 5 : 0;
  for (int w = threadIdx.x; w < words; w += blockDim.x) touched[w] = 0u;
  if (threadIdx.x < kMaxPlanes) {
#pragma unroll
    for (int q = 0; q < kMaxPlanes; ++q) {
      if (q == (int)threadIdx.x) {
        planes[q] = a.planes[q];
        stage_vals[q] = a.stage_vals[q];
      }
    }
  }
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < a.n;
  // every load of the row is issued before any dependent work
  long long ts = 0;
  unsigned long long kr = 0, cv[NC > 0 ? NC : 1];
  if (in) {
    ts = __ldg(a.ts + i);
    kr = load_one(a.keys, a.key_dtype, i);
#pragma unroll
    for (int c = 0; c < NC; ++c) cv[c] = load_one(a.cols[c].data,
                                                  a.cols[c].dtype, i);
  }
  // wraps like torch's int64 subtraction; the pane floors as
  // torch.div(..., rounding_mode="floor") does
  const long long d = (long long)((unsigned long long)ts -
                                  (unsigned long long)a.offset);
  const long long pane = floor_div(d, a.pane);
  const long long first_open =
      a.first_open_at != nullptr ? __ldg(a.first_open_at) : a.first_open;
  const bool fresh = in && pane >= first_open;
  long long k = value_as<long long>(kr, a.key_dtype);
  if (k == (long long)kEmpty) k = (long long)kEmpty - 1;  // sanitize
  bool spilled_row = false;
  if (spill && in) {
    const int g = key_group((unsigned long long)k, a.maxp);
    spilled_row = a.spilled[g] != 0;
    if (clock) atomicOr(&touched[g >> 5], 1u << (g & 31));
  }
  const int slot = fresh && !spilled_row
                       ? probe(a.table, a.mask, (unsigned long long)k, true)
                       : -1;
  long long row = pane % a.ring;
  if (row < 0) row += a.ring;
  if (slot >= 0) {
    // read before the store: after its first row a block's byte reads 1,
    // and 2^19 stores into a few KiB would queue on the same L2 lines
    if (a.dirty != nullptr && __ldcg(a.dirty + (slot >> a.dirty_shift)) == 0)
      a.dirty[slot >> a.dirty_shift] = 1;
    const long long idx = row * a.cap + slot;
    for (int q = 0; q < a.n_planes; ++q) {
      if (planes[q].col < 0) fold(planes[q], idx, 1ull, kI64);
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      for (int q = 0; q < a.n_planes; ++q) {
        if (planes[q].col == c) fold(planes[q], idx, cv[c],
                                     a.cols[c].dtype);
      }
    }
  }
  // every lane gets here (no early return above), so the warp-wide calls
  // are legal
  bool drop = fresh && slot < 0;
  if (spill) {
    const bool to_host = drop;   // a spilled group's row, or a failed insert
    drop = false;
    const unsigned m = __ballot_sync(kFull, to_host);
    if (m != 0u) {
      const int lane = threadIdx.x & 31;
      const int leader = __ffs(m) - 1;
      unsigned long long base = 0;
      if (lane == leader)
        base = atomicAdd(a.stage_count, (unsigned long long)__popc(m));
      base = __shfl_sync(kFull, base, leader);
      if (to_host) {
        const long long pos =
            (long long)(base + (unsigned long long)__popc(m & ((1u << lane) -
                                                               1u)));
        if (pos < a.stage_cap) {
          a.stage_keys[pos] = k;
          a.stage_ring[pos] = (int)row;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            for (int q = 0; q < a.n_planes; ++q) {
              if (planes[q].col == c && stage_vals[q] != nullptr)
                store_as(stage_vals[q], pos, planes[q].dtype, cv[c],
                         a.cols[c].dtype);
            }
          }
        } else {
          drop = true;
        }
      }
    }
  }
  const unsigned late = __reduce_add_sync(kFull, (in && !fresh) ? 1u : 0u);
  const unsigned dropped = __reduce_add_sync(kFull, drop ? 1u : 0u);
  if ((threadIdx.x & 31) == 0) {
    if (late) atomicAdd(a.late, (unsigned long long)late);
    if (dropped) atomicAdd(a.dropped, (unsigned long long)dropped);
  }
  if (clock) {
    __syncthreads();
    for (int w = threadIdx.x; w < words; w += blockDim.x) {
      unsigned bits = touched[w];
      while (bits != 0u) {
        const int g = (w << 5) + __ffs(bits) - 1;
        bits &= bits - 1u;
        if (__ldcg(a.touch + g) < a.batch_no) atomicMax(a.touch + g,
                                                        a.batch_no);
      }
    }
  }
}

template <int NC>
cudaError_t launch_step(const StepArgs& a, cudaStream_t stream) {
  const long long blocks = (a.n + kThreads - 1) / kThreads;
  const size_t smem = a.maxp > 0 && a.touch != nullptr
                          ? (size_t)((a.maxp + 31) >> 5) * sizeof(unsigned)
                          : 0;
  ingest_step_kernel<NC><<<(unsigned)blocks, kThreads, smem, stream>>>(a);
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
// could not hold, and failed inserts stage instead.
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
    void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (n_planes < 1 || n_planes > kMaxPlanes || n_cols < 0 ||
      n_cols > kMaxCols || pane <= 0 || ring <= 0 || key_dtype == kF32 ||
      key_dtype == kF64 || key_dtype < 0 || key_dtype > kBool ||
      dirty_shift < 0 || dirty_shift > 30 || maxp < 0 ||
      (maxp > 0 && (spilled == nullptr || stage_count == nullptr ||
                    stage_keys == nullptr || stage_ring == nullptr ||
                    stage_cap < 0)))
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
  a.maxp = maxp;
  if (maxp > 0) {
    a.spilled = (const uint8_t*)spilled;
    a.touch = (long long*)touch;
    a.batch_no = batch_no;
    a.stage_count = (unsigned long long*)stage_count;
    a.stage_cap = stage_cap;
    a.stage_keys = (long long*)stage_keys;
    a.stage_ring = (int*)stage_ring;
    for (int q = 0; q < n_planes; ++q)
      a.stage_vals[q] = stage_vals != nullptr ? stage_vals[q] : nullptr;
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
extern "C" int hash_table_load() {
  cudaFuncAttributes attr;
  cudaFuncGetAttributes(&attr, hash_probe_kernel);
  cudaFuncGetAttributes(&attr, ingest_step_kernel<0>);
  cudaFuncGetAttributes(&attr, ingest_step_kernel<1>);
  cudaFuncGetAttributes(&attr, ingest_step_kernel<2>);
  cudaFuncGetAttributes(&attr, ingest_step_kernel<3>);
  cudaFuncGetAttributes(&attr, ingest_step_kernel<4>);
  cudaFuncGetAttributes(&attr, ingest_step_kernel<5>);
  cudaFuncGetAttributes(&attr, ingest_step_kernel<6>);
  cudaFuncGetAttributes(&attr, ingest_step_kernel<7>);
  return (int)cudaGetLastError();
}

extern "C" const char* hash_probe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
