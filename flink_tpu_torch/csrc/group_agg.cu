// Device GROUP BY: one micro-batch of the changelog aggregation, folded
// into float64 accumulator planes of [capacity] slots.
//
// Replaces flink_tpu/sql/device_group_agg.py::_gagg_program, the one XLA
// program a batch ran on the TPU. Its steps need grid-wide order (the
// previous values are read before any fold, the dead groups are known only
// after every fold), so the batch is four launches on one stream:
//
//  1. group_agg_first_kernel: the first row of each touched slot, an
//     atomicMin of the row index into a persistent [capacity] int32 scratch
//     (firstpos). The scratch holds kNoRow everywhere between batches: the
//     emit pass restores the entries a batch touched, so a batch costs O(B)
//     where the reference filled a [capacity + 1] array per batch.
//  2. group_agg_compact_kernel: the first-occurrence rows, compacted in
//     batch order (the order the changelog is emitted in) by a block scan
//     of ballots and a decoupled look-back over tiles taken from an atomic
//     tile counter (as hash_table.cu's spill form), write their row index
//     and every plane's PREV value; the last tile writes the group count.
//  3. group_agg_fold_kernel: every valid row folds into its slot: the
//     signed row count and each sum plane add (value * sign, or the sign
//     for a count plane), min and max planes fold the raw value and ignore
//     the sign (the reference's documented append-only degradation).
//  4. group_agg_emit_kernel: one thread per group reads the post-fold
//     count, resets a drained group's planes to their identities (0, +inf,
//     -inf), writes the NEW values, marks the slot's dirty block and
//     restores the slot's firstpos entry.
//
// What bounds it on an H100: bytes, and at few groups the atomics. Rows of
// one slot inside a warp are folded first (__match_any_sync on the slot,
// then a shuffle tree over the peers), so TPC-H Q1's 6 groups cost one
// atomic per group per warp and plane instead of one per row; at 10M keys
// nearly every peer set is one row and the tree is skipped. float64 min and
// max have no native atomic: a CAS loop folds with the reference's
// semantics (NaN wins, -0.0 below +0.0), which XLA's scatter-min and
// scatter-max on the CPU were measured to follow.
//
// The plain PyTorch version of every stage is in ops/group_agg.py.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPlanes = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoRow = 0x7fffffff;  // firstpos of an untouched slot
// look-back words: flag in the top two bits, value below
constexpr unsigned long long kFlagAggregate = 1ull << 62;
constexpr unsigned long long kFlagPrefix = 2ull << 62;
constexpr unsigned long long kValueMask = (1ull << 62) - 1;

enum Kind { kSum = 0, kMin = 1, kMax = 2 };
enum Stage { kFirst = 0, kCompact = 1, kFold = 2, kEmit = 3 };

struct Args {
  double* planes[kMaxPlanes];  // plane 0: the signed row count
  int kind[kMaxPlanes];
  int col[kMaxPlanes];         // value column; -1 folds the sign
  int n_planes;
  const int* slots;            // [n]; < 0: the row folds nowhere
  const double* sign;          // [n]
  const double* vals;          // [n_cols, n]
  long long n;                 // rows of the batch buffers
  long long n_valid;           // rows at or past it fold nowhere
  int* firstpos;               // [capacity]
  unsigned char* dirty;        // [blocks + 1] or null
  int dirty_shift;
  int* row_idx;                // [n] out: the groups' first rows
  double* comp;                // [n, 2 * n_planes] out: PREV, then NEW
  long long* n_groups;         // out
  unsigned long long* status;  // [n_tiles] look-back words, zeroed
  unsigned* tile_counter;      // zeroed
  long long n_tiles;
};

__device__ __forceinline__ int row_slot(const Args& a, long long i) {
  return i < a.n_valid ? __ldg(a.slots + i) : -1;
}

// the peers of a lane: the lanes of its warp holding its slot; a row that
// folds nowhere is a peer set of its own
__device__ __forceinline__ unsigned slot_peers(int s, int lane) {
  return __match_any_sync(kFull, s >= 0 ? (unsigned)s : 0x80000000u | lane);
}

__device__ __forceinline__ double pos_inf() {
  return __longlong_as_double(0x7ff0000000000000ll);
}

__device__ __forceinline__ bool is_nan(double x) { return x != x; }

__device__ __forceinline__ bool sign_bit(double x) {
  return __double_as_longlong(x) < 0;
}

__device__ __forceinline__ double fold_min(double x, double y) {
  if (is_nan(x)) return x;
  if (is_nan(y)) return y;
  if (x < y) return x;
  if (y < x) return y;
  return sign_bit(x) ? x : y;  // equal: -0.0 is below +0.0
}

__device__ __forceinline__ double fold_max(double x, double y) {
  if (is_nan(x)) return x;
  if (is_nan(y)) return y;
  if (x > y) return x;
  if (y > x) return y;
  return sign_bit(x) ? y : x;
}

template <int K>
__device__ __forceinline__ double combine(double x, double y) {
  if (K == kSum) return x + y;
  if (K == kMin) return fold_min(x, y);
  return fold_max(x, y);
}

// Folds x over each peer set; the set's lowest lane ends with the whole
// set's value. A tree over ranks: in round r, a lane adds the partial of
// its next remaining peer, and the lanes whose rank has bit r set drop
// out. Every lane of the warp takes part in every shuffle.
template <int K>
__device__ __forceinline__ double reduce_peers(unsigned peers, int lane,
                                               double x) {
  unsigned rest = lane == 31 ? 0u : peers & (~0u << (lane + 1));
  unsigned rank = __popc(peers & ((1u << lane) - 1u));
  while (__any_sync(kFull, rest != 0u)) {
    const int next = __ffs(rest);  // 1-based, 0 for none
    const double t = __shfl_sync(kFull, x, next ? next - 1 : lane);
    if (next) x = combine<K>(x, t);
    rest &= ~__ballot_sync(kFull, rank & 1u);
    rank >>= 1;
  }
  return x;
}

template <int K>
__device__ __forceinline__ void atomic_fold(double* addr, double v) {
  if (K == kSum) {
    atomicAdd(addr, v);
    return;
  }
  unsigned long long* p = reinterpret_cast<unsigned long long*>(addr);
  unsigned long long old = __ldcg(p);
  while (true) {
    const unsigned long long want =
        __double_as_longlong(combine<K>(__longlong_as_double(old), v));
    if (want == old) return;
    const unsigned long long seen = atomicCAS(p, old, want);
    if (seen == old) return;
    old = seen;
  }
}

template <int K>
__device__ __forceinline__ void fold_plane(const Args& a, int q, int s,
                                           long long i, double sg,
                                           unsigned peers, int lane,
                                           bool lead) {
  double v;
  if (K == kSum) {
    const int c = a.col[q];
    v = s < 0 ? 0.0 : (c < 0 ? sg : __ldg(a.vals + c * a.n + i) * sg);
  } else {
    v = s < 0 ? (K == kMin ? pos_inf() : -pos_inf())
              : __ldg(a.vals + a.col[q] * a.n + i);
  }
  v = reduce_peers<K>(peers, lane, v);
  if (lead) atomic_fold<K>(a.planes[q] + s, v);
}

__device__ __forceinline__ double identity_of(int kind) {
  if (kind == kMin) return pos_inf();
  if (kind == kMax) return -pos_inf();
  return 0.0;
}

__global__ void __launch_bounds__(kThreads) group_agg_first_kernel(
    const Args a) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int s = row_slot(a, i);
  const unsigned peers = slot_peers(s, lane);
  // the set's lowest lane holds its smallest row index
  if (s >= 0 && lane == __ffs(peers) - 1) atomicMin(a.firstpos + s, (int)i);
}

__global__ void __launch_bounds__(kThreads) group_agg_compact_kernel(
    const Args a) {
  __shared__ unsigned warp_count[kWarps];
  __shared__ int warp_stop[kWarps];
  __shared__ unsigned long long warp_sum[kWarps];
  __shared__ long long tile_s, tile_base;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) tile_s = atomicAdd(a.tile_counter, 1u);
  __syncthreads();
  const long long tile = tile_s;
  const long long i = tile * kThreads + tid;
  const int s = row_slot(a, i);
  const bool first = s >= 0 && __ldcg(a.firstpos + s) == (int)i;
  const unsigned ballot = __ballot_sync(kFull, first);
  if (lane == 0) warp_count[warp] = __popc(ballot);
  __syncthreads();
  unsigned before_warp = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const unsigned v = warp_count[w];
    before_warp += w < warp ? v : 0u;
    total += v;
  }
  volatile unsigned long long* st = a.status;
  if (tile == 0) {
    if (tid == 0) {
      st[0] = kFlagPrefix | total;
      tile_base = 0;
    }
  } else {
    if (tid == 0) st[tile] = kFlagAggregate | total;
    // the whole block looks back: thread k reads tile - 1 - k, 256 at a
    // time, and the nearest published prefix ends the walk
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
        warp_stop[warp] =
            prefixes ? 32 * warp + __ffs(prefixes) - 1 : kThreads;
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
  if (tid == 0 && tile == a.n_tiles - 1) *a.n_groups = tile_base + total;
  if (first) {
    const long long pos =
        tile_base + (long long)(before_warp + __popc(ballot & ((1u << lane) - 1u)));
    a.row_idx[pos] = (int)i;
    double* out = a.comp + pos * 2 * a.n_planes;
    for (int q = 0; q < a.n_planes; ++q) out[q] = __ldcg(a.planes[q] + s);
  }
}

__global__ void __launch_bounds__(kThreads) group_agg_fold_kernel(
    const Args a) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int s = row_slot(a, i);
  const double sg = s >= 0 ? __ldg(a.sign + i) : 0.0;
  const unsigned peers = slot_peers(s, lane);
  const bool lead = s >= 0 && lane == __ffs(peers) - 1;
  // kind is the same for every lane: the shuffles stay warp-uniform
  for (int q = 0; q < a.n_planes; ++q) {
    const int kind = a.kind[q];
    if (kind == kSum)
      fold_plane<kSum>(a, q, s, i, sg, peers, lane, lead);
    else if (kind == kMin)
      fold_plane<kMin>(a, q, s, i, sg, peers, lane, lead);
    else
      fold_plane<kMax>(a, q, s, i, sg, peers, lane, lead);
  }
}

__global__ void __launch_bounds__(kThreads) group_agg_emit_kernel(
    const Args a) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= __ldcg(a.n_groups)) return;
  const int s = __ldg(a.slots + __ldcg(a.row_idx + p));
  const bool dead = __ldcg(a.planes[0] + s) <= 0.0;
  double* out = a.comp + p * 2 * a.n_planes + a.n_planes;
  for (int q = 0; q < a.n_planes; ++q) {
    double v;
    if (dead) {
      v = identity_of(a.kind[q]);
      a.planes[q][s] = v;
    } else {
      v = __ldcg(a.planes[q] + s);
    }
    out[q] = v;
  }
  if (a.dirty != nullptr) a.dirty[s >> a.dirty_shift] = 1;
  a.firstpos[s] = kNoRow;
}

}  // namespace

// One stage of a group aggregation step (Stage: 0 first, 1 compact, 2
// fold, 3 emit) over n rows: planes[n_planes] float64 [capacity] with
// kinds and value columns, slots [n] int32, sign [n] float64, vals
// [n_cols, n] float64, firstpos [capacity] int32, dirty [blocks + 1] bytes
// or null, row_idx [n] int32, comp [n, 2 * n_planes] float64, n_groups one
// int64, status n_tiles + 1 int64 words (the compact stage zeroes them).
// Returns cudaGetLastError, or cudaErrorInvalidValue for more than
// kMaxPlanes planes.
extern "C" int group_agg_launch(int stage, void** planes, const int* kinds,
                                const int* cols, int n_planes,
                                const void* slots, const void* sign,
                                const void* vals, long long n,
                                long long n_valid, void* firstpos,
                                void* dirty, int dirty_shift, void* row_idx,
                                void* comp, void* n_groups, void* status,
                                void* stream) {
  if (n_planes < 1 || n_planes > kMaxPlanes || n_valid > n)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  Args a;
  for (int q = 0; q < n_planes; ++q) {
    a.planes[q] = static_cast<double*>(planes[q]);
    a.kind[q] = kinds[q];
    a.col[q] = cols[q];
  }
  a.n_planes = n_planes;
  a.slots = static_cast<const int*>(slots);
  a.sign = static_cast<const double*>(sign);
  a.vals = static_cast<const double*>(vals);
  a.n = n;
  a.n_valid = n_valid;
  a.firstpos = static_cast<int*>(firstpos);
  a.dirty = static_cast<unsigned char*>(dirty);
  a.dirty_shift = dirty_shift;
  a.row_idx = static_cast<int*>(row_idx);
  a.comp = static_cast<double*>(comp);
  a.n_groups = static_cast<long long*>(n_groups);
  a.n_tiles = (n + kThreads - 1) / kThreads;
  a.status = static_cast<unsigned long long*>(status);
  a.tile_counter = reinterpret_cast<unsigned*>(a.status + a.n_tiles);
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)a.n_tiles;
  switch (stage) {
    case kFirst:
      group_agg_first_kernel<<<blocks, kThreads, 0, st>>>(a);
      break;
    case kCompact: {
      cudaError_t err = cudaMemsetAsync(
          a.status, 0, (size_t)(a.n_tiles + 1) * sizeof(unsigned long long),
          st);
      if (err != cudaSuccess) return (int)err;
      group_agg_compact_kernel<<<blocks, kThreads, 0, st>>>(a);
      break;
    }
    case kFold:
      group_agg_fold_kernel<<<blocks, kThreads, 0, st>>>(a);
      break;
    case kEmit:
      group_agg_emit_kernel<<<blocks, kThreads, 0, st>>>(a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// int64 words of the look-back scratch for n rows: one word per tile of
// kThreads rows and the tile counter.
extern "C" int group_agg_scratch_words(long long n) {
  return (int)((n + kThreads - 1) / kThreads + 1);
}

extern "C" const char* group_agg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
