// Session windows on per-key lanes: the per-batch step and the fire.
//
// Replaces:
//  * session_step_launch: flink_tpu/runtime/operators/device_session.py::
//    _sess_step (:76), the one XLA program per batch: lookup-or-insert,
//    the merge check of every event against all L lanes of its key, the
//    late mask, anchors, per-segment totals, the settled / lane split,
//    lane allocation by rotation, the folds into (lane, slot), cur_lane
//    and dirty marking, and the compaction of settled segments.
//  * session_fire_launch: device_session.py::_sess_fire (:256), the fire
//    scan: every open lane with end + gap <= boundary compacted into
//    [capacity] buffers in lane-major order, and reset.
//
// Bound on the H100: device memory. The step reads each row's key, ts and
// values once (coalesced), one random table sector per key, and the
// start, end and open cells of the key's L lanes (3 L random sectors, one
// of them per plane for a key seen first), then writes the sectors of the
// lane each segment folds into, cur_lane and one dirty byte. The fire
// reads the [L, capacity] open plane, the end cell of every open lane,
// and for each fired lane its key, start, count and aggregates; it writes
// the outputs and the identities back.
//
// Step design: one thread per KEY RUN. The batch arrives sorted by (key,
// ts), so a key's rows are one contiguous run, and every decision of the
// reference program is local to a key: its segments, the ordinal of each
// new segment among the key's allocations, whether a segment is the key's
// last, the lanes it merges into. The thread at the head of a run (the
// row whose predecessor has another key) probes once for the key, reads
// the key's L lanes into registers BEFORE it writes anything (the merge
// checks and the free-lane rotation read the lanes as they stood before
// the batch, as the reference's gathers do), walks the run in order, and
// folds each segment's totals into its lane with plain read-modify-writes:
// the lanes of a slot belong to one key, so no other thread touches them,
// and two segments of the key merging into one lane fold one after the
// other. No total crosses a block boundary: a run is one thread's, so
// there is no cross-block scan. The cost is that a hot key's run is walked
// serially (a run of R rows takes R steps of one thread); the batches of
// the session cells hold a few rows per key. Settled segments go to the
// emit buffers at positions from one atomicAdd each (they are rare: they
// need end + 2 gap behind the fired boundary), so the buffers fill in
// atomic order, not batch order. The late and dropped counts go to their
// int64 counters with one atomic per thread that has any.
//
// Fire design: one pass with decoupled look-back. A block takes the next
// tile of 4096 lanes (an atomic tile counter, so tiles start in order and
// a block only waits on tiles that already started), reads open and, for
// open lanes, end, and ranks its due lanes by ballot and popc in lane-major
// order. The first warp publishes the tile's count, reads the tiles
// before it 32 at a time until one has published its inclusive prefix,
// and publishes its own; flag and value share one 64-bit word, so a
// reader never sees one without the other. Then each due lane whose position is below the
// capacity is written out and reset, and its slot's dirty block marked;
// lanes past the capacity stay open for the next round, as in the
// reference. The last tile writes [fired, overflow].
#include <cstdint>
#include <cuda_runtime.h>

#include "probe.cuh"

namespace {

using probe_table::kEmpty;
using probe_table::probe;

constexpr int kMaxFolds = 8;
constexpr int kMaxOuts = 16;
constexpr int kStepThreads = 256;
constexpr int kFireThreads = 256;
constexpr int kFireWarps = kFireThreads / 32;
constexpr int kFireItems = 16;  // stripes of 256 lanes per tile
constexpr long long kTile = (long long)kFireThreads * kFireItems;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kI64Max = 0x7FFFFFFFFFFFFFFFll;
constexpr long long kI64Min = -kI64Max - 1;
constexpr unsigned long long kFlagAggregate = 1ull << 62;
constexpr unsigned long long kFlagPrefix = 2ull << 62;
constexpr unsigned long long kValueMask = (1ull << 62) - 1;

enum Dtype { kI64 = 0, kI32 = 1, kF32 = 2, kF64 = 3 };
enum Kind { kSum = 0, kMin = 1, kMax = 2 };
enum OutKind { kAvg = 0, kValue = 1 };

// int64 arithmetic that wraps, as the reference's and torch's does
__device__ __forceinline__ long long wadd(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}
__device__ __forceinline__ long long wsub(long long a, long long b) {
  return (long long)((unsigned long long)a - (unsigned long long)b);
}
__device__ __forceinline__ long long sanitize(long long k) {
  return k == (long long)kEmpty ? (long long)kEmpty - 1 : k;
}

// A value travels as its bits in 64 bits, in its plane's dtype.
__device__ __forceinline__ unsigned long long load_raw(const void* p,
                                                       int dtype,
                                                       long long i) {
  if (dtype == kI64 || dtype == kF64)
    return __ldg(static_cast<const unsigned long long*>(p) + i);
  return __ldg(static_cast<const unsigned int*>(p) + i);
}

__device__ __forceinline__ void store_raw(void* p, int dtype, long long i,
                                          unsigned long long raw) {
  if (dtype == kI64 || dtype == kF64)
    static_cast<unsigned long long*>(p)[i] = raw;
  else
    static_cast<unsigned int*>(p)[i] = (unsigned int)raw;
}

template <typename T>
__device__ __forceinline__ T combine_t(T a, T b, int kind) {
  return kind == kSum ? a + b : kind == kMin ? (b < a ? b : a)
                                             : (b > a ? b : a);
}

// a (+) b of plane `dtype` folded by `kind`, on raw bits
__device__ __forceinline__ unsigned long long combine(unsigned long long a,
                                                      unsigned long long b,
                                                      int kind, int dtype) {
  switch (dtype) {
    case kI64:
      return (unsigned long long)combine_t<long long>((long long)a,
                                                      (long long)b, kind);
    case kI32:
      return (unsigned)combine_t<int>((int)(unsigned)a, (int)(unsigned)b,
                                      kind);
    case kF32:
      return __float_as_uint(combine_t<float>(__uint_as_float((unsigned)a),
                                              __uint_as_float((unsigned)b),
                                              kind));
    default:
      return (unsigned long long)__double_as_longlong(combine_t<double>(
          __longlong_as_double((long long)a),
          __longlong_as_double((long long)b), kind));
  }
}

struct FoldPlane {
  void* data;          // [L, cap] of dtype
  const void* values;  // [n] of dtype (the batch, sorted)
  void* emit;          // [n] of dtype: the settled segments' totals
  int kind;
  int dtype;
};

struct StepArgs {
  unsigned long long* table;
  unsigned long long mask;  // capacity - 1
  long long cap;
  const long long* keys;    // [n], sorted by (key, ts)
  const long long* ts;      // [n]
  long long n;
  long long gap;
  long long fired_boundary;
  int lanes;
  long long* start;         // [L, cap] int64, min
  long long* end;           // [L, cap] int64, max
  int8_t* open;             // [L, cap] int8, max
  long long* count;         // [L, cap] int64
  int* cur_lane;            // [cap] int32
  int n_folds;
  FoldPlane folds[kMaxFolds];
  unsigned long long* dropped;
  unsigned long long* late;
  uint8_t* dirty;           // null: no dirty marking
  int dirty_shift;
  unsigned long long* n_emit;
  long long* ekey;
  long long* estart;
  long long* eend;
  long long* ecount;
};

// A segment in the making: the totals of its rows and, from its anchor
// row, whether it merges and into which lane.
struct Segment {
  long long start, end, count;
  unsigned long long vals[kMaxFolds];
  int merge_lane;  // -1: the anchor merges into no open lane
};

__device__ __forceinline__ void mark_dirty(const StepArgs& a, long long slot) {
  // read before the store: most bytes are already 1
  if (a.dirty != nullptr && __ldcg(a.dirty + (slot >> a.dirty_shift)) == 0)
    a.dirty[slot >> a.dirty_shift] = 1;
}

// The reference's classification of a closed segment (device_session.py
// :176-224): settled segments that neither merge nor are their key's last
// are emitted; every other takes a lane, an allocating one the
// (ordinal + 1)-th free lane of the rotation from cur_lane + 1. Returns
// the lane it folded into, or -1.
__device__ __forceinline__ int close_segment(
    const StepArgs& a, const Segment& s, bool is_last, long long key,
    long long slot, unsigned long long open_mask, int cl, int& ordinal,
    unsigned long long& dropped) {
  const bool merge = s.merge_lane >= 0;
  const bool settled = wadd(s.end, 2 * a.gap) <= a.fired_boundary;
  if (!merge && !is_last && settled) {
    const unsigned long long pos = atomicAdd(a.n_emit, 1ull);
    a.ekey[pos] = key;
    a.estart[pos] = s.start;
    a.eend[pos] = s.end;
    a.ecount[pos] = s.count;
    for (int q = 0; q < a.n_folds; ++q)
      store_raw(a.folds[q].emit, a.folds[q].dtype, (long long)pos, s.vals[q]);
    return -1;
  }
  int lane = s.merge_lane;
  if (!merge) {
    const int want = ordinal++;
    int seen = 0;
    lane = -1;
    for (int j = 0; j < a.lanes; ++j) {
      const int l = (cl + 1 + j) % a.lanes;
      if (!((open_mask >> l) & 1ull)) {
        if (seen == want) {
          lane = l;
          break;
        }
        ++seen;
      }
    }
    if (lane < 0) {  // no free lane: counted, raised at the next fire
      ++dropped;
      return -1;
    }
  }
  const long long idx = (long long)lane * a.cap + slot;
  if (s.start < a.start[idx]) a.start[idx] = s.start;
  if (s.end > a.end[idx]) a.end[idx] = s.end;
  if (a.open[idx] < 1) a.open[idx] = 1;
  a.count[idx] += s.count;
  for (int q = 0; q < a.n_folds; ++q) {
    const FoldPlane& f = a.folds[q];
    const unsigned long long cur =
        (f.dtype == kI64 || f.dtype == kF64)
            ? static_cast<unsigned long long*>(f.data)[idx]
            : static_cast<unsigned int*>(f.data)[idx];
    store_raw(f.data, f.dtype, idx, combine(cur, s.vals[q], f.kind, f.dtype));
  }
  return lane;
}

template <int LMAX>
__global__ void __launch_bounds__(kStepThreads)
session_step_kernel(StepArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const long long key = sanitize(__ldg(a.keys + i));
  if (i > 0 && sanitize(__ldg(a.keys + i - 1)) == key) return;  // not a head
  const int slot = probe(a.table, a.mask, (unsigned long long)key, true);
  unsigned long long late = 0, dropped = 0;
  if (slot < 0) {
    // the insert failed: every row of the key counts as dropped
    long long r = i + 1;
    while (r < a.n && sanitize(__ldg(a.keys + r)) == key) ++r;
    dropped = (unsigned long long)(r - i);
  } else {
    mark_dirty(a, slot);
    // the key's lanes as they stood before the batch
    long long os[LMAX], oe[LMAX];
    unsigned long long open_mask = 0;
#pragma unroll
    for (int l = 0; l < LMAX; ++l) {
      os[l] = kI64Max;
      oe[l] = kI64Min;
      if (l < a.lanes) {
        const long long idx = (long long)l * a.cap + slot;
        if (a.open[idx] > 0) {
          open_mask |= 1ull << l;
          os[l] = a.start[idx];
          oe[l] = a.end[idx];
        }
      }
    }
    int cl = a.cur_lane[slot] % a.lanes;
    if (cl < 0) cl += a.lanes;
    Segment seg;
    bool have = false, prev_late = false;
    long long prev_ts = 0;
    int ordinal = 0;
    for (long long r = i; r < a.n; ++r) {
      if (r > i && sanitize(__ldg(a.keys + r)) != key) break;
      const long long t = __ldg(a.ts + r);
      // the first open lane that [t, t + gap) meets (TimeWindow.intersects)
      int ml = -1;
#pragma unroll
      for (int l = LMAX - 1; l >= 0; --l) {
        if (((open_mask >> l) & 1ull) && t > wsub(os[l], a.gap) &&
            t < wadd(oe[l], a.gap))
          ml = l;
      }
      if (ml < 0 && wadd(t, a.gap) <= a.fired_boundary) {
        ++late;
        prev_late = true;
        prev_ts = t;
        continue;
      }
      const bool anchor = r == i || wsub(t, prev_ts) >= a.gap || prev_late;
      if (anchor) {
        if (have) {
          close_segment(a, seg, false, key, slot, open_mask, cl, ordinal,
                        dropped);
        }
        seg.start = t;
        seg.end = t;
        seg.count = 1;
        seg.merge_lane = ml;
        for (int q = 0; q < a.n_folds; ++q)
          seg.vals[q] = load_raw(a.folds[q].values, a.folds[q].dtype, r);
        have = true;
      } else {
        if (t < seg.start) seg.start = t;
        if (t > seg.end) seg.end = t;
        ++seg.count;
        for (int q = 0; q < a.n_folds; ++q)
          seg.vals[q] = combine(
              seg.vals[q], load_raw(a.folds[q].values, a.folds[q].dtype, r),
              a.folds[q].kind, a.folds[q].dtype);
      }
      prev_late = false;
      prev_ts = t;
    }
    if (have) {
      const int lane = close_segment(a, seg, true, key, slot, open_mask, cl,
                                     ordinal, dropped);
      if (lane >= 0) a.cur_lane[slot] = lane;
    }
  }
  if (late) atomicAdd(a.late, late);
  if (dropped) atomicAdd(a.dropped, dropped);
}

struct ResetPlane {
  void* data;  // [L, cap] of dtype
  int kind;
  int dtype;
};

struct OutCol {
  const void* src;  // [L, cap] plane of dtype
  void* out;        // [cap] of dtype
  int kind;         // kAvg: sum / max(count, 1); kValue: the plane's cell
  int dtype;
};

struct FireArgs {
  const long long* table;
  long long cap;
  long long entries;        // L * cap
  long long gap;
  long long boundary;
  long long* start;
  long long* end;
  int8_t* open;
  long long* count;
  int n_resets;
  ResetPlane resets[kMaxFolds];
  int n_outs;
  OutCol outs[kMaxOuts];
  long long* okey;
  long long* ostart;
  long long* oend;
  long long* ocount;
  uint8_t* dirty;
  int dirty_shift;
  long long* counts;        // [2]: fired, overflow
  unsigned long long* status;  // [n_tiles] look-back words, zeroed
  unsigned int* tile_counter;  // zeroed
  long long n_tiles;
};

__device__ __forceinline__ unsigned long long reset_bits(int kind,
                                                         int dtype) {
  if (kind == kSum) return 0ull;
  const bool lo = kind == kMax;  // max resets to the lowest value
  switch (dtype) {
    case kI64:
      return (unsigned long long)(lo ? kI64Min : kI64Max);
    case kI32:
      return lo ? 0x80000000u : 0x7FFFFFFFu;
    case kF32:
      return lo ? 0xFF800000u : 0x7F800000u;  // -inf, +inf
    default:
      return lo ? 0xFFF0000000000000ull : 0x7FF0000000000000ull;
  }
}

__global__ void __launch_bounds__(kFireThreads)
session_fire_kernel(FireArgs a) {
  __shared__ unsigned warp_bits[kFireItems][kFireWarps];
  __shared__ unsigned warp_off[kFireItems][kFireWarps];
  __shared__ unsigned scan_sums[4];
  __shared__ long long tile_s, tile_base, tile_total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) tile_s = atomicAdd(a.tile_counter, 1u);
  __syncthreads();
  const long long tile = tile_s;
  const long long base = tile * kTile;
  unsigned mine = 0;  // bit j: this thread's lane of stripe j is due
#pragma unroll
  for (int j = 0; j < kFireItems; ++j) {
    const long long e = base + (long long)j * kFireThreads + tid;
    bool due = false;
    if (e < a.entries && a.open[e] > 0)
      due = wadd(a.end[e], a.gap) <= a.boundary;
    const unsigned bits = __ballot_sync(kFull, due);
    if (lane == 0) warp_bits[j][warp] = bits;
    mine |= (due ? 1u : 0u) << j;
  }
  __syncthreads();
  // exclusive scan of the 128 (stripe, warp) counts in lane-major order:
  // four warps of 32 counts, then the warps' sums
  static_assert(kFireItems * kFireWarps == 128, "four warps of counts");
  unsigned c = 0, incl = 0;
  if (tid < 128) {
    c = __popc(warp_bits[tid / kFireWarps][tid % kFireWarps]);
    incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) scan_sums[warp] = incl;
  }
  __syncthreads();
  if (tid < 128) {
    unsigned add = 0;
    for (int w = 0; w < warp; ++w) add += scan_sums[w];
    warp_off[tid / kFireWarps][tid % kFireWarps] = add + incl - c;
    if (tid == 127) tile_total = add + incl;
  }
  __syncthreads();
  if (warp == 0) {
    // decoupled look-back by the first warp: lane k reads the status of
    // tile - 1 - k, 32 predecessors per round, until one of them has
    // published its inclusive prefix
    const unsigned long long total = (unsigned long long)tile_total;
    volatile unsigned long long* st = a.status;
    unsigned long long before = 0;
    if (tile == 0) {
      if (lane == 0) st[0] = kFlagPrefix | total;
    } else {
      if (lane == 0) st[tile] = kFlagAggregate | total;
      for (long long j = tile - 1 - lane;; j -= 32) {
        unsigned long long v = kFlagPrefix;  // before tile 0: a prefix of 0
        if (j >= 0) {
          do {
            v = st[j];
          } while ((v >> 62) == 0ull);  // not published yet
        }
        const unsigned prefixes = __ballot_sync(kFull, (v >> 62) == 2ull);
        const int stop = prefixes ? __ffs(prefixes) - 1 : 32;
        unsigned long long part = lane <= stop ? (v & kValueMask) : 0ull;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          part += __shfl_down_sync(kFull, part, o);
        before += __shfl_sync(kFull, part, 0);
        if (prefixes) break;
      }
      if (lane == 0) st[tile] = kFlagPrefix | (before + total);
    }
    if (lane == 0) {
      tile_base = (long long)before;
      if (tile == a.n_tiles - 1) {
        const long long all = (long long)(before + total);
        const long long fired = all < a.cap ? all : a.cap;
        a.counts[0] = fired;
        a.counts[1] = all - fired;
      }
    }
  }
  __syncthreads();
  const long long tbase = tile_base;
#pragma unroll 4
  for (int j = 0; j < kFireItems; ++j) {
    if (!((mine >> j) & 1u)) continue;
    const long long pos =
        tbase + warp_off[j][warp] +
        __popc(warp_bits[j][warp] & ((1u << lane) - 1u));
    if (pos >= a.cap) continue;  // past the buffer: fires next round
    const long long e = base + (long long)j * kFireThreads + tid;
    const long long slot = e & (a.cap - 1);
    const long long cnt = a.count[e];
    a.okey[pos] = __ldg(a.table + slot);
    a.ostart[pos] = a.start[e];
    a.oend[pos] = a.end[e];
    a.ocount[pos] = cnt;
    for (int q = 0; q < a.n_outs; ++q) {
      const OutCol& o = a.outs[q];
      const unsigned long long raw = load_raw(o.src, o.dtype, e);
      if (o.kind == kAvg) {
        const long long d = cnt > 1 ? cnt : 1;
        if (o.dtype == kF64)
          static_cast<double*>(o.out)[pos] =
              __longlong_as_double((long long)raw) / (double)d;
        else
          static_cast<float*>(o.out)[pos] =
              __uint_as_float((unsigned)raw) / (float)d;
      } else {
        store_raw(o.out, o.dtype, pos, raw);
      }
    }
    a.open[e] = 0;
    a.start[e] = kI64Max;
    a.end[e] = kI64Min;
    a.count[e] = 0;
    for (int q = 0; q < a.n_resets; ++q)
      store_raw(a.resets[q].data, a.resets[q].dtype, e,
                reset_bits(a.resets[q].kind, a.resets[q].dtype));
    if (a.dirty != nullptr &&
        __ldcg(a.dirty + (slot >> a.dirty_shift)) == 0)
      a.dirty[slot >> a.dirty_shift] = 1;
  }
}

template <int LMAX>
cudaError_t launch_step(const StepArgs& a, cudaStream_t s) {
  const long long blocks = (a.n + kStepThreads - 1) / kStepThreads;
  session_step_kernel<LMAX><<<(unsigned)blocks, kStepThreads, 0, s>>>(a);
  return cudaGetLastError();
}

bool valid_dtype(int d) { return d >= kI64 && d <= kF64; }

}  // namespace

// One session step over n rows sorted by (key, ts): keys [n] int64 (raw;
// sanitized here), ts [n] int64. Planes [lanes, capacity]: start, end
// (int64), open (int8), count (int64); cur_lane [capacity] int32. Fold
// plane q: fold_data[q] of fold_dtype[q] folded by fold_kind[q] with
// fold_values[q] [n] of the same dtype. dropped and late: int64
// counters, added to. dirty: null, or [capacity >> dirty_shift] bytes set
// to 1 for the block of every slot the batch touches. n_emit (int64) is
// set to the number of settled segments written to ekey, estart, eend,
// ecount (int64 [n]) and emit_vals[q] ([n] of fold q's dtype).
// Dtype codes: 0 int64, 1 int32, 2 float32, 3 float64. Kind codes: 0 sum,
// 1 min, 2 max. Returns cudaGetLastError.
extern "C" int session_step_launch(
    void* table, long long capacity, const void* keys, const void* ts,
    long long n, long long gap, long long fired_boundary, int lanes,
    void* start, void* end, void* open, void* count, void* cur_lane,
    int n_folds, void* const* fold_data, const int* fold_kind,
    const int* fold_dtype, const void* const* fold_values, void* dropped,
    void* late, void* dirty, int dirty_shift, void* n_emit, void* ekey,
    void* estart, void* eend, void* ecount, void* const* emit_vals,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (lanes < 1 || lanes > 64 || n_folds < 0 || n_folds > kMaxFolds ||
      n < 0 || capacity < 1 || (capacity & (capacity - 1)) != 0 ||
      dirty_shift < 0 || dirty_shift > 30)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaMemsetAsync(n_emit, 0, sizeof(long long), s);
  if (err != cudaSuccess || n == 0) return (int)err;
  StepArgs a{};
  a.table = (unsigned long long*)table;
  a.mask = (unsigned long long)(capacity - 1);
  a.cap = capacity;
  a.keys = (const long long*)keys;
  a.ts = (const long long*)ts;
  a.n = n;
  a.gap = gap;
  a.fired_boundary = fired_boundary;
  a.lanes = lanes;
  a.start = (long long*)start;
  a.end = (long long*)end;
  a.open = (int8_t*)open;
  a.count = (long long*)count;
  a.cur_lane = (int*)cur_lane;
  a.n_folds = n_folds;
  for (int q = 0; q < n_folds; ++q) {
    if (fold_kind[q] < kSum || fold_kind[q] > kMax ||
        !valid_dtype(fold_dtype[q]))
      return (int)cudaErrorInvalidValue;
    a.folds[q] = FoldPlane{fold_data[q], fold_values[q], emit_vals[q],
                           fold_kind[q], fold_dtype[q]};
  }
  a.dropped = (unsigned long long*)dropped;
  a.late = (unsigned long long*)late;
  a.dirty = (uint8_t*)dirty;
  a.dirty_shift = dirty_shift;
  a.n_emit = (unsigned long long*)n_emit;
  a.ekey = (long long*)ekey;
  a.estart = (long long*)estart;
  a.eend = (long long*)eend;
  a.ecount = (long long*)ecount;
  if (lanes <= 4) return (int)launch_step<4>(a, s);
  if (lanes <= 8) return (int)launch_step<8>(a, s);
  if (lanes <= 16) return (int)launch_step<16>(a, s);
  return (int)launch_step<64>(a, s);
}

// int64 words of the fire's scratch for `entries` = lanes * capacity
// lanes: one look-back word per tile and the tile counter.
extern "C" int session_fire_scratch_words(long long entries) {
  return (int)((entries + kTile - 1) / kTile + 1);
}

// One fire round over [lanes, capacity] planes: every lane with open > 0
// and end + gap <= boundary, in lane-major order, up to capacity of them,
// goes to okey (table[slot]), ostart, oend, ocount and, per output q,
// out_data[q] ([capacity] of out_dtype[q]): out_src[q]'s cell (kind 1) or
// that over max(count, 1) (kind 0, avg; float32 or float64); and is reset:
// open 0, start int64 max, end int64 min, count 0, and reset plane q to
// the identity of reset_kind[q] (0 sum, 1 min, 2 max; float min and max
// to +-inf). dirty: as in the step, for the slots of reset lanes. counts
// [2] int64 receives [fired, overflow]. scratch: session_fire_scratch_words
// int64 words. Returns cudaGetLastError.
extern "C" int session_fire_launch(
    const void* table, long long capacity, int lanes, long long gap,
    long long boundary, void* start, void* end, void* open, void* count,
    int n_resets, void* const* reset_data, const int* reset_kind,
    const int* reset_dtype, int n_outs, const int* out_kind,
    const void* const* out_src, const int* out_dtype, void* const* out_data,
    void* okey, void* ostart, void* oend, void* ocount, void* dirty,
    int dirty_shift, void* counts, void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (lanes < 1 || lanes > 64 || capacity < 1 ||
      (capacity & (capacity - 1)) != 0 || n_resets < 0 ||
      n_resets > kMaxFolds || n_outs < 0 || n_outs > kMaxOuts ||
      dirty_shift < 0 || dirty_shift > 30)
    return (int)cudaErrorInvalidValue;
  FireArgs a{};
  a.table = (const long long*)table;
  a.cap = capacity;
  a.entries = (long long)lanes * capacity;
  a.gap = gap;
  a.boundary = boundary;
  a.start = (long long*)start;
  a.end = (long long*)end;
  a.open = (int8_t*)open;
  a.count = (long long*)count;
  a.n_resets = n_resets;
  for (int q = 0; q < n_resets; ++q) {
    if (reset_kind[q] < kSum || reset_kind[q] > kMax ||
        !valid_dtype(reset_dtype[q]))
      return (int)cudaErrorInvalidValue;
    a.resets[q] = ResetPlane{reset_data[q], reset_kind[q], reset_dtype[q]};
  }
  a.n_outs = n_outs;
  for (int q = 0; q < n_outs; ++q) {
    if (out_kind[q] < kAvg || out_kind[q] > kValue ||
        !valid_dtype(out_dtype[q]) ||
        (out_kind[q] == kAvg && out_dtype[q] != kF32 && out_dtype[q] != kF64))
      return (int)cudaErrorInvalidValue;
    a.outs[q] = OutCol{out_src[q], out_data[q], out_kind[q], out_dtype[q]};
  }
  a.okey = (long long*)okey;
  a.ostart = (long long*)ostart;
  a.oend = (long long*)oend;
  a.ocount = (long long*)ocount;
  a.dirty = (uint8_t*)dirty;
  a.dirty_shift = dirty_shift;
  a.counts = (long long*)counts;
  a.n_tiles = (a.entries + kTile - 1) / kTile;
  a.status = (unsigned long long*)scratch;
  a.tile_counter = (unsigned int*)((unsigned long long*)scratch + a.n_tiles);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, (size_t)(a.n_tiles + 1) * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  session_fire_kernel<<<(unsigned)a.n_tiles, kFireThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* session_window_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
