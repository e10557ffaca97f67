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
// lane each segment folds into, cur_lane where it changes and one dirty
// byte. The fire
// reads the [L, capacity] open plane, the end cell of every open lane,
// and for each fired lane its key, start, count and aggregates; it writes
// the outputs and the identities back.
//
// The step's sector floor. The [L, capacity] planes put a key's lanes in
// L planes apart, so a key's cells share no 32-byte sector. A key already
// in the table touches its table sector, the open sector of each of its L
// lanes, its cur_lane sector, the start and end sectors of each open lane
// and the start, end and count sectors (and one per aggregate plane) of
// the lane it folds into: with 4 lanes and no aggregate, 9 sectors when
// it merges into its one open lane, 11 when it opens a second lane beside
// it. A key new to the table touches its table sector, the start, end,
// open and count sectors of one lane and its cur_lane sector: 6 (the
// dirty bitmap stays in L2). Each written sector is written in part, so
// device memory reads it and writes it back: at Q11-10M some 10.6 to 11
// sector transfers a key, 0.053 to 0.055 ms for a 2^19-row batch at 3.35
// TB/s, five times the bytes bound, which counts 8-byte cells and not
// sectors (chip_smoke.py's step_sectors counts them from the batch).
//
// Step design: one thread per KEY RUN. The batch arrives sorted by (key,
// ts), so a key's rows are one contiguous run, and every decision of the
// reference program is local to a key: its segments, the ordinal of each
// new segment among the key's allocations, whether a segment is the key's
// last, the lanes it merges into. The thread at the head of a run (the
// row whose predecessor has another key) probes once for the key, reads
// the key's lanes into registers BEFORE it writes anything (the merge
// checks and the free-lane rotation read the lanes as they stood before
// the batch, as the reference's gathers do), walks the run in order, and
// folds each segment's totals into its lane; the lanes of a slot belong
// to one key, so no other thread touches them. The reads are cut to the
// rounds the probe allows:
//  * a key whose probe claimed its slot from EMPTY has lanes that were
//    never written: every lane free at the identities, cur_lane 0. Its
//    thread reads no lane at all.
//  * a key already present issues its L open loads and its cur_lane load
//    together, then the start and end loads of its open lanes.
// The writes need no read: a lane that is not open holds the identities
// its plane started with or a fire reset it to (tests/
// test_torch_session_edges.py holds that invariant), and those agree for
// every plane but a float min or max plane (largest finite against inf;
// cell 0 may hold either, see fold_cell0), so a segment that takes a
// free lane stores its totals (identity (+) total for an aggregate)
// outright. A segment that merges into an open lane folds start, end,
// count and its integer aggregates with atomic
// reductions whose result nobody waits for (two segments of one key may
// merge into one lane); a float aggregate, and a float min or max into a
// free lane, is read and written back. Specialized on the lane count and
// on whether there are aggregate planes, so the count-only path carries
// no fold registers. A hot key's run is walked serially (a run of R rows
// takes R steps of one thread). Settled segments go to the emit buffers
// at positions from one atomicAdd each (they are rare: they need end + 2
// gap behind the fired boundary), so the buffers fill in atomic order,
// not batch order. The late and dropped counts go to their int64 counters
// with one atomic per thread that has any.
//
// Fire design: one pass with decoupled look-back. A block takes the next
// tile (an atomic tile counter, so tiles start in order and a block only
// waits on tiles that already started): 16384 lanes, 2048 to a warp in
// four spans of 512, from 2^24 lanes on; 4096, one span a warp, below,
// so a small state's tiles still spread over the SMs. Every load and
// store of the planes is a 16-byte vector a thread and 512 contiguous
// bytes a warp: the open bytes of 16 lanes a thread, staged in shared
// memory; the 8-byte planes 2 lanes a thread in groups of 64, so two
// neighbouring threads share a 32-byte sector. The scan reads open, then
// the end cells of each sector that holds an open lane, a span's loads
// all issued before any is used, and keeps only the due bits (64
// registers a thread, four blocks to an SM: a fire that finds few lanes
// due is a scan, all latency, so the loads in flight are what it needs).
// The block's look-back reads the status of the 256 tiles before it at
// once (thread k reads tile - 1 - k), round after round, until one has
// published its inclusive prefix; flag and value share one 64-bit word,
// so a reader never sees one without the other. A block of 256 readers,
// not a warp of 32, lets the published prefixes keep up with the tiles.
// Then each warp ranks its due lanes in lane-major order by ballot and
// popc, group by group; a due lane whose row is below the capacity is
// written to the outputs with streaming stores, in rows consecutive
// across the warp, and reset: each 32-byte sector of each plane that
// holds a fired lane is read and written whole (start, end and count
// read together), the lanes that do not fire keeping their values
// (nothing else touches the planes during the fire, on the stream). A
// warp with nothing due, or past the capacity (an overflowing round's
// tail), reads only open and end, which it needs for the count. Lanes
// past the capacity stay open for the next round, as in the reference;
// fired slots mark their dirty blocks. The last tile writes [fired,
// overflow].
//
// The fire's sector floor: the open plane, the end sectors that hold an
// open lane, and for each fired lane the sectors of its table cell and of
// its start, end, open, count and aggregate cells, read and written
// whole, plus the outputs (chip_smoke.py's fire_sectors). At [4, 2^24]
// with half the lanes due, every sector holds a due lane, so the floor
// (0.77 ms) is above the bytes bound (0.55 ms), which counts cells.
#include <cstdint>
#include <cuda_runtime.h>

#include "probe.cuh"

namespace {

using probe_table::kEmpty;
using probe_table::probe_claim;

constexpr int kMaxFolds = 8;
constexpr int kMaxOuts = 16;
constexpr int kStepThreads = 256;
constexpr int kFireThreads = 256;
constexpr int kFireWarps = kFireThreads / 32;
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

__device__ __forceinline__ bool wide(int dtype) {
  return dtype == kI64 || dtype == kF64;
}

// A value travels as its bits in 64 bits, in its plane's dtype.
__device__ __forceinline__ unsigned long long load_raw(const void* p,
                                                       int dtype,
                                                       long long i) {
  if (wide(dtype))
    return __ldg(static_cast<const unsigned long long*>(p) + i);
  return __ldg(static_cast<const unsigned int*>(p) + i);
}

// the same, coherent with this kernel's own stores
__device__ __forceinline__ unsigned long long load_cg(const void* p,
                                                      int dtype,
                                                      long long i) {
  if (wide(dtype))
    return __ldcg(static_cast<const unsigned long long*>(p) + i);
  return __ldcg(static_cast<const unsigned int*>(p) + i);
}

__device__ __forceinline__ void store_raw(void* p, int dtype, long long i,
                                          unsigned long long raw) {
  if (wide(dtype))
    static_cast<unsigned long long*>(p)[i] = raw;
  else
    static_cast<unsigned int*>(p)[i] = (unsigned int)raw;
}

__device__ __forceinline__ void stream_raw(void* p, int dtype, long long i,
                                           unsigned long long raw) {
  if (wide(dtype))
    __stcs(static_cast<unsigned long long*>(p) + i, raw);
  else
    __stcs(static_cast<unsigned int*>(p) + i, (unsigned int)raw);
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

// The identity a fire resets a plane of `kind` to (float min and max to
// +-inf, as the reference's fire does).
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

// A free lane's cell of this plane is known without a read: its fresh
// and reset identities agree (all but a float min or max plane).
__device__ __forceinline__ bool identity_known(int kind, int dtype) {
  return kind == kSum || dtype == kI64 || dtype == kI32;
}

// cell op= v as an atomic reduction nobody waits for (integer planes)
__device__ __forceinline__ void reduce_int(void* p, int dtype, int kind,
                                           long long i,
                                           unsigned long long v) {
  if (dtype == kI64) {
    if (kind == kSum)
      atomicAdd(static_cast<unsigned long long*>(p) + i, v);
    else if (kind == kMin)
      atomicMin(static_cast<long long*>(p) + i, (long long)v);
    else
      atomicMax(static_cast<long long*>(p) + i, (long long)v);
  } else {
    if (kind == kSum)
      atomicAdd(static_cast<unsigned int*>(p) + i, (unsigned int)v);
    else if (kind == kMin)
      atomicMin(static_cast<int*>(p) + i, (int)(unsigned)v);
    else
      atomicMax(static_cast<int*>(p) + i, (int)(unsigned)v);
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
template <bool FOLDS>
struct Segment {
  long long start, end, count;
  unsigned long long vals[FOLDS ? kMaxFolds : 1];
  int merge_lane;  // -1: the anchor merges into no open lane
};

// The reference's classification of a closed segment (device_session.py
// :176-224): settled segments that neither merge nor are their key's last
// are emitted; every other takes a lane, an allocating one the
// (ordinal + 1)-th free lane of the rotation from cur_lane + 1. Returns
// the lane it folded into, or -1.
template <bool FOLDS>
__device__ __forceinline__ int close_segment(
    const StepArgs& a, const Segment<FOLDS>& s, bool is_last, long long key,
    long long slot, unsigned long long open_mask, int cl, int& ordinal,
    unsigned long long& dropped) {
  const int n_folds = FOLDS ? a.n_folds : 0;
  const bool merge = s.merge_lane >= 0;
  const bool settled = wadd(s.end, 2 * a.gap) <= a.fired_boundary;
  if (!merge && !is_last && settled) {
    const unsigned long long pos = atomicAdd(a.n_emit, 1ull);
    a.ekey[pos] = key;
    a.estart[pos] = s.start;
    a.eend[pos] = s.end;
    a.ecount[pos] = s.count;
    for (int q = 0; q < n_folds; ++q)
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
  if (merge) {  // open is 1 already
    atomicMin(a.start + idx, s.start);
    atomicMax(a.end + idx, s.end);
    atomicAdd(reinterpret_cast<unsigned long long*>(a.count) + idx,
              (unsigned long long)s.count);
  } else {  // a free lane at the identities
    a.start[idx] = s.start;
    a.end[idx] = s.end;
    a.open[idx] = 1;
    a.count[idx] = s.count;
  }
  for (int q = 0; q < n_folds; ++q) {
    const FoldPlane& f = a.folds[q];
    const bool is_int = f.dtype == kI64 || f.dtype == kI32;
    if (merge && is_int) {
      reduce_int(f.data, f.dtype, f.kind, idx, s.vals[q]);
    } else {
      const unsigned long long cur =
          !merge && identity_known(f.kind, f.dtype)
              ? reset_bits(f.kind, f.dtype)
              : load_cg(f.data, f.dtype, idx);
      store_raw(f.data, f.dtype, idx,
                combine(cur, s.vals[q], f.kind, f.dtype));
    }
  }
  return lane;
}

// The reference folds every row that takes no lane (a follower of a
// segment, a late or dropped row, an emitted segment) into flat cell 0 of
// each aggregate plane as the plane's identity (device_session.py:205-223,
// through flink_tpu/ops/segment_ops.py::scatter_fold). That changes a
// cell only in a float min or max plane, where a lane reset to +-inf
// becomes the largest finite value: folded here with a compare-and-swap,
// skipped once the cell holds it.
__device__ __forceinline__ void fold_cell0(const StepArgs& a) {
  for (int q = 0; q < a.n_folds; ++q) {
    const FoldPlane& f = a.folds[q];
    if (identity_known(f.kind, f.dtype)) continue;
    const bool lo = f.kind == kMax;
    if (f.dtype == kF32) {
      unsigned* p = static_cast<unsigned*>(f.data);
      const unsigned id = lo ? 0xFF7FFFFFu : 0x7F7FFFFFu;  // -+FLT_MAX
      unsigned cur = __ldcg(p);
      for (;;) {
        const unsigned nv = (unsigned)combine(cur, id, f.kind, kF32);
        if (nv == cur) break;
        const unsigned seen = atomicCAS(p, cur, nv);
        if (seen == cur) break;
        cur = seen;
      }
    } else {
      unsigned long long* p = static_cast<unsigned long long*>(f.data);
      const unsigned long long id =
          lo ? 0xFFEFFFFFFFFFFFFFull : 0x7FEFFFFFFFFFFFFFull;  // -+DBL_MAX
      unsigned long long cur = __ldcg(p);
      for (;;) {
        const unsigned long long nv = combine(cur, id, f.kind, kF64);
        if (nv == cur) break;
        const unsigned long long seen = atomicCAS(p, cur, nv);
        if (seen == cur) break;
        cur = seen;
      }
    }
  }
}

template <int LMAX, bool FOLDS>
__global__ void __launch_bounds__(kStepThreads)
session_step_kernel(StepArgs a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const long long key = sanitize(__ldg(a.keys + i));
  if (i > 0 && sanitize(__ldg(a.keys + i - 1)) == key) return;  // not a head
  const int n_folds = FOLDS ? a.n_folds : 0;
  bool fresh;
  const int slot =
      probe_claim(a.table, a.mask, (unsigned long long)key, true, fresh);
  unsigned long long late = 0, dropped = 0;
  long long rows = 0, to_lanes = 0;  // the run's rows, and those a lane took
  if (slot < 0) {
    // the insert failed: every row of the key counts as dropped
    long long r = i + 1;
    while (r < a.n && sanitize(__ldg(a.keys + r)) == key) ++r;
    dropped = (unsigned long long)(r - i);
    rows = r - i;
  } else {
    uint8_t* const dirty =
        a.dirty != nullptr ? a.dirty + (slot >> a.dirty_shift) : nullptr;
    // read now, stored last: most bytes are already 1
    const bool mark = dirty != nullptr && __ldcg(dirty) == 0;
    // the key's lanes as they stood before the batch; a slot this probe
    // claimed has none open and cur_lane 0
    long long os[LMAX], oe[LMAX];
    unsigned long long open_mask = 0;
    int cur = 0, cl = 0;
#pragma unroll
    for (int l = 0; l < LMAX; ++l) {
      os[l] = kI64Max;
      oe[l] = kI64Min;
    }
    if (!fresh) {
      signed char ob[LMAX];
#pragma unroll
      for (int l = 0; l < LMAX; ++l)
        ob[l] = l < a.lanes ? __ldcg(reinterpret_cast<const signed char*>(
                                  a.open) + (long long)l * a.cap + slot)
                            : 0;
      cur = __ldcg(a.cur_lane + slot);
#pragma unroll
      for (int l = 0; l < LMAX; ++l) {
        if (ob[l] > 0) {
          const long long idx = (long long)l * a.cap + slot;
          open_mask |= 1ull << l;
          os[l] = __ldcg(a.start + idx);
          oe[l] = __ldcg(a.end + idx);
        }
      }
      cl = cur % a.lanes;
      if (cl < 0) cl += a.lanes;
    }
    Segment<FOLDS> seg;
    bool have = false, prev_late = false;
    long long prev_ts = 0;
    int ordinal = 0;
    for (long long r = i; r < a.n; ++r) {
      if (r > i && sanitize(__ldg(a.keys + r)) != key) break;
      ++rows;
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
        if (have)
          to_lanes += close_segment<FOLDS>(a, seg, false, key, slot,
                                           open_mask, cl, ordinal,
                                           dropped) >= 0;
        seg.start = t;
        seg.end = t;
        seg.count = 1;
        seg.merge_lane = ml;
        for (int q = 0; q < n_folds; ++q)
          seg.vals[q] = load_raw(a.folds[q].values, a.folds[q].dtype, r);
        have = true;
      } else {
        if (t < seg.start) seg.start = t;
        if (t > seg.end) seg.end = t;
        ++seg.count;
        for (int q = 0; q < n_folds; ++q)
          seg.vals[q] = combine(
              seg.vals[q], load_raw(a.folds[q].values, a.folds[q].dtype, r),
              a.folds[q].kind, a.folds[q].dtype);
      }
      prev_late = false;
      prev_ts = t;
    }
    if (have) {
      const int lane = close_segment<FOLDS>(a, seg, true, key, slot,
                                            open_mask, cl, ordinal, dropped);
      if (lane >= 0 && lane != cur) a.cur_lane[slot] = lane;
      to_lanes += lane >= 0;
    }
    if (mark) *dirty = 1;
  }
  if (FOLDS && rows != to_lanes) fold_cell0(a);
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

// The fire's lanes: a warp takes 1 or 4 spans of 512 lanes. A thread
// reads the open bytes of 16 consecutive lanes of a span (one 16-byte
// load, the warp's 512 bytes whole); the 8-byte planes go in groups of 64
// lanes, a thread's 2 consecutive lanes one 16-byte vector, the warp's
// 512 bytes whole; two neighbouring threads share a 32-byte sector.
constexpr int kSpanLanes = 512;
constexpr int kGroups = kSpanLanes / 64;  // groups of 64 lanes a span

// Spans a warp takes: 4 (tiles of 16384 lanes) where that still leaves
// 1024 tiles, about two waves of the resident blocks, else 1 (tiles of
// 4096), so a small state's tiles still spread over the SMs. Entries of
// 2^24 and more are a multiple of 16384 (a power-of-two capacity of at
// least 2^18 times the lanes).
int fire_spans(long long entries) {
  return entries >= (1ll << 24) ? 4 : 1;
}

long long fire_tile(long long entries) {
  return (long long)fire_spans(entries) * kSpanLanes * kFireWarps;
}

// The 16 bytes of lanes (e, e + 1) of an 8-byte plane, or those of them
// inside the plane.
__device__ __forceinline__ ulonglong2 load_pair(const unsigned long long* p,
                                                long long e,
                                                long long entries) {
  if (e + 2 <= entries)
    return *reinterpret_cast<const ulonglong2*>(p + e);
  return make_ulonglong2(e < entries ? p[e] : 0ull, 0ull);
}

__device__ __forceinline__ void store_pair(unsigned long long* p, long long e,
                                           long long entries, ulonglong2 v) {
  if (e + 2 <= entries)
    *reinterpret_cast<ulonglong2*>(p + e) = v;
  else if (e < entries)
    p[e] = v.x;
}

// Lanes (e, e + 1) of an 8-byte plane, the fired ones (bits 0 and 1 of
// `f`) set to `bits`: the thread's 16 bytes read and written whole.
__device__ __forceinline__ void reset_pair(unsigned long long* p, long long e,
                                           long long entries, unsigned f,
                                           unsigned long long bits) {
  ulonglong2 v = load_pair(p, e, entries);
  if (f & 1u) v.x = bits;
  if (f & 2u) v.y = bits;
  store_pair(p, e, entries, v);
}

template <int kFireSpans>
__global__ void __launch_bounds__(kFireThreads, 4)
session_fire_kernel(FireArgs a) {
  constexpr int kWarpLanes = kFireSpans * kSpanLanes;
  constexpr long long kTile = (long long)kWarpLanes * kFireWarps;
  __shared__ uint4 open_s[kFireSpans * kFireThreads];  // the tile's open
  __shared__ unsigned warp_due[kFireWarps];
  __shared__ unsigned fired_s[kFireWarps][kFireSpans * kGroups];
  __shared__ int warp_stop[kFireWarps];
  __shared__ unsigned long long warp_sum[kFireWarps];
  __shared__ long long tile_s, tile_base;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  if (tid == 0) tile_s = atomicAdd(a.tile_counter, 1u);
  __syncthreads();
  const long long tile = tile_s;
  const long long wbase = tile * kTile + (long long)warp * kWarpLanes;
  // open: 16 lanes a thread per span, staged in shared memory
#pragma unroll
  for (int m = 0; m < kFireSpans; ++m) {
    const long long eo = wbase + kSpanLanes * m + 16 * lane;
    uint4 ov;
    if (eo + 16 <= a.entries) {
      ov = __ldcs(reinterpret_cast<const uint4*>(a.open + eo));
    } else {
      unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (eo + j < a.entries)
          w[j >> 2] |= (unsigned)(uint8_t)a.open[eo + j] << (8 * (j & 3));
      ov = make_uint4(w[0], w[1], w[2], w[3]);
    }
    open_s[(warp * kFireSpans + m) * 32 + lane] = ov;
  }
  __syncwarp();
  const unsigned char* ob =
      reinterpret_cast<const unsigned char*>(open_s + warp * kFireSpans * 32);
  // the end of each sector that holds an open lane; the due lanes, bits
  // (2 g, 2 g + 1) for group g = 8 m + k
  unsigned long long due = 0;
#pragma unroll
  for (int m = 0; m < kFireSpans; ++m) {
    // a span's loads all issued before any is used
    ulonglong2 v[kGroups];
    unsigned opened = 0;
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const int j = kSpanLanes * m + 64 * k + 2 * lane;
      opened |= ((signed char)ob[j] > 0 ? 1u : 0u) << (2 * k);
      opened |= ((signed char)ob[j + 1] > 0 ? 2u : 0u) << (2 * k);
      v[k] = (opened >> (2 * k)) & 3u
                 ? load_pair(reinterpret_cast<const unsigned long long*>(
                                 a.end),
                             wbase + j, a.entries)
                 : make_ulonglong2(0ull, 0ull);
    }
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const bool d0 = ((opened >> (2 * k)) & 1u) &&
                      wadd((long long)v[k].x, a.gap) <= a.boundary;
      const bool d1 = ((opened >> (2 * k)) & 2u) &&
                      wadd((long long)v[k].y, a.gap) <= a.boundary;
      due |= (unsigned long long)((d0 ? 1u : 0u) | (d1 ? 2u : 0u))
             << (2 * (kGroups * m + k));
    }
  }
  const unsigned seen = __reduce_add_sync(kFull, (unsigned)__popcll(due));
  if (lane == 0) warp_due[warp] = seen;
  __syncthreads();
  unsigned before_warp = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kFireWarps; ++w) {
    const unsigned v = warp_due[w];
    before_warp += w < warp ? v : 0u;
    total += v;
  }
  // decoupled look-back by the whole block: thread k reads the status of
  // tile - 1 - k, 256 predecessors per round, until one of them has
  // published its inclusive prefix
  volatile unsigned long long* st = a.status;
  if (tile == 0) {
    if (tid == 0) {
      st[0] = kFlagPrefix | total;
      tile_base = 0;
    }
  } else {
    if (tid == 0) st[tile] = kFlagAggregate | total;
    unsigned long long before = 0;
    for (long long j0 = tile - 1;; j0 -= kFireThreads) {
      const long long j = j0 - tid;
      unsigned long long v = kFlagPrefix;  // before tile 0: a prefix of 0
      if (j >= 0) {
        do {
          v = st[j];
        } while ((v >> 62) == 0ull);  // not published yet
      }
      const unsigned prefixes = __ballot_sync(kFull, (v >> 62) == 2ull);
      if (lane == 0)
        warp_stop[warp] = prefixes ? 32 * warp + __ffs(prefixes) - 1
                                   : kFireThreads;
      __syncthreads();
      int stop = kFireThreads;
#pragma unroll
      for (int w = 0; w < kFireWarps; ++w)
        stop = warp_stop[w] < stop ? warp_stop[w] : stop;
      unsigned long long part = tid <= stop ? (v & kValueMask) : 0ull;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        part += __shfl_down_sync(kFull, part, o);
      if (lane == 0) warp_sum[warp] = part;
      __syncthreads();
#pragma unroll
      for (int w = 0; w < kFireWarps; ++w) before += warp_sum[w];
      __syncthreads();  // warp_stop and warp_sum are read before reuse
      if (stop < kFireThreads) break;
    }
    if (tid == 0) {
      st[tile] = kFlagPrefix | (before + total);
      tile_base = (long long)before;
    }
  }
  __syncthreads();
  if (tid == 0 && tile == a.n_tiles - 1) {
    const long long all = tile_base + (long long)total;
    const long long fired = all < a.cap ? all : a.cap;
    a.counts[0] = fired;
    a.counts[1] = all - fired;
  }
  const long long wrow = tile_base + before_warp;
  // a warp with nothing due, or past the capacity (an overflowing
  // round's tail), is done
  if (wrow >= a.cap || seen == 0) return;
  unsigned char* obw = reinterpret_cast<unsigned char*>(
      open_s + warp * kFireSpans * 32);
  unsigned row = 0;  // due lanes of the warp before this group
  long long last_block = -1;
#pragma unroll 2
  for (int g = 0; g < kFireSpans * kGroups; ++g) {
    const unsigned d = (unsigned)(due >> (2 * g)) & 3u;
    const unsigned b0 = __ballot_sync(kFull, d & 1u);
    const unsigned b1 = __ballot_sync(kFull, d & 2u);
    const long long row0 = wrow + row + __popc(b0 & lt) + __popc(b1 & lt);
    const long long row1 = row0 + (d & 1u);
    row += __popc(b0) + __popc(b1);
    const unsigned f = ((d & 1u) && row0 < a.cap ? 1u : 0u) |
                       ((d & 2u) && row1 < a.cap ? 2u : 0u);
    const bool sector = (f | __shfl_xor_sync(kFull, f, 1)) != 0u;
    const unsigned fired = __ballot_sync(kFull, f != 0u);
    if (lane == 0) fired_s[warp][g] = fired;
    if (!fired) continue;
    const long long e = wbase + 64 * g + 2 * lane;
    // outputs of the aggregate planes, before the lanes are reset
    for (int q = 0; q < a.n_outs; ++q) {
      const OutCol& o = a.outs[q];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (!((f >> i) & 1u)) continue;
        const long long r = i ? row1 : row0;
        const unsigned long long raw = load_cg(o.src, o.dtype, e + i);
        if (o.kind == kAvg) {
          const long long cnt = __ldcg(a.count + e + i);
          const long long dv = cnt > 1 ? cnt : 1;
          if (o.dtype == kF64)
            __stcs(static_cast<double*>(o.out) + r,
                   __longlong_as_double((long long)raw) / (double)dv);
          else
            __stcs(static_cast<float*>(o.out) + r,
                   __uint_as_float((unsigned)raw) / (float)dv);
        } else {
          stream_raw(o.out, o.dtype, r, raw);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!((f >> i) & 1u)) continue;
      const long long slot = (e + i) & (a.cap - 1);
      __stcs(a.okey + (i ? row1 : row0), __ldg(a.table + slot));
      const long long b = slot >> a.dirty_shift;
      if (a.dirty != nullptr && b != last_block && __ldcg(a.dirty + b) == 0)
        a.dirty[b] = 1;
      last_block = b;
      obw[64 * g + 2 * lane + i] = 0;
    }
    if (sector) {
      // start, end and count read together, then written: output, reset
      unsigned long long* sp = reinterpret_cast<unsigned long long*>(a.start);
      unsigned long long* ep = reinterpret_cast<unsigned long long*>(a.end);
      unsigned long long* cp = reinterpret_cast<unsigned long long*>(a.count);
      ulonglong2 sv = load_pair(sp, e, a.entries);
      ulonglong2 ev = load_pair(ep, e, a.entries);
      ulonglong2 cv = load_pair(cp, e, a.entries);
      if (f & 1u) {
        __stcs(a.ostart + row0, (long long)sv.x);
        __stcs(a.oend + row0, (long long)ev.x);
        __stcs(a.ocount + row0, (long long)cv.x);
        sv.x = (unsigned long long)kI64Max;
        ev.x = (unsigned long long)kI64Min;
        cv.x = 0ull;
      }
      if (f & 2u) {
        __stcs(a.ostart + row1, (long long)sv.y);
        __stcs(a.oend + row1, (long long)ev.y);
        __stcs(a.ocount + row1, (long long)cv.y);
        sv.y = (unsigned long long)kI64Max;
        ev.y = (unsigned long long)kI64Min;
        cv.y = 0ull;
      }
      store_pair(sp, e, a.entries, sv);
      store_pair(ep, e, a.entries, ev);
      store_pair(cp, e, a.entries, cv);
    }
    for (int q = 0; q < a.n_resets; ++q) {
      const ResetPlane& r = a.resets[q];
      const unsigned long long bits = reset_bits(r.kind, r.dtype);
      if (wide(r.dtype)) {
        if (sector)
          reset_pair(static_cast<unsigned long long*>(r.data), e, a.entries,
                     f, bits);
        continue;
      }
      // a 4-byte plane's sector spans four threads
      if (!(__shfl_xor_sync(kFull, sector, 2) || sector)) continue;
      unsigned* p = static_cast<unsigned*>(r.data);
      if (e + 2 <= a.entries) {
        uint2 v = *reinterpret_cast<const uint2*>(p + e);
        if (f & 1u) v.x = (unsigned)bits;
        if (f & 2u) v.y = (unsigned)bits;
        *reinterpret_cast<uint2*>(p + e) = v;
      } else if (e < a.entries && (f & 1u)) {
        p[e] = (unsigned)bits;
      }
    }
  }
  // open: each thread writes its 16 bytes back whole where a lane of its
  // 32-byte sector fired (the 16 lanes of thread t of a span are those of
  // threads 8 (t % 4) to 8 (t % 4) + 7 in the span's group t / 4)
  __syncwarp();
#pragma unroll
  for (int m = 0; m < kFireSpans; ++m) {
    const unsigned fired = fired_s[warp][m * kGroups + (lane >> 2)];
    const bool changed = ((fired >> (8 * (lane & 3))) & 0xFFu) != 0u;
    if (!(__shfl_xor_sync(kFull, changed, 1) || changed)) continue;
    const uint4 nv = open_s[(warp * kFireSpans + m) * 32 + lane];
    const long long eo = wbase + kSpanLanes * m + 16 * lane;
    if (eo + 16 <= a.entries) {
      *reinterpret_cast<uint4*>(a.open + eo) = nv;
    } else {
      const unsigned char* nb = reinterpret_cast<const unsigned char*>(&nv);
      for (int j = 0; j < 16; ++j)
        if (eo + j < a.entries) a.open[eo + j] = (int8_t)nb[j];
    }
  }
}

template <int LMAX>
cudaError_t launch_step(const StepArgs& a, cudaStream_t s) {
  const unsigned blocks = (unsigned)((a.n + kStepThreads - 1) / kStepThreads);
  if (a.n_folds > 0)
    session_step_kernel<LMAX, true><<<blocks, kStepThreads, 0, s>>>(a);
  else
    session_step_kernel<LMAX, false><<<blocks, kStepThreads, 0, s>>>(a);
  return cudaGetLastError();
}

bool valid_dtype(int d) { return d >= kI64 && d <= kF64; }

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

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
  const long long tile = fire_tile(entries);
  return (int)((entries + tile - 1) / tile + 1);
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
// int64 words. The planes start on 16-byte boundaries.
// Returns cudaGetLastError.
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
      dirty_shift < 0 || dirty_shift > 30 || !aligned16(start) ||
      !aligned16(end) || !aligned16(open) || !aligned16(count))
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
        !valid_dtype(reset_dtype[q]) || !aligned16(reset_data[q]))
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
  const long long tile = fire_tile(a.entries);
  a.n_tiles = (a.entries + tile - 1) / tile;
  a.status = (unsigned long long*)scratch;
  a.tile_counter = (unsigned int*)((unsigned long long*)scratch + a.n_tiles);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, (size_t)(a.n_tiles + 1) * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  const int spans = fire_spans(a.entries);
  if (spans == 4)
    session_fire_kernel<4><<<(unsigned)a.n_tiles, kFireThreads, 0, s>>>(a);
  else
    session_fire_kernel<1><<<(unsigned)a.n_tiles, kFireThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* session_window_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
