// Device GROUP BY: one micro-batch of the changelog aggregation, folded
// into float64 accumulator planes of [capacity] slots.
//
// Replaces flink_tpu/sql/device_group_agg.py::_gagg_program, the one XLA
// program a batch ran on the TPU. Its steps need order across the grid
// (the previous values are read before any fold, the dead groups are known
// only after every fold, the groups come out in first-row order), so a
// batch is a schedule of launches on one stream:
//
//  1. group_agg_first_kernel: the first and the last row of each touched
//     slot, an atomicMin and an atomicMax of the row index into the two
//     int32 halves of the slot's entry of a persistent [capacity, 2]
//     scratch (rowpos; one 32-byte sector holds both; rows of a block meet
//     in shared memory first where they hold few slots). It holds (kNoRow,
//     kNoLast) everywhere between batches: a batch restores the entries it
//     touched, so it costs O(B). It also zeroes the compaction's look-back
//     words.
//  2. group_agg_compact_kernel: the first-occurrence rows, compacted in
//     batch order (the changelog's order) by a block scan of ballots and a
//     decoupled look-back over tiles taken from an atomic tile counter (as
//     hash_table.cu's spill form); the last tile writes the group count.
//     Each first row writes its row index and every plane's PREV value. A
//     group whose first row is also its last (its only row in the batch)
//     takes the whole step there: its planes are loaded once, folded, reset
//     if drained and stored, its NEW values written, its dirty block marked
//     and both scratches restored; its row is marked in a per-row byte
//     (single) that the fold and the emit skip. Any other group leaves its
//     position in its slot's first-row half as ~position (negative: no row
//     index equals it).
//  3. group_agg_fold_kernel: every other valid row folds into its slot: the
//     signed row count and each sum plane add (value * sign, or the sign
//     for a count plane), min and max planes fold the raw value and ignore
//     the sign (the reference's documented append-only degradation).
//  4. group_agg_emit_kernel: one thread a row that is its slot's last row
//     (of a group of more than one row): every plane's post-fold value
//     loaded, a drained group (count <= 0) reset to the identities (0,
//     +inf, -inf), the NEW values written at the position the first-row
//     half holds, the slot's dirty block marked and its scratch entry
//     restored.
//
// What bounds it on an H100: random 32-byte sectors. At 10M keys a batch of
// 2^19 rows touches 2^19 groups (every row its own group), each a sector
// in every plane, 128 MB apart, and in the row scratch. Run as separate
// stages, the compaction, the fold and the emit each fetched those sectors
// from device memory again. Cutting the batch into ranges of rows, each
// range's stages run in turn, keeps a range's groups in the 50 MB L2 only
// while the range is small (a group holds a 128-byte line in each plane and
// in the row scratch, 8 lines at 7 planes), and the small ranges' launches
// cost more than the L2 saved (tools/gagg_designs.py). So a group of one
// row in the batch (every group at 10M keys) is finished by its compaction
// thread: its sectors are fetched once, folded by the fold's own atomics
// while in L2, and its row is skipped by the fold and the emit. For the
// atomics to find the lines still in L2, the compaction's blocks walk the
// tiles with few threads in flight where the planes exceed L2
// (kCompactBlocksPerSM): 2^15 groups' lines, 34 MB, at one block an SM.
//
// At few groups (TPC-H Q1's 6) the atomics contend instead. Rows of one
// slot inside a warp are combined first (__match_any_sync on the slot,
// then a shuffle tree over the peers); a tile whose warps hold few peer
// sets in all (by a block-wide count of the warps' leaders) then folds
// them into a small slot-keyed table in shared memory, and the block
// issues one global atomic per table entry and plane at its end. A fold
// block walks several tiles, so TPC-H's fold issues a few atomics per
// block where it issued some per warp. An all-distinct tile skips the
// table. float64 min and max have no native atomic: a CAS loop
// folds with the reference's semantics (NaN wins, -0.0 below +0.0), which
// XLA's scatter-min and scatter-max on the CPU were measured to follow.
//
// The plain PyTorch version of every stage is in ops/group_agg.py.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPlanes = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoRow = 0x7fffffff;  // first row of an untouched slot
constexpr int kNoLast = -1;         // last row of an untouched slot
// look-back words: flag in the top two bits, value below
constexpr unsigned long long kFlagAggregate = 1ull << 62;
constexpr unsigned long long kFlagPrefix = 2ull << 62;
constexpr unsigned long long kValueMask = (1ull << 62) - 1;
// the fold's pre-fold table: entries (slots) a block holds; a tile takes
// the table when its warps hold at most kPreFoldLeads peer sets in all
constexpr int kTable = 64;
constexpr int kPreFoldLeads = 64;
constexpr int kFirstPreFoldLeads = 64;  // the same for the first rows
static_assert(kTable == 64, "table_entry hashes a slot to 6 bits");
constexpr int kFoldBlocksPerSM = 8;  // fold blocks walk the tiles
// The compaction's blocks: a block a tile while the planes and the row
// scratch fit in kL2Budget bytes of the 50 MB L2; else kCompactBlocksPerSM
// an SM walking the tiles, chosen from tools/gagg_designs.py's sweep.
constexpr long long kL2Budget = 40ll << 20;
constexpr double kCompactBlocksPerSM = 1.0;
constexpr int kEmitChunk = 16;  // plane loads an emit thread issues together
constexpr int kFirstChunk = 8;  // and a compaction thread

enum Kind { kSum = 0, kMin = 1, kMax = 2 };
enum Stage { kFirst = 0, kCompact = 1, kFold = 2, kEmit = 3, kStep = 4 };

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
  int2* rowpos;                // [capacity]: first row, last row
  unsigned char* single;       // [n]: 1 where the compaction took the row
  unsigned char* dirty;        // [blocks + 1] or null
  int dirty_shift;
  int* row_idx;                // [n] out: the groups' first rows
  double* comp;                // [n, 2 * n_planes] out: PREV, then NEW
  long long* n_groups;         // out
  unsigned long long* status;  // [n_tiles] look-back words, then the
                               // tile counter
  long long n_tiles;           // look-back tiles of the batch
  long long status_words;      // look-back words and the counter
};

__host__ __device__ long long tiles_of(long long rows) {
  return (rows + kThreads - 1) / kThreads;
}

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

// the pre-fold table's starting value: -0.0 is the identity of every sum
// (+0.0 would turn a sum of -0.0 into +0.0)
template <int K>
__device__ __forceinline__ double table_identity() {
  if (K == kSum) return __longlong_as_double(0x8000000000000000ll);
  if (K == kMin) return pos_inf();
  return -pos_inf();
}

__device__ __forceinline__ double identity_of(int kind) {
  if (kind == kMin) return pos_inf();
  if (kind == kMax) return -pos_inf();
  return 0.0;
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

// addr = combine(addr, v) atomically, in global or shared memory
template <int K>
__device__ __forceinline__ void atomic_fold(double* addr, double v) {
  if (K == kSum) {
    atomicAdd(addr, v);
    return;
  }
  unsigned long long* p = reinterpret_cast<unsigned long long*>(addr);
  unsigned long long old =
      *reinterpret_cast<volatile unsigned long long*>(p);
  while (true) {
    const unsigned long long want =
        __double_as_longlong(combine<K>(__longlong_as_double(old), v));
    if (want == old) return;
    const unsigned long long seen = atomicCAS(p, old, want);
    if (seen == old) return;
    old = seen;
  }
}

__device__ __forceinline__ void atomic_fold_kind(int kind, double* addr,
                                                 double v) {
  if (kind == kSum)
    atomic_fold<kSum>(addr, v);
  else if (kind == kMin)
    atomic_fold<kMin>(addr, v);
  else
    atomic_fold<kMax>(addr, v);
}

// The entry of slot s in the block's table, claimed if new; -1 when the
// table is full (the caller folds into the planes directly).
__device__ __forceinline__ int table_entry(int* keys, int s) {
  const unsigned h = ((unsigned)s * 0x9E3779B1u) >> 26;  // 64 entries
  for (int k = 0; k < kTable; ++k) {
    const int e = (int)((h + k) & (kTable - 1));
    const int seen = *reinterpret_cast<volatile int*>(keys + e);
    if (seen == s) return e;
    if (seen == -1) {
      const int won = atomicCAS(keys + e, -1, s);
      if (won == -1 || won == s) return e;
    }
  }
  return -1;
}

// What row i folds into plane q: value * sign (the sign for a count
// plane) into a sum, the raw value into a min or max.
template <int K>
__device__ __forceinline__ double row_value(const Args& a, int q, long long i,
                                            double sg) {
  const int c = a.col[q];
  if (K == kSum) return c < 0 ? sg : __ldg(a.vals + c * a.n + i) * sg;
  return __ldg(a.vals + c * a.n + i);
}

// One plane's fold of a tile: the warp's peer sets combined, then each
// set's leader folds into the table entry e (>= 0) or the plane.
template <int K>
__device__ __forceinline__ void fold_plane(const Args& a, double* table,
                                           int q, int s, long long i,
                                           double sg, unsigned peers,
                                           int lane, bool lead, int e) {
  double v = s < 0 ? (K == kSum ? 0.0 : K == kMin ? pos_inf() : -pos_inf())
                   : row_value<K>(a, q, i, sg);
  v = reduce_peers<K>(peers, lane, v);
  if (!lead) return;
  if (e >= 0)
    atomic_fold<K>(table + e * a.n_planes + q, v);
  else
    atomic_fold<K>(a.planes[q] + s, v);
}

// The stages' bodies, one block's share each (a persistent schedule can
// call them in loops); the kernels below run one a block.

// The first and the last row of each slot of rows i of a block (the whole
// block calls it). Where the block's warps hold few peer sets in all, as
// in the fold, they meet in a table in shared memory first, and the block
// issues one atomicMin and one atomicMax per entry.
__device__ __forceinline__ void first_rows(const Args& a, long long i) {
  __shared__ int keys[kTable], lo[kTable], hi[kTable];
  const int tid = threadIdx.x, lane = tid & 31;
  const int s = row_slot(a, i);
  const unsigned peers = slot_peers(s, lane);
  // the set's lowest lane holds its smallest row index, its highest the
  // largest
  const bool first = s >= 0 && lane == __ffs(peers) - 1;
  const bool last = s >= 0 && lane == 31 - __clz(peers);
  const bool prefold = __syncthreads_count(first) <= kFirstPreFoldLeads;
  if (prefold) {
    if (tid < kTable) {
      keys[tid] = -1;
      lo[tid] = kNoRow;
      hi[tid] = kNoLast;
    }
    __syncthreads();
  }
  const int e = prefold && (first || last) ? table_entry(keys, s) : -1;
  if (first) atomicMin(e >= 0 ? lo + e : &a.rowpos[s].x, (int)i);
  if (last) atomicMax(e >= 0 ? hi + e : &a.rowpos[s].y, (int)i);
  if (!prefold) return;
  __syncthreads();
  if (tid < kTable && keys[tid] >= 0) {
    atomicMin(&a.rowpos[keys[tid]].x, lo[tid]);
    atomicMax(&a.rowpos[keys[tid]].y, hi[tid]);
  }
  __syncthreads();  // the table is free for the block's next rows
}

// Row i, the only row of its group in the batch, folded into plane q at
// slot s, whose value before was prev: the plane is updated by the fold
// kernel's own atomics (the line is in L2 since prev's load; measured
// faster than a store, tools/gagg_designs.py), and the value after is
// returned. No other thread touches the slot, so they agree.
__device__ __forceinline__ double fold_one(const Args& a, int q, int s,
                                           long long i, double sg,
                                           double prev) {
  const int kind = a.kind[q];
  double* cell = a.planes[q] + s;
  if (kind == kSum) {
    const double v = row_value<kSum>(a, q, i, sg);
    atomicAdd(cell, v);
    return prev + v;
  }
  const double v = row_value<kMin>(a, q, i, sg);
  atomic_fold_kind(kind, cell, v);
  return kind == kMin ? fold_min(prev, v) : fold_max(prev, v);
}

// The group at ``pos`` whose first row is i: its PREV values; and when i
// is also its last row (``single``), the whole step for it: the fold, a
// drained group reset, NEW, the dirty block and both scratches restored.
// Otherwise its position is left in the first-row half for the emit.
__device__ __forceinline__ void first_of_group(const Args& a, int s,
                                               long long i, long long pos,
                                               bool single) {
  double* out = a.comp + pos * 2 * a.n_planes;
  const double sg = single ? __ldg(a.sign + i) : 0.0;
  bool dead = false;
  for (int q0 = 0; q0 < a.n_planes; q0 += kFirstChunk) {
    double v[kFirstChunk];
    // every load of the chunk issued before any is used
#pragma unroll
    for (int j = 0; j < kFirstChunk; ++j)
      if (q0 + j < a.n_planes) v[j] = __ldcg(a.planes[q0 + j] + s);
#pragma unroll
    for (int j = 0; j < kFirstChunk; ++j)
      if (q0 + j < a.n_planes) out[q0 + j] = v[j];
    if (!single) continue;
    if (q0 == 0) dead = v[0] + sg <= 0.0;  // plane 0 counts the sign
#pragma unroll
    for (int j = 0; j < kFirstChunk; ++j) {
      const int q = q0 + j;
      if (q < a.n_planes) {
        double x;
        if (dead) {
          x = identity_of(a.kind[q]);
          a.planes[q][s] = x;
        } else {
          x = fold_one(a, q, s, i, sg, v[j]);
        }
        out[a.n_planes + q] = x;
      }
    }
  }
  if (!single) {
    a.rowpos[s].x = ~(int)pos;  // the emit finds the group's row here
    return;
  }
  if (a.dirty != nullptr) a.dirty[s >> a.dirty_shift] = 1;
  a.rowpos[s] = make_int2(kNoRow, kNoLast);
}

// Compacts look-back tile ``tile`` (the whole block calls it; the caller
// took the tile from the counter, so tiles start in order). A
// group of one row in the batch is folded and emitted here, and its row
// is marked in ``single`` for the fold and the emit to skip.
__device__ __forceinline__ void compact_tile(const Args& a, long long tile) {
  __shared__ unsigned warp_count[kWarps];
  __shared__ int warp_stop[kWarps];
  __shared__ unsigned long long warp_sum[kWarps];
  __shared__ long long tile_base;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long i = tile * kThreads + tid;
  const int s = row_slot(a, i);
  const int2 fl = s >= 0 ? __ldcg(a.rowpos + s) : make_int2(kNoRow, kNoLast);
  const bool first = s >= 0 && fl.x == (int)i;
  const bool single = first && fl.y == (int)i;
  if (i < a.n) a.single[i] = single;
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
  const long long base = tile_base;
  if (tid == 0 && tile == a.n_tiles - 1) *a.n_groups = base + total;
  if (first) {
    const long long pos =
        base + (long long)(before_warp + __popc(ballot & ((1u << lane) - 1u)));
    a.row_idx[pos] = (int)i;
    first_of_group(a, s, i, pos, single);
  }
  __syncthreads();  // tile_base is read before the block's next tile
}

// Folds tiles t0, t0 + stride, ... (the whole block calls it
// with the same arguments), through the block's pre-fold table where a
// tile's peer sets are few.
__device__ __forceinline__ void fold_tiles(const Args& a, long long t0,
                                           long long stride) {
  extern __shared__ double table[];  // [kTable, n_planes]
  __shared__ int keys[kTable];
  const int tid = threadIdx.x, lane = tid & 31;
  const long long tiles = tiles_of(a.n);
  bool table_ready = false;  // the same in every thread of the block
  for (long long t = t0; t < tiles; t += stride) {
    const long long i = t * kThreads + tid;
    // the compaction folded the rows of one-row groups; both loads are
    // issued before either is used
    const int slot = row_slot(a, i);
    const bool taken = i < a.n && __ldcg(a.single + i);
    const int s = taken ? -1 : slot;
    const double sg = s >= 0 ? __ldg(a.sign + i) : 0.0;
    const unsigned peers = slot_peers(s, lane);
    const bool lead = s >= 0 && lane == __ffs(peers) - 1;
    const bool prefold = __syncthreads_count(lead) <= kPreFoldLeads;
    if (prefold && !table_ready) {
      for (int k = tid; k < kTable * a.n_planes; k += kThreads) {
        const int kind = a.kind[k % a.n_planes];
        table[k] = kind == kSum   ? table_identity<kSum>()
                   : kind == kMin ? table_identity<kMin>()
                                  : table_identity<kMax>();
      }
      if (tid < kTable) keys[tid] = -1;
      __syncthreads();
      table_ready = true;
    }
    const int e = prefold && lead ? table_entry(keys, s) : -1;
    // kind is the same for every lane: the shuffles stay warp-uniform
    for (int q = 0; q < a.n_planes; ++q) {
      const int kind = a.kind[q];
      if (kind == kSum)
        fold_plane<kSum>(a, table, q, s, i, sg, peers, lane, lead, e);
      else if (kind == kMin)
        fold_plane<kMin>(a, table, q, s, i, sg, peers, lane, lead, e);
      else
        fold_plane<kMax>(a, table, q, s, i, sg, peers, lane, lead, e);
    }
  }
  if (!table_ready) return;
  __syncthreads();
  // one atomic per entry and plane into the planes
  for (int k = tid; k < kTable * a.n_planes; k += kThreads) {
    const int s = keys[k / a.n_planes], q = k % a.n_planes;
    if (s >= 0) atomic_fold_kind(a.kind[q], a.planes[q] + s, table[k]);
  }
  __syncthreads();  // the table is read before the block's next use
}

// Emits row i's group if i is its slot's last row.
__device__ __forceinline__ void emit_row(const Args& a, long long i) {
  if (i >= a.n) return;
  // a row the compaction took was its group's only one, emitted there
  const bool taken = __ldcg(a.single + i);
  const int s = row_slot(a, i);
  if (s < 0 || taken) return;
  const int2 fl = __ldcg(a.rowpos + s);
  if (fl.y != (int)i) return;
  const long long pos = (long long)~fl.x;
  double* out = a.comp + pos * 2 * a.n_planes + a.n_planes;
  bool dead = false;
  for (int q0 = 0; q0 < a.n_planes; q0 += kEmitChunk) {
    double v[kEmitChunk];
    // every load of the chunk issued before any is used
#pragma unroll
    for (int j = 0; j < kEmitChunk; ++j)
      if (q0 + j < a.n_planes) v[j] = __ldcg(a.planes[q0 + j] + s);
    if (q0 == 0) dead = v[0] <= 0.0;
#pragma unroll
    for (int j = 0; j < kEmitChunk; ++j) {
      const int q = q0 + j;
      if (q < a.n_planes) {
        if (dead) {
          v[j] = identity_of(a.kind[q]);
          a.planes[q][s] = v[j];
        }
        out[q] = v[j];
      }
    }
  }
  if (a.dirty != nullptr) a.dirty[s >> a.dirty_shift] = 1;
  a.rowpos[s] = make_int2(kNoRow, kNoLast);
}

__global__ void __launch_bounds__(kThreads) group_agg_first_kernel(
    const Args a) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (long long j = i; j < a.status_words;
       j += (long long)gridDim.x * kThreads)
    a.status[j] = 0ull;
  first_rows(a, i);
}

// Compacts the batch's tiles, taken in row order from the counter until
// none is left (the whole block calls it).
__device__ __forceinline__ void compact_tiles(const Args& a) {
  __shared__ long long tile_s;
  unsigned* counter = reinterpret_cast<unsigned*>(a.status + a.n_tiles);
  while (true) {
    if (threadIdx.x == 0) tile_s = atomicAdd(counter, 1u);
    __syncthreads();
    const long long tile = tile_s;
    if (tile >= a.n_tiles) return;
    compact_tile(a, tile);  // ends in a barrier: tile_s is free again
  }
}

__global__ void __launch_bounds__(kThreads) group_agg_compact_kernel(
    const Args a) {
  compact_tiles(a);
}

__global__ void __launch_bounds__(kThreads) group_agg_fold_kernel(
    const Args a) {
  fold_tiles(a, blockIdx.x, gridDim.x);
}

__global__ void __launch_bounds__(kThreads) group_agg_emit_kernel(
    const Args a) {
  emit_row(a, (long long)blockIdx.x * kThreads + threadIdx.x);
}

}  // namespace

// Stages of a group aggregation step over n rows: stage 0 runs the
// first-occurrence kernel (and zeroes the look-back words), 1 the
// compaction, 2 the fold, 3 the emit, each over the whole batch; 4 runs the
// four in order, the whole step. A batch of no rows launches nothing.
// planes[n_planes] float64 [capacity] with kinds and value columns, slots
// [n] int32, sign [n] float64, vals [n_cols, n] float64, rowpos [capacity,
// 2] int32, single [n] bytes (written by the compaction, read by the fold
// and the emit), dirty [blocks + 1] bytes or null, row_idx [n] int32, comp
// [n, 2 * n_planes] float64, n_groups one int64, status
// group_agg_scratch_words(n) int64 words. Returns cudaGetLastError after
// the launches, or cudaErrorInvalidValue for more than kMaxPlanes planes.
extern "C" int group_agg_launch(int stage, void** planes, const int* kinds,
                                const int* cols, int n_planes,
                                long long capacity, const void* slots,
                                const void* sign, const void* vals,
                                long long n, long long n_valid, void* rowpos,
                                void* single, void* dirty, int dirty_shift,
                                void* row_idx, void* comp, void* n_groups,
                                void* status, void* stream) {
  if (n_planes < 1 || n_planes > kMaxPlanes || n_valid > n ||
      stage < kFirst || stage > kStep)
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
  a.rowpos = static_cast<int2*>(rowpos);
  a.single = static_cast<unsigned char*>(single);
  a.dirty = static_cast<unsigned char*>(dirty);
  a.dirty_shift = dirty_shift;
  a.row_idx = static_cast<int*>(row_idx);
  a.comp = static_cast<double*>(comp);
  a.n_groups = static_cast<long long*>(n_groups);
  a.n_tiles = tiles_of(n);
  a.status = static_cast<unsigned long long*>(status);
  a.status_words = a.n_tiles + 1;
  const unsigned tiles = (unsigned)a.n_tiles;
  const bool all = stage == kStep;
  cudaStream_t st = (cudaStream_t)stream;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (all || stage == kFirst)
    group_agg_first_kernel<<<tiles, kThreads, 0, st>>>(a);
  if (all || stage == kCompact) {
    long long blocks = tiles;
    if (capacity * (8ll * n_planes + 8) > kL2Budget) {
      const long long most = (long long)(kCompactBlocksPerSM * sms + 0.5);
      blocks = most < 1 ? 1 : most < blocks ? most : blocks;
    }
    group_agg_compact_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(a);
  }
  if (all || stage == kFold) {
    const unsigned most = (unsigned)(kFoldBlocksPerSM * sms);
    group_agg_fold_kernel<<<tiles < most ? tiles : most, kThreads,
                            (size_t)kTable * n_planes * sizeof(double),
                            st>>>(a);
  }
  if (all || stage == kEmit)
    group_agg_emit_kernel<<<tiles, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// int64 words of the look-back scratch for n rows: one word per tile of
// kThreads rows, and the tile counter.
extern "C" int group_agg_scratch_words(long long n) {
  return (int)((n + kThreads - 1) / kThreads + 1);
}

extern "C" const char* group_agg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
