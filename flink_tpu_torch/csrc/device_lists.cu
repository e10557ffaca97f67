// Device list state: per-key bounded row lists, the three programs of the
// interval join that use them, and a per-tile summary of the lists' event
// times that lets a prune skip what it cannot change.
//
// Replaces the XLA programs of flink_tpu/state/device_lists.py:
//  * list_append_launch: _append_prog (:44). Lookup-or-insert each key,
//    the stable in-batch rank of each row among the rows of its slot,
//    the packed row written at counts[slot] + rank when that is below L,
//    counts bumped by the rows that fit; list-full, insert-failed, the
//    keys inserted and the failed rows reported. XLA ranked by a stable
//    argsort of the whole batch by slot.
//  * list_probe_launch: _probe_slots (:77) and _probe_gather (:86) with
//    the operator's host mask (flink_tpu/sql/join.py:349-357). The
//    reference gathered [B, L_eff, C] candidate rows and brought them home
//    for the interval mask; here each key is looked up read-only, its live
//    rows whose ts lies in the row's [ts + lo_off, ts + hi_off] are
//    counted and only the matches are written, compacted in (batch row,
//    list position) order: np.nonzero's order.
//  * list_prune_launch: _prune_prog (:91). Per key, the stable partition
//    of its live rows into those with ts >= horizon first, the others
//    after them, as the reference's argsort(~keep, stable) leaves them.
//    The reference permuted the whole [capacity, L, C] block.
//
// Layout: table [capacity] int64 (probe.cuh), rows [capacity, L, C] int64
// (column 0 the row's event time, floats as their int64 bits), counts
// [capacity] int32, hits [capacity] int64: a scratch that is zero between
// launches; and the tile summary tiles [3, capacity / T] int64 of T slots
// a tile (T a power of two given by the tensors' shapes; the store's is
// 128): tiles[0] a lower and tiles[1] an upper bound on column 0 of every
// live row of the tile, tiles[2] its slots with a nonzero count, exact.
// An empty tile holds (int64 max, int64 min, 0).
//
// list_append: one cooperative launch (a thread a row, at most the blocks
// the card holds at once, walking the batch), grid-wide barriers between
// its phases.
//  1. Claim each row's slot (a CAS claims a new key's) and take its
//     arrival index with an atomic add on hits[slot]; after the barrier
//     hits[slot] is k, the slot's rows in the batch. "Inserted" rides in
//     the arrival word's top bit.
//  2. A slot of one row (every row on the Q7 cells: the MULT mixer gives
//     distinct auctions in a batch, a fire's maxes are unique) is finished
//     by it: row written at its count, count bumped, hits reset; a claimed
//     slot's count (0 before) is written unread and its row marked for
//     phase W. A slot of k > 1 rows takes a segment of k words, allocated
//     by its first arrival (hits[slot] = base << 32 | k), and its rows
//     join the duplicate list.
//  W. After the barrier, every claimed list is written once, whole, by 8
//     lanes (4 lists a warp at once): its row at position 0 (none for a
//     slot of k > 1 rows) and zeros after it, 16 bytes a lane, streamed
//     past L2 (st.global.cs) so that a fire's gigabytes of zeros do not
//     evict the table, hits and counts. Storing the row apart from its
//     zeros leaves partial sectors, read and written back.
//  3. Only when phase 2 found duplicates (a branch uniform over the grid):
//     each duplicate row writes its batch index into its slot's segment at
//     its arrival index; after a barrier (which also orders phase W's
//     zeros first) it counts the indices below its own there, its rank in
//     batch order (k loads a row, k^2 a slot; L bounds k unless the batch
//     overflows), and is written at count + rank below L; after a barrier
//     the first arrival bumps the count and resets hits.
//  The launch zeroes its flags. A written row lowers tiles[0] and raises
//  tiles[1] of its tile by atomics; a count leaving 0 adds one to
//  tiles[2]. (Folding a warp's rows of one tile first, and reading a bound
//  before its atomic, measured slower: tools/list_designs.py.)
//
// list_prune: one launch, a warp a group of up to 32 tiles (fewer on a
// small state, so that at least 16 warps an SM share the tiles), each
// lane reading one tile's summary:
//  * tiles[0] >= horizon: no row can drop; the tile's live slots count;
//  * tiles[1] < horizon: every live row drops: the warp writes zero counts
//    over the tile in 16-byte stores and the summary becomes the empty
//    one, no ts read. The rows stay in place, as the reference's
//    argsort(~keep) leaves a list that keeps nothing;
//  * otherwise the warp visits the tile: its counts in 16-byte loads (8
//    slots a lane), every live list's first ts loaded at once, then any
//    further rows; a list whose kept rows come first gets its new count,
//    one that must move is partitioned by the warp through shared memory
//    (one ballot a 32 rows); the tile's exact bounds and live slots come
//    from warp reductions.
//  A prune on another column than 0 visits every tile with a live slot
//  and keeps the bounds (the rows left are a subset). The keys left with
//  a live row: each block's sum, then the last block's total (a ticket in
//  hits[0], reset by that block).
//
// list_probe: one launch, a block a tile of 256 rows, the tiles taken in
// order from a counter so that a tile's predecessors are running or done.
// Each row looks its key up, reads its count with its first row's ts, and
// issues its other live rows' ts loads 8 at a time, independent of each
// other, keeping the matches among the first 32 rows as a bit mask. The tile scans its rows' match counts
// and takes its output offset by a decoupled look-back over the tiles
// before it; then each row writes its matches, their other columns read
// from the sectors the ts loads brought in (a list past 32 rows reads the
// rest again). Only the first `cap` matches are written; the total M and
// every row's count always are, so the host reads M once and, past the
// capacity, launches again with room for M. The last block to finish (a
// ticket) zeroes the look-back words, the counter and the ticket: no
// memset runs before a launch.
//
// Bound on the H100: random 32-byte sectors, not bytes. An append costs a
// key its table sector (a claim when new), its count and scratch words,
// its row's sector and a new key's list; a probe a key's table sector,
// count and live rows; a prune the summary, and in a tile it visits the
// counts, each live list's ts, changed counts and moved lists. At the Q7
// join's 10M shapes on an H100 80GB HBM3 at 700 W (chip_smoke.py,
// check_device_lists): the append of a bid batch at 66% of its floor at
// the card's measured sector rates, of a fire's maxes at 81% (38% of its
// bytes, most of them the new lists); the bids' prune at a watermark at
// 18% of its bound (the summary, the visited tiles' counts and live
// lists' sectors: two dependent round trips a tile), the maxes' prune,
// which empties every tile, at 81% (its counts zeroed); a fire's probe of
// 4.2M maxes at 74% to 85% of its floor at the measured random read rate
// by its device time (0.60 to 0.70 ms; the host's read of M adds 0.05 to
// 0.18 ms a call). The designs tried beside these (staging the probe's
// matches in shared memory, one ts load at a time: neither won at both
// cells' shapes): tools/list_designs.py.
#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "probe.cuh"

namespace {

namespace cg = cooperative_groups;
using probe_table::probe;
using probe_table::probe_claim;
constexpr int kThreads = 256;
constexpr int kPruneWarps = 8;  // most warps of a prune block
// a prune's warps an SM: fewer tiles a warp (down to 1) until the grid
// has this many, so that a small state's tiles are visited in parallel
constexpr int kPruneWarpsPerSM = 16;
// lanes that write one claimed list (write_claimed)
constexpr int kListLanes = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kInt64Max = LLONG_MAX;
constexpr long long kInt64Min = LLONG_MIN;
// the arrival word's flags: the row claimed its slot; and (after phase 2)
// its slot has no other row: the claimed list holds it
constexpr unsigned kInserted31 = 0x80000000u;
constexpr unsigned kRow30 = 0x40000000u;
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

__device__ __forceinline__ void store_streaming(long long* p, long long x,
                                                long long y) {
  asm volatile("st.global.cs.v2.b64 [%0], {%1, %2};" ::"l"(p), "l"(x),
               "l"(y)
               : "memory");
}

__device__ __forceinline__ void store_streaming(long long* p, long long x) {
  asm volatile("st.global.cs.b64 [%0], %1;" ::"l"(p), "l"(x) : "memory");
}

// The tile summary: tiles[0], tiles[1] and tiles[2] of a [3, n] tensor.
struct Tiles {
  long long* lo;
  long long* hi;
  long long* live;
  long long n;
  int shift;  // log2 of the slots a tile
};

// A row into the tile summary: a row written (ts its column 0) widens its
// tile's bounds to it; a slot whose count left 0 adds a live slot. No
// prune runs during an append, so the bounds only widen.
__device__ __forceinline__ void tile_note(const Tiles& t, int s, bool wrote,
                                          long long ts, bool born) {
  const long long tile = (long long)(s >> t.shift);
  if (wrote) {
    atomicMin(t.lo + tile, ts);
    atomicMax(t.hi + tile, ts);
  }
  if (born)
    atomicAdd(reinterpret_cast<unsigned long long*>(t.live + tile), 1ull);
}

struct AppendArgs {
  unsigned long long* table;
  unsigned long long mask;  // capacity - 1
  long long* rows;
  int L, C;
  long long lc;  // L * C
  int* counts;
  unsigned long long* hits;
  Tiles tiles;
  const long long* keys;
  const long long* packed;
  long long n;
  int* slot;      // [n] the row's slot, -1 where the insert failed
  unsigned* arr;  // [n] arrival index in the slot | kInserted31
  int* dup;       // [n] rows of slots of more than one row
  int* seg;       // [n] the slots' segments
  uint8_t* failed;
  unsigned long long* flags;
};

// The claimed lists of rows [c0, c1), kListLanes lanes a list, all the
// grid's warps at once: a claimed list is written whole, its row (a slot
// of one row) at position 0 and zeros after it, 16 bytes a lane (8 for an
// odd list width), so that each store writes whole sectors.
__device__ __forceinline__ void write_claimed(const AppendArgs& a,
                                              long long c0, long long c1) {
  constexpr int kGroups = 32 / kListLanes;  // lists a warp writes at once
  const int lane = threadIdx.x & 31, sl = lane % kListLanes;
  const long long step = (long long)gridDim.x * (kThreads / 32) * kGroups;
  const long long g0 =
      ((long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) *
          kGroups + lane / kListLanes;
  for (long long i = c0 + g0; i < c1; i += step) {
    const int s = __ldcg(a.slot + i);
    const unsigned ar = s >= 0 ? __ldcg(a.arr + i) : 0u;
    if (!(ar & kInserted31)) continue;
    const bool row = (ar & kRow30) != 0;
    long long* r = a.rows + (long long)s * a.lc;
    const long long* p = a.packed + i * a.C;
    if ((a.lc & 1) == 0) {  // an even list keeps 16-byte alignment
      for (long long e = sl; e < a.lc / 2; e += kListLanes) {
        const long long w = 2 * e;
        store_streaming(r + w, row && w < a.C ? p[w] : 0,
                        row && w + 1 < a.C ? p[w + 1] : 0);
      }
    } else {
      for (long long e = sl; e < a.lc; e += kListLanes)
        store_streaming(r + e, row && e < a.C ? p[e] : 0);
    }
  }
}

__global__ void __launch_bounds__(kThreads) list_append_kernel(AppendArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ unsigned long long blk_inserted;
  __shared__ int blk_failed;
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads;
  if (threadIdx.x == 0) {
    blk_inserted = 0ull;
    blk_failed = 0;
  }
  if (blockIdx.x == 0 && threadIdx.x < kFlags) a.flags[threadIdx.x] = 0ull;
  __syncthreads();
  // 1. claim; arrival index; keys inserted and failed inserts a block
  for (long long base = first; base < a.n; base += stride) {
    const long long i = base + threadIdx.x;
    bool inserted = false;
    if (i < a.n) {
      const int s = probe_claim(a.table, a.mask, sanitize(a.keys[i]), true,
                                inserted);
      a.slot[i] = s;
      a.failed[i] = s < 0 ? 1 : 0;
      if (s < 0) {
        blk_failed = 1;
        a.arr[i] = 0u;
      } else {
        a.arr[i] = (unsigned)atomicAdd(a.hits + s, 1ull) |
                   (inserted ? kInserted31 : 0u);
      }
    }
    const unsigned b = __ballot_sync(kFull, inserted);
    if (lane == 0 && b)
      atomicAdd(&blk_inserted, (unsigned long long)__popc(b));
  }
  grid.sync();
  // 2. slots of one row finished, duplicates listed
  bool full = false;
  for (long long base = first; base < a.n; base += stride) {
    const long long i = base + threadIdx.x;
    int s = -1;
    unsigned ar = 0u, k = 0u;
    if (i < a.n) {
      s = __ldcg(a.slot + i);
      if (s >= 0) {
        ar = __ldcg(a.arr + i);
        k = (unsigned)__ldcg(a.hits + s);
      }
    }
    bool wrote = false, born = false;
    long long ts = 0;
    if (s >= 0 && k == 1u) {
      ts = a.packed[i * a.C];
      if (ar & kInserted31) {  // its list written whole by write_claimed
        a.arr[i] = kInserted31 | kRow30;
        a.counts[s] = 1;
        wrote = born = true;
      } else {
        const int c = __ldcg(a.counts + s);
        if (c < a.L) {
          copy_row(a.rows + ((long long)s * a.L + c) * a.C,
                   a.packed + i * a.C, a.C);
          a.counts[s] = c + 1;
          wrote = true;
          born = c == 0;
        } else {
          full = true;
        }
      }
      a.hits[s] = 0ull;
    } else if (s >= 0) {
      if ((ar & ~kInserted31) == 0u) {
        const unsigned long long base_w =
            atomicAdd(a.flags + kCursor, (unsigned long long)k);
        a.hits[s] = (base_w << 32) | k;  // the low word stays k
      }
      a.dup[atomicAdd(a.flags + kDups, 1ull)] = (int)i;
    }
    tile_note(a.tiles, s, wrote, ts, born);
  }
  grid.sync();
  // W. the claimed lists (the duplicate rows come after the next barrier)
  write_claimed(a, 0, a.n);
  const long long nd = (long long)__ldcg(a.flags + kDups);
  if (nd > 0) {  // uniform over the grid
    // 3a. each duplicate row's batch index at its arrival in the segment
    for (long long base = first; base < nd; base += stride) {
      const long long t = base + threadIdx.x;
      if (t < nd) {
        const int i = __ldcg(a.dup + t);
        const int s = __ldcg(a.slot + i);
        a.seg[(__ldcg(a.hits + s) >> 32) +
              (__ldcg(a.arr + i) & ~kInserted31)] = i;
      }
    }
    grid.sync();
    // 3b. each duplicate row's rank; the row written at count + rank
    for (long long base = first; base < nd; base += stride) {
      const long long t = base + threadIdx.x;
      int s = -1;
      bool wrote = false;
      long long ts = 0;
      if (t < nd) {
        const int i = __ldcg(a.dup + t);
        s = __ldcg(a.slot + i);
        const unsigned long long h = __ldcg(a.hits + s);
        const int* g = a.seg + (h >> 32);
        const unsigned k = (unsigned)h;
        int rank = 0;
        for (unsigned u = 0; u < k; ++u) rank += __ldcg(g + u) < i;
        const long long pos = (long long)__ldcg(a.counts + s) + rank;
        if (pos < a.L) {
          copy_row(a.rows + ((long long)s * a.L + pos) * a.C,
                   a.packed + (long long)i * a.C, a.C);
          ts = a.packed[(long long)i * a.C];
          wrote = true;
        } else {
          full = true;
        }
      }
      tile_note(a.tiles, s, wrote, ts, false);
    }
    grid.sync();
    // 3c. the first arrival of each slot bumps its count by the rows that
    // fit and resets hits
    for (long long base = first; base < nd; base += stride) {
      const long long t = base + threadIdx.x;
      int s = -1;
      bool born = false;
      if (t < nd) {
        const int i = __ldcg(a.dup + t);
        if ((__ldcg(a.arr + i) & ~kInserted31) == 0u) {
          s = __ldcg(a.slot + i);
          const long long k = (long long)(unsigned)__ldcg(a.hits + s);
          const int c = __ldcg(a.counts + s);
          if (c < a.L) {
            a.counts[s] = (int)(c + k < a.L ? c + k : a.L);
            born = c == 0;
          }
          a.hits[s] = 0ull;
        }
      }
      tile_note(a.tiles, s, false, 0, born);
    }
  }
  // the flags were zeroed before the first barrier
  if (full) a.flags[kListFull] = 1ull;
  __syncthreads();
  if (threadIdx.x == 0) {
    if (blk_inserted) atomicAdd(a.flags + kInserted, blk_inserted);
    if (blk_failed) a.flags[kInsertFailed] = 1ull;
  }
}

struct PruneArgs {
  long long* rows;
  int L, C;
  long long lc;  // L * C
  int* counts;
  Tiles tiles;
  long long horizon;
  int ts_col;
  unsigned long long* ticket;  // hits[0]
  long long* part;             // [blocks] keys left with a live row
  long long* result;           // [1] their total
  int group;                   // tiles a warp (a power of two, <= 32)
};

// The list of slot s partitioned stably, kept rows first, by the warp:
// the live rows go to shared memory; one ballot a 32 rows gives the keep
// mask; each element is written to its row's place; the count is set.
__device__ __forceinline__ void move_list(const PruneArgs& a, long long s,
                                          long long* stage,
                                          long long* meta) {
  const int lane = threadIdx.x & 31;
  const int C = a.C;
  const int c = a.counts[s];
  long long* r = a.rows + s * a.lc;
  const int ce = c * C;
  for (int e = lane; e < ce; e += 32) stage[e] = r[e];
  __syncwarp();
  int kept = 0;
  for (int ch = 0; ch * 32 < c; ++ch) {
    const int j = ch * 32 + lane;
    const bool keep = j < c && stage[(long long)j * C + a.ts_col] >= a.horizon;
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
  if (lane == 0) a.counts[s] = kept;
  __syncwarp();
}

// A tile visited by the warp: 256 slots a round, 8 a lane (a 16-byte load
// of counts for each whole 128), the first ts of every live list loaded
// at once, then any further rows. Sets the tile's summary; returns its
// live slots.
__device__ long long prune_tile(const PruneArgs& a, long long t,
                                long long* stage, long long* meta) {
  const int lane = threadIdx.x & 31;
  const bool bounds = a.ts_col == 0;
  const long long span = 1ll << a.tiles.shift;
  const long long s0 = t << a.tiles.shift;
  long long lo = kInt64Max, hi = kInt64Min;
  long long live = 0;
  for (long long ch = 0; ch < span; ch += 256) {
    const long long b0 = s0 + ch + lane * 4;
    int c[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // a 16-byte load of each whole half
      if (ch + 128 * (h + 1) <= span) {
        const int4 x =
            *reinterpret_cast<const int4*>(a.counts + b0 + 128 * h);
        c[4 * h] = x.x, c[4 * h + 1] = x.y, c[4 * h + 2] = x.z;
        c[4 * h + 3] = x.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const long long off = ch + 128 * h + lane * 4 + q;
          c[4 * h + q] = off < span ? a.counts[s0 + off] : 0;
        }
      }
    }
    long long first[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      first[k] = c[k] > 0
                     ? a.rows[(b0 + (k >> 2) * 128 + (k & 3)) * a.lc + a.ts_col]
                     : 0;
    unsigned moves = 0u;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (c[k] <= 0) continue;
      const long long s = b0 + (k >> 2) * 128 + (k & 3);
      const long long* r = a.rows + s * a.lc + a.ts_col;
      int kept = 0;
      bool dropped = false, move = false;
      for (int j = 0; j < c[k]; ++j) {
        const long long v = j == 0 ? first[k] : r[(long long)j * a.C];
        if (v >= a.horizon) {
          ++kept;
          move |= dropped;
          if (bounds) {
            lo = v < lo ? v : lo;
            hi = v > hi ? v : hi;
          }
        } else {
          dropped = true;
        }
      }
      live += kept > 0;
      if (move)
        moves |= 1u << k;
      else if (kept != c[k])
        a.counts[s] = kept;
    }
    unsigned m = __ballot_sync(kFull, moves != 0u);
    while (m) {
      const int src = __ffs(m) - 1;
      const int k = __ffs(__shfl_sync(kFull, moves, src)) - 1;
      move_list(a, s0 + ch + (k >> 2) * 128 + src * 4 + (k & 3), stage,
                meta);
      if (lane == src) moves &= moves - 1u;
      m = __ballot_sync(kFull, moves != 0u);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const long long x = __shfl_xor_sync(kFull, lo, o);
    const long long y = __shfl_xor_sync(kFull, hi, o);
    lo = x < lo ? x : lo;
    hi = y > hi ? y : hi;
    live += __shfl_xor_sync(kFull, live, o);
  }
  if (lane == 0) {
    if (live == 0) {
      a.tiles.lo[t] = kInt64Max;
      a.tiles.hi[t] = kInt64Min;
    } else if (bounds) {
      a.tiles.lo[t] = lo;
      a.tiles.hi[t] = hi;
    }
    a.tiles.live[t] = live;
  }
  return live;
}

// The prune: a warp a group of tiles (see the note at the top).
__global__ void __launch_bounds__(kPruneWarps * 32)
    list_prune_kernel(PruneArgs a) {
  extern __shared__ long long smem[];
  __shared__ long long red[kPruneWarps];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  long long* stage = smem + (long long)warp * (a.lc + (a.L + 31) / 32);
  long long* meta = stage + a.lc;
  const bool bounds = a.ts_col == 0;
  const long long g0 = ((long long)blockIdx.x * warps + warp) * a.group;
  const long long t = g0 + lane;
  long long lo = kInt64Max, hi = kInt64Min, lv = 0;
  if (lane < a.group && t < a.tiles.n) {
    lo = a.tiles.lo[t];
    hi = a.tiles.hi[t];
    lv = a.tiles.live[t];
  }
  const bool skip = lv > 0 && bounds && lo >= a.horizon;
  const bool zero = lv > 0 && bounds && !skip && hi < a.horizon;
  const bool visit = lv > 0 && !skip && !zero;
  long long live = skip ? lv : 0;
  const long long span = 1ll << a.tiles.shift;
  unsigned b = __ballot_sync(kFull, zero);
  while (b) {
    const int src = __ffs(b) - 1;
    b &= b - 1u;
    int* cnt = a.counts + ((g0 + src) << a.tiles.shift);
    if (span >= 4) {
      for (long long e = lane; e < span / 4; e += 32)
        reinterpret_cast<int4*>(cnt)[e] = make_int4(0, 0, 0, 0);
    } else {
      for (long long e = lane; e < span; e += 32) cnt[e] = 0;
    }
  }
  if (zero) {
    a.tiles.lo[t] = kInt64Max;
    a.tiles.hi[t] = kInt64Min;
    a.tiles.live[t] = 0;
  }
  b = __ballot_sync(kFull, visit);
  while (b) {
    const int src = __ffs(b) - 1;
    b &= b - 1u;
    const long long l = prune_tile(a, g0 + src, stage, meta);
    if (lane == src) live += l;
  }
  for (int o = 16; o > 0; o >>= 1) live += __shfl_down_sync(kFull, live, o);
  if (lane == 0) red[warp] = live;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long sum = 0;
    for (int w = 0; w < warps; ++w) sum += red[w];
    a.part[blockIdx.x] = sum;
    __threadfence();
    last = atomicAdd(a.ticket, 1ull) == (unsigned long long)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  long long sum = 0;
  for (long long j = threadIdx.x; j < gridDim.x; j += blockDim.x)
    sum += __ldcg(a.part + j);
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_down_sync(kFull, sum, o);
  __syncthreads();
  if (lane == 0) red[warp] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long total = 0;
    for (int w = 0; w < warps; ++w) total += red[w];
    a.result[0] = total;
    *a.ticket = 0ull;
  }
}

// The probe's look-back words (one a tile, then the tile counter and the
// blocks' ticket; zero between launches): flag in the top two bits, the
// tile's match count or its inclusive prefix below.
constexpr unsigned long long kFlagAggregate = 1ull << 62;
constexpr unsigned long long kFlagPrefix = 2ull << 62;
constexpr unsigned long long kValueMask = (1ull << 62) - 1;
// a row's matches among its list's first kMaskRows rows are a bit mask;
// its ts loads are issued kTsLoads at a time
constexpr int kMaskRows = 32;
constexpr int kTsLoads = 8;

struct ProbeArgs {
  unsigned long long* table;  // read only: probe() without insert
  unsigned long long mask;    // capacity - 1
  const long long* rows;
  int C;
  long long lc;  // L * C
  const int* counts;
  const long long* keys;
  long long n;
  const long long* ts;  // [n], or null: every live row matches
  long long lo_off, hi_off;
  long long cap;        // output rows this launch may write
  int* m_out;           // [n] each row's matches
  long long* out_idx;   // [cap] batch row of each match
  long long* out_packed;  // [cap, C]
  long long* total;     // [1] M, every match, written or not
  unsigned long long* status;  // [n_tiles + 2] look-back words, counter,
                               // ticket
  long long n_tiles;
};

// A row's matches: its live rows' ts loaded kTsLoads at a time, each
// group's loads independent (the first row's, v0, loaded already); the
// matches among the first kMaskRows rows into bits. Returns the count.
__device__ __forceinline__ long long match_rows(const long long* r, int C,
                                                int c, long long v0,
                                                long long lo, long long hi,
                                                unsigned& bits) {
  long long m = 0;
  for (int j0 = 0; j0 < c; j0 += kTsLoads) {
    long long v[kTsLoads];
#pragma unroll
    for (int q = 0; q < kTsLoads; ++q)
      v[q] = j0 + q == 0  ? v0
             : j0 + q < c ? __ldg(r + (long long)(j0 + q) * C)
                          : 0;
    unsigned g = 0u;
#pragma unroll
    for (int q = 0; q < kTsLoads; ++q)
      g |= (unsigned)(j0 + q < c && v[q] >= lo && v[q] <= hi) << q;
    m += __popc(g);
    if (j0 < kMaskRows) bits |= g << j0;
  }
  return m;
}

__device__ __forceinline__ void write_match(const ProbeArgs& a, long long off,
                                            long long i,
                                            const long long* row) {
  a.out_idx[off] = i;
  long long* o = a.out_packed + off * a.C;
  for (int e = 0; e < a.C; ++e) o[e] = __ldg(row + e);
}

// The tile's exclusive prefix over the tiles before it (the whole block
// calls it): tile 0 publishes its prefix at once; any other publishes its
// aggregate, then thread k reads the word of tile - 1 - k, kThreads at a
// time, and the nearest published prefix ends the walk.
__device__ __forceinline__ long long look_back(const ProbeArgs& a,
                                              long long tile,
                                              long long total) {
  __shared__ int warp_stop[kThreads / 32];
  __shared__ unsigned long long warp_sum[kThreads / 32];
  __shared__ long long base_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  volatile unsigned long long* st = a.status;
  if (tile == 0) {
    if (tid == 0) {
      st[0] = kFlagPrefix | (unsigned long long)total;
      base_s = 0;
    }
    __syncthreads();
    return 0;
  }
  if (tid == 0) st[tile] = kFlagAggregate | (unsigned long long)total;
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
      warp_stop[warp] = prefixes ? 32 * warp + __ffs(prefixes) - 1 : kThreads;
    __syncthreads();
    int stop = kThreads;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w)
      stop = warp_stop[w] < stop ? warp_stop[w] : stop;
    unsigned long long part = tid <= stop ? (v & kValueMask) : 0ull;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_down_sync(kFull, part, o);
    if (lane == 0) warp_sum[warp] = part;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) before += warp_sum[w];
    __syncthreads();  // warp_stop and warp_sum are read before reuse
    if (stop < kThreads) break;
  }
  if (tid == 0) {
    st[tile] = kFlagPrefix | (before + (unsigned long long)total);
    base_s = (long long)before;
  }
  __syncthreads();
  return base_s;
}

// The probe: a block a tile of kThreads rows, tiles taken in order from
// the counter (see the note at the top).
__global__ void __launch_bounds__(kThreads) list_probe_kernel(ProbeArgs a) {
  __shared__ long long tile_s;
  __shared__ long long warp_tot[kThreads / 32];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned long long* counter = a.status + a.n_tiles;
  if (tid == 0) tile_s = (long long)atomicAdd(counter, 1ull);
  __syncthreads();
  const long long tile = tile_s;
  const long long i = tile * kThreads + tid;
  // 1. lookup, count, the live rows' ts: the row's matches
  int s = -1, c = 0;
  unsigned bits = 0u;
  long long m = 0, lo = 0, hi = 0;
  if (i < a.n) {
    s = probe(a.table, a.mask, sanitize(a.keys[i]), false);
    if (s >= 0) {
      const long long* r = a.rows + (long long)s * a.lc;
      // the first row's ts loaded with the count, before it is known to
      // be live (a slot's list is always there to read)
      const long long v0 = a.ts != nullptr ? __ldg(r) : 0;
      c = __ldg(a.counts + s);
      if (a.ts == nullptr) {
        m = c;
        bits = c >= kMaskRows ? kFull : (1u << c) - 1u;
      } else {
        const long long t = a.ts[i];
        lo = t + a.lo_off;
        hi = t + a.hi_off;
        m = match_rows(r, a.C, c, v0, lo, hi, bits);
      }
    }
    a.m_out[i] = (int)m;
  }
  // 2. the tile's scan of the matches, its prefix by the look-back
  long long x = m;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  long long before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    before += w < warp ? warp_tot[w] : 0;
    total += warp_tot[w];
  }
  const long long base = look_back(a, tile, total);
  if (tid == 0 && tile == a.n_tiles - 1) *a.total = base + total;
  // 3. the row's matches at its offset, those below the capacity: the
  // first kMaskRows from the mask, any later ones read again
  long long off = base + before + x - m;
  if (m > 0 && off < a.cap) {
    const long long* r = a.rows + (long long)s * a.lc;
    for (unsigned b = bits; b && off < a.cap; b &= b - 1u, ++off)
      write_match(a, off, i, r + (long long)(__ffs(b) - 1) * a.C);
    for (int j = kMaskRows; j < c && off < a.cap; ++j) {
      const long long* row = r + (long long)j * a.C;
      if (a.ts != nullptr) {
        const long long v = __ldg(row);
        if (v < lo || v > hi) continue;
      }
      write_match(a, off++, i, row);
    }
  }
  // 4. the last block to finish zeroes the look-back words, the counter
  // and the ticket: every block has done its look-back before its ticket
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(counter + 1, 1ull) == (unsigned long long)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  for (long long j = tid; j < a.n_tiles + 2; j += kThreads) a.status[j] = 0ull;
}

inline long long blocks_for(long long n) {
  return (n + kThreads - 1) / kThreads;
}

inline bool tiles_fit(long long capacity, long long n_tiles, int shift) {
  return n_tiles > 0 && shift >= 0 && shift < 40 &&
         (n_tiles << shift) == capacity;
}

}  // namespace

// Append n packed rows ([n, C] int64) under keys [n] int64, one
// cooperative launch. scratch: 4n int32 words (slot, arrival, duplicate
// list, segments); failed: [n] bytes, 1 where the insert failed; flags:
// kFlags int64 words, zeroed by the launch (list full, insert failed, keys
// inserted, duplicate rows, segment words); tiles: [3, n_tiles] int64 of
// 2^tile_shift slots a tile, kept.
extern "C" int list_append_launch(void* table, long long capacity,
                                  void* rows, int L, int C, void* counts,
                                  void* hits, void* tiles, long long n_tiles,
                                  int tile_shift, const void* keys,
                                  const void* packed, long long n,
                                  void* scratch, void* failed, void* flags,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0)
    return (int)cudaMemsetAsync(flags, 0, kFlags * sizeof(long long), st);
  if (L <= 0 || C <= 0 || capacity <= 0 || n > (1ll << 30) ||
      !tiles_fit(capacity, n_tiles, tile_shift))
    return (int)cudaErrorInvalidValue;
  static int most = 0, most_dev = -1;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (most_dev != dev) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, list_append_kernel, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    most = per_sm * sms;
    most_dev = dev;
  }
  const long long want = blocks_for(n);
  const unsigned grid = (unsigned)(want < most ? want : most);
  long long* t = (long long*)tiles;
  int* words = (int*)scratch;
  AppendArgs a{(unsigned long long*)table,
               (unsigned long long)(capacity - 1),
               (long long*)rows,
               L,
               C,
               (long long)L * C,
               (int*)counts,
               (unsigned long long*)hits,
               Tiles{t, t + n_tiles, t + 2 * n_tiles, n_tiles, tile_shift},
               (const long long*)keys,
               (const long long*)packed,
               n,
               words,
               (unsigned*)(words + n),
               words + 2 * n,
               words + 3 * n,
               (uint8_t*)failed,
               (unsigned long long*)flags};
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel((void*)list_append_kernel, dim3(grid),
                                  dim3(kThreads), params, 0, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Words of a probe's look-back scratch for n rows: a word a tile, the
// tile counter and the ticket. They are zero before a launch and the
// launch leaves them zero.
extern "C" int list_probe_status_words(long long n) {
  return (int)(blocks_for(n) + 2);
}

// The probe, one launch: per row its matches m [n] int32; total [1] int64
// M, every match; the first cap matches, out_idx [cap] int64 (batch row)
// and out_packed [cap, C] int64, in (batch row, list position) order.
// ts null: every live row matches. status: list_probe_status_words(n)
// int64 words, zero. Reads the state only, so a launch again with a
// larger cap writes the same matches.
extern "C" int list_probe_launch(void* table, long long capacity,
                                 const void* rows, int L, int C,
                                 const void* counts, const void* keys,
                                 long long n, const void* ts,
                                 long long lo_off, long long hi_off,
                                 long long cap, void* m, void* total,
                                 void* out_idx, void* out_packed,
                                 void* status, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (L <= 0 || C <= 0 || capacity <= 0 || cap < 0 || n > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const long long nt = blocks_for(n);
  ProbeArgs a{(unsigned long long*)table,
              (unsigned long long)(capacity - 1),
              (const long long*)rows,
              C,
              (long long)L * C,
              (const int*)counts,
              (const long long*)keys,
              n,
              (const long long*)ts,
              lo_off,
              hi_off,
              cap,
              (int*)m,
              (long long*)out_idx,
              (long long*)out_packed,
              (long long*)total,
              (unsigned long long*)status,
              nt};
  list_probe_kernel<<<(unsigned)nt, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Bytes of shared memory the prune takes a warp to move a list.
extern "C" long long list_prune_smem_per_warp(int L, int C) {
  return ((long long)L * C + (L + 31) / 32) * (long long)sizeof(long long);
}

// Prune every list to its rows with ts (column ts_col) >= horizon, one
// launch. tiles: [3, n_tiles] int64 of 2^tile_shift slots a tile, kept;
// hits: the [capacity] int64 zero scratch (its first word the blocks'
// ticket), zero again after; part: n_tiles int64 words of scratch (a
// word a block); result: 1 int64 word, the keys left with a live row.
extern "C" int list_prune_launch(void* rows, int L, int C, void* counts,
                                 long long capacity, void* tiles,
                                 long long n_tiles, int tile_shift,
                                 long long horizon, int ts_col, void* hits,
                                 void* part, void* result, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (L <= 0 || C <= 0 || ts_col < 0 || ts_col >= C || capacity <= 0 ||
      !tiles_fit(capacity, n_tiles, tile_shift) ||
      ((uintptr_t)counts & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const long long per_warp = list_prune_smem_per_warp(L, C);
  int max_smem = 0, dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&max_smem,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (per_warp > max_smem) return (int)cudaErrorInvalidValue;
  long long warps = (48 << 10) / per_warp;
  warps = warps < 1 ? 1 : (warps > kPruneWarps ? kPruneWarps : warps);
  const long long smem = warps * per_warp;
  if (smem > (48 << 10)) {
    e = cudaFuncSetAttribute(list_prune_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long want = (long long)sms * kPruneWarpsPerSM;
  int group = 1;
  while (group < 32 && (long long)group * want < n_tiles) group *= 2;
  const long long groups = (n_tiles + group - 1) / group;
  long long* t = (long long*)tiles;
  PruneArgs a{(long long*)rows,
              L,
              C,
              (long long)L * C,
              (int*)counts,
              Tiles{t, t + n_tiles, t + 2 * n_tiles, n_tiles, tile_shift},
              horizon,
              ts_col,
              (unsigned long long*)hits,
              (long long*)part,
              (long long*)result,
              group};
  list_prune_kernel<<<(unsigned)((groups + warps - 1) / warps),
                      (unsigned)(warps * 32), (size_t)smem, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* device_lists_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
