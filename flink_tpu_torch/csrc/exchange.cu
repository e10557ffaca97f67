// The mesh's keyBy exchange: bucket source blocks of rows by destination
// shard, straight into the buffers the destinations' ingest steps read.
//
// Replaces flink_tpu/parallel/exchange.py::plan_exchange (:110) and
// ::exchange_round (:130), with the routing of the sharded step
// (flink_tpu/parallel/sharded_window.py:143-152, :162-169): per device a
// stable argsort of the rows by destination, per round a scatter of `cap`
// rows a destination, then lax.all_to_all over ICI. The port's mesh is one
// process holding D shards; with every shard on one card the all_to_all
// costs no copy, because this kernel writes each row where its
// destination's step reads it.
//
// Contract. S source blocks of B rows. A row r of block s is in when r <
// n_valid (rows of the flattened [S, B] block) and its valid byte is set
// (when a mask is given). Its key group is the murmur of
// core/keygroups.py over the RAW key (keygroup.cuh, as
// sharded_window.py:143 computes it before sanitising); the row is valid
// when its group lies in [base_start, base_start + base_len), and its
// destination is (kg - base_start) * D / base_len (mesh.py's
// device_index_for_key_groups). Invalid rows vanish. Destination d's
// buffer holds S segments of B rows: segment s holds, at its front and in
// batch order (the reference's stable argsort), the rows source s sends
// to d; counts[s * D + d] is how many. The buffer is sized for the worst
// case (a whole block to one destination), so one launch always suffices.
// Each row writes its sanitised key (EMPTY_KEY -> EMPTY_KEY - 1,
// sharded_window.py:84), its pane floor((ts - offset) / pane) and its
// value columns (raw bytes of 1, 2, 4 or 8).
//
// Bound on the H100: device memory, streamed at 3.35 TB/s. Each row reads
// its key, ts and columns once and writes them once; the counts are a word
// a (source, destination).
//
// Design: one cooperative launch, one device operation a call. Block k
// takes tile k of kTile consecutive rows, in (source, tile) order. kTile is
// the largest of 1024, 512 and 256 rows that still gives every
// multiprocessor a tile. The cooperative launch keeps every block
// resident at once, so a tile only waits on tiles that are running, and
// more tiles than the card holds go round the grid in order.
//  1. Loads: each warp brings its own rows into shared memory by 16-byte
//     cp.async (a chunk the range cuts element by element): the keys and
//     valid bytes first, ranked as soon as they land, then the ts and
//     columns, which land behind the ranks and the look-back.
//  2. Stable ranks: every round's destination first (their latencies
//     overlap; the divisions by max parallelism, base_len and pane are
//     multiplies by magic numbers fixed for the launch), then
//     __match_any_sync a round against counters of the warp's own in
//     shared memory; a prefix over the warps a destination gives each row
//     its rank among the tile's rows of its destination, in row order.
//  3. A decoupled look-back a source: each tile publishes its D counts,
//     first as an aggregate, then as an inclusive prefix, and reads its
//     predecessors' words to find its base in each bucket (a group of
//     lanes a destination, up to 32 predecessors a read, 64 ns of sleep
//     before reading words not yet published again). The last tile of a
//     source writes counts[s, :] from its prefix: no atomic, no zeroing.
//  4. Staged, coalesced writes: each routed row's tile index goes to its
//     (destination, rank) place in shared memory; consecutive threads then
//     write each destination's run of keys, panes and columns to
//     consecutive addresses.
// The scratch (ExchangeBuffers.scratch, zeroed once when allocated) holds
// S x tiles x D look-back words. Each word carries the launch's epoch,
// counted by the wrapper on the buffers, and counts only in its own
// launch: nothing is cleared between calls, and a new shape comes with
// new, zeroed buffers.
//
// Against the earlier kernel (tools/exchange_earlier.cu: a memset, then
// one thread a row, each block stalling on a global atomic a destination
// between its loads and its stores, stores split into about D pieces a
// warp, rows in the order the atomics land) this one is one device
// operation, keeps batch order and writes whole runs. At one wave of
// tiles it pays a tile's phases one after another across the card (the
// loads, then the ranks, the look-back and the stores), where the earlier
// kernel's later blocks load while its earlier ones store.
// tools/exchange_designs.py times both, and the designs tried: tile
// sizes, load orders, TMA bulk loads, tickets, ordinary launches, wider
// look-back reads, ballot ranks, int64 division, scratch cleared by its
// last readers or by a memset, and an unordered atomic base a tile; the
// times are in PERF.md.
#include <cstdint>
#include <cuda_runtime.h>

#include "keygroup.cuh"

namespace {

using keygroup::key_hash;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// tile sizes: the largest that still gives every multiprocessor a tile
constexpr int kMaxTileRows = 1024;
constexpr int kMinTileRows = 256;
constexpr int kMaxDest = 256;
constexpr int kMaxCols = 7;
// look-back words a lane reads at once
constexpr int kLookWords = 1;
// the tile's arrays in shared memory: keys, ts, the columns, valid bytes
constexpr int kMaxArrays = kMaxCols + 3;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kEmpty = 0x7FFFFFFFFFFFFFFFll;
// a look-back word: flag (top two bits), the launch's tag, the count
constexpr unsigned long long kFlagAggregate = 1ull << 62;
constexpr unsigned long long kFlagPrefix = 2ull << 62;
constexpr int kTagShift = 40;
constexpr unsigned long long kTagMask = (1ull << 22) - 1;
constexpr unsigned long long kValueMask = (1ull << kTagShift) - 1;

// Division by a divisor fixed for the launch (Granlund and Montgomery):
// for n < 2^63, n / d = umulhi(n, m) >> shift with m and shift from
// magic_for(d) on the host; shift -1 marks d = 1.
struct Magic {
  unsigned long long m;
  int shift;
};

struct Args {
  const long long* keys;  // [S, B]
  const long long* ts;    // [S, B]
  const uint8_t* valid;   // [S, B] bytes, or null
  long long n_valid;      // rows of the flattened block that may be in
  long long B;
  long long offset;
  int D, maxp, base_start, base_len;
  Magic by_pane, by_base_len, by_maxp;  // pane, base_len and maxp
  int n_cols;
  const void* cols[kMaxCols];  // [S, B] each
  int col_size[kMaxCols];      // bytes of an element: 1, 2, 4 or 8
  long long* out_keys;         // [D, out_stride]
  long long* out_panes;        // [D, out_stride]
  void* out_cols[kMaxCols];    // [D, out_stride] each
  long long out_stride;        // S * B
  long long* counts;           // [S, D]
  unsigned long long* scratch;  // [S * tiles_per_src * D] look-back words
  unsigned long long tag;       // the launch's epoch, kTagMask at most
  long long tiles_per_src, n_tiles;
  int lb_lanes;                // lanes of a destination's look-back group
  // byte offset of each array's 16-byte-aligned region in shared memory
  int smem_off[kMaxArrays];
  int pos_off;                 // the staged order: row << 8 | dest
};

__device__ __forceinline__ unsigned long long div_magic(unsigned long long n,
                                                        Magic g) {
  return g.shift < 0 ? n : __umul64hi(n, g.m) >> g.shift;
}

// floor(a / d) for d > 0: a < 0 divides ~a = -a - 1, then ~q
__device__ __forceinline__ long long floor_div(long long a, Magic g) {
  const unsigned long long q =
      div_magic(a >= 0 ? (unsigned long long)a : ~(unsigned long long)a, g);
  return a >= 0 ? (long long)q : (long long)~q;
}

__device__ __forceinline__ void copy_elem(unsigned char* dst,
                                          const unsigned char* src,
                                          int size) {
  switch (size) {
    case 8:
      *reinterpret_cast<long long*>(dst) =
          __ldg(reinterpret_cast<const long long*>(src));
      break;
    case 4:
      *reinterpret_cast<int*>(dst) = __ldg(reinterpret_cast<const int*>(src));
      break;
    case 2:
      *reinterpret_cast<short*>(dst) =
          __ldg(reinterpret_cast<const short*>(src));
      break;
    default:
      *dst = __ldg(src);
      break;
  }
}

__device__ __forceinline__ void store_elem(void* base, long long at,
                                           const unsigned char* src,
                                           int size) {
  switch (size) {
    case 8:
      static_cast<long long*>(base)[at] =
          *reinterpret_cast<const long long*>(src);
      break;
    case 4:
      static_cast<int*>(base)[at] = *reinterpret_cast<const int*>(src);
      break;
    case 2:
      static_cast<short*>(base)[at] = *reinterpret_cast<const short*>(src);
      break;
    default:
      static_cast<unsigned char*>(base)[at] = *src;
      break;
  }
}

// Bytes [from, to) of an array whose tile starts at src into its region:
// byte b of the 16-byte chunk at (src & ~15) lands at region + b, so
// element i sits at region + (src & 15) + i * size. The calling warp's
// lanes take whole chunks by 16-byte cp.async, and the bytes of a chunk
// the range cuts element by element. from and to count from the chunk.
__device__ __forceinline__ void load_range(unsigned char* region,
                                           const unsigned char* src,
                                           int from, int to, int size,
                                           int lane) {
  const unsigned char* chunk0 = src - ((uintptr_t)src & 15);
  for (int c = (from >> 4) + lane; c < (to + 15) >> 4; c += 32) {
    const int lo = c << 4, hi = lo + 16;
    if (lo >= from && hi <= to) {
      const unsigned dst = (unsigned)__cvta_generic_to_shared(region + lo);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                   "l"(chunk0 + lo));
    } else {
      for (int b = lo > from ? lo : from; b < (hi < to ? hi : to); b += size)
        copy_elem(region + b, chunk0 + b, size);
    }
  }
}

// A tile: its source block s, its place t in it, its first row of the
// flattened block and its rows that may be in. Tiles run in (source,
// tile) order.
struct Tile {
  long long s, t, row0;
  int live;
};

template <int kTile>
__device__ __forceinline__ Tile tile_of(const Args& a, long long k) {
  Tile tl;
  tl.s = k / a.tiles_per_src;
  tl.t = k % a.tiles_per_src;
  tl.row0 = tl.s * a.B + tl.t * kTile;
  long long rows = a.B - tl.t * kTile;
  rows = rows < kTile ? rows : kTile;
  long long live = a.n_valid - tl.row0;
  live = live < rows ? live : rows;
  tl.live = live > 0 ? (int)live : 0;
  return tl;
}

// Thread k < n_arrays: array k's first byte of the tile.
__device__ __forceinline__ const unsigned char* array_src(const Args& a,
                                                          int k,
                                                          long long row0) {
  if (k == 0) return reinterpret_cast<const unsigned char*>(a.keys + row0);
  if (k == 1) return reinterpret_cast<const unsigned char*>(a.ts + row0);
  if (k < 2 + a.n_cols)
    return static_cast<const unsigned char*>(a.cols[k - 2]) +
           row0 * a.col_size[k - 2];
  return a.valid + row0;
}

// Tile k of kTile rows: loads, ranks, look-back and writes (see the note
// at the top).
template <int kTile>
__device__ __forceinline__ void exchange_tile(const Args& a,
                                              unsigned char* smem,
                                              long long k) {
  constexpr int kWarpRows = kTile / kWarps;
  constexpr int kRounds = kWarpRows / 32;
  // a warp's rows a destination; then the staged place of its first one
  __shared__ int warp_cnt[kWarps][kMaxDest];
  __shared__ int tile_cnt[kMaxDest];
  // the output position of destination d's staged row 0, less its place
  __shared__ long long seg_base[kMaxDest];
  __shared__ int warp_tot[kWarps];
  // each array's first byte of the tile in device memory, and its width
  __shared__ const unsigned char* in_src[kMaxArrays];
  __shared__ int in_size[kMaxArrays];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const int n_arrays = 2 + a.n_cols + (a.valid != nullptr ? 1 : 0);
  const unsigned long long tag = a.tag;
  for (int q = tid; q < kWarps * kMaxDest; q += kThreads)
    (&warp_cnt[0][0])[q] = 0;
  const Tile tl = tile_of<kTile>(a, k);
  const long long s = tl.s, t = tl.t;
  const int live = tl.live;
  if (tid < n_arrays) {
    in_src[tid] = array_src(a, tid, tl.row0);
    in_size[tid] = tid < 2 ? 8 : (tid < 2 + a.n_cols ? a.col_size[tid - 2]
                                                     : 1);
  }
  __syncthreads();
  // 1. each warp loads its own rows: the keys and valid bytes as one
  // group, then the ts and columns as another, and ranks its rows as soon
  // as the first lands; the second lands behind the ranks and the
  // look-back
  const int w0 = warp * kWarpRows;
  const int w1 = live < w0 + kWarpRows ? live : w0 + kWarpRows;
  const int valid_k = a.valid != nullptr ? n_arrays - 1 : 0;
  if (w1 > w0) {
    for (int g = 0; g < 2; ++g) {
      for (int q = 0; q < n_arrays; ++q) {
        if ((q == 0 || q == valid_k) != (g == 0)) continue;
        const int mis = (int)((uintptr_t)in_src[q] & 15), sz = in_size[q];
        load_range(smem + a.smem_off[q], in_src[q], mis + w0 * sz,
                   mis + w1 * sz, sz, lane);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  }
  __syncwarp();
  const long long* keys_s = reinterpret_cast<const long long*>(
      smem + a.smem_off[0] + ((uintptr_t)in_src[0] & 15));
  const uint8_t* valid_s =
      a.valid == nullptr
          ? nullptr
          : smem + a.smem_off[n_arrays - 1] +
                ((uintptr_t)in_src[n_arrays - 1] & 15);
  // 2. each row's destination: rounds independent of each other, so their
  // latencies overlap
  int dest[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int i = w0 + r * 32 + lane;
    dest[r] = -1;
    if (i < live && (valid_s == nullptr || valid_s[i])) {
      const unsigned h = (unsigned)key_hash((unsigned long long)keys_s[i]);
      const long long rel =
          (long long)(h - (unsigned)div_magic(h, a.by_maxp) * a.maxp) -
          a.base_start;
      if (rel >= 0 && rel < a.base_len)
        dest[r] = (int)div_magic((unsigned long long)rel * a.D,
                                 a.by_base_len);
    }
  }
  // each row's rank among its warp's rows of its destination, in row
  // order: one counter a (warp, destination)
  int rank[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const unsigned peers = __match_any_sync(kFull, dest[r]);
    const int before = dest[r] >= 0 ? warp_cnt[warp][dest[r]] : 0;
    __syncwarp();
    if (dest[r] >= 0 && lane == __ffs(peers) - 1)
      warp_cnt[warp][dest[r]] = before + __popc(peers);
    __syncwarp();
    rank[r] = before + __popc(peers & lt);
  }
  __syncthreads();
  // thread d: the tile's count of d, and the rows of d before each warp's
  int cnt = 0;
  if (tid < a.D) {
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_cnt[w][tid];
      warp_cnt[w][tid] = cnt;
      cnt += c;
    }
  }
  volatile unsigned long long* const status =
      a.scratch + s * a.tiles_per_src * a.D;
  if (tid < a.D)
    status[t * a.D + tid] = (t == 0 ? kFlagPrefix : kFlagAggregate) |
                            (tag << kTagShift) | (unsigned long long)cnt;
  // the staged order is destination-major: d's run starts after the runs
  // of destinations below it
  int x = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  int run0 = x - cnt;
  for (int w = 0; w < warp; ++w) run0 += warp_tot[w];
  if (tid < a.D) {
    for (int w = 0; w < kWarps; ++w) warp_cnt[w][tid] += run0;
    tile_cnt[tid] = cnt;
    seg_base[tid] = (long long)tid * a.out_stride + s * a.B - run0;
  }
  __syncthreads();
  // each routed row's tile index and destination at its staged place
  unsigned* const staged = reinterpret_cast<unsigned*>(smem + a.pos_off);
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (dest[r] >= 0)
      staged[warp_cnt[warp][dest[r]] + rank[r]] =
          (unsigned)(w0 + r * 32 + lane) << 8 | (unsigned)dest[r];
  }
  // 3. the look-back: lanes [gbase, gbase + G) of a warp serve destination
  // d, lane gbase + k reading the kLookWords words below tile
  // j0 - k * kLookWords
  const int G = a.lb_lanes;
  const int gbase = lane & ~(G - 1);
  const unsigned gmask = G == 32 ? kFull : ((1u << G) - 1u) << gbase;
  const int d = warp * (32 / G) + lane / G;
  bool done = t == 0 || d >= a.D;
  unsigned long long earlier = 0;  // rows of d in the source's tiles before
  long long j0 = t - 1;
  while (__any_sync(kFull, !done)) {
    // this lane's words down to its nearest prefix: all published, and
    // their counts' sum
    bool pub = true, pre = false;
    unsigned long long part = 0;
    if (!done) {
      unsigned long long v[kLookWords];
#pragma unroll
      for (int q = 0; q < kLookWords; ++q) {
        const long long j = j0 - (long long)(lane - gbase) * kLookWords - q;
        // before tile 0: a prefix of nothing
        v[q] = j < 0 ? kFlagPrefix | (tag << kTagShift)
                     : status[j * a.D + d];
      }
#pragma unroll
      for (int q = 0; q < kLookWords; ++q) {
        if (!pre) {
          const bool ok = (v[q] >> 62) != 0 &&
                          ((v[q] >> kTagShift) & kTagMask) == tag;
          pub = pub && ok;
          pre = ok && (v[q] >> 62) == 2;
          part += v[q] & kValueMask;
        }
      }
    }
    const unsigned pres = __ballot_sync(kFull, pre) & gmask;
    const unsigned unpub = __ballot_sync(kFull, !pub) & gmask;
    // the lanes up to the nearest prefix must all have published
    const unsigned upto = pres ? (2u << (__ffs(pres) - 1)) - 1u : kFull;
    const bool ready = (unpub & upto) == 0u;
    part = (!done && ready && ((upto >> lane) & 1u)) ? part : 0ull;
    for (int o = G >> 1; o > 0; o >>= 1)
      part += __shfl_xor_sync(kFull, part, o);
    if (!done && ready) {
      earlier += part;
      if (pres) done = true;
      else j0 -= (long long)G * kLookWords;
    } else if (!done) {
      __nanosleep(64);  // a predecessor has not published yet
    }
  }
  if (d < a.D && lane == gbase) {
    const unsigned long long incl =
        earlier + (unsigned long long)tile_cnt[d];
    if (t > 0) status[t * a.D + d] = kFlagPrefix | (tag << kTagShift) | incl;
    if (t == a.tiles_per_src - 1) a.counts[s * a.D + d] = (long long)incl;
    seg_base[d] += (long long)earlier;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  // 4. each destination's run, consecutive threads on consecutive rows
  int total = 0;
  for (int w = 0; w < kWarps; ++w) total += warp_tot[w];
  const long long* ts_s = reinterpret_cast<const long long*>(
      smem + a.smem_off[1] + ((uintptr_t)in_src[1] & 15));
#pragma unroll 2
  for (int p = tid; p < total; p += kThreads) {
    const unsigned e = staged[p];
    const int i = (int)(e >> 8);
    const long long o = seg_base[e & 0xFFu] + p;
    const long long key = keys_s[i];
    a.out_keys[o] = key == kEmpty ? kEmpty - 1 : key;
    const long long since = (long long)((unsigned long long)ts_s[i] -
                                        (unsigned long long)a.offset);
    a.out_panes[o] = floor_div(since, a.by_pane);
    for (int c = 0; c < a.n_cols; ++c) {
      const int sz = in_size[2 + c];
      store_elem(a.out_cols[c], o,
                 smem + a.smem_off[2 + c] + ((uintptr_t)in_src[2 + c] & 15) +
                     i * sz,
                 sz);
    }
  }
  __syncthreads();  // the tile's shared memory is read before the next
}

template <int kTile>
__global__ void __launch_bounds__(kThreads) exchange_bucket_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  // a block a tile; more tiles than the card holds blocks at once go round
  for (long long k = blockIdx.x; k < a.n_tiles; k += gridDim.x)
    exchange_tile<kTile>(a, smem, k);
}

size_t region(long long bytes) { return (size_t)((bytes + 16 + 15) & ~15ll); }

// m = ceil(2^(63 + l) / d), l = ceil(log2 d): exact for every n < 2^63
Magic magic_for(unsigned long long d) {
  if (d == 1) return {0, -1};
  int l = 0;
  while ((1ull << l) < d) ++l;
  const unsigned __int128 top = (unsigned __int128)1 << (63 + l);
  return {(unsigned long long)((top + d - 1) / d), l - 1};
}

// room for the smallest tiles' words, whichever size a call takes
long long words_needed(long long S, long long B, int D) {
  return S * ((B + kMinTileRows - 1) / kMinTileRows) * D;
}

// The multiprocessors of the current device (once a device).
cudaError_t multiprocessors(int& sms) {
  static int dev_seen = -1, sms_seen = 0;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess && device != dev_seen) {
    e = cudaDeviceGetAttribute(&sms_seen, cudaDevAttrMultiProcessorCount,
                               device);
    dev_seen = e == cudaSuccess ? device : -1;
  }
  sms = sms_seen;
  return e;
}

// The largest tile size that still gives every multiprocessor a tile.
int tile_rows_for(long long rows, int sms) {
  int t = kMaxTileRows;
  while (t > kMinTileRows && (rows + t - 1) / t < sms) t >>= 1;
  return t;
}

// Lays out the tile's shared memory for kTile rows and launches.
template <int kTile>
int launch_tiles(Args& a, long long S, long long B, int sms,
                 cudaStream_t stream) {
  size_t smem = 2 * region(8ll * kTile);
  a.smem_off[0] = 0;
  a.smem_off[1] = (int)region(8ll * kTile);
  for (int c = 0; c < a.n_cols; ++c) {
    a.smem_off[2 + c] = (int)smem;
    smem += region((long long)a.col_size[c] * kTile);
  }
  if (a.valid != nullptr) {
    a.smem_off[2 + a.n_cols] = (int)smem;
    smem += region(kTile);
  }
  a.pos_off = (int)smem;
  smem += 4 * kTile;
  a.tiles_per_src = (B + kTile - 1) / kTile;
  a.n_tiles = S * a.tiles_per_src;
  if (a.n_tiles > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  // static and dynamic shared memory pass 48 KB together: opt in, and
  // count the blocks the card holds at once (once a device and size)
  static int set_dev = -1;
  static size_t set_smem = 0;
  static long long most = 0;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  if (device != set_dev || smem != set_smem) {
    int per_sm = 0;
    e = cudaFuncSetAttribute(exchange_bucket_kernel<kTile>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, exchange_bucket_kernel<kTile>, kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    most = (long long)per_sm * sms;
    set_dev = device;
    set_smem = smem;
  }
  if (most < 1) return (int)cudaErrorInvalidValue;
  // a cooperative launch keeps every block resident at once, so a tile
  // only ever waits on tiles that are running
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel(
      (const void*)exchange_bucket_kernel<kTile>,
      dim3((unsigned)(a.n_tiles < most ? a.n_tiles : most)), dim3(kThreads),
      params, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// int64 words of the scratch for S blocks of B rows to D destinations: a
// look-back word a (source, tile, destination); -1 when that passes
// INT_MAX.
extern "C" int exchange_scratch_words(long long S, long long B, int D) {
  const long long w = words_needed(S, B, D);
  return w > 0x7FFFFFFFll ? -1 : (int)w;
}

// S source blocks of B rows: keys [S, B] int64, ts [S, B] int64, valid
// [S, B] bytes or null, n_valid the rows of the flattened block that may be
// in; cols[c] [S, B] of col_size[c] bytes. D destinations (1 to 256); a row
// routes by its key group against [base_start, base_start + base_len) of
// max parallelism maxp. Writes out_keys, out_panes and out_cols[c], each
// [D, S * B], and counts [S, D] int64. scratch: scratch_words int64 words,
// zero when first used and left for the next call on the same buffers.
// Returns cudaGetLastError.
extern "C" int exchange_bucket_launch(
    const void* keys, const void* ts, const void* valid, long long n_valid,
    long long S, long long B, long long pane, long long offset, int D,
    int maxp, int base_start, int base_len, int n_cols,
    const void* const* cols, const int* col_size, void* out_keys,
    void* out_panes, void* const* out_cols, void* counts, void* scratch,
    long long scratch_words, long long epoch, void* stream) {
  if (S <= 0 || B <= 0 || B >= (1ll << kTagShift) || D < 1 ||
      D > kMaxDest || maxp < 1 || pane <= 0 || base_len < 1 || n_cols < 0 ||
      n_cols > kMaxCols || S > 65535 || scratch == nullptr ||
      scratch_words < words_needed(S, B, D))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.keys = (const long long*)keys;
  a.ts = (const long long*)ts;
  a.valid = (const uint8_t*)valid;
  a.n_valid = n_valid;
  a.B = B;
  a.offset = offset;
  a.by_pane = magic_for((unsigned long long)pane);
  a.by_base_len = magic_for((unsigned long long)base_len);
  a.by_maxp = magic_for((unsigned long long)maxp);
  a.D = D;
  a.maxp = maxp;
  a.base_start = base_start;
  a.base_len = base_len;
  a.n_cols = n_cols;
  for (int c = 0; c < n_cols; ++c) {
    const int sz = col_size[c];
    if (sz != 1 && sz != 2 && sz != 4 && sz != 8)
      return (int)cudaErrorInvalidValue;
    a.cols[c] = cols[c];
    a.col_size[c] = sz;
    a.out_cols[c] = out_cols[c];
  }
  a.out_keys = (long long*)out_keys;
  a.out_panes = (long long*)out_panes;
  a.out_stride = S * B;
  a.counts = (long long*)counts;
  a.scratch = (unsigned long long*)scratch;
  a.tag = (unsigned long long)epoch & kTagMask;
  int per_warp = (D + kWarps - 1) / kWarps, lanes = 32;
  while (lanes * per_warp > 32) lanes >>= 1;
  a.lb_lanes = lanes;
  int sms = 0;
  const cudaError_t e = multiprocessors(sms);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (tile_rows_for(S * B, sms)) {
    case 1024: return launch_tiles<1024>(a, S, B, sms, st);
    case 512: return launch_tiles<512>(a, S, B, sms, st);
    default: return launch_tiles<kMinTileRows>(a, S, B, sms, st);
  }
}

extern "C" const char* exchange_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
