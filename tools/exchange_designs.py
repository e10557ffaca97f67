#!/usr/bin/env python3
"""The designs of the mesh's keyBy exchange kernel, ``exchange_bucket``
(csrc/exchange.cu), timed beside the kept one on one CUDA card.

Run from the repository root, on the card:

    python3 tools/exchange_designs.py [--out FILE] [--timeline] [DESIGN ...]

(with names, only those designs beside the kept one; ``--out``: every
design's whole record also appended to FILE, one JSON line each;
``--timeline``: instead of timing, the kept source and the named designs
with a mark at each phase's end, ``%globaltimer`` read by thread 0 of
each tile, one call each at both shapes: where a tile's time goes).

The earlier kernel stays buildable here: ``tools/exchange_earlier.cu``
holds the earlier kernel (a memset of the counts and one thread a row, a
global atomic base a block and destination, rows in the order the atomics
land). At three shapes (the mesh cell's 4 blocks of 2^17 rows of Q5-10M's
33rd batch to 4 shards with panes of 2000 ms, as the smoke times it; the
same rows with pane 1, as the mesh step passes them; and the mesh Q5-1M
block of 4 x 2^12 rows) each design is timed in turns with the kept
kernel and the earlier one on the same inputs (``chip_smoke.turns``: in
order, then in reverse), each on buffers of its own allocated once.
Before that each design's buffers are held to the plain version's after
two calls back to back on them: every live row position by position for
the stable designs, each segment as a multiset for the unordered one and
the earlier kernel. The profiler counts each design's device operations
a call.

The designs, each against the kept one (a cooperative launch, block k
taking tile k in (source, tile) order, of the largest of 1024, 512 and
256 rows that gives every multiprocessor a tile; each warp's rows
by 16-byte cp.async, its keys first, ranked as soon as they land, its ts
and columns behind the ranks and the look-back; every round's
destination before the ranking, divisions by magic numbers; one
look-back word a lane a step, a 64 ns sleep before reading again; words
tagged with the wrapper's epoch):

* ``tiles_256``, ``tiles_512``, ``tiles_1024``: tiles of that many rows
  at every shape;
* ``one_load_group``: a warp's keys, ts and columns as one group, waited
  for before it ranks;
* ``tile_major``: tiles tile-major over the sources;
* ``ballot_ranks``: up to 8 destinations ranked by a ballot a (round,
  destination), the warp's counts in registers;
* ``ticket``: each block takes its tiles by an atomic ticket;
* ``normal_launch``: an ordinary launch of the same grid, safe only while
  the card holds every block; ``normal_launch_ticket``: an ordinary
  launch with the ticket, safe always;
* ``empty_kernel``: the same launch of an empty kernel with no shared
  memory, the launch's own cost (its buffers are not checked);
* ``look_words_2``, ``look_words_4``: 2 or 4 look-back words a lane a
  step;
* ``late_tail_loads``: a warp's ts and columns issued after it ranks;
* ``no_backoff``: the look-back reads again at once;
* ``int64_division``: the key group, the destination and the pane by
  integer division;
* ``tma_loads``: each warp's ts and columns by TMA bulk copies
  (``cp.async.bulk`` into shared memory, completion on the warp's
  ``mbarrier``), the ragged ends element by element;
* ``self_clearing``: no epoch; the last tile of a source past its
  look-back clears the source's words (a counter a source);
* ``memset_scratch``: no epoch; the scratch zeroed by a memset before each
  launch (two device operations a call);
* ``unordered``: the same staging with an atomic base a (source,
  destination) in place of the look-back; the last tile of a source to
  add writes its counts. Rows within a bucket come in the order the
  tiles' atomics land: the price of stable order.

Each design is the kept source with one change, built with the package's
flags into the package's build directory (all at once, one nvcc each,
with the earlier source); a design that does not build is reported and
skipped. One JSON line per design, each with the card's name and power
limit.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

EARLIER_SOURCE = os.path.join(HERE, "tools", "exchange_earlier.cu")
_P, _PP, _I64, _I32 = (ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                       ctypes.c_longlong, ctypes.c_int)
_PI32 = ctypes.POINTER(ctypes.c_int)
TILES = (256, 512, 1024)
#: designs whose rows within a bucket are not in batch order
UNORDERED = {"unordered"}
#: designs timed only: their buffers are not the function's
UNCHECKED = {"empty_kernel"}

TILE = """  int t = kMaxTileRows;
  while (t > kMinTileRows && (rows + t - 1) / t < sms) t >>= 1;
  return t;"""
LOOK = "constexpr int kLookWords = 1;"
WORDS = "  return S * ((B + kMinTileRows - 1) / kMinTileRows) * D;"
LAUNCH = "  void* params[] = {&a};\n"
TAG_SET = "  a.tag = (unsigned long long)epoch & kTagMask;\n"
COOP = """  e = cudaLaunchCooperativeKernel(
      (const void*)exchange_bucket_kernel<kTile>,
      dim3((unsigned)(a.n_tiles < most ? a.n_tiles : most)), dim3(kThreads),
      params, smem, stream);
"""

TILE_LOOP = """  for (long long k = blockIdx.x; k < a.n_tiles; k += gridDim.x)
    exchange_tile<kTile>(a, smem, k);
"""
TICKET_LOOP = """  // tiles by an atomic ticket, the counter past the look-back words
  __shared__ unsigned long long ticket_s;
  for (;;) {
    if (threadIdx.x == 0)
      ticket_s = atomicAdd(a.scratch + a.n_tiles * a.D, 1ull);
    __syncthreads();
    const long long k = (long long)(ticket_s % (a.n_tiles + gridDim.x));
    __syncthreads();
    if (k >= a.n_tiles) break;
    exchange_tile<kTile>(a, smem, k);
  }
"""
KERNEL = "// Tile k of kTile rows: loads, ranks, look-back and writes"
TILE_ORDER = """  tl.s = k / a.tiles_per_src;
  tl.t = k % a.tiles_per_src;
"""
BACKOFF = """    } else if (!done) {
      __nanosleep(64);  // a predecessor has not published yet
    }
"""
WARP_LOADS = """  if (w1 > w0) {
    for (int g = 0; g < 2; ++g) {
      for (int q = 0; q < n_arrays; ++q) {
        if ((q == 0 || q == valid_k) != (g == 0)) continue;
        const int mis = (int)((uintptr_t)in_src[q] & 15), sz = in_size[q];
        load_range(smem + a.smem_off[q], in_src[q], mis + w0 * sz,
                   mis + w1 * sz, sz, lane);
      }
      asm volatile("cp.async.commit_group;\\n" ::: "memory");
    }
    asm volatile("cp.async.wait_group 1;\\n" ::: "memory");
  }
  __syncwarp();
"""
ONE_GROUP_LOADS = """  if (w1 > w0) {
    for (int q = 0; q < n_arrays; ++q) {
      const int mis = (int)((uintptr_t)in_src[q] & 15), sz = in_size[q];
      load_range(smem + a.smem_off[q], in_src[q], mis + w0 * sz,
                 mis + w1 * sz, sz, lane);
    }
    asm volatile("cp.async.wait_all;\\n" ::: "memory");
  }
  __syncwarp();
"""
TMA_LOADS = """  if (w1 > w0) {
    for (int q = 0; q < n_arrays; ++q) {
      if (q != 0 && q != valid_k) continue;
      const int mis = (int)((uintptr_t)in_src[q] & 15), sz = in_size[q];
      load_range(smem + a.smem_off[q], in_src[q], mis + w0 * sz,
                 mis + w1 * sz, sz, lane);
    }
    // the ts and columns by TMA bulk copies on the warp's mbarrier
    if (lane == 0) {
      unsigned tx = 0;
      for (int q = 1; q < n_arrays; ++q) {
        if (q == valid_k) continue;
        const int mis = (int)((uintptr_t)in_src[q] & 15), sz = in_size[q];
        const int lo = (mis + w0 * sz + 15) & ~15, hi = (mis + w1 * sz) & ~15;
        if (hi > lo) tx += (unsigned)(hi - lo);
      }
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(mb), "r"(tx) : "memory");
      for (int q = 1; q < n_arrays; ++q) {
        if (q == valid_k) continue;
        const int mis = (int)((uintptr_t)in_src[q] & 15), sz = in_size[q];
        const int lo = (mis + w0 * sz + 15) & ~15, hi = (mis + w1 * sz) & ~15;
        if (hi > lo) {
          const unsigned dst = (unsigned)__cvta_generic_to_shared(
              smem + a.smem_off[q] + lo);
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
              "::bytes [%0], [%1], %2, [%3];" ::"r"(dst),
              "l"(in_src[q] - mis + lo), "r"(hi - lo), "r"(mb) : "memory");
        }
      }
    }
    for (int q = 1; q < n_arrays; ++q) {
      if (q == valid_k) continue;
      const int mis = (int)((uintptr_t)in_src[q] & 15), sz = in_size[q];
      const int from = mis + w0 * sz, to = mis + w1 * sz;
      const int lo = (from + 15) & ~15, hi = to & ~15;
      const unsigned char* chunk0 = in_src[q] - mis;
      unsigned char* region = smem + a.smem_off[q];
      // the ends no whole chunk covers, element by element
      const int head_end = hi > lo ? lo : to;
      for (int b = from + lane * sz; b < head_end; b += 32 * sz)
        copy_elem(region + b, chunk0 + b, sz);
      for (int b = (hi > lo ? hi : to) + lane * sz; b < to; b += 32 * sz)
        copy_elem(region + b, chunk0 + b, sz);
    }
    asm volatile("cp.async.wait_all;\\n" ::: "memory");
  }
  __syncwarp();
"""
RANK_END = """  __syncthreads();
  // thread d: the tile's count of d"""
TAIL_ISSUE = """  if (w1 > w0) {
    for (int q = 1; q < n_arrays; ++q) {
      if (q == valid_k) continue;
      const int mis = (int)((uintptr_t)in_src[q] & 15), sz = in_size[q];
      load_range(smem + a.smem_off[q], in_src[q], mis + w0 * sz,
                 mis + w1 * sz, sz, lane);
    }
  }
"""
TAIL_WAIT = """  asm volatile("cp.async.wait_all;\\n" ::: "memory");
  __syncthreads();
  // 4. each destination's run"""
TMA_TAIL_WAIT = """  if (w1 > w0)
    asm volatile(
        "{\\n.reg .pred p;\\nWAIT_%=:\\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\\n"
        "@!p bra WAIT_%=;\\n}" ::"r"(mb) : "memory");
  __syncthreads();
  // 4. each destination's run"""
TMA_INIT_AT = ("  if (tid < n_arrays) {\n"
               "    in_src[tid] = array_src(a, tid, tl.row0);\n")
TMA_INIT = """  // a warp's mbarrier for its TMA loads
  __shared__ __align__(8) unsigned long long tma_bar[kWarps];
  const unsigned mb = (unsigned)__cvta_generic_to_shared(&tma_bar[warp]);
  if (lane == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(mb));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
"""
KERNEL_END = """                     i * sz,
                 sz);
    }
  }
  __syncthreads();  // the tile's shared memory is read before the next
}
"""
DEST = """        dest[r] = (int)div_magic((unsigned long long)rel * a.D,
                                 a.by_base_len);"""
PANE = "    a.out_panes[o] = floor_div(since, a.by_pane);"
GROUP = ("          (long long)(h - (unsigned)div_magic(h, a.by_maxp) * "
         "a.maxp) -")
MATCH_RANKS = """  // each row's rank among its warp's rows of its destination, in row
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
"""
BALLOT_RANKS = """  int rank[kRounds];
  if (a.D <= kBallotDest) {
    int seen[kBallotDest];
#pragma unroll
    for (int q = 0; q < kBallotDest; ++q) seen[q] = 0;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      rank[r] = 0;
#pragma unroll
      for (int q = 0; q < kBallotDest; ++q) {
        if (q < a.D) {
          const unsigned m = __ballot_sync(kFull, dest[r] == q);
          if (dest[r] == q) rank[r] = seen[q] + __popc(m & lt);
          seen[q] += __popc(m);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kBallotDest; ++q)
      if (lane == q && q < a.D) warp_cnt[warp][q] = seen[q];
  } else {
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
  }
"""
INT64_DIV = """// floor(a / b) for b > 0 by int64 division
__device__ __forceinline__ long long floor_div64(long long a, long long b) {
  const long long q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

"""
SELF_CLEAR_END = """                     i * sz,
                 sz);
    }
  }
  // the source's last tile past its look-back clears the source's words
  __shared__ int clear_s;
  unsigned long long* const src_done = a.scratch + a.n_tiles * a.D;
  if (tid == 0) {
    __threadfence();
    clear_s = atomicAdd(src_done + s, 1ull) ==
              (unsigned long long)(a.tiles_per_src - 1);
  }
  __syncthreads();
  if (clear_s) {
    __threadfence();
    for (long long q = tid; q < a.tiles_per_src * a.D; q += kThreads)
      status[q] = 0ull;
    if (tid == 0) src_done[s] = 0ull;
  }
  __syncthreads();  // the tile's shared memory is read before the next
}
"""
PUBLISH = """  if (tid < a.D)
    status[t * a.D + tid] = (t == 0 ? kFlagPrefix : kFlagAggregate) |
                            (tag << kTagShift) | (unsigned long long)cnt;
"""
LOOKBACK_START = "  // 3. the look-back:"
LOOKBACK_END = """    seg_base[d] += (long long)earlier;
  }
"""
UNORDERED_BASE = """  // 3. an atomic base a (source, destination); the source's last tile
  // to add writes its counts and zeroes the accumulators
  __shared__ int last_s;
  unsigned long long* const src_done = a.scratch + a.n_tiles * a.D;
  unsigned long long* const acc = src_done + a.n_tiles / a.tiles_per_src;
  if (tid < a.D)
    seg_base[tid] += (long long)atomicAdd(
        acc + s * a.D + tid, (unsigned long long)tile_cnt[tid]);
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last_s = atomicAdd(src_done + s, 1ull) ==
             (unsigned long long)(a.tiles_per_src - 1);
  }
  __syncthreads();
  if (last_s) {
    __threadfence();
    if (tid < a.D)
      a.counts[s * a.D + tid] =
          (long long)atomicExch(acc + s * a.D + tid, 0ull);
    if (tid == 0) src_done[s] = 0ull;
  }
"""

#: --timeline: thread 0 of each tile writes the %globaltimer at each
#: phase's end into TIMELINE_WORDS words a tile past the scratch's words
#: (warp 0's load and rank stand for the block's)
TIMELINE_WORDS = 8
TIMELINE_PHASES = ("load", "rank", "publish", "look_back", "write")
TAG = "  const unsigned long long tag = a.tag;\n"


def timeline(src: str) -> str:
    """``src`` with the phase marks: word 0 of a tile's record its SM,
    word 1 the time the tile started, words 2 to 6 the end of each of
    TIMELINE_PHASES."""
    src = patch(src, WORDS, WORDS[:-1] +
                f" + S * ((B + kMinTileRows - 1) / kMinTileRows) * "
                f"{TIMELINE_WORDS};")

    def mark(k: int) -> str:
        return ("  if (tid == 0) {\n"
                "    unsigned long long* const rec = a.scratch + "
                "(a.n_tiles / a.tiles_per_src) * ((a.B + kMinTileRows - 1) "
                f"/ kMinTileRows) * a.D + k * {TIMELINE_WORDS};\n"
                "    unsigned long long now;\n"
                "    asm volatile(\"mov.u64 %0, %globaltimer;\" : "
                "\"=l\"(now));\n"
                + ("    unsigned sm;\n"
                   "    asm volatile(\"mov.u32 %0, %smid;\" : \"=r\"(sm));\n"
                   "    rec[0] = sm;\n    rec[1] = now;  // start\n"
                   if k < 0 else f"    rec[{k + 2}] = now;  // "
                                 f"{TIMELINE_PHASES[k]}\n") +
                "  }\n")

    src = patch(src, TAG, TAG + mark(-1))
    keys_in = "  __syncwarp();\n  const long long* keys_s"
    src = patch(src, keys_in, keys_in.replace(
        "  const long long* keys_s", mark(0) + "  const long long* keys_s"))
    for k, anchor in ((1, "  // thread d: the tile's count of d"),
                      (2, LOOKBACK_START),
                      (3, "  // 4. each destination's run")):
        src = patch(src, anchor, mark(k) + anchor)
    return patch(src, KERNEL_END, KERNEL_END.replace(
        "  __syncthreads();  // the tile", mark(4) + "  __syncthreads();  "
        "// the tile"))


def patch(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"the kept source changed: {old[:60]!r}")
    return src.replace(old, new)


def designs(src: str) -> dict:
    """design -> (what it changes, its source)."""
    out = {f"tiles_{t}": (f"tiles of {t} rows at every shape",
                          patch(src, TILE, f"  (void)rows;\n  (void)sms;\n"
                                           f"  return {t};"))
           for t in TILES}
    out["one_load_group"] = (
        "a warp's keys, ts and columns as one group, waited for before it "
        "ranks (kept: the keys first, the ts and columns behind the ranks "
        "and the look-back)",
        patch(patch(src, WARP_LOADS, ONE_GROUP_LOADS), TAIL_WAIT,
              TAIL_WAIT.replace('  asm volatile("cp.async.wait_all;\\n" '
                                '::: "memory");\n', "")))
    late = WARP_LOADS.replace(
        "    for (int g = 0; g < 2; ++g) {",
        "    for (int g = 0; g < 1; ++g) {"
    ).replace("    asm volatile(\"cp.async.wait_group 1;\\n\" ::: "
              "\"memory\");\n", "    asm volatile(\"cp.async.wait_group 0;"
              "\\n\" ::: \"memory\");\n")
    out["late_tail_loads"] = (
        "a warp's ts and columns issued after it ranks (kept: right after "
        "its keys)",
        patch(patch(src, WARP_LOADS, late), RANK_END, TAIL_ISSUE + RANK_END))
    out["look_words_2"] = (
        "2 look-back words a lane a step (kept: 1)",
        patch(src, LOOK, "constexpr int kLookWords = 2;"))
    out["ballot_ranks"] = (
        "up to 8 destinations ranked by a ballot a (round, destination), "
        "the warp's counts in registers (kept: __match_any_sync against "
        "counters in shared memory)",
        patch(patch(src, MATCH_RANKS, BALLOT_RANKS), LOOK,
              LOOK + "\nconstexpr int kBallotDest = 8;"))
    out["tile_major"] = (
        "tiles tile-major over the sources (tile k / S of source k % S; "
        "kept: (source, tile) order)",
        patch(src, TILE_ORDER, "  const long long S = a.n_tiles / "
                               "a.tiles_per_src;\n  tl.s = k % S;\n"
                               "  tl.t = k / S;\n"))
    out["ticket"] = (
        "each block takes its tiles by an atomic ticket (kept: its block "
        "index, every block resident by the cooperative launch)",
        patch(patch(src, WORDS, WORDS[:-1] + " + 1;"), TILE_LOOP,
              TICKET_LOOP))
    out["look_words_4"] = (
        "4 look-back words a lane a step (kept: 1)",
        patch(src, LOOK, "constexpr int kLookWords = 4;"))
    out["no_backoff"] = (
        "the look-back reads again at once (kept: a 64 ns sleep first)",
        patch(src, BACKOFF, "    }\n"))
    out["int64_division"] = (
        "the key group, the destination and the pane by int64 division "
        "(kept: a multiply by a magic number fixed for the launch)",
        patch(patch(patch(patch(patch(patch(
            src, KERNEL, INT64_DIV + KERNEL), DEST,
            "        dest[r] = (int)(rel * a.D / a.base_len);"),
            PANE, "    a.out_panes[o] = floor_div64(since, a.pane);"),
            GROUP, "          (long long)(h % a.maxp) -"),
            "  long long offset;\n", "  long long offset, pane;\n"),
            "  a.offset = offset;\n",
            "  a.offset = offset;\n  a.pane = pane;\n"))
    out["tma_loads"] = (
        "each warp's ts and columns by TMA bulk copies on its own mbarrier "
        "(kept: 16-byte cp.async)",
        patch(patch(patch(src, TMA_INIT_AT, TMA_INIT + TMA_INIT_AT),
                    WARP_LOADS, TMA_LOADS), TAIL_WAIT, TMA_TAIL_WAIT))
    out["self_clearing"] = (
        "no epoch: the source's last tile past its look-back clears its "
        "words",
        patch(patch(patch(src, WORDS, WORDS[:-1] + " + S;"), KERNEL_END,
                    SELF_CLEAR_END), TAG_SET, "  a.tag = 0;\n"))
    normal = ("  exchange_bucket_kernel<kTile><<<(unsigned)(a.n_tiles < most "
              "? a.n_tiles : most),\n"
              "                                  kThreads, smem, stream>>>(a);"
              "\n  e = cudaGetLastError();\n  (void)params;\n")
    out["normal_launch"] = (
        "an ordinary launch of the same grid (kept: cooperative, which "
        "keeps every block resident); safe only while the card holds "
        "every block",
        patch(src, COOP, normal))
    out["normal_launch_ticket"] = (
        "an ordinary launch, each block taking its tiles by an atomic "
        "ticket, so a tile waits only on tiles that started",
        patch(out["ticket"][1], COOP, normal))
    out["empty_kernel"] = (
        "the same launch of a kernel with an empty body and no shared "
        "memory: the launch's own cost (its buffers are not checked)",
        patch(patch(patch(src, TILE_LOOP, ""), COOP,
                    COOP.replace("params, smem,", "params, 0,")),
              "          &per_sm, exchange_bucket_kernel<kTile>, kThreads, "
              "smem);",
              "          &per_sm, exchange_bucket_kernel<kTile>, kThreads, "
              "0);"))
    out["memset_scratch"] = (
        "no epoch: a memset of the scratch before each launch",
        patch(patch(src, LAUNCH,
                    "  e = cudaMemsetAsync(a.scratch, 0,\n"
                    "                      (size_t)words_needed(S, B, a.D)"
                    " * 8, stream);\n"
                    "  if (e != cudaSuccess) return (int)e;\n" + LAUNCH),
              TAG_SET, "  a.tag = 0;\n"))
    i, j = src.index(LOOKBACK_START), src.index(LOOKBACK_END)
    look = src[i:j + len(LOOKBACK_END)]
    out["unordered"] = (
        "an atomic base a (source, destination) in place of the look-back",
        patch(patch(patch(src, WORDS, WORDS[:-1] + " + S + S * D;"),
                    PUBLISH, ""), look, UNORDERED_BASE))
    return out


def _build(kernels, src_path: str, out):
    """nvcc on ``src_path`` into ``out`` with the package's flags, started;
    returns the process."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC_DIR),
         "-o", str(out), src_path], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)


def start_earlier_build():
    """Starts nvcc on tools/exchange_earlier.cu beside the package's
    builds. Returns (library path, (tmp path, process) or None when
    built)."""
    from flink_tpu_torch.ops import kernels

    with open(EARLIER_SOURCE, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update((kernels.CSRC_DIR / "keygroup.cuh").read_bytes())
    h.update(" ".join(kernels.NVCC_FLAGS).encode())
    out = kernels.BUILD_DIR / f"libexchange_earlier-{h.hexdigest()[:12]}.so"
    if out.exists():
        return out, None
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    return out, (tmp, _build(kernels, EARLIER_SOURCE, tmp))


class EarlierKernel:
    """The earlier exchange_bucket (a memset of the counts, then its kernel) on
    ``chip_smoke.exchange_case`` inputs."""

    def __init__(self, build):
        out, job = build
        if job is not None:
            tmp, proc = job
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed on tools/exchange_earlier.cu:"
                                   "\n" + log.decode(errors="replace"))
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        fn = lib.exchange_bucket_earlier_launch
        fn.argtypes = [_P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I32, _I32,
                       _I32, _I32, _I32, _PP, _PI32, _P, _P, _PP, _P, _P]
        fn.restype = ctypes.c_int
        lib.exchange_earlier_error_string.argtypes = [ctypes.c_int]
        lib.exchange_earlier_error_string.restype = ctypes.c_char_p
        self.lib = lib

    def run(self, torch, cs, x: dict, out) -> None:
        cols, ocols = x["cols"], out.cols
        n = len(cols)
        rc = self.lib.exchange_bucket_earlier_launch(
            x["keys"].data_ptr(), x["ts"].data_ptr(), None, x["n_valid"],
            x["S"], x["B"], x.get("pane", cs.PANE_MS), 0, x["D"], x["maxp"],
            x["start"], x["length"], n,
            (ctypes.c_void_p * n)(*[c.data_ptr() for c in cols]),
            (ctypes.c_int * n)(*[c.element_size() for c in cols]),
            out.keys.data_ptr(), out.panes.data_ptr(),
            (ctypes.c_void_p * n)(*[c.data_ptr() for c in ocols]),
            out.counts.data_ptr(),
            torch.cuda.current_stream(x["keys"].device).cuda_stream)
        if rc:
            raise RuntimeError("the earlier exchange kernel: CUDA error "
                               + self.lib.exchange_earlier_error_string(rc)
                               .decode())


def bind(kernels, so):
    lib = ctypes.CDLL(str(so))
    for entry, argtypes in kernels.SOURCES["exchange"].items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.exchange_error_string.argtypes = [ctypes.c_int]
    lib.exchange_error_string.restype = ctypes.c_char_p
    return lib


@contextlib.contextmanager
def bound(kernels, lib):
    """``ops/exchange.py`` on ``lib`` in place of the kept library."""
    kept = kernels._LIBS.get("exchange")
    kernels._LIBS["exchange"] = lib
    try:
        yield
    finally:
        kernels._LIBS["exchange"] = kept


def segments_equal_as_multisets(torch, a, b) -> bool:
    """Equal counts, and every (source, destination) segment the same
    multiset of (key, pane, value) rows."""
    if not torch.equal(a.counts, b.counts):
        return False
    S, B, D = a.n_src, a.block, a.n_dest
    pos = torch.arange(S * B, device=a.keys.device)
    live = (pos % B)[None, :] < a.counts.t().repeat_interleave(B, 1)
    for d in range(D):
        cols = []
        for o in (a, b):
            seg = (pos // B)[live[d]]
            rows = [o.keys[d][live[d]], o.panes[d][live[d]],
                    *[c[d][live[d]] for c in o.cols]]
            order = torch.arange(seg.numel(), device=seg.device)
            for col in reversed([seg] + rows):
                order = order[torch.argsort(col[order], stable=True)]
            cols.append([r[order] for r in rows])
        if not all(torch.equal(x, y) for x, y in zip(*cols)):
            return False
    return True


def shapes(torch, cs, dev) -> dict:
    """The cell's block (panes of PANE_MS ms, as the smoke times it), the
    same rows as the mesh step passes them (pane 1: the ts are its panes
    already), and the mesh Q5-1M block."""
    out = cs.exchange_shapes(torch, dev)
    return {"cell": out["cell"], "cell_pane_1": {**out["cell"], "pane": 1},
            "q5_1m_block": out["q5_1m_block"]}


def design_turns(torch, cs, kernels, flush, name: str, lib, kept_lib,
                 earlier, inputs: dict) -> dict:
    """At each shape: the design's buffers after two calls back to back
    held to the plain version's (and the earlier kernel's as multisets),
    its device operations a call, and its time in turns with the kept and
    the earlier kernels."""
    dev = torch.device("cuda", 0)
    out = {}
    for label, x in inputs.items():
        D = x["D"]
        want = cs.run_exchange(torch, dev, x, D, True)
        with bound(kernels, lib):
            mine = cs.run_exchange(torch, dev, x, D, False)
            cs.run_exchange(torch, dev, x, D, False, mine)
        with bound(kernels, kept_lib):
            kept = cs.run_exchange(torch, dev, x, D, False)
        older = cs.run_exchange(torch, dev, x, D, True)
        earlier.run(torch, cs, x, older)
        torch.cuda.synchronize()
        same = name in UNCHECKED or (
            segments_equal_as_multisets if name in UNORDERED
            else cs.exchange_segments_equal)(torch, mine, want)
        if not same or not segments_equal_as_multisets(torch, older, want):
            raise AssertionError(f"{name} at {label}: the buffers differ "
                                 "from the plain version's")

        def design_fn():
            with bound(kernels, lib):
                cs.run_exchange(torch, dev, x, D, False, mine)

        def kept_fn():
            with bound(kernels, kept_lib):
                cs.run_exchange(torch, dev, x, D, False, kept)

        def earlier_fn():
            earlier.run(torch, cs, x, older)

        ops, _tries = cs.device_kernels(torch, design_fn, "exchange_bucket",
                                        1)
        fns = {"design": design_fn, "kept": kept_fn, "earlier": earlier_fn}
        if name == "kept":
            del fns["design"]
        out[label] = {"rows": x["S"] * x["B"], "destinations": D,
                      "routed": int(want.counts.sum()),
                      "device_ops_a_call": len(ops), "device_ops": ops,
                      **cs.turns(torch, flush, None, **fns)}
        del want, mine, kept, older
    return out


def timeline_record(torch, cs, kernels, flush, lib, x: dict) -> dict:
    """One call of a timeline build at the shape of ``x`` (after a
    warm-up call, queued behind a device sleep, the L2 flushed): per
    phase of a tile the 10th, 50th and 90th percentile of its µs, the
    tiles' start and end against the first tile's start, the span, and
    the tiles an SM took."""
    import numpy as np

    dev = torch.device("cuda", 0)
    with bound(kernels, lib):
        out = cs.run_exchange(torch, dev, x, x["D"], False)
        cs.run_exchange(torch, dev, x, x["D"], False, out)
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000)
        flush()
        cs.run_exchange(torch, dev, x, x["D"], False, out)
    torch.cuda.synchronize()
    slots = out.scratch.numel() // (x["D"] + TIMELINE_WORDS)
    rec = out.scratch[slots * x["D"]:].view(slots, TIMELINE_WORDS)
    rec = rec.cpu().numpy().astype(np.float64)
    rec = rec[rec[:, 1] > 0]  # the tiles this launch took
    n_tiles = len(rec)
    t0 = rec[:, 1].min()
    us = np.diff(rec[:, 1:2 + len(TIMELINE_PHASES)], axis=1) / 1e3

    def pct(v):
        return {f"p{q}": float(np.percentile(v, q)) for q in (10, 50, 90)}

    _sms, per_sm = np.unique(rec[:, 0], return_counts=True)
    end = rec[:, 1 + len(TIMELINE_PHASES)]
    return {"tiles": n_tiles, "span_us": float((end.max() - t0) / 1e3),
            "phases_us": {ph: pct(us[:, k])
                          for k, ph in enumerate(TIMELINE_PHASES)},
            "tile_start_us": pct((rec[:, 1] - t0) / 1e3),
            "tile_end_us": pct((end - t0) / 1e3),
            "sms": int(len(per_sm)), "tiles_an_sm": pct(per_sm)}


def main(argv: list[str]) -> int:
    import gc

    import torch

    out_path = None
    if argv[:1] == ["--out"]:
        out_path, argv = argv[1], argv[2:]
    with_timeline = argv[:1] == ["--timeline"]
    if with_timeline:
        argv = argv[1:]
    if not torch.cuda.is_available():
        print("exchange_designs: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from flink_tpu_torch.ops import kernels

    def emit(rec: dict) -> None:
        cs.emit(rec)
        if out_path:
            with open(out_path, "a") as f:
                f.write(cs.json.dumps(rec) + "\n")

    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    src = (kernels.CSRC_DIR / "exchange.cu").read_text()
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    every = designs(src)
    if with_timeline:
        marked = {}
        for name, (what, text) in {"kept": ("the kept source", src),
                                   **every}.items():
            if name != "kept" and name not in argv:
                continue
            try:
                marked[f"timeline_{name}"] = (
                    f"{what}, with the phase marks", timeline(text))
            except ValueError as e:
                emit({"design": f"timeline_{name}", "card": smi,
                      "built": False, "marks": str(e)})
        every, argv = marked, []
    for name, (what, text) in every.items():
        if argv and name not in argv:
            continue
        cu = kernels.BUILD_DIR / f"design_exchange_{name}.cu"
        cu.write_text(text)
        so = kernels.BUILD_DIR / f"libdesign_exchange_{name}.so"
        jobs[name] = (what, so, _build(kernels, str(cu), so))
    earlier = EarlierKernel(start_earlier_build())
    kernels.build_all()
    flush = cs.L2Flush(torch, dev)
    kept = kernels.library("exchange")
    inputs = shapes(torch, cs, dev)

    def timed(name, lib) -> dict:
        rec = design_turns(torch, cs, kernels, flush, name, lib, kept,
                           earlier, inputs)
        gc.collect()
        torch.cuda.empty_cache()
        return rec

    if with_timeline:
        for name, (what, so, proc) in jobs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                emit({"design": name, "card": smi, "built": False,
                      "nvcc": log.decode(errors="replace")[-2000:]})
                continue
            lib = bind(kernels, so)
            emit({"design": name, "change": what, "card": smi, "timeline": {
                label: timeline_record(torch, cs, kernels, flush, lib, x)
                for label, x in inputs.items()}})
        return 0
    emit({"design": "kept", "card": smi,
          "ptxas": cs.ptxas_report(kernels.build_log("exchange")),
          "shapes": timed("kept", kept)})
    for name, (what, so, proc) in jobs.items():
        log, _ = proc.communicate()
        text = log.decode(errors="replace")
        if proc.returncode != 0:
            emit({"design": name, "change": what, "card": smi,
                  "built": False, "nvcc": text[-2000:]})
            continue
        try:
            rec = {"shapes": timed(name, bind(kernels, so))}
        except (AssertionError, RuntimeError) as e:
            rec = {"failed": str(e)[:500]}
        emit({"design": name, "change": what, "card": smi,
              "ptxas": cs.ptxas_report(text), **rec})
    emit({"design": "kept, again", "card": smi,
          "shapes": timed("kept", kept)})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
