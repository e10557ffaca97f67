#!/usr/bin/env python3
"""The designs of the list state's append, probe and prune
(csrc/device_lists.cu), timed beside the kept ones on one CUDA card.

Run from the repository root, on the card:

    python3 tools/list_designs.py [--out FILE] [DESIGN ...]

(with names, only those designs beside the kept one; ``--out``: every
design's whole record also appended to FILE, one JSON line each).

The earlier designs' kernels stay buildable here:
``tools/list_earlier.cu`` holds them as they were before the tile
summary and the one-launch probe (the append as five kernels and a
memset, a claimed list zeroed in the first and its row written in the
second; the prune as one thread a slot over every count, then a warp a
list that moves; the probe as a count, a scan and a write kernel with a
host read of the total between them, each list read twice), bound by
``EarlierKernels``. Every case of ``chip_smoke.list_shape_cases`` times
them in turns with the kernel of the design under test, on the same
states, their results held equal to the kernel's.

The designs, at both Q7 join cells' shapes (``chip_smoke.list_shape_cases``:
a bid batch and a fire's maxes appended, the maxes probing the bids and
a bid batch probing the maxes, the bids' watermark prune and the maxes'
prune that drops them all), each held against the plain versions:

* tiles of 64, 256 and 512 slots against the kept 128 (the tile size is
  read from the summary's shape: no rebuild);
* the append's phases over chunks of 2^18 and 2^20 rows in turn (kept:
  the whole batch at once), so that a chunk's hits and counts sectors
  are still in L2 when its second phase comes back to them;
* a warp a claimed list (kept: 8 lanes a list), and every resident block
  in the grid, so that a small batch's lists are written by all the
  card's warps (kept: a thread a row, at most the resident blocks);
* a claimed list's row stored by its own lane in 8-byte stores, the
  zeros after it by the grid (partial sectors);
* the claimed lists stored through L2 (plain stores, not st.global.cs);
* a warp's rows of one tile folded before the summary's atomics, and
  each bound read before its atomic;
* the probe's matches staged in shared memory and stored by the block as
  16-byte words (a tile whose matches do not fit stores them row by row;
  kept: each row stores its own matches);
* the probe's ts loads one at a time (kept: 8 issued together).

Each source design is the kept source with one change, built with the
package's flags into the package's build directory (all at once, one
nvcc each, with the earlier source) and bound in place of the kept library; a
design that does not build is reported and skipped. One JSON line per
design, each with the card's name and power limit: the kernel's ms and
the earlier design's at each case, the prune's tiles visited.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

EARLIER_SOURCE = os.path.join(HERE, "tools", "list_earlier.cu")
#: the kept streaming stores of a claimed list
STREAM_V2 = 'asm volatile("st.global.cs.v2.b64 [%0], {%1, %2};"'
STREAM_1 = 'asm volatile("st.global.cs.b64 [%0], %1;"'
#: the kept append kernel: its phases over the whole batch at once
KERNEL_FROM = ("__global__ void __launch_bounds__(kThreads) "
               "list_append_kernel(AppendArgs a) {")
KERNEL_TO = "struct PruneArgs {"
#: the append kernel with its phases over chunks of kChunkRows rows in
#: turn, in batch order (an append of a batch is the appends of its chunks
#: in turn), a barrier between chunks
CHUNKED = r"""__global__ void __launch_bounds__(kThreads) list_append_kernel(AppendArgs a) {
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
  bool full = false;
  long long dups_before = 0;
  // the phases run over kChunkRows rows at a time, in batch order: an
  // append of a batch is the appends of its chunks in turn
  for (long long c0 = 0; c0 < a.n; c0 += kChunkRows) {
    const long long c1 = a.n - c0 < kChunkRows ? a.n : c0 + kChunkRows;
    // 1. claim; arrival index; keys inserted and failed inserts a block
    for (long long base = c0 + first; base < c1; base += stride) {
      const long long i = base + threadIdx.x;
      bool inserted = false;
      if (i < c1) {
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
    // 2. slots of one row finished, claimed lists written, duplicates
    // listed
    for (long long base = c0 + first; base < c1; base += stride) {
      const long long i = base + threadIdx.x;
      int s = -1;
      unsigned ar = 0u, k = 0u;
      if (i < c1) {
        s = __ldcg(a.slot + i);
        if (s >= 0) {
          ar = __ldcg(a.arr + i);
          k = (unsigned)__ldcg(a.hits + s);
        }
      }
      const bool fresh = s >= 0 && (ar & kInserted31);
      bool wrote = false, born = false;
      long long ts = 0;
      if (s >= 0 && k == 1u) {
        ts = a.packed[i * a.C];
        if (fresh) {  // its list written whole by write_claimed
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
    // W. the claimed lists (the dup rows come after the next barrier)
    write_claimed(a, c0, c1);
    const long long d0 = dups_before;
    const long long d1 = (long long)__ldcg(a.flags + kDups);
    dups_before = d1;
    if (d1 == d0) {  // uniform over the grid
      if (c1 < a.n) grid.sync();  // lists written before the next chunk
      continue;
    }
    // 3a. each duplicate row's batch index at its arrival in the segment
    for (long long base = d0 + first; base < d1; base += stride) {
      const long long t = base + threadIdx.x;
      if (t < d1) {
        const int i = __ldcg(a.dup + t);
        const int s = __ldcg(a.slot + i);
        a.seg[(__ldcg(a.hits + s) >> 32) +
              (__ldcg(a.arr + i) & ~kInserted31)] = i;
      }
    }
    grid.sync();
    // 3b. each duplicate row's rank; the row written at count + rank
    for (long long base = d0 + first; base < d1; base += stride) {
      const long long t = base + threadIdx.x;
      int s = -1;
      bool wrote = false;
      long long ts = 0;
      if (t < d1) {
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
    for (long long base = d0 + first; base < d1; base += stride) {
      const long long t = base + threadIdx.x;
      int s = -1;
      bool born = false;
      if (t < d1) {
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
    if (c1 < a.n) grid.sync();  // hits zero again before the next chunk
  }
  // flags were zeroed before the first barrier
  if (full) a.flags[kListFull] = 1ull;
  __syncthreads();
  if (threadIdx.x == 0) {
    if (blk_inserted) atomicAdd(a.flags + kInserted, blk_inserted);
    if (blk_failed) a.flags[kInsertFailed] = 1ull;
  }
}

"""
#: the kept lanes a claimed list
LIST_LANES = "constexpr int kListLanes = 8;"
#: the kept grid of the append: a thread a row, at most the resident blocks
GRID = ("  const long long want = blocks_for(n);\n"
        "  const unsigned grid = (unsigned)(want < most ? want : most);")
#: the kept claimed list's stores: its row and the zeros after it together
EVEN_UNIT = ("        store_streaming(r + w, row && w < a.C ? p[w] : 0,\n"
             "                        row && w + 1 < a.C ? p[w + 1] : 0);\n")
ODD_UNIT = "        store_streaming(r + e, row && e < a.C ? p[e] : 0);\n"
FRESH = "        a.arr[i] = kInserted31 | kRow30;\n"
#: the kept summary note of a row: its atomics, each row its own
NOTE_FROM = "__device__ __forceinline__ void tile_note("
NOTE_TO = "struct AppendArgs {"
#: a warp's rows of one tile folded first, each bound read before its
#: atomic (the first design)
NOTE_FOLD = r"""__device__ __forceinline__ void tile_note(const Tiles& t, int s, bool wrote,
                                          long long ts, bool born) {
  const int lane = threadIdx.x & 31;
  const bool any = wrote || born;
  const long long tile = any ? (long long)(s >> t.shift) : -1ll - lane;
  const unsigned peers = __match_any_sync(kFull, tile);
  long long lo = wrote ? ts : kInt64Max, hi = wrote ? ts : kInt64Min;
  int add = born ? 1 : 0;
  const int most = (int)__reduce_max_sync(kFull, (unsigned)__popc(peers));
  if (most > 1) {
    const long long lo0 = lo, hi0 = hi;
    const int add0 = add;
    unsigned m = peers & ~(1u << lane);
    for (int r = 1; r < most; ++r) {
      const int src = m ? __ffs(m) - 1 : lane;
      m &= m - 1u;
      const long long x = __shfl_sync(kFull, lo0, src);
      const long long y = __shfl_sync(kFull, hi0, src);
      const int z = __shfl_sync(kFull, add0, src);
      if (src != lane) {
        lo = x < lo ? x : lo;
        hi = y > hi ? y : hi;
        add += z;
      }
    }
  }
  if (!any || (peers & ((1u << lane) - 1u))) return;
  if (lo < __ldcg(t.lo + tile)) atomicMin(t.lo + tile, lo);
  if (hi > __ldcg(t.hi + tile)) atomicMax(t.hi + tile, hi);
  if (add)
    atomicAdd(reinterpret_cast<unsigned long long*>(t.live + tile),
              (unsigned long long)add);
}

"""
#: the kept probe's write: each row its own matches
PROBE_WRITE = r"""  long long off = base + before + x - m;
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
"""
#: the probe's write staged: a tile's matches (when they fit) into shared
#: memory at their place in the tile's output, then the block stores them
#: as 16-byte words (an 8-byte word at an unaligned head or a lone tail)
PROBE_STAGED = r"""  constexpr long long kStageWords = 2048;
  __shared__ __align__(16) long long stage[kStageWords];
  long long off = base + before + x - m;
  const long long end = base + total < a.cap ? base + total : a.cap;
  const bool staged = (end - base) * a.C <= kStageWords;  // block-uniform
  if (m > 0 && off < a.cap) {
    const long long* r = a.rows + (long long)s * a.lc;
    for (int j = 0; j < c && off < a.cap; ++j) {
      const long long* row = r + (long long)j * a.C;
      if (j < kMaskRows) {
        if (!((bits >> j) & 1u)) continue;
      } else if (a.ts != nullptr) {
        const long long v = __ldg(row);
        if (v < lo || v > hi) continue;
      }
      a.out_idx[off] = i;
      if (staged) {
        long long* o = stage + (off - base) * a.C;
        for (int e = 0; e < a.C; ++e) o[e] = __ldg(row + e);
      } else {
        long long* o = a.out_packed + off * a.C;
        for (int e = 0; e < a.C; ++e) o[e] = __ldg(row + e);
      }
      ++off;
    }
  }
  if (staged) {
    __syncthreads();
    const long long words = (end - base) * a.C;
    long long* dst = a.out_packed + base * a.C;
    const long long head = ((uintptr_t)dst & 15) != 0 ? 1 : 0;
    if (tid == 0 && head && words > 0) dst[0] = stage[0];
    const long long pairs = words > head ? (words - head) / 2 : 0;
    for (long long q = tid; q < pairs; q += kThreads) {
      const long long w = head + 2 * q;
      *reinterpret_cast<longlong2*>(dst + w) =
          make_longlong2(stage[w], stage[w + 1]);
    }
    if (tid == 0 && words > head && (words - head) % 2)
      dst[words - 1] = stage[words - 1];
  }
"""
#: the kept ts loads a probe row issues together
TS_LOADS = "constexpr int kTsLoads = 8;"
#: tile sizes tried beside the kept one (128)
TILE_SIZES = (64, 256, 512)

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def patch(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"the kept source changed: {old[:60]!r}")
    return src.replace(old, new)


def designs(src: str) -> dict:
    """design -> (what it changes, its source)."""
    lo, hi = src.index(NOTE_FROM), src.index(NOTE_TO)
    return {
        **{f"chunks_of_2^{b}": (
            f"the append's phases over chunks of 2^{b} rows in turn",
            src[:src.index(KERNEL_FROM)]
            + f"constexpr long long kChunkRows = 1ll << {b};\n\n" + CHUNKED
            + src[src.index(KERNEL_TO):])
           for b in (18, 20)},
        "list_lanes_32": (
            "a warp a claimed list (kept: 8 lanes a list)",
            patch(src, LIST_LANES, LIST_LANES.replace("8", "32"))),
        "whole_grid": (
            "the append's grid every resident block, so that a small "
            "batch's lists are written by all the card's warps (kept: a "
            "thread a row)",
            patch(src, GRID, "  const unsigned grid = (unsigned)most;")),
        "row_by_its_lane": (
            "a claimed list's row stored by its own lane in 8-byte stores "
            "in phase 2, the zeros after it by the grid",
            patch(patch(patch(src, FRESH, FRESH + (
                "        for (int w = 0; w < a.C; ++w)\n"
                "          store_streaming(a.rows + (long long)s * a.lc + w, "
                "a.packed[i * a.C + w]);\n")), EVEN_UNIT, (
                "        if (row && w + 1 < a.C) continue;\n"
                "        if (row && w < a.C) {\n"
                "          store_streaming(r + w + 1, 0ll);\n"
                "          continue;\n"
                "        }\n"
                "        store_streaming(r + w, 0ll, 0ll);\n")), ODD_UNIT,
                "        if (!(row && e < a.C)) store_streaming(r + e, 0ll);"
                "\n")),
        "stores_through_l2": (
            "a claimed list stored through L2 (plain stores)",
            patch(patch(src, STREAM_V2, STREAM_V2.replace(".cs", "")),
                  STREAM_1, STREAM_1.replace(".cs", ""))),
        "tile_fold_and_read": (
            "a warp's rows of one tile folded before the summary's atomics, "
            "each bound read before its atomic",
            src[:lo] + NOTE_FOLD + src[hi:]),
        "probe_staged_stores": (
            "the probe's matches staged in shared memory, stored as 16-byte "
            "words by the block (kept: each row its own)",
            patch(src, PROBE_WRITE, PROBE_STAGED)),
        "probe_ts_loads_1": (
            "the probe's ts loads one at a time (kept: 8 together)",
            patch(src, TS_LOADS, TS_LOADS.replace("8", "1"))),
    }


def _build(kernels, name: str, src_path: str, out):
    """nvcc on ``src_path`` into ``out`` with the package's flags, started;
    returns the process."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC_DIR),
         "-o", str(out), src_path], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)


def start_earlier_build():
    """Starts nvcc on tools/list_earlier.cu beside the package's builds.
    Returns (library path, process or None when already built)."""
    from flink_tpu_torch.ops import kernels

    with open(EARLIER_SOURCE, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update((kernels.CSRC_DIR / "probe.cuh").read_bytes())
    h.update(" ".join(kernels.NVCC_FLAGS).encode())
    out = kernels.BUILD_DIR / f"liblist_earlier-{h.hexdigest()[:12]}.so"
    if out.exists():
        return out, None
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    return out, (tmp, _build(kernels, "earlier", EARLIER_SOURCE, tmp))


class EarlierKernels:
    """The earlier list_append, list_prune and list_probe on a
    ``chip_smoke.list_state`` (its tile summary neither read nor kept)."""

    def __init__(self, build):
        out, job = build
        if job is not None:
            tmp, proc = job
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed on tools/list_earlier.cu:\n"
                                   + log.decode(errors="replace"))
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        lib.list_append_earlier_launch.argtypes = [
            _P, _I64, _P, _I32, _I32, _P, _P, _P, _P, _I64, _P, _P, _P, _P]
        lib.list_prune_earlier_launch.argtypes = [
            _P, _I32, _I32, _P, _I64, _I64, _I32, _P, _P, _P]
        lib.list_probe_earlier_blocks.argtypes = [_I64]
        lib.list_probe_earlier_count_launch.argtypes = [
            _P, _I64, _P, _I32, _I32, _P, _P, _I64, _P, _I64, _I64, _P, _P,
            _P, _P]
        lib.list_probe_earlier_write_launch.argtypes = [
            _P, _I32, _I32, _P, _I64, _P, _I64, _I64, _P, _P, _P, _P, _P, _P]
        for fn in (lib.list_append_earlier_launch,
                   lib.list_prune_earlier_launch,
                   lib.list_probe_earlier_blocks,
                   lib.list_probe_earlier_count_launch,
                   lib.list_probe_earlier_write_launch):
            fn.restype = ctypes.c_int
        lib.list_earlier_error_string.argtypes = [ctypes.c_int]
        lib.list_earlier_error_string.restype = ctypes.c_char_p
        self.lib = lib

    def _check(self, rc: int) -> None:
        if rc:
            raise RuntimeError("the earlier list kernel: CUDA error "
                               + self.lib.list_earlier_error_string(rc)
                               .decode())

    def append(self, torch, st: dict, keys, packed):
        """(flags int64 [3], failed bool [n]) as ``list_append``."""
        n = keys.numel()
        dev = keys.device
        scratch = torch.empty(4 * max(n, 1), dtype=torch.int32, device=dev)
        failed = torch.empty(n, dtype=torch.bool, device=dev)
        flags = torch.empty(5, dtype=torch.int64, device=dev)
        rows = st["rows"]
        self._check(self.lib.list_append_earlier_launch(
            st["table"].data_ptr(), st["table"].numel(), rows.data_ptr(),
            rows.shape[1], rows.shape[2], st["counts"].data_ptr(),
            st["hits"].data_ptr(), keys.data_ptr(), packed.data_ptr(), n,
            scratch.data_ptr(), failed.data_ptr(), flags.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream))
        return flags[:3], failed

    def probe(self, torch, st: dict, keys, ts, lo_off: int, hi_off: int):
        """(batch row [M], packed rows [M, C], matches a row [n]) as
        ``list_probe``: three kernels, one host read of M between them."""
        n = keys.numel()
        dev = keys.device
        rows = st["rows"]
        L, C = rows.shape[1], rows.shape[2]
        nb = self.lib.list_probe_earlier_blocks(n)
        m = torch.empty(n, dtype=torch.int32, device=dev)
        slots = torch.empty(n, dtype=torch.int32, device=dev)
        block_off = torch.empty(nb + 1, dtype=torch.int64, device=dev)
        ts_ptr = ts.data_ptr() if ts is not None else None
        stream = torch.cuda.current_stream(dev).cuda_stream
        self._check(self.lib.list_probe_earlier_count_launch(
            st["table"].data_ptr(), st["table"].numel(), rows.data_ptr(), L,
            C, st["counts"].data_ptr(), keys.data_ptr(), n, ts_ptr,
            int(lo_off), int(hi_off), m.data_ptr(), slots.data_ptr(),
            block_off.data_ptr(), stream))
        total = int(block_off[nb])
        out_idx = torch.empty(total, dtype=torch.int64, device=dev)
        out_packed = torch.empty((total, C), dtype=torch.int64, device=dev)
        if total:
            self._check(self.lib.list_probe_earlier_write_launch(
                rows.data_ptr(), L, C, st["counts"].data_ptr(), n, ts_ptr,
                int(lo_off), int(hi_off), m.data_ptr(), slots.data_ptr(),
                block_off.data_ptr(), out_idx.data_ptr(),
                out_packed.data_ptr(), stream))
        return out_idx, out_packed, m

    def prune(self, torch, st: dict, horizon: int):
        """The keys left with a live row, as ``list_prune``."""
        rows = st["rows"]
        result = torch.empty(2, dtype=torch.int64, device=rows.device)
        self._check(self.lib.list_prune_earlier_launch(
            rows.data_ptr(), rows.shape[1], rows.shape[2],
            st["counts"].data_ptr(), rows.shape[0], int(horizon), 0,
            st["hits"].data_ptr(), result.data_ptr(),
            torch.cuda.current_stream(rows.device).cuda_stream))
        return result[0]


def with_earlier(cs, earlier):
    """``chip_smoke``'s append, probe and prune cases, each followed by
    the kernel and the earlier design's kernels timed in turns on the
    same state (put back before each launch), the earlier results held
    equal to the kernel's. Returns the kept cases, to put back."""
    from flink_tpu_torch.ops import device_lists as dl

    kept = (cs.list_append_case, cs.list_probe_case, cs.list_prune_case)
    append_case, probe_case, prune_case = kept

    def saver(torch, st: dict, rows_too: bool):
        live = torch.nonzero(st["counts"] > 0).flatten()
        saved = {k: st[k].clone() for k in ("table", "counts", "tiles")}
        r0 = st["rows"][live] if rows_too else None

        def restore():
            for k, v in saved.items():
                st[k].copy_(v)
            if rows_too:
                st["rows"][live] = r0
        return restore, live

    def append(torch, flush, rates, st, keys, packed):
        restore, _live = saver(torch, st, False)
        rec = append_case(torch, flush, rates, st, keys, packed)
        args = (st["table"], st["rows"], st["counts"], st["tiles"])
        restore()
        fk, _x = dl.list_append(*args, st["hits"], keys, packed)
        want = cs.list_lists_of(torch, st, keys)
        restore()
        fe, _x = earlier.append(torch, st, keys, packed)
        if fe.tolist() != fk.tolist() or not all(
                torch.equal(a, b)
                for a, b in zip(cs.list_lists_of(torch, st, keys), want)):
            raise AssertionError("the earlier list_append differs")
        del want
        times = cs.turns(torch, flush, restore,
                         kernel=lambda: dl.list_append(*args, st["hits"],
                                                       keys, packed),
                         earlier=lambda: earlier.append(torch, st, keys,
                                                        packed))
        restore()
        return {**rec, **times}

    def probe(torch, flush, rates, st, keys, ts, lo_off, hi_off):
        rec = probe_case(torch, flush, rates, st, keys, ts, lo_off, hi_off)
        args = (st["table"], st["rows"], st["counts"], keys, ts, lo_off,
                hi_off)
        got = dl.list_probe(*args)
        if not all(torch.equal(a, b) for a, b in zip(
                got, earlier.probe(torch, st, keys, ts, lo_off, hi_off))):
            raise AssertionError("the earlier list_probe differs")
        m = int(got[0].numel())
        del got
        return {**rec, **cs.turns(
            torch, flush, None,
            kernel=lambda: dl.list_probe(*args, hint=m),
            earlier=lambda: earlier.probe(torch, st, keys, ts, lo_off,
                                          hi_off)),
            "earlier_device_ms": cs.kernel_device_ms(
                torch, lambda: earlier.probe(torch, st, keys, ts, lo_off,
                                             hi_off),
                flush, ("list_probe_earlier_",))}

    def prune(torch, flush, rates, st, horizon):
        restore, live = saver(torch, st, True)
        rec = prune_case(torch, flush, rates, st, horizon)
        lk = int(dl.list_prune(st["rows"], st["counts"], st["tiles"],
                               st["hits"], horizon))
        ck, rk = st["counts"].clone(), st["rows"][live]
        restore()
        if int(earlier.prune(torch, st, horizon)) != lk \
                or not torch.equal(ck, st["counts"]) \
                or not torch.equal(rk, st["rows"][live]):
            raise AssertionError("the earlier list_prune differs")
        del ck, rk
        times = cs.turns(torch, flush, restore,
                         kernel=lambda: dl.list_prune(
                             st["rows"], st["counts"], st["tiles"],
                             st["hits"], horizon),
                         earlier=lambda: earlier.prune(torch, st, horizon))
        restore()
        return {**rec, **times}

    cs.list_append_case, cs.list_probe_case, cs.list_prune_case = (
        append, probe, prune)
    return kept


def with_tiles_of(torch, list_state, tile_slots: int):
    """``chip_smoke.list_state`` with an empty summary of ``tile_slots``
    slots a tile in place of the store's (the kernels read the tile size
    from the summary's shape)."""
    def state(torch_, dev, cap: int, L: int, C: int) -> dict:
        st = list_state(torch_, dev, cap, L, C)
        t = torch.empty((3, max(1, cap // tile_slots)), dtype=torch.int64,
                        device=dev)
        t[0], t[1], t[2] = (1 << 63) - 1, -(1 << 63), 0
        st["tiles"] = t
        return st
    return state


def bind(kernels, so):
    lib = ctypes.CDLL(str(so))
    for entry, argtypes in kernels.SOURCES["device_lists"].items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.device_lists_error_string.argtypes = [ctypes.c_int]
    lib.device_lists_error_string.restype = ctypes.c_char_p
    return lib


def brief(rec: dict) -> dict:
    """A design's record cut to its times: each case's kernel ms (both
    turns) and the earlier design's, and the prune's tiles visited (no
    ptxas)."""
    if "shapes" not in rec:
        return rec
    keep = ("kernel_ms", "kernel_ms_again", "earlier_ms", "earlier_ms_again",
            "device_ms", "earlier_device_ms", "matches", "tiles_visited",
            "tiles_emptied")
    return {**{k: v for k, v in rec.items() if k not in ("shapes",
                                                          "ptxas")},
            "shapes": {label: {case: {k: r[k] for k in keep if k in r}
                               for case, r in cases.items()}
                       for label, cases in rec["shapes"].items()}}


def main(argv: list[str]) -> int:
    import torch

    out_path = None
    if argv[:1] == ["--out"]:
        out_path, argv = argv[1], argv[2:]
    if not torch.cuda.is_available():
        print("list_designs: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from flink_tpu_torch.ops import kernels

    def emit(rec: dict) -> None:
        cs.emit(brief(rec))
        if out_path:
            with open(out_path, "a") as f:
                f.write(cs.json.dumps(rec) + "\n")

    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    src = (kernels.CSRC_DIR / "device_lists.cu").read_text()
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, (what, text) in designs(src).items():
        if argv and name not in argv:
            continue
        cu = kernels.BUILD_DIR / f"design_lists_{name}.cu"
        cu.write_text(text)
        so = kernels.BUILD_DIR / f"libdesign_lists_{name}.so"
        jobs[name] = (what, so, _build(kernels, name, str(cu), so))
    earlier = EarlierKernels(start_earlier_build())
    kernels.build_all()
    flush = cs.L2Flush(torch, dev)
    kept = kernels.library("device_lists")
    with_earlier(cs, earlier)

    def timed(tile_slots=None) -> dict:
        kept_state = cs.list_state
        if tile_slots:
            cs.list_state = with_tiles_of(torch, kept_state, tile_slots)
        try:
            return {label: cs.list_shape_cases(torch, dev, flush, None,
                                               n_keys, count, cap)
                    for label, n_keys, count, cap in cs.LIST_SHAPES}
        finally:
            cs.list_state = kept_state

    emit({"design": "kept", "card": smi,
          "ptxas": cs.ptxas_report(kernels.build_log("device_lists")),
          "shapes": timed()})
    for t in TILE_SIZES:
        if argv and f"tiles_of_{t}" not in argv:
            continue
        emit({"design": f"tiles_of_{t}", "card": smi,
              "change": f"tiles of {t} slots", "shapes": timed(t)})
    for name, (what, so, proc) in jobs.items():
        log, _ = proc.communicate()
        text = log.decode(errors="replace")
        if proc.returncode != 0:
            emit({"design": name, "change": what, "card": smi,
                  "built": False, "nvcc": text[-2000:]})
            continue
        kernels._LIBS["device_lists"] = bind(kernels, so)
        try:
            rec = {"shapes": timed()}
        except (AssertionError, RuntimeError) as e:
            rec = {"failed": str(e)[:500]}
        emit({"design": name, "change": what, "card": smi,
              "ptxas": cs.ptxas_report(text), **rec})
    kernels._LIBS["device_lists"] = kept
    emit({"design": "kept, again", "card": smi, "shapes": timed()})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
