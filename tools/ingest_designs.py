#!/usr/bin/env python3
"""The designs tried for the ingest step's kernel (csrc/hash_table.cu),
timed beside the kept one on one CUDA card.

Run from the repository root, on the card:

    python3 tools/ingest_designs.py

Each design is the kept source with one change, built with the package's
flags into the package's build directory and bound in place of the kept
library; ``chip_smoke.check_ingest_forms`` then holds it against the
plain version and times it at the Q5 shapes (the dirty form at 2^21 and
2^24, every key new and every key present, and the spill form at 2^23).
Then the kept kernel on the Q5-10M batch reordered by home slot: bucketed
into spans of 2^14 and 2^18 slots, and sorted (the order a partition pass
would give the step, without the pass's cost). One JSON line per design,
each with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

#: the kept read of a slot's dirty byte, and the kept fold of a row
DIRTY_READ = "__ldca(a.dirty + (slot >> a.dirty_shift))"
MARK_FIRST = ("  mark_dirty(a, slot);\n  const long long idx = row * a.cap + "
              "slot;\n")
STEP_HEAD = ("template <int NC>\n__global__ void __launch_bounds__(kThreads, "
             "kStepBlocks)\ningest_step_kernel(StepArgs a) {")
STEP_TAIL = "// The spill form: tiles"
DIRTY_LAUNCH = ("    ingest_step_kernel<NC><<<(unsigned)blocks, kThreads, 0, "
                "stream>>>(a);\n    return cudaGetLastError();\n")

#: two rows a thread, both rows' home slots read before either resolves
TWO_ROW_STEP = r'''template <int NC>
__global__ void __launch_bounds__(kThreads, kStepBlocks)
ingest_step_kernel(StepArgs a) {
  __shared__ StepPlane planes[kMaxPlanes];
  if (threadIdx.x < kMaxPlanes) {
#pragma unroll
    for (int q = 0; q < kMaxPlanes; ++q)
      if (q == (int)threadIdx.x) planes[q] = a.planes[q];
  }
  __syncthreads();
  const long long i0 = (long long)blockIdx.x * (2 * kThreads) + threadIdx.x;
  const long long i1 = i0 + kThreads;
  const bool in0 = i0 < a.n, in1 = i1 < a.n;
  const RowIn<NC> r0 = load_row<NC>(a, i0, in0);
  const RowIn<NC> r1 = load_row<NC>(a, i1, in1);
  const long long fo = first_open_of(a);
  const long long p0 = row_pane(a, r0.ts), p1 = row_pane(a, r1.ts);
  const bool f0 = in0 && p0 >= fo, f1 = in1 && p1 >= fo;
  const long long k0 = row_key(a, r0.kr), k1 = row_key(a, r1.kr);
  const unsigned long long h0 =
      probe_table::probe_hash((unsigned long long)k0) & a.mask;
  const unsigned long long h1 =
      probe_table::probe_hash((unsigned long long)k1) & a.mask;
  const unsigned long long c0 = f0 ? __ldcg(a.table + h0) : 0ull;
  const unsigned long long c1 = f1 ? __ldcg(a.table + h1) : 0ull;
  const int s0 = !f0 ? -1
                 : c0 == (unsigned long long)k0
                     ? (int)h0
                     : probe(a.table, a.mask, (unsigned long long)k0, true);
  const int s1 = !f1 ? -1
                 : c1 == (unsigned long long)k1
                     ? (int)h1
                     : probe(a.table, a.mask, (unsigned long long)k1, true);
  if (s0 >= 0) {
    long long row = p0 % a.ring;
    if (row < 0) row += a.ring;
    fold_row<NC>(a, planes, s0, row, r0);
  }
  if (s1 >= 0) {
    long long row = p1 % a.ring;
    if (row < 0) row += a.ring;
    fold_row<NC>(a, planes, s1, row, r1);
  }
  const unsigned late = __reduce_add_sync(
      kFull, ((in0 && !f0) ? 1u : 0u) + ((in1 && !f1) ? 1u : 0u));
  const unsigned dropped = __reduce_add_sync(
      kFull, ((f0 && s0 < 0) ? 1u : 0u) + ((f1 && s1 < 0) ? 1u : 0u));
  if ((threadIdx.x & 31) == 0) {
    if (late) atomicAdd(a.late, (unsigned long long)late);
    if (dropped) atomicAdd(a.dropped, (unsigned long long)dropped);
  }
}

'''

#: the rows bucketed by home slot first (one launch: a counter per
#: bucket of about 256 rows, row lists of twice that, an overflow list),
#: then a block a bucket folds its rows, gathered from the columns, in
#: address order (a second launch, which zeroes the counters after it)
BUCKETED = r'''
__global__ void __launch_bounds__(kThreads)
bucket_kernel(StepArgs a, int* cnt, int* list, int C, int shift, int* ovf,
              int* ovf_cnt) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = i < a.n;
  const long long ts = in ? __ldg(a.ts + i) : 0;
  const unsigned long long kr = in ? load_one(a.keys, a.key_dtype, i) : 0ull;
  const long long pane = row_pane(a, ts);
  const bool fresh = in && pane >= first_open_of(a);
  const long long k = row_key(a, kr);
  if (fresh) {
    for (int c = 0; c < kMaxCols; ++c)
      if (a.cols[c].data != nullptr)
        asm volatile("prefetch.global.L2 [%0];" :: "l"(
            (const char*)a.cols[c].data + i * 8));
    const unsigned long long h =
        probe_table::probe_hash((unsigned long long)k) & a.mask;
    const int b = (int)(h >> shift);
    const int pos = atomicAdd(cnt + b, 1);
    if (pos < C) list[(long long)b * C + pos] = (int)i;
    else ovf[atomicAdd(ovf_cnt, 1)] = (int)i;
  }
  const unsigned late = __reduce_add_sync(kFull, (in && !fresh) ? 1u : 0u);
  if ((threadIdx.x & 31) == 0 && late)
    atomicAdd(a.late, (unsigned long long)late);
}

template <int NC>
__device__ __forceinline__ unsigned fold_at(const StepArgs& a,
                                            const StepPlane* planes,
                                            long long i) {
  const RowIn<NC> r = load_row<NC>(a, i, true);
  const long long pane = row_pane(a, r.ts);
  const long long k = row_key(a, r.kr);
  const int slot = probe(a.table, a.mask, (unsigned long long)k, true);
  if (slot < 0) return 1u;
  long long row = pane % a.ring;
  if (row < 0) row += a.ring;
  fold_row<NC>(a, planes, slot, row, r);
  return 0u;
}

template <int NC>
__global__ void __launch_bounds__(kThreads)
fold_bucket_kernel(StepArgs a, int* cnt, const int* list, int C,
                   const int* ovf, int* ovf_cnt, unsigned* done) {
  __shared__ StepPlane planes[kMaxPlanes];
  if (threadIdx.x < kMaxPlanes) {
#pragma unroll
    for (int q = 0; q < kMaxPlanes; ++q)
      if (q == (int)threadIdx.x) planes[q] = a.planes[q];
  }
  __syncthreads();
  const int b = blockIdx.x;
  const int got = cnt[b];
  const int m = got < C ? got : C;
  const int novf = *((volatile int*)ovf_cnt);
  unsigned dropped = 0;
  for (int j = threadIdx.x; j < m; j += kThreads)
    dropped += fold_at<NC>(a, planes, list[(long long)b * C + j]);
  for (long long j = (long long)b * kThreads + threadIdx.x; j < novf;
       j += (long long)gridDim.x * kThreads)
    dropped += fold_at<NC>(a, planes, ovf[j]);
  if (dropped) atomicAdd(a.dropped, (unsigned long long)dropped);
  __syncthreads();
  if (threadIdx.x == 0) {
    cnt[b] = 0;
    __threadfence();
    if (atomicAdd(done, 1u) == gridDim.x - 1) {
      *ovf_cnt = 0;
      *done = 0;
    }
  }
}

'''
BUCKETED_LAUNCH = r'''    static int* scratch = nullptr;
    static long long have = 0;
    int nb = 1;
    while ((long long)nb * kThreads < a.n) nb <<= 1;
    if (nb > a.cap) nb = (int)a.cap;
    int lg_cap = 0, lg_nb = 0;
    while ((1ll << lg_cap) < a.cap) ++lg_cap;
    while ((1 << lg_nb) < nb) ++lg_nb;
    const int C = 2 * kThreads;
    const long long words = nb + (long long)nb * C + a.n + 2;
    if (words > have) {
      cudaFree(scratch);
      cudaMalloc(&scratch, words * sizeof(int));
      cudaMemset(scratch, 0, words * sizeof(int));
      have = words;
    }
    int* cnt = scratch;
    int* list = cnt + nb;
    int* ovf = list + (long long)nb * C;
    int* ovf_cnt = ovf + a.n;
    unsigned* done = (unsigned*)(ovf_cnt + 1);
    bucket_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
        a, cnt, list, C, lg_cap - lg_nb, ovf, ovf_cnt);
    fold_bucket_kernel<NC><<<(unsigned)nb, kThreads, 0, stream>>>(
        a, cnt, list, C, ovf, ovf_cnt, done);
    return cudaGetLastError();
'''


#: the rows partitioned by the top bits of their home slot into NB
#: buckets first (one launch: 1024 rows a block, a histogram in shared
#: memory, one global atomic a bucket a block, each fresh row's key, ring
#: row and values written to its bucket's region of 2n/NB records or to an
#: overflow list), then the fold over the records in bucket order (a
#: second launch: a block 256 records of a region, blocks past a region's
#: count exit, the last block of a bucket zeroes its counter; the overflow
#: list by a fixed grid after the regions)
PARTITIONED = r'''
constexpr int kPartRows = 4;  // rows a thread in the partition
constexpr int kOvfBlocks = 528;

template <int NC, int NB>
__global__ void __launch_bounds__(kThreads)
part_kernel(StepArgs a, int* cnt, int* ovf_cnt, long long C, int shift,
            long long* rkey, int* rrow, unsigned long long* rval,
            long long stride) {
  __shared__ int hist[NB];
  __shared__ int base[NB];
  for (int b = threadIdx.x; b < NB; b += kThreads) hist[b] = 0;
  __syncthreads();
  const long long first_open = first_open_of(a);
  RowIn<NC> r[kPartRows];
  int bk[kPartRows], rank[kPartRows];
  long long key[kPartRows];
  int row[kPartRows];
  unsigned late = 0;
#pragma unroll
  for (int j = 0; j < kPartRows; ++j) {
    const long long i = ((long long)blockIdx.x * kPartRows + j) * kThreads +
                        threadIdx.x;
    const bool in = i < a.n;
    r[j] = load_row<NC>(a, i, in);
    const long long pane = row_pane(a, r[j].ts);
    const bool fresh = in && pane >= first_open;
    late += (in && !fresh) ? 1u : 0u;
    key[j] = row_key(a, r[j].kr);
    long long rw = pane % a.ring;
    if (rw < 0) rw += a.ring;
    row[j] = (int)rw;
    bk[j] = -1;
    if (fresh) {
      bk[j] = (int)((probe_table::probe_hash((unsigned long long)key[j]) &
                     a.mask) >> shift);
      rank[j] = atomicAdd(&hist[bk[j]], 1);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < NB; b += kThreads)
    if (hist[b]) base[b] = atomicAdd(cnt + b, hist[b]);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPartRows; ++j) {
    if (bk[j] < 0) continue;
    const long long pos = (long long)base[bk[j]] + rank[j];
    long long at;
    if (pos < C) at = (long long)bk[j] * C + pos;
    else at = (long long)NB * C + atomicAdd(ovf_cnt, 1);
    rkey[at] = key[j];
    rrow[at] = row[j];
#pragma unroll
    for (int c = 0; c < NC; ++c) rval[c * stride + at] = r[j].cv[c];
  }
  late = __reduce_add_sync(kFull, late);
  if ((threadIdx.x & 31) == 0 && late)
    atomicAdd(a.late, (unsigned long long)late);
}

template <int NC>
__device__ __forceinline__ bool fold_record(const StepArgs& a,
                                            const StepPlane* planes,
                                            const long long* rkey,
                                            const int* rrow,
                                            const unsigned long long* rval,
                                            long long stride, long long at) {
  RowIn<NC> r;
  r.ts = 0;
  r.kr = 0;
#pragma unroll
  for (int c = 0; c < NC; ++c) r.cv[c] = __ldcs(rval + c * stride + at);
  const long long k = __ldcs(rkey + at);
  const int row = __ldcs(rrow + at);
  const int slot = probe(a.table, a.mask, (unsigned long long)k, true);
  if (slot < 0) return true;
  fold_row<NC>(a, planes, slot, row, r);
  return false;
}

template <int NC, int NB>
__global__ void __launch_bounds__(kThreads, kStepBlocks)
fold_part_kernel(StepArgs a, int* cnt, int* done, int* ovf_cnt,
                 int* ovf_done, long long C, const long long* rkey,
                 const int* rrow, const unsigned long long* rval,
                 long long stride) {
  __shared__ StepPlane planes[kMaxPlanes];
  __shared__ int have;
  if (threadIdx.x < kMaxPlanes) {
#pragma unroll
    for (int q = 0; q < kMaxPlanes; ++q)
      if (q == (int)threadIdx.x) planes[q] = a.planes[q];
  }
  const long long per = C / kThreads;  // blocks a region
  const long long region_blocks = (long long)NB * per;
  const bool ovf = blockIdx.x >= region_blocks;
  const int b = ovf ? 0 : (int)(blockIdx.x / per);
  if (threadIdx.x == 0) have = ovf ? *((volatile int*)ovf_cnt) : cnt[b];
  __syncthreads();
  unsigned dropped = 0;
  if (!ovf) {
    const long long j = (blockIdx.x % per) * kThreads + threadIdx.x;
    const long long m = have < C ? have : C;
    if (j < m)
      dropped += fold_record<NC>(a, planes, rkey, rrow, rval, stride,
                                 (long long)b * C + j) ? 1u : 0u;
  } else {
    for (long long j = (blockIdx.x - region_blocks) * kThreads + threadIdx.x;
         j < have; j += (long long)kOvfBlocks * kThreads)
      dropped += fold_record<NC>(a, planes, rkey, rrow, rval, stride,
                                 (long long)NB * C + j) ? 1u : 0u;
  }
  dropped = __reduce_add_sync(kFull, dropped);
  if ((threadIdx.x & 31) == 0 && dropped)
    atomicAdd(a.dropped, (unsigned long long)dropped);
  __syncthreads();
  if (threadIdx.x == 0) {
    if (!ovf) {
      if (atomicAdd(done + b, 1) == (int)per - 1) {
        cnt[b] = 0;
        done[b] = 0;
      }
    } else if (atomicAdd(ovf_done, 1) == kOvfBlocks - 1) {
      *ovf_cnt = 0;
      *ovf_done = 0;
    }
  }
}

template <int NC, int NB>
cudaError_t launch_partitioned(const StepArgs& a, cudaStream_t stream) {
  static char* scratch = nullptr;
  static long long have = 0;
  long long C = 2 * ((a.n + NB - 1) / NB);
  C = (C + kThreads - 1) / kThreads * kThreads;
  const long long recs = (long long)NB * C + a.n;
  const long long bytes = (2 * NB + 2) * 4 + recs * (8 + 4 + 8 * (NC + 0));
  if (bytes > have) {
    cudaFree(scratch);
    cudaMalloc(&scratch, bytes);
    cudaMemset(scratch, 0, bytes);
    have = bytes;
  }
  int* cnt = (int*)scratch;
  int* done = cnt + NB;
  int* ovf_cnt = done + NB;
  int* ovf_done = ovf_cnt + 1;
  long long* rkey = (long long*)(scratch + ((2 * NB + 2) * 4 + 7) / 8 * 8);
  unsigned long long* rval = (unsigned long long*)(rkey + recs);
  int* rrow = (int*)(rval + (long long)NC * recs);
  int lg_cap = 0, lg_nb = 0;
  while ((1ll << lg_cap) < a.cap) ++lg_cap;
  while ((1 << lg_nb) < NB) ++lg_nb;
  const int shift = lg_cap > lg_nb ? lg_cap - lg_nb : 0;
  const long long pblocks =
      (a.n + kPartRows * kThreads - 1) / (kPartRows * kThreads);
  part_kernel<NC, NB><<<(unsigned)pblocks, kThreads, 0, stream>>>(
      a, cnt, ovf_cnt, C, shift, rkey, rrow, rval, recs);
  const long long fblocks = (long long)NB * (C / kThreads) + kOvfBlocks;
  fold_part_kernel<NC, NB><<<(unsigned)fblocks, kThreads, 0, stream>>>(
      a, cnt, done, ovf_cnt, ovf_done, C, rkey, rrow, rval, recs);
  return cudaGetLastError();
}

'''


def partitioned(src: str, nb: int) -> str:
    src = patch(src, "template <int NC>\ncudaError_t launch_step",
                PARTITIONED + "template <int NC>\ncudaError_t launch_step")
    return patch(src, DIRTY_LAUNCH, f"    return launch_partitioned<NC, {nb}>"
                 "(a, stream);\n")


def replace_step(src: str, body: str) -> str:
    i, j = src.index(STEP_HEAD), src.index(STEP_TAIL)
    return src[:i] + body + src[j:]


def patch(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"the kept source changed: {old[:60]!r}")
    return src.replace(old, new)


def grid_stride(src: str, blocks: int) -> str:
    """The kept dirty kernel looping over the rows with a grid of
    ``blocks`` blocks an SM (fewer rows in flight)."""
    step = src[src.index(STEP_HEAD):src.index(STEP_TAIL)]
    head = ("  const long long i = (long long)blockIdx.x * blockDim.x + "
            "threadIdx.x;\n")
    loop = ("  for (long long base = (long long)blockIdx.x * blockDim.x; "
            "base < a.n;\n       base += (long long)gridDim.x * blockDim.x) "
            "{\n  const long long i = base + threadIdx.x;\n")
    body = patch(step, head, loop)
    end = body.rindex("}")
    body = body[:end] + "  }\n" + body[end:]
    launch = (f"    int dev = 0, sms = 132;\n    cudaGetDevice(&dev);\n"
              "    cudaDeviceGetAttribute(&sms, "
              "cudaDevAttrMultiProcessorCount, dev);\n"
              f"    const long long grid = blocks < {blocks}ll * sms ? blocks "
              f": {blocks}ll * sms;\n"
              "    ingest_step_kernel<NC><<<(unsigned)grid, kThreads, 0, "
              "stream>>>(a);\n    return cudaGetLastError();\n")
    return patch(src.replace(step, body), DIRTY_LAUNCH, launch)


def designs(src: str) -> dict:
    """design -> (what it changes, its source)."""
    fold = src[src.index("__device__ __forceinline__ void fold_row("):]
    fold = fold[:fold.index("\n}\n") + 3]
    folds_first = patch(fold, MARK_FIRST,
                        "  const long long idx = row * a.cap + slot;\n")
    folds_first = folds_first[:-2] + "  mark_dirty(a, slot);\n}\n"
    loads = src
    for width in ("unsigned long long", "unsigned int", "unsigned char"):
        loads = patch(loads, f"return __ldg(static_cast<const {width}*>(p) "
                             "+ i);",
                      f"return __ldcs(static_cast<const {width}*>(p) + i);")
    loads = patch(loads, "r.ts = in ? __ldg(a.ts + i) : 0;",
                  "r.ts = in ? __ldcs(a.ts + i) : 0;")
    return {
        "dirty_byte_through_l2": (
            "the dirty byte read through L2 (__ldcg), as before",
            patch(src, DIRTY_READ, DIRTY_READ.replace("__ldca", "__ldcg"))),
        "folds_before_dirty_byte": (
            "the folds issued before the dirty byte's read",
            patch(src, fold, folds_first)),
        "two_rows_a_thread": (
            "two rows a thread, both home slots read together",
            patch(replace_step(src, TWO_ROW_STEP), DIRTY_LAUNCH,
                  DIRTY_LAUNCH.replace(
                      "(unsigned)blocks",
                      "(unsigned)((a.n + 2 * kThreads - 1) / "
                      "(2 * kThreads))"))),
        "ptxas_registers": (
            "__launch_bounds__(256): ptxas picks 32 registers and a stack "
            "frame, 8 blocks an SM",
            patch(src, STEP_HEAD, STEP_HEAD.replace(", kStepBlocks)", ")"))),
        **{f"grid_stride_{blocks}_blocks_an_sm": (
            f"{blocks} blocks an SM looping over the batch's rows",
            grid_stride(src, blocks)) for blocks in (3, 4, 5)},
        "streaming_columns": (
            "ts, keys and value columns loaded evict-first (__ldcs)", loads),
        **{f"partitioned_{nb}_buckets": (
            f"rows partitioned into {nb} buckets of home slots, then folded "
            "bucket by bucket (two launches)", partitioned(src, nb))
           for nb in (16, 64, 256)},
        "bucketed_two_launches": (
            "rows bucketed by home slot into row lists, then a block a "
            "bucket gathers and folds its rows (two launches)",
            patch(patch(src, "template <int NC>\ncudaError_t launch_step",
                        BUCKETED + "template <int NC>\ncudaError_t "
                        "launch_step"), DIRTY_LAUNCH, BUCKETED_LAUNCH)),
    }


def build(kernels, name: str, src: str):
    cu = kernels.BUILD_DIR / f"design_{name}.cu"
    cu.write_text(src)
    so = kernels.BUILD_DIR / f"libdesign_{name}.so"
    return so, subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC_DIR),
         "-o", str(so), str(cu)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)


def bind(kernels, so):
    lib = ctypes.CDLL(str(so))
    for entry, argtypes in kernels.SOURCES["hash_table"].items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.hash_probe_error_string.argtypes = [ctypes.c_int]
    lib.hash_probe_error_string.restype = ctypes.c_char_p
    kernels.check("hash_table", lib.hash_table_load())
    return lib


def address_order(cs, torch, dev, flush) -> dict:
    """The kept kernel (dirty form) on the Q5-10M batch in batch order and
    reordered by home slot."""
    from flink_tpu_torch.ops.hash_table import hash_keys_device, \
        ingest_step, sanitize_keys_device

    _label, n_keys, n_events, cap = cs.Q5_CELLS[1]
    case = cs.q5_step_case(torch, dev, n_keys, n_events, cap)
    ts, keys, price = case["batch"]
    home = hash_keys_device(sanitize_keys_device(keys)) & (cap - 1)
    orders = {"batch": torch.arange(keys.numel(), device=dev),
              "spans_of_2^14": torch.sort(home >> 14, stable=True).indices,
              "spans_of_2^18": torch.sort(home >> 18, stable=True).indices,
              "sorted": torch.sort(home).indices}
    table0 = case["table"]
    table = table0.clone()
    late = torch.zeros((), dtype=torch.int64, device=dev)
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    dirty = torch.zeros((cap >> cs.DIRTY_SHIFT) + 1, dtype=torch.uint8,
                        device=dev)
    out = {}
    for name, order in orders.items():
        t, k, p = (x[order].contiguous() for x in (ts, keys, price))
        out[name] = cs.cuda_ms(lambda t=t, k=k, p=p: ingest_step(
            table, [("count", case["count"], None), ("sum", case["rev"], p)],
            t, k, cs.PANE_MS, 0, cs.MIN_TIMESTAMP, late, dropped, dirty,
            cs.DIRTY_SHIFT), torch, flush, setup=lambda: table.copy_(table0))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ingest_designs: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from flink_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    src = (kernels.CSRC_DIR / "hash_table.cu").read_text()
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {name: (what, *build(kernels, name, text))
            for name, (what, text) in designs(src).items()}
    kernels.build_all()
    flush = cs.L2Flush(torch, dev)
    kept = kernels.library("hash_table")

    def times(forms: dict) -> dict:
        return {k: {"ms": v["ms"], "ms_without_parts": v["ms_without_parts"]}
                for k, v in forms["shapes"].items()}

    cs.emit({"design": "kept", "card": smi,
             "ptxas": cs.ptxas_report(kernels.build_log("hash_table")),
             "times": times(cs.check_ingest_forms(torch, dev, flush)),
             "address_order_ms": address_order(cs, torch, dev, flush)})
    for name, (what, so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"design {name} failed to build:\n"
                               + log.decode(errors="replace"))
        kernels._LIBS["hash_table"] = bind(kernels, so)
        cs.emit({"design": name, "change": what, "card": smi,
                 "ptxas": {k: v for k, v in cs.ptxas_report(
                     log.decode(errors="replace")).items()
                     if "ingest_step_kernel" in k},
                 "times": times(cs.check_ingest_forms(torch, dev, flush))})
    kernels._LIBS["hash_table"] = kept
    cs.emit({"design": "kept, again", "card": smi,
             "times": times(cs.check_ingest_forms(torch, dev, flush))})
    return 0


if __name__ == "__main__":
    sys.exit(main())
