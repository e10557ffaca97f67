#!/usr/bin/env python3
"""The designs tried for the group aggregation step (csrc/group_agg.cu),
timed beside the kept one on one CUDA card.

Run from the repository root, on the card:

    python3 tools/gagg_designs.py [DESIGN ...]

(with names, only those designs beside the kept one).

At both main paths' shapes (``chip_smoke.gagg_shape``: TPC-H Q1's 6th
batch, 6 groups in 12 planes at 2^16 slots; the 10M GROUP BY's 6th batch,
2^19 groups in 7 planes at 2^24 slots) each design's whole step is held
against the plain version (``chip_smoke.compare_gagg_shape``) and timed as
one ``group_agg_step`` call, the L2 flushed before it only
(``chip_smoke.cuda_ms``). The kept kernels are also timed on the 10M
shape with every group of two rows (the slots of the batch's first half,
each twice, at random places and side by side), where ranges of rows
could keep a group's lines in L2 between its stages.

Each design is the kept source with one change:

* the batch cut into ranges of 2^14, 2^15 and 2^16 rows, each range's
  compaction, fold and emit run in turn (the look-back's tile counter and
  status words carried from one range to the next), also on the pairs;
* the compaction's blocks at 0.5, 2 and 4 an SM walking the tiles (kept:
  1 where the planes exceed L2), a block a tile at every shape, and one
  an SM at every shape (TPC-H's planes fit in L2: kept a block a tile);
* the fold's pre-fold table off (every peer set folds into the planes),
  and taken by every tile (an all-distinct tile overflows it); the first
  rows' table off;
* 2 and 4 fold blocks an SM walking the tiles (kept: 8);
* a one-row group's planes stored where the kept compaction folds them by
  atomics; PREV and NEW rows stored evict-first;
* one persistent cooperative kernel for the whole step, a grid-wide
  barrier between the stages, against the kept four launches.

Each design is built with the package's flags into the package's build
directory (all at once, one nvcc each) and bound in place of the kept
library; a design that does not build is reported and skipped. One JSON
line per design, each with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

PREFOLD = "constexpr int kPreFoldLeads = 64;"
FIRST_PREFOLD = "constexpr int kFirstPreFoldLeads = 64;"
FOLD_BLOCKS = "constexpr int kFoldBlocksPerSM = 8;"
COMPACT_BLOCKS = "constexpr double kCompactBlocksPerSM = 1.0;"
L2_BUDGET = "constexpr long long kL2Budget = 40ll << 20;"
NAMESPACE_END = "}  // namespace"
FIRST_LAUNCH = "  if (all || stage == kFirst)\n"
FOLD_ONE_CALL = "x = fold_one(a, q, s, i, sg, v[j]);"
PREV_STORE = "      if (q0 + j < a.n_planes) out[q0 + j] = v[j];\n"
NEW_STORE = "        out[a.n_planes + q] = x;\n"
FIRST_OF_GROUP = "// The group at ``pos`` whose first row is i"
#: rows a range tried
RANGES = (1 << 14, 1 << 15, 1 << 16)

#: the whole step as one cooperative kernel over the kept stage bodies
PERSISTENT = r'''
__global__ void __launch_bounds__(kThreads)
    group_agg_persistent_kernel(Args a) {
  cooperative_groups::grid_group g = cooperative_groups::this_grid();
  const long long stride = (long long)gridDim.x * kThreads;
  const long long start = (long long)blockIdx.x * kThreads;
  for (long long j = start + threadIdx.x; j < a.status_words; j += stride)
    a.status[j] = 0ull;
  for (long long base = start; base < a.n; base += stride)
    first_rows(a, base + threadIdx.x);
  g.sync();
  compact_tiles(a);
  g.sync();
  fold_tiles(a, blockIdx.x, gridDim.x);
  g.sync();
  for (long long base = start; base < a.n; base += stride)
    emit_row(a, base + threadIdx.x);
}

cudaError_t launch_persistent(const Args& a, cudaStream_t st) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = (size_t)kTable * a.n_planes * sizeof(double);
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, group_agg_persistent_kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  Args args = a;
  void* params[] = {&args};
  return cudaLaunchCooperativeKernel(
      (void*)group_agg_persistent_kernel, dim3(per_sm * sms),
      dim3(kThreads), params, smem, st);
}

'''


#: a one-row group's fold stored (the kept kernel folds it by atomics)
STORE_ONE = r'''
__device__ __forceinline__ double store_one(const Args& a, int q, int s,
                                            long long i, double sg,
                                            double prev) {
  const int kind = a.kind[q];
  double x;
  if (kind == kSum) {
    x = prev + row_value<kSum>(a, q, i, sg);
  } else {
    const double v = row_value<kMin>(a, q, i, sg);
    x = kind == kMin ? fold_min(prev, v) : fold_max(prev, v);
  }
  a.planes[q][s] = x;
  return x;
}

'''

#: the step's compaction, fold and emit run range by range (kRangeRows a
#: range, a multiple of kThreads): each stage's rows r0 <= i < r1, the
#: range's look-back tiles from tile0 on, one tile counter a range
RANGE_ARGS = ("  long long status_words;      // look-back words and the counter\n"
              "};",
              "  long long status_words;      // look-back words and the counter\n"
              "  long long r0 = 0, r1 = 0, tile0 = 0;  // the launch's range\n"
              "  unsigned* tile_counter = nullptr;\n"
              "};")
RANGE_EDITS = (
    RANGE_ARGS,
    ("  const long long i = tile * kThreads + tid;\n"
     "  const int s = row_slot(a, i);",
     "  const long long i = a.r0 + (tile - a.tile0) * kThreads + tid;\n"
     "  const int s = i < a.r1 ? row_slot(a, i) : -1;"),
    ("  if (i < a.n) a.single[i] = single;",
     "  if (i < a.r1) a.single[i] = single;"),
    ("  unsigned* counter = reinterpret_cast<unsigned*>(a.status + a.n_tiles);\n"
     "  while (true) {\n"
     "    if (threadIdx.x == 0) tile_s = atomicAdd(counter, 1u);\n"
     "    __syncthreads();\n"
     "    const long long tile = tile_s;\n"
     "    if (tile >= a.n_tiles) return;",
     "  const long long end = a.tile0 + tiles_of(a.r1 - a.r0);\n"
     "  while (true) {\n"
     "    if (threadIdx.x == 0)\n"
     "      tile_s = a.tile0 + atomicAdd(a.tile_counter, 1u);\n"
     "    __syncthreads();\n"
     "    const long long tile = tile_s;\n"
     "    if (tile >= end) return;"),
    ("  const long long tiles = tiles_of(a.n);",
     "  const long long tiles = tiles_of(a.r1 - a.r0);"),
    ("    const long long i = t * kThreads + tid;",
     "    const long long i = a.r0 + t * kThreads + tid;"),
    ("    const int slot = row_slot(a, i);\n"
     "    const bool taken = i < a.n && __ldcg(a.single + i);",
     "    const int slot = i < a.r1 ? row_slot(a, i) : -1;\n"
     "    const bool taken = i < a.r1 && __ldcg(a.single + i);"),
    ("  if (i >= a.n) return;", "  if (i >= a.r1) return;"),
    ("  emit_row(a, (long long)blockIdx.x * kThreads + threadIdx.x);",
     "  emit_row(a, a.r0 + (long long)blockIdx.x * kThreads + threadIdx.x);"),
    ("  a.status_words = a.n_tiles + 1;",
     "  a.status_words = a.n_tiles + (n + kRangeRows - 1) / kRangeRows;"),
    ("  return (int)((n + kThreads - 1) / kThreads + 1);",
     "  return (int)((n + kThreads - 1) / kThreads\n"
     "               + (n + kRangeRows - 1) / kRangeRows);"),
)
#: the kept launches of the compaction, the fold and the emit, replaced by
#: a loop over the ranges
RANGE_LAUNCH_FROM = "  if (all || stage == kCompact) {\n"
RANGE_LAUNCH_TO = "  return (int)cudaGetLastError();\n}"
RANGE_LAUNCH = r'''  if (!all) return (int)cudaErrorInvalidValue;  // the whole step only
  long long most_compact = tiles;
  if (capacity * (8ll * n_planes + 8) > kL2Budget) {
    const long long m = (long long)(kCompactBlocksPerSM * sms + 0.5);
    most_compact = m < 1 ? 1 : m;
  }
  const long long most_fold = (long long)kFoldBlocksPerSM * sms;
  for (long long r0 = 0, k = 0; r0 < n; r0 += kRangeRows, ++k) {
    Args r = a;
    r.r0 = r0;
    r.r1 = r0 + kRangeRows < n ? r0 + kRangeRows : n;
    r.tile0 = r0 / kThreads;
    r.tile_counter = reinterpret_cast<unsigned*>(a.status + a.n_tiles + k);
    const long long t = tiles_of(r.r1 - r.r0);
    group_agg_compact_kernel<<<(unsigned)(t < most_compact ? t
                                          : most_compact), kThreads, 0,
                               st>>>(r);
    group_agg_fold_kernel<<<(unsigned)(t < most_fold ? t : most_fold),
                            kThreads,
                            (size_t)kTable * n_planes * sizeof(double),
                            st>>>(r);
    group_agg_emit_kernel<<<(unsigned)t, kThreads, 0, st>>>(r);
  }
'''


def patch(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"the kept source changed: {old[:60]!r}")
    return src.replace(old, new)


def ranges(src: str, rows: int) -> str:
    for old, new in RANGE_EDITS:
        src = patch(src, old, new)
    src = patch(src, L2_BUDGET, L2_BUDGET
                + f"\nconstexpr long long kRangeRows = {rows};")
    lo = src.index(RANGE_LAUNCH_FROM)
    hi = src.index(RANGE_LAUNCH_TO, lo)
    return src[:lo] + RANGE_LAUNCH + src[hi:]


def persistent(src: str) -> str:
    src = patch(src, "#include <cuda_runtime.h>\n",
                "#include <cooperative_groups.h>\n"
                "#include <cuda_runtime.h>\n")
    src = patch(src, NAMESPACE_END, PERSISTENT + NAMESPACE_END)
    return patch(src, FIRST_LAUNCH,
                 "  if (all) return (int)launch_persistent(a, st);\n"
                 + FIRST_LAUNCH)


def designs(src: str) -> dict:
    """design -> (what it changes, its source)."""
    return {
        **{f"ranges_of_{rows}_rows": (
            f"the batch cut into ranges of {rows} rows, each range's "
            "compaction, fold and emit in turn", ranges(src, rows))
           for rows in RANGES},
        **{f"compact_blocks_{b}_an_sm": (
            f"{b} compaction blocks an SM walk the tiles where the planes "
            "exceed L2",
            patch(src, COMPACT_BLOCKS, COMPACT_BLOCKS.replace("1.0", b)))
           for b in ("0.5", "2.0", "4.0")},
        "compact_block_a_tile": (
            "a compaction block a tile at every shape",
            patch(src, L2_BUDGET, L2_BUDGET.replace("40ll << 20",
                                                    "1ll << 62"))),
        "compact_blocks_an_sm_everywhere": (
            "one compaction block an SM at every shape",
            patch(src, L2_BUDGET, L2_BUDGET.replace("40ll << 20", "0"))),
        "prefold_off": (
            "no pre-fold table: every peer set folds into the planes",
            patch(src, PREFOLD, PREFOLD.replace("64", "-1"))),
        "first_prefold_off": (
            "the first rows' atomics straight to the scratch",
            patch(src, FIRST_PREFOLD, FIRST_PREFOLD.replace("64", "-1"))),
        "prefold_every_tile": (
            "every tile takes the pre-fold table (all-distinct tiles "
            "overflow it)", patch(src, PREFOLD, PREFOLD.replace("64",
                                                                "256"))),
        **{f"fold_blocks_{b}_an_sm": (
            f"{b} fold blocks an SM walk the tiles",
            patch(src, FOLD_BLOCKS, FOLD_BLOCKS.replace("8", str(b))))
           for b in (2, 4)},
        "single_by_stores": (
            "a one-row group's planes stored where the compaction folds "
            "them by atomics",
            patch(patch(src, FOLD_ONE_CALL, "x = store_one(a, q, s, i, sg, "
                        "v[j]);"), FIRST_OF_GROUP,
                  STORE_ONE + FIRST_OF_GROUP)),
        "comp_streaming_stores": (
            "PREV and NEW rows stored evict-first (st.global.cs)",
            patch(patch(src, PREV_STORE, PREV_STORE.replace(
                "out[q0 + j] = v[j];", "__stcs(out + q0 + j, v[j]);")),
                NEW_STORE, "        __stcs(out + a.n_planes + q, x);\n")),
        "persistent_kernel": (
            "the whole step as one cooperative kernel with grid-wide "
            "barriers", persistent(src)),
    }


def build(kernels, name: str, src: str):
    cu = kernels.BUILD_DIR / f"design_gagg_{name}.cu"
    cu.write_text(src)
    so = kernels.BUILD_DIR / f"libdesign_gagg_{name}.so"
    return so, subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC_DIR),
         "-o", str(so), str(cu)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)


def bind(kernels, so):
    lib = ctypes.CDLL(str(so))
    for entry, argtypes in kernels.SOURCES["group_agg"].items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.group_agg_error_string.argtypes = [ctypes.c_int]
    lib.group_agg_error_string.restype = ctypes.c_char_p
    return lib


def pair_shapes(torch, sh: dict) -> dict:
    """The 10M shape with every group of two rows: the slots of the
    batch's first half, each twice, at random places and side by side."""
    s = sh["step"]
    n = s["slots"].numel()
    gen = torch.Generator(device=s["slots"].device).manual_seed(10)
    perm = torch.randperm(n, generator=gen, device=s["slots"].device)
    out = {}
    for label, idx in (("pairs at random places", perm // 2),
                       ("pairs side by side",
                        torch.arange(n, device=perm.device) // 2)):
        out[label] = {**sh, "step": {**s, "slots":
                                     s["slots"][idx].contiguous()}}
    return out


def step_ms(cs, torch, flush, sh: dict) -> dict:
    """The step at a shape against the plain version, then timed as one
    call from the shape's state each time."""
    from flink_tpu_torch.ops import group_agg as ga

    _planes, err, _abs = cs.compare_gagg_shape(torch, sh)
    planes = [p.clone() for p in sh["planes"]]
    scratch = tuple(x.clone() for x in sh["scratch"])
    dirty = sh["dirty"].clone()

    def restore():
        for p, p0 in zip(planes, sh["planes"]):
            p.copy_(p0)
        for x, x0 in zip(scratch, sh["scratch"]):
            x.copy_(x0)
        dirty.copy_(sh["dirty"])

    ms = cs.cuda_ms(lambda: cs.gagg_call(ga.group_agg_step, sh, planes,
                                         scratch, dirty),
                    torch, flush, setup=restore)
    del planes, scratch, dirty
    return {"ms": ms, "max_rel_err": err}


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("gagg_designs: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from flink_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    src = (kernels.CSRC_DIR / "group_agg.cu").read_text()
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {name: (what, *build(kernels, name, text))
            for name, (what, text) in designs(src).items()
            if not argv or name in argv}
    kernels.build_all()
    flush = cs.L2Flush(torch, dev)
    kept = kernels.library("group_agg")
    shapes = {label: cs.gagg_shape(torch, dev, label)
              for label in ("tpch_q1", "groupby_10m")}
    shapes.update(pair_shapes(torch, shapes["groupby_10m"]))

    def timed(names) -> dict:
        return {label: step_ms(cs, torch, flush, shapes[label])
                for label in names}

    main_shapes = ("tpch_q1", "groupby_10m")
    cs.emit({"design": "kept", "card": smi,
             "ptxas": cs.ptxas_report(kernels.build_log("group_agg")),
             "step": timed(shapes)})
    for name, (what, so, proc) in jobs.items():
        log, _ = proc.communicate()
        text = log.decode(errors="replace")
        if proc.returncode != 0:
            cs.emit({"design": name, "change": what, "card": smi,
                     "built": False, "nvcc": text[-2000:]})
            continue
        kernels._LIBS["group_agg"] = bind(kernels, so)
        try:
            rec = {"step": timed(shapes if name.startswith("ranges")
                                 else main_shapes)}
        except (AssertionError, RuntimeError) as e:
            rec = {"failed": str(e)[:500]}
        cs.emit({"design": name, "change": what, "card": smi,
                 "ptxas": cs.ptxas_report(text), **rec})
    kernels._LIBS["group_agg"] = kept
    cs.emit({"design": "kept, again", "card": smi, "step": timed(shapes)})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
