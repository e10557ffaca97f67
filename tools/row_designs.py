#!/usr/bin/env python3
"""The designs of the row plane's dedup_first and row_set
(csrc/row_state.cu), timed beside the kept ones on one CUDA card.

Run from the repository root, on the card:

    python3 tools/row_designs.py [--out FILE] [DESIGN ...]

(with names, only those designs beside the kept one; ``--out``: every
design's whole record also appended to FILE, one JSON line each).

The earlier design stays buildable here: ``tools/row_earlier.cu`` holds
dedup_first and row_set as they were before the batch map (two launches
each over a ``[capacity]`` int32 scratch; bound by ``EarlierKernels``).
At each of ``chip_smoke.ROW_SHAPES`` (the dedup cell's 17th batch of 2^19
rows into 2^24 slots, and 2^12 rows into 2^16), at 2^15 rows into 2^20
between them, and for a row_set of one key (the ValueState path's
shape), the kernel of the design under test and the earlier kernels are
timed in turns on the same state, put back before each launch, their
results held equal (fresh rows, status, the state by key; row_set's
planes).

The designs, each against the kept one (one cooperative launch, or one
ordinary block for at most 256 rows; a map of ``batch_map_entries(n)``
entries, 2n or, for 257 to 2^16 rows, up to 16n, cleared by its walkers
behind the barrier; a slot left unwritten when nothing of it changes):

* ``two_launches``: the two phases as two ordinary launches (the map
  walk's grid a thread an entry), no grid barrier;
* ``map_2n`` to ``map_16n``: a map of the least power of two at or above
  2n, 4n, 8n or 16n entries for every batch (no rebuild: the wrappers
  size the map by ``batch_map_entries``);
* ``memset_reset``: the map's entries set free by a memset before each
  launch, the walkers leaving them as they are;
* ``cooperative_one_block``: a call of at most 256 rows (a ValueState's
  one key) as a cooperative launch too (kept: one ordinary block,
  ``__syncthreads`` its barrier);
* ``map_hashed``: a row's first map entry at a multiplicative hash of its
  slot (kept: the slot's low bits);
* ``clock_read_always``: dedup_first's walker loads a slot's clock
  beside its presence (kept: only where presence is set, a second
  dependent load);
* ``write_every_slot``: dedup_first's walker writes presence and marks the
  dirty block of every slot of the batch, changed or not.

Each source design is the kept source with one change, built with the
package's flags into the package's build directory (all at once, one
nvcc each, with the earlier source) and bound in place of the kept
library; a design that does not build is reported and skipped. One JSON
line per design, each with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

EARLIER_SOURCE = os.path.join(HERE, "tools", "row_earlier.cu")
_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
INT32_MAX = (1 << 31) - 1
#: the map sizes tried, as entries per row (rounded up to a power of two)
MAP_FACTORS = (2, 4, 8, 16)


def shapes(cs) -> tuple:
    """chip_smoke's two row shapes and one between them: 2^15 rows into
    2^20 slots (the dedup cell's stream over 600,000 keys)."""
    return (*cs.ROW_SHAPES, ("medium", 1 << 15, 1 << 20, 600_000))

#: the kept cooperative launches
DEDUP_LAUNCH = (
    "  e = cudaLaunchCooperativeKernel((const void*)dedup_first_kernel<true>,"
    "\n                                  dim3(coop_grid(map_entries, most)),"
    "\n                                  dim3(kThreads), params, 0, st);")
SET_LAUNCH = DEDUP_LAUNCH.replace("dedup_first_kernel", "row_set_kernel")
#: the kept one-block launches of at most kThreads rows
DEDUP_BLOCK = """  if (n <= kThreads) {
    dedup_first_kernel<false><<<1, kThreads, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
"""
SET_BLOCK = DEDUP_BLOCK.replace("dedup_first_kernel", "row_set_kernel")
GRID_FOR = "unsigned grid_for(long long n) {"
#: the phases as kernels of their own (two_launches)
PHASE_KERNELS = """__global__ void __launch_bounds__(kThreads)
    dedup_resolve_only(DedupArgs a) {
  dedup_resolve(a, (long long)blockIdx.x * kThreads,
                (long long)gridDim.x * kThreads);
}

__global__ void __launch_bounds__(kThreads) dedup_admit_only(DedupArgs a) {
  dedup_admit(a, (long long)blockIdx.x * kThreads,
              (long long)gridDim.x * kThreads);
}

__global__ void __launch_bounds__(kThreads) row_set_mark_only(SetArgs a) {
  row_set_mark(a, (long long)blockIdx.x * kThreads,
               (long long)gridDim.x * kThreads);
}

__global__ void __launch_bounds__(kThreads) row_set_write_only(SetArgs a) {
  row_set_write(a, (long long)blockIdx.x * kThreads,
                (long long)gridDim.x * kThreads);
}

"""
CLEAR = "        a.map[e] = kNoEntry;\n"
CLEAR_SET = "    a.map[e] = kNoEntry;\n"
MAP_HOME = "  ull h = (ull)(unsigned)slot & mask;"
CLOCK_READ = ("            if (was) was = within_ttl(t, a.last_ts[s], "
              "a.ttl);")
SKIP_WRITE = """          } else if (p != 1) {
            a.presence[s] = 1;
          }
          if (!was || p != 1) a.dirty[s >> a.dirty_shift] = 1;"""


def patch(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"the kept source changed: {old[:60]!r}")
    return src.replace(old, new)


def designs(src: str) -> dict:
    """design -> (what it changes, its source)."""
    memset = ("  {{\n"
              "    const cudaError_t m = cudaMemsetAsync(\n"
              "        a.map, 0xff, (size_t)map_entries * sizeof(ull), st);\n"
              "    if (m != cudaSuccess) return (int)m;\n"
              "  }}\n")
    two = ("  {0}<<<grid_for(n), kThreads, 0, st>>>(a);\n"
           "  e = cudaGetLastError();\n"
           "  if (e != cudaSuccess) return (int)e;\n"
           "  {1}<<<grid_for(map_entries), kThreads, 0, st>>>(a);\n"
           "  e = cudaGetLastError();\n"
           "  (void)params;")
    return {
        "two_launches": (
            "the two phases as two ordinary launches, no grid barrier",
            patch(patch(patch(src, GRID_FOR, PHASE_KERNELS + GRID_FOR),
                        DEDUP_LAUNCH, two.format("dedup_resolve_only",
                                                 "dedup_admit_only")),
                  SET_LAUNCH, two.format("row_set_mark_only",
                                         "row_set_write_only"))),
        "cooperative_one_block": (
            "a call of at most 256 rows as a cooperative launch too (kept: "
            "one ordinary block, __syncthreads its barrier)",
            patch(patch(src, DEDUP_BLOCK, ""), SET_BLOCK, "")),
        "memset_reset": (
            "the map's entries set free by a memset before each launch; "
            "the walkers leave them",
            patch(patch(patch(patch(src, CLEAR, ""), CLEAR_SET, ""),
                        DEDUP_BLOCK, memset.format() + DEDUP_BLOCK),
                  SET_BLOCK, memset.format() + SET_BLOCK)),
        "map_hashed": (
            "a row's first map entry at a multiplicative hash of its slot",
            patch(src, MAP_HOME,
                  "  ull h = (((ull)(unsigned)slot * 0x9E3779B97F4A7C15ull) "
                  ">> 32) & mask;")),
        "clock_read_always": (
            "dedup_first's walker loads the slot's clock beside its "
            "presence (kept: only where presence is set)",
            patch(src, CLOCK_READ,
                  "            const long long last = a.last_ts[s];\n"
                  "            if (was) was = within_ttl(t, last, a.ttl);")),
        "write_every_slot": (
            "dedup_first writes presence and marks the dirty block of "
            "every slot of the batch",
            patch(src, SKIP_WRITE,
                  "          } else {\n"
                  "            a.presence[s] = 1;\n"
                  "          }\n"
                  "          a.dirty[s >> a.dirty_shift] = 1;")),
    }


def _build(kernels, src_path: str, out):
    """nvcc on ``src_path`` into ``out`` with the package's flags, started;
    returns the process."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC_DIR),
         "-o", str(out), src_path], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)


def start_earlier_build():
    """Starts nvcc on tools/row_earlier.cu beside the package's builds.
    Returns (library path, (tmp path, process) or None when built)."""
    from flink_tpu_torch.ops import kernels

    with open(EARLIER_SOURCE, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update((kernels.CSRC_DIR / "probe.cuh").read_bytes())
    h.update(" ".join(kernels.NVCC_FLAGS).encode())
    out = kernels.BUILD_DIR / f"librow_earlier-{h.hexdigest()[:12]}.so"
    if out.exists():
        return out, None
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    return out, (tmp, _build(kernels, EARLIER_SOURCE, tmp))


class EarlierKernels:
    """The earlier dedup_first and row_set on a
    ``chip_smoke.row_shape_state`` with a ``[capacity]`` int32 scratch of
    INT32_MAX beside it."""

    def __init__(self, build):
        out, job = build
        if job is not None:
            tmp, proc = job
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed on tools/row_earlier.cu:\n"
                                   + log.decode(errors="replace"))
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        lib.dedup_first_earlier_launch.argtypes = [
            _P, _I64, _P, _P, _P, _I64, _P, _P, _I64, _P, _P, _I32, _P, _P,
            _P, _P]
        lib.row_set_earlier_launch.argtypes = [
            _P, _I64, _P, _P, _I32, _P, _P, _P, _I64, _P, _P]
        for fn in (lib.dedup_first_earlier_launch,
                   lib.row_set_earlier_launch):
            fn.restype = ctypes.c_int
        lib.row_earlier_error_string.argtypes = [ctypes.c_int]
        lib.row_earlier_error_string.restype = ctypes.c_char_p
        self.lib = lib

    def _check(self, rc: int) -> None:
        if rc:
            raise RuntimeError("the earlier row kernel: CUDA error "
                               + self.lib.row_earlier_error_string(rc)
                               .decode())

    def dedup(self, torch, st: dict, scratch, keys, ts, ttl: int,
              dirty_shift: int):
        """(fresh, slots, status) as ``dedup_first``."""
        n = keys.numel()
        dev = keys.device
        slots = torch.empty(n, dtype=torch.int32, device=dev)
        fresh = torch.empty(n, dtype=torch.bool, device=dev)
        status = torch.empty(3, dtype=torch.int64, device=dev)
        self._check(self.lib.dedup_first_earlier_launch(
            st["table"].data_ptr(), st["table"].numel(), keys.data_ptr(),
            None, ts.data_ptr(), n, st["presence"].data_ptr(),
            st["last_ts"].data_ptr(), int(ttl), scratch.data_ptr(),
            st["dirty"].data_ptr(), int(dirty_shift), slots.data_ptr(),
            fresh.data_ptr(), status.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream))
        return fresh, slots, status

    def row_set(self, torch, st: dict, scratch, slots, vals, now) -> None:
        """``row_set`` with a clock a row (``now`` int64 [n])."""
        self._check(self.lib.row_set_earlier_launch(
            slots.data_ptr(), slots.numel(), st["vals"].data_ptr(),
            vals.data_ptr(), st["vals"].element_size(),
            st["presence"].data_ptr(), st["last_ts"].data_ptr(),
            now.data_ptr(), 0, scratch.data_ptr(),
            torch.cuda.current_stream(slots.device).cuda_stream))


def row_turns(torch, cs, flush, earlier, rows: int, cap: int,
              n_keys: int) -> dict:
    """dedup_first and row_set of the bound library against the earlier
    kernels at one shape, results held equal, timed in turns; and a
    row_set of one key."""
    from flink_tpu_torch.ops import row_state as rs
    from flink_tpu_torch.ops.hash_table import lookup_or_insert_plain, \
        sanitize_keys_device

    dev = torch.device("cuda", 0)
    st = cs.row_shape_state(torch, dev, rows, cap, n_keys)
    base = cs.row_clone(st)
    keys, ts, ttl = st["keys"], st["ts"], st["ttl"]
    scratch = torch.full((cap,), INT32_MAX, dtype=torch.int32, device=dev)

    def put_back():
        cs.row_put_back(st, base)

    def kernel_dedup():
        return rs.dedup_first(st["table"], st["presence"], st["last_ts"],
                              keys, None, ts, ttl, st["dirty"],
                              cs.DIRTY_SHIFT, st["map"])

    def earlier_dedup():
        return earlier.dedup(torch, st, scratch, keys, ts, ttl,
                             cs.DIRTY_SHIFT)

    fk, _sk, stk = kernel_dedup()
    got = cs.row_state_of(torch, st)
    put_back()
    fe, _se, ste = earlier_dedup()
    if not (torch.equal(fk, fe) and torch.equal(stk, ste)
            and cs.states_by_key_equal(got, cs.row_state_of(torch, st))):
        raise AssertionError("the earlier dedup_first differs")
    out = {"dedup_first": {"rows": rows, "capacity": cap,
                           "fresh": int(stk[2]), **cs.turns(
                               torch, flush, put_back, kernel=kernel_dedup,
                               earlier=earlier_dedup)}}
    del got
    # row_set: the batch's keys (all in the table), a clock a row
    put_back()
    _, slots, _ok = lookup_or_insert_plain(st["table"],
                                           sanitize_keys_device(keys))
    base2 = cs.row_clone(st)
    vals = (keys % 1000).to(torch.float64) * 0.5
    now = ts + 1

    def put_back2():
        cs.row_put_back(st, base2)

    def case(sl, v, t):
        put_back2()

        def kernel():
            rs.row_set(st["vals"], st["presence"], st["last_ts"], sl, v, t,
                       st["map"])

        def older():
            earlier.row_set(torch, st, scratch, sl, v, t)

        kernel()
        want = [st[k].clone() for k in ("vals", "presence", "last_ts")]
        put_back2()
        older()
        if not all(torch.equal(a, st[k]) for a, k in
                   zip(want, ("vals", "presence", "last_ts"))):
            raise AssertionError("the earlier row_set differs")
        del want
        return cs.turns(torch, flush, put_back2, kernel=kernel,
                        earlier=older)

    out["row_set"] = {"rows": rows, **case(slots, vals, now)}
    out["row_set_one_key"] = {"rows": 1, **case(
        slots[:1].contiguous(), vals[:1].contiguous(), now[:1].contiguous())}
    if not bool((scratch == INT32_MAX).all()):
        raise AssertionError("the earlier kernels left their scratch dirty")
    del st, base, base2, scratch
    return out


def bind(kernels, so):
    lib = ctypes.CDLL(str(so))
    for entry, argtypes in kernels.SOURCES["row_state"].items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.row_state_error_string.argtypes = [ctypes.c_int]
    lib.row_state_error_string.restype = ctypes.c_char_p
    return lib


def main(argv: list[str]) -> int:
    import gc

    import torch

    out_path = None
    if argv[:1] == ["--out"]:
        out_path, argv = argv[1], argv[2:]
    if not torch.cuda.is_available():
        print("row_designs: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from flink_tpu_torch.ops import kernels
    from flink_tpu_torch.ops import row_state as rs

    def emit(rec: dict) -> None:
        cs.emit(rec)
        if out_path:
            with open(out_path, "a") as f:
                f.write(cs.json.dumps(rec) + "\n")

    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi_line()
    src = (kernels.CSRC_DIR / "row_state.cu").read_text()
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, (what, text) in designs(src).items():
        if argv and name not in argv:
            continue
        cu = kernels.BUILD_DIR / f"design_rows_{name}.cu"
        cu.write_text(text)
        so = kernels.BUILD_DIR / f"libdesign_rows_{name}.so"
        jobs[name] = (what, so, _build(kernels, str(cu), so))
    earlier = EarlierKernels(start_earlier_build())
    kernels.build_all()
    flush = cs.L2Flush(torch, dev)
    kept = kernels.library("row_state")

    def timed() -> dict:
        out = {label: row_turns(torch, cs, flush, earlier, rows, cap,
                                n_keys)
               for label, rows, cap, n_keys in shapes(cs)}
        gc.collect()
        torch.cuda.empty_cache()
        return out

    emit({"design": "kept", "card": smi,
          "ptxas": {k: v for k, v in cs.ptxas_report(
              kernels.build_log("row_state")).items()
              if "dedup_first" in k or "row_set" in k},
          "shapes": timed()})
    entries = rs.batch_map_entries
    for k in MAP_FACTORS:
        if argv and f"map_{k}n" not in argv:
            continue
        rs.batch_map_entries = lambda n, k=k: 1 << (k * n - 1).bit_length()
        try:
            emit({"design": f"map_{k}n", "card": smi,
                  "change": f"a map of the least power of two at or above "
                            f"{k}n entries", "shapes": timed()})
        finally:
            rs.batch_map_entries = entries
    for name, (what, so, proc) in jobs.items():
        log, _ = proc.communicate()
        text = log.decode(errors="replace")
        if proc.returncode != 0:
            emit({"design": name, "change": what, "card": smi,
                  "built": False, "nvcc": text[-2000:]})
            continue
        kernels._LIBS["row_state"] = bind(kernels, so)
        try:
            rec = {"shapes": timed()}
        except (AssertionError, RuntimeError) as e:
            rec = {"failed": str(e)[:500]}
        emit({"design": name, "change": what, "card": smi,
              "ptxas": {k: v for k, v in cs.ptxas_report(text).items()
                        if "dedup" in k or "row_set" in k}, **rec})
    kernels._LIBS["row_state"] = kept
    emit({"design": "kept, again", "card": smi, "shapes": timed()})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
