"""Build and bind the hand-written CUDA kernels (``flink_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under
``flink_tpu_torch/_build/`` (git-ignored), then loaded with ``ctypes``.
Pointers come from ``tensor.data_ptr()`` and the stream from
``torch.cuda.current_stream().cuda_stream``, all passed as
``ctypes.c_void_p`` (host arrays of them as ctypes arrays). Every C entry returns ``cudaGetLastError()`` and
``check`` raises on a non-zero code.

The build runs at first use, never at import: one ``nvcc`` process per
source, all started together. A library is named by the hash of its
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header rebuilds and an unchanged one is reused. The compiler's
output (ptxas's registers, shared memory and spills per kernel) is kept
beside each library (``build_log``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["build_all", "build_log", "library", "check", "BUILD_DIR",
           "SOURCES", "builds"]

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_U64 = ctypes.c_ulonglong
_I32 = ctypes.c_int
_PI32 = ctypes.POINTER(ctypes.c_int)
_PP = ctypes.POINTER(ctypes.c_void_p)
#: source stem -> {C entry: argtypes}; every entry returns int
SOURCES = {
    "hist256": {
        "radix_grid": [_I32, _I32, _PI32],
        "radix_pass_launch": [_P, _I32, _P, _I64, _I32, _U64, _U64, _I64,
                              _I32, _I32, _P, _P, _P, _P, _I32, _P],
        "hist256_launch": [_P, _P, _I64, _I32, _I32, _P, _P, _P, _I32, _P],
    },
    "hash_table": {
        "hash_probe_launch": [_P, _I64, _P, _P, _I64, _I32, _P, _P, _P],
        "ingest_step_launch": [_P, _I64, _P, _P, _I32, _I64, _I64, _I64,
                               _I64, _P, _I64, _P, _P, _I32, _PP, _PI32,
                               _PI32, _PI32, _I32, _PP, _PI32, _P, _I32,
                               _I32, _P, _P, _I64, _P, _I64, _P, _P, _PP,
                               _P, _P, _I64, _I64, _P],
        "hash_table_load": [],
        "ingest_step_scratch_words": [_I64],
    },
    "session_window": {
        "session_step_launch": [_P, _I64, _P, _P, _I64, _I64, _I64, _I32, _P,
                                _P, _P, _P, _P, _I32, _PP, _PI32, _PI32, _PP,
                                _P, _P, _P, _I32, _P, _P, _P, _P, _P, _PP,
                                _P],
        "session_fire_launch": [_P, _I64, _I32, _I64, _I64, _P, _P, _P, _P,
                                _I32, _PP, _PI32, _PI32, _I32, _PI32, _PP,
                                _PI32, _PP, _P, _P, _P, _P, _P, _I32, _P, _P,
                                _P],
        "session_fire_scratch_words": [_I64],
    },
    "group_agg": {
        "group_agg_launch": [_I32, _PP, _PI32, _PI32, _I32, _I64, _P, _P,
                             _P, _I64, _I64, _P, _P, _P, _I32, _P, _P, _P,
                             _P, _P],
        "group_agg_scratch_words": [_I64],
    },
    "window_seal": {
        "window_seal_launch": [_I64, _I64, _I32, _PP, _PP, _PP, _PI32, _PI32,
                               _PI32, _I32, _I32, _I32, _I32, _I32, _I32,
                               _P],
        "window_rebuild_launch": [_I64, _I64, _I32, _PP, _PP, _PP, _PI32,
                                  _PI32, _PI32, _I32, _I32, _P, _I32, _I32,
                                  _P],
    },
    "device_lists": {
        "list_append_launch": [_P, _I64, _P, _I32, _I32, _P, _P, _P, _I64,
                               _I32, _P, _P, _I64, _P, _P, _P, _P],
        "list_probe_status_words": [_I64],
        "list_probe_launch": [_P, _I64, _P, _I32, _I32, _P, _P, _I64, _P,
                              _I64, _I64, _I64, _P, _P, _P, _P, _P, _P],
        "list_prune_launch": [_P, _I32, _I32, _P, _I64, _P, _I64, _I32,
                              _I64, _I32, _P, _P, _P, _P],
    },
    "exchange": {
        "exchange_bucket_launch": [_P, _P, _P, _I64, _I64, _I64, _I64, _I64,
                                   _I32, _I32, _I32, _I32, _I32, _PP, _PI32,
                                   _P, _P, _PP, _P, _P, _I64, _I64, _P],
        "exchange_scratch_words": [_I64, _I64, _I32],
    },
    "row_state": {
        "dedup_first_launch": [_P, _I64, _P, _P, _P, _I64, _P, _P, _I64, _P,
                               _I64, _P, _I32, _P, _P, _P, _P],
        "row_set_launch": [_P, _I64, _P, _P, _I32, _P, _P, _P, _I64, _P,
                           _I64, _P],
        "row_get_launch": [_P, _I64, _P, _I64, _P, _I32, _P, _P, _I64, _I64,
                           _P, _P, _P],
        "row_unset_launch": [_P, _I64, _P, _I64, _P, _P, _P],
        "row_state_block_rows": [],
    },
}
_ERROR_STRING = {"hist256": "hist256_error_string",
                 "hash_table": "hash_probe_error_string",
                 "session_window": "session_window_error_string",
                 "window_seal": "window_seal_error_string",
                 "group_agg": "group_agg_error_string",
                 "device_lists": "device_lists_error_string",
                 "row_state": "row_state_error_string",
                 "exchange": "exchange_error_string"}

#: source stem -> C entry that loads every kernel of the library at once
#: (its kernels launch inside CUDA graph captures)
_LOAD = {"hash_table": "hash_table_load"}

_LIBS: dict[str, ctypes.CDLL] = {}
#: sources compiled by this process (``builds()``)
_BUILT = [0]


def builds() -> int:
    """Sources this process has compiled: a run that builds nothing after
    its warm-up reads the same count before and after."""
    return _BUILT[0]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH); the CUDA kernels "
                           "build only where the CUDA toolkit is installed")
    return found


def _lib_path(stem: str) -> Path:
    """The library's path, named by the hash of its source, every shared
    header of ``csrc/`` and the flags."""
    h = hashlib.sha256((CSRC_DIR / f"{stem}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{stem}-{digest[:12]}.so"


def build_all() -> float:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all at once. Returns the wall seconds spent (0.0 when every
    library was already built). Raises with the compiler's output when a
    build fails."""
    todo = [s for s in SOURCES if not _lib_path(s).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    _BUILT[0] += len(todo)
    t0 = time.perf_counter()
    procs = []
    for stem in todo:
        out = _lib_path(stem)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{stem}.cu")]
        procs.append((stem, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for stem, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{stem}.cu:\n{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
            out.with_suffix(".log").write_bytes(log)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def build_log(stem: str) -> str:
    """The compiler's output of the built ``csrc/<stem>.cu``: ptxas's
    registers, shared memory and spills of every kernel (``-Xptxas
    -v``); empty before the build."""
    log = _lib_path(stem).with_suffix(".log")
    return log.read_text(errors="replace") if log.exists() else ""


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, building it first if
    needed, with every C entry's argtypes and restype declared."""
    lib = _LIBS.get(stem)
    if lib is None:
        path = _lib_path(stem)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        for entry, argtypes in SOURCES[stem].items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        err = getattr(lib, _ERROR_STRING[stem])
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _LIBS[stem] = lib
        if stem in _LOAD:
            check(stem, getattr(lib, _LOAD[stem])())
    return lib


def check(stem: str, code: int) -> None:
    """Raise when a C entry reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if code != 0:
        msg = getattr(library(stem), _ERROR_STRING[stem])(code)
        raise RuntimeError(f"{stem} kernel launch failed: CUDA error {code} "
                           f"({msg.decode(errors='replace')})")
