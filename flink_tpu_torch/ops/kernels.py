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

With the build cache on (``aot.enabled`` and ``aot.dir``,
``runtime/aot.py``) a library is opened only from bytes that verified
against a cache artifact's digest and fingerprint; a missing, corrupt or
skewed artifact is built live from the same source and stored. Every
build runs under the ``device.compile`` fault site and watchdog deadline,
and each source built counts in ``builds()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["build_all", "build_log", "library", "check", "BUILD_DIR",
           "SOURCES", "builds", "load_cached", "loaded_count"]

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
#: serializes loads and builds (the cache's warm-up loads on the
#: watchdog's worker while a task thread may need a library)
_LOCK = threading.RLock()
#: opens a verified library file (``ctypes.CDLL``)
_dlopen = ctypes.CDLL


def builds() -> int:
    """Sources this process has compiled: a run that builds nothing after
    its warm-up reads the same count before and after."""
    return _BUILT[0]


def loaded_count() -> int:
    """Libraries this process has open."""
    return len(_LIBS)


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


def _source_digest(stem: str) -> str:
    """The hash of the source, every shared header of ``csrc/`` and the
    flags: what names a library."""
    h = hashlib.sha256((CSRC_DIR / f"{stem}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def _lib_path(stem: str) -> Path:
    """The library's path, named by the hash of its source, every shared
    header of ``csrc/`` and the flags."""
    return BUILD_DIR / f"lib{stem}-{_source_digest(stem)[:12]}.so"


def _build_key(stem: str, source_digest: str, flags: str) -> str:
    """The parts of a build the ledger's recompile attribution diffs."""
    return f"{stem}:{source_digest[:12]}:{flags}"


def _compile(todo: list, out_of) -> float:
    """Compile every source of ``todo`` to ``out_of(stem)``, one ``nvcc``
    per source, all at once, under the ``device.compile`` fault site and
    watchdog deadline. Raises with the compiler's output when a build
    fails. Each build counts in ``DEVICE_STATS`` (``compiles``,
    ``compile_ms``: the seconds until its compiler exited) and is a
    ``device.Compile`` span, the port's counterpart of the reference's
    XLA compile."""
    from ..metrics.device import DEVICE_STATS
    from ..metrics.profiler import DEVICE_LEDGER
    from ..metrics.tracing import now_ms
    from ..runtime.watchdog import stall_bounded

    nvcc = _nvcc()
    flags = " ".join(NVCC_FLAGS)

    def run() -> float:
        _BUILT[0] += len(todo)
        for stem in todo:
            DEVICE_LEDGER.note_build(f"build.{stem}", _build_key(
                stem, _source_digest(stem), flags), _build_key,
                (stem, _source_digest(stem), flags), {})
        start_ms = now_ms()
        t0 = time.perf_counter()
        procs = []
        for stem in todo:
            out = Path(out_of(stem))
            tmp = out.with_suffix(f".tmp{os.getpid()}")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / f"{stem}.cu")]
            procs.append((stem, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for stem, out, tmp, proc in procs:
            log, _ = proc.communicate()
            DEVICE_STATS.note_build(f"build.{stem}")
            DEVICE_STATS.note_compile_done(
                f"build.{stem}", (time.perf_counter() - t0) * 1e3, start_ms)
            if proc.returncode != 0:
                failed.append(f"{stem}.cu:\n{log.decode(errors='replace')}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
                out.with_suffix(".log").write_bytes(log)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        return time.perf_counter() - t0

    # the site is visited before the build starts (a hang past the
    # deadline is a stall there); the build itself runs under the deadline
    return stall_bounded("device.compile", run, scope="kernels")


def _nvcc_version() -> str:
    """The last line of ``nvcc --version`` (recorded in a cache artifact's
    header at build time only)."""
    try:
        out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return ""
    lines = [ln for ln in out.splitlines() if ln.strip()]
    return lines[-1] if lines else ""


def build_all() -> float:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all at once. Returns the wall seconds spent (0.0 when every
    library was already built). Raises with the compiler's output when a
    build fails. With the build cache on (``runtime/aot.py``) a library
    is missing when no verified artifact holds it: each one built is
    stored."""
    from ..runtime.aot import AOT
    with _LOCK:
        if AOT.enabled:
            return _build_cached([s for s in SOURCES if s not in _READY])
        todo = [s for s in SOURCES if not _lib_path(s).exists()]
        if not todo:
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        return _compile(todo, _lib_path)


#: source stem -> a verified library file not opened yet (cache mode)
_READY: dict[str, str] = {}


def _build_cached(stems: list) -> float:
    """Cache mode: every stem whose artifact does not verify is built live
    (into the cache's work directory) and stored. A stem not open yet ends
    ready to open (``_READY``); an open one keeps its library, and the
    file just verified or built is removed."""
    from ..runtime.aot import AOT
    todo = []
    for stem in stems:
        path = AOT.load(stem, _source_digest(stem))
        if path is None:
            todo.append(stem)
        else:
            _keep_ready(stem, path)
    if not todo:
        return 0.0
    work = Path(AOT.directory) / ".build"
    work.mkdir(parents=True, exist_ok=True)

    def out_of(stem: str) -> Path:
        return work / f"lib{stem}-{_source_digest(stem)[:12]}-{os.getpid()}.so"

    from ..metrics.device import DEVICE_STATS
    for stem in todo:
        # a live build while the cache is on
        DEVICE_STATS.note_compile_storm(f"build.{stem}")
    seconds = _compile(todo, out_of)
    version = _nvcc_version()
    for stem in todo:
        out = out_of(stem)
        AOT.store(stem, _source_digest(stem), out.read_bytes(), version)
        out.with_suffix(".log").unlink(missing_ok=True)
        _keep_ready(stem, str(out))
    return seconds


def _keep_ready(stem: str, path: str) -> None:
    if stem in _LIBS:
        Path(path).unlink(missing_ok=True)
    else:
        _READY[stem] = path


def build_log(stem: str) -> str:
    """The compiler's output of the built ``csrc/<stem>.cu``: ptxas's
    registers, shared memory and spills of every kernel (``-Xptxas
    -v``); empty before the build."""
    log = _lib_path(stem).with_suffix(".log")
    return log.read_text(errors="replace") if log.exists() else ""


def _open(stem: str, path: str, private: bool) -> ctypes.CDLL:
    """Open and bind ``path`` as ``stem``'s library (``_LOCK`` held); a
    private copy from the cache is removed once open."""
    try:
        lib = _dlopen(str(path))
    finally:
        if private:
            Path(path).unlink(missing_ok=True)
            Path(path).with_suffix(".log").unlink(missing_ok=True)
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


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, building it first if
    needed, with every C entry's argtypes and restype declared. With the
    build cache on, the library comes from its verified artifact, or from
    a live build of that source alone."""
    lib = _LIBS.get(stem)
    if lib is not None:
        return lib
    from ..metrics.device import DEVICE_STATS
    from ..runtime.aot import AOT
    with _LOCK:
        lib = _LIBS.get(stem)
        if lib is not None:
            return lib
        built = _BUILT[0]
        if AOT.enabled:
            if stem not in _READY:
                _build_cached([stem])
            lib = _open(stem, _READY.pop(stem), private=True)
        else:
            path = _lib_path(stem)
            if not path.exists():
                build_all()
            lib = _open(stem, str(path), private=False)
        if _BUILT[0] == built:
            # opened without a build: found built (or in the cache)
            DEVICE_STATS.note_cache_hit(f"build.{stem}")
        return lib


def load_cached() -> int:
    """Cache mode's warm-up: open every library whose artifact verifies,
    ``hash_table_load`` included; the others build at first use. Returns
    the libraries opened."""
    from ..runtime.aot import AOT
    opened = 0
    for stem in SOURCES:
        with _LOCK:
            if stem in _LIBS:
                continue
            path = _READY.pop(stem, None) or AOT.load(
                stem, _source_digest(stem))
            if path is None:
                continue
            _open(stem, path, private=True)
            opened += 1
    return opened


def check(stem: str, code: int) -> None:
    """Raise when a C entry reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if code != 0:
        msg = getattr(library(stem), _ERROR_STRING[stem])(code)
        raise RuntimeError(f"{stem} kernel launch failed: CUDA error {code} "
                           f"({msg.decode(errors='replace')})")
