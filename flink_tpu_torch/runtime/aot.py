"""The verified, persistent cache of the kernel libraries (port of
``flink_tpu/runtime/aot.py``).

The reference persists serialized XLA executables so that a cold process
serves its first batch without a compile storm. The port's compiled
artifacts are the shared libraries that ``ops/kernels.py`` builds from
``csrc/*.cu`` with ``nvcc``; with ``aot.enabled`` and an ``aot.dir`` they
are kept here under the reference's artifact contract:

* one artifact per source, named by the source's digest (the hash
  ``kernels._lib_path`` computes over the source, the shared headers and
  the flags) and the environment fingerprint:
  ``<stem>-<source digest[:12]>-<fingerprint digest[:12]>.aotx``;
* a JSON header line (format tag, source stem, source digest, flags,
  fingerprint, the ``nvcc --version`` line of the build, payload size and
  blake2b digest) followed by the library's bytes;
* every write goes to a temporary file, is fsynced and renamed into place
  (``checkpoint/storage.py``); a digest, size or format mismatch raises
  the checkpoint verifier's ``CorruptArtifactError`` and the artifact is
  quarantined as ``<name>.corrupt``;
* the fingerprint (compute capability, ``torch.version.cuda``,
  ``kernels.NVCC_FLAGS`` and the toolkit's version, read from the
  toolkit's ``version.json``, so a warm start spawns no ``nvcc`` to
  compare) keeps a library off a card or toolkit it was not built for:
  skew is a miss, never an error.

Only a verified payload is handed to ``ctypes.CDLL``: ``load`` copies the
bytes it verified into a private file, which the loader removes once the
library is open. Every failure on this path, a missing, corrupt,
truncated or skewed artifact, an ``aot.load`` or ``aot.store`` fault or
a stalled ``aot.warmup`` scan, degrades to a live ``nvcc`` build of the
same source, never to a plain PyTorch version; a build that fails still
raises, as ``kernels.build_all`` does. With ``aot.enabled`` off (the
default) nothing here runs and the builds go to ``_build/`` as before.

``AOT.configure`` and ``AOT.warmup`` run on the deploy paths
(``cluster/local.py::deploy_local``, which the supervisor's restarts
call too): the warm-up loads every library, ``hash_table_load`` included,
before the first batch, under the ``aot.warmup`` deadline. The cache's
command-line verifier and its HA and REST wiring are not ported;
``verify_aot_cache`` is.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Optional

from ..checkpoint.storage import CorruptArtifactError, _digest, _fsync_write

__all__ = ["AotRuntime", "AOT", "AOT_FORMAT", "environment_fingerprint",
           "artifact_name", "verify_aot_cache"]

#: Format tag every artifact header carries; bumped on layout changes so
#: an old cache directory reads as all-skew (miss), never as garbage.
AOT_FORMAT = "flink-tpu-torch-aot-v1"

_SUFFIX = ".aotx"
_EVENT_LIMIT = 512


def _toolkit_version() -> str:
    """The CUDA toolkit's version without spawning ``nvcc``: its
    ``version.json`` next to ``bin/nvcc``, else the compiler binary's size
    and modification time."""
    from ..ops import kernels
    try:
        nvcc = kernels._nvcc()
    except RuntimeError:
        return "none"
    root = os.path.dirname(os.path.dirname(nvcc))
    try:
        with open(os.path.join(root, "version.json")) as f:
            info = json.load(f)
        return str(info["cuda_nvcc"]["version"])
    except (OSError, ValueError, KeyError, TypeError):
        st = os.stat(nvcc)
        return f"nvcc@{st.st_size}:{st.st_mtime_ns}"


def environment_fingerprint() -> list:
    """Card and toolkit discriminator baked into every artifact: a library
    built for another card or toolkit never loads, so a mismatch is a
    plain cache miss."""
    import torch

    from ..ops import kernels
    cap = ("".join(str(v) for v in torch.cuda.get_device_capability())
           if torch.cuda.is_available() else "none")
    return [AOT_FORMAT, f"sm_{cap}", str(torch.version.cuda),
            " ".join(kernels.NVCC_FLAGS), _toolkit_version()]


def artifact_name(stem: str, source_digest: str, fingerprint: list) -> str:
    fp = hashlib.blake2b(repr(tuple(fingerprint)).encode(),
                         digest_size=16).hexdigest()
    return f"{stem}-{source_digest[:12]}-{fp[:12]}{_SUFFIX}"


def _parse_artifact(raw: bytes, path: str) -> tuple:
    """Split and verify one artifact's header and payload; raises
    CorruptArtifactError on any integrity problem (truncation, digest
    mismatch, undecodable header, wrong format tag)."""
    nl = raw.find(b"\n")
    if nl < 0:
        raise CorruptArtifactError(f"AOT artifact {path}: no header line")
    try:
        header = json.loads(raw[:nl].decode())
    except (ValueError, UnicodeDecodeError) as e:
        raise CorruptArtifactError(
            f"AOT artifact {path}: undecodable header ({e})") from e
    if not isinstance(header, dict) or header.get("format") != AOT_FORMAT:
        raise CorruptArtifactError(
            f"AOT artifact {path}: format "
            f"{header.get('format') if isinstance(header, dict) else header!r}"
            f" != {AOT_FORMAT}")
    payload = raw[nl + 1:]
    if len(payload) != header.get("payload_size"):
        raise CorruptArtifactError(
            f"AOT artifact {path}: payload truncated "
            f"({len(payload)} != {header.get('payload_size')} bytes)")
    if _digest(payload) != header.get("payload_digest"):
        raise CorruptArtifactError(
            f"AOT artifact {path}: payload digest mismatch")
    return header, payload


def _mutate(data: bytes) -> bytes:
    """A poison trip's corruption: one flipped bit in the middle."""
    mutated = bytearray(data)
    mutated[len(mutated) // 2] ^= 0x40
    return bytes(mutated)


class AotRuntime:
    """Process-global cache of the kernel libraries (the ``FAULTS`` /
    ``WATCHDOG`` singleton pattern): deploy paths ``configure()`` it from
    the job's Configuration and ``warmup()`` it before the first batch;
    ``ops/kernels.py`` consults it at every build and load."""

    def __init__(self):
        self._lock = threading.Lock()
        self.enabled = False
        self.directory = ""
        self.in_memory_max_programs = 0
        self.warmed = False
        self._fingerprint: Optional[list] = None
        #: counters of this process's cache traffic (``snapshot``)
        self.hits = 0
        self.misses = 0
        self.stores = 0
        self.quarantined = 0
        #: bounded event log (quarantines, skew, faults, stalls)
        self.events: list[dict] = []

    # -- configuration ---------------------------------------------------
    def configure(self, config) -> None:
        """Adopt the ``aot.*`` keys of a job's Configuration."""
        from ..core.config import AotOptions

        enabled = bool(config.get(AotOptions.ENABLED))
        directory = str(config.get(AotOptions.DIR) or "")
        cap = int(config.get(AotOptions.IN_MEMORY_MAX_PROGRAMS))
        with self._lock:
            if directory != self.directory:
                self.warmed = False
            self.enabled = enabled and bool(directory)
            self.directory = directory
            self.in_memory_max_programs = max(cap, 0)
        if self.enabled:
            try:
                os.makedirs(directory, exist_ok=True)
            except OSError as e:
                self._event("aot-dir-unusable", error=str(e))
                with self._lock:
                    self.enabled = False

    def reset(self) -> None:
        """Disarm and clear every counter and event (test isolation)."""
        with self._lock:
            self.enabled = False
            self.directory = ""
            self.in_memory_max_programs = 0
            self.warmed = False
            self._fingerprint = None
            self.hits = self.misses = self.stores = self.quarantined = 0
            self.events.clear()

    def fingerprint(self) -> list:
        """This process's environment fingerprint, computed once."""
        with self._lock:
            fp = self._fingerprint
        if fp is None:
            fp = environment_fingerprint()
            with self._lock:
                self._fingerprint = fp
        return fp

    def artifact_path(self, stem: str, source_digest: str) -> str:
        return os.path.join(self.directory, artifact_name(
            stem, source_digest, self.fingerprint()))

    # -- events ----------------------------------------------------------
    def _event(self, kind: str, **fields) -> None:
        with self._lock:
            if len(self.events) < _EVENT_LIMIT:
                self.events.append(
                    {"timestamp": time.time(), "kind": kind, **fields})

    # -- store -----------------------------------------------------------
    def store(self, stem: str, source_digest: str, payload: bytes,
              nvcc_version: str = "") -> bool:
        """Persist one freshly built library. Every failure (an injected
        ``aot.store`` trip, an unwritable directory) skips persistence and
        returns False; the build keeps serving this process. A poison trip
        commits a corrupt-mutated payload (the ``checkpoint.corrupt``
        analog) that the verified load must catch."""
        if not self.enabled:
            return False
        from ..metrics.device import DEVICE_STATS
        from .faults import InjectedFault, fire_with_retries
        poison = False
        try:
            fire_with_retries("aot.store", scope="aot")
        except InjectedFault as e:
            if not e.poison:
                self._event("aot-store-failed", stem=stem, error=str(e))
                return False
            poison = True
        from ..ops import kernels
        fingerprint = self.fingerprint()
        header = json.dumps({
            "format": AOT_FORMAT, "stem": stem,
            "source_digest": source_digest,
            "flags": " ".join(kernels.NVCC_FLAGS),
            "fingerprint": fingerprint, "nvcc_version": nvcc_version,
            "payload_size": len(payload),
            "payload_digest": _digest(payload),
        }, sort_keys=True).encode()
        if poison and payload:
            # the digest was taken over the clean payload, so the committed
            # artifact is corrupt on disk: the load MUST detect it
            payload = _mutate(payload)
        try:
            _fsync_write(self.artifact_path(stem, source_digest),
                         header + b"\n" + payload)
        except OSError as e:
            self._event("aot-store-failed", stem=stem, error=str(e))
            return False
        with self._lock:
            self.stores += 1
        DEVICE_STATS.note_aot_store(stem)
        return True

    # -- load ------------------------------------------------------------
    def load(self, stem: str, source_digest: str) -> Optional[str]:
        """The path of a private copy of ``stem``'s verified library, or
        None on a miss: no artifact, a fingerprint or source skew, a
        corrupt artifact (quarantined) or an ``aot.load`` fault (the
        artifact survives). The caller then builds the source live."""
        from ..metrics.device import DEVICE_STATS
        from .faults import InjectedFault
        path = self.artifact_path(stem, source_digest)
        name = os.path.basename(path)
        if not os.path.exists(path):
            self._miss(stem)
            return None
        try:
            header, payload = self._read_artifact(path)
        except InjectedFault as e:
            DEVICE_STATS.note_aot_fallback(stem)
            self._event("aot-load-failed", artifact=name, error=str(e))
            self._miss(stem)
            return None
        except CorruptArtifactError as e:
            self._quarantine(path, str(e))
            self._miss(stem)
            return None
        except OSError as e:
            self._event("aot-load-failed", artifact=name, error=str(e))
            self._miss(stem)
            return None
        if header.get("fingerprint") != self.fingerprint() or \
                header.get("stem") != stem or \
                header.get("source_digest") != source_digest:
            # another card, toolkit or source: a miss, never an error
            self._event("aot-version-skew", artifact=name,
                        artifact_fingerprint=header.get("fingerprint"),
                        process_fingerprint=self.fingerprint())
            self._miss(stem)
            return None
        private = self._private_copy(stem, payload)
        with self._lock:
            self.hits += 1
        DEVICE_STATS.note_aot_hit(stem)
        return private

    def _miss(self, stem: str) -> None:
        from ..metrics.device import DEVICE_STATS
        with self._lock:
            self.misses += 1
        DEVICE_STATS.note_aot_miss(stem)

    def _private_copy(self, stem: str, payload: bytes) -> str:
        """The verified bytes in a file of this process's own, for
        ``ctypes.CDLL`` (the loader removes it once the library is open)."""
        import tempfile
        work = os.path.join(self.directory, ".load")
        os.makedirs(work, exist_ok=True)
        fd, path = tempfile.mkstemp(prefix=f"lib{stem}-", suffix=".so",
                                    dir=work)
        with os.fdopen(fd, "wb") as f:
            f.write(payload)
        return path

    def _read_artifact(self, path: str) -> tuple:
        """Read and verify one artifact under the ``aot.load`` fault site.
        A poison trip mutates the bytes before verification, so the digest
        check, not luck, is what catches it."""
        from .faults import InjectedFault, fire_with_retries
        poison = False
        try:
            fire_with_retries("aot.load", scope="aot")
        except InjectedFault as e:
            if not e.poison:
                raise
            poison = True
        with open(path, "rb") as f:
            raw = f.read()
        if poison and raw:
            raw = _mutate(raw)
        return _parse_artifact(raw, path)

    def _quarantine(self, path: str, reason: str) -> None:
        """A corrupt artifact: renamed to ``<name>.corrupt`` so it is never
        read again, counted and logged."""
        try:
            os.replace(path, path + ".corrupt")
        except OSError:
            pass
        with self._lock:
            self.quarantined += 1
        self._event("aot-corrupt-artifact",
                    artifact=os.path.basename(path), error=reason)
        from ..metrics.device import DEVICE_STATS
        DEVICE_STATS.note_verify_failure("aot.artifact")

    # -- warm start ------------------------------------------------------
    def warmup(self) -> int:
        """Load every library whose artifact verifies, under the
        watchdog's ``aot.warmup`` deadline, before the first batch.
        Returns the libraries loaded by the scan; a stall leaves partial
        warmth (what loaded stays loaded, the rest load or build at first
        use); never raises for a cache problem."""
        if not self.enabled:
            return 0
        from ..ops import kernels
        from .watchdog import WATCHDOG, StallError
        loaded = 0
        try:
            loaded = WATCHDOG.run("aot.warmup", kernels.load_cached,
                                  scope="aot")
        except StallError as e:
            self._event("aot-warmup-stalled", error=str(e))
            loaded = kernels.loaded_count()
        with self._lock:
            self.warmed = True
        return loaded

    # -- views -----------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled, "directory": self.directory,
                    "warmed": self.warmed, "hits": self.hits,
                    "misses": self.misses, "stores": self.stores,
                    "quarantined": self.quarantined}


#: The process-global cache every kernel build and load consults;
#: ``deploy_local`` configures and warms it from the job's Configuration.
AOT = AotRuntime()


def verify_aot_cache(directory: str) -> list:
    """Offline artifact verification: ``(artifact, status, detail)`` rows.
    OK (header and digest verify), CORRUPT (any integrity failure),
    QUARANTINED (``*.corrupt`` left by an earlier run)."""
    rows = []
    try:
        names = sorted(os.listdir(directory))
    except OSError as e:
        return [(directory, "CORRUPT", f"unreadable directory: {e}")]
    for name in names:
        path = os.path.join(directory, name)
        if name.endswith(".corrupt"):
            rows.append((name, "QUARANTINED", "quarantined by a prior run"))
            continue
        if not name.endswith(_SUFFIX):
            continue
        try:
            with open(path, "rb") as f:
                raw = f.read()
            header, _payload = _parse_artifact(raw, path)
        except (CorruptArtifactError, OSError) as e:
            rows.append((name, "CORRUPT", str(e)))
            continue
        fp = header.get("fingerprint") or []
        rows.append((name, "OK",
                     f"stem={header.get('stem')} "
                     f"arch={fp[1] if len(fp) > 1 else '?'} "
                     f"cuda={fp[2] if len(fp) > 2 else '?'}"))
    return rows
