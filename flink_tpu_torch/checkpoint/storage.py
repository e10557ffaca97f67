"""Checkpoint storage: where completed snapshots live (trimmed port of
``flink_tpu/checkpoint/storage.py``).

* ``MemoryCheckpointStorage`` keeps them in a dict.
* ``FsCheckpointStorage`` writes one directory per checkpoint,
  ``<dir>/chk-<id>/`` (``sp-<id>`` for a savepoint), holding a pickled
  manifest (``_manifest.pkl``): the checkpoint with each numpy array
  replaced by a reference. A checkpoint is written into a temporary
  directory and renamed into place, so a directory that exists is
  complete; ``load`` checks every digest and raises
  ``CorruptArtifactError`` on a mismatch.
* Incremental storage (the default): a device keyed snapshot (``{"kind":
  "tpu", ...}`` in canonical group order) is cut into 16 key-group pages,
  equal spans of the max-parallelism key-group space, and each page of
  its keys, key groups and every state's values is a content-addressed
  chunk under ``<dir>/chunks/`` named by its blake2b digest (of the bytes,
  the dtype and the leading shape). A page whose keys and values did not
  change since an earlier checkpoint hashes the same and is not written
  again, so a checkpoint writes O(changed pages). ``_refs.pkl`` counts the
  checkpoints that reference each chunk; discarding (subsuming) a
  checkpoint deletes the chunks no retained checkpoint references.
  Everything else, and every array of a savepoint or of a storage made
  with ``incremental=False``, is written inline into the checkpoint's own
  directory (``a<k>.bin``), so a savepoint stays self-contained.
  ``last_bytes_written`` is what the last ``store`` wrote.

The on-disk format is the port's own (raw pages, no compression); a
snapshot crosses packages as the snapshot dict, not as files.

Fault sites (``runtime/faults.py``): every store runs under the
``checkpoint.write`` site and every load under ``checkpoint.load``, each
bounded by ``watchdog.checkpoint-timeout`` with in-place retries of a
stall (a write is published by a rename and chunks are content-addressed,
so running one again is safe); a raising trip fails that store or load.
Every file of array bytes written visits the mutation sites
``checkpoint.corrupt`` (one byte flipped mid-file) and
``checkpoint.truncate`` (the second half dropped), which the digests
catch at load and at ``verify_checkpoint``.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import re
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

__all__ = ["CompletedCheckpoint", "CheckpointStorage",
           "MemoryCheckpointStorage", "FsCheckpointStorage",
           "CorruptArtifactError", "load_checkpoint", "verify_checkpoint",
           "snapshot_nbytes"]

_MANIFEST = "_manifest.pkl"
_CHUNKS = "chunks"
_REFS = "_refs.pkl"
N_PAGES = 16   # key-group space divided into this many pages


class CorruptArtifactError(RuntimeError):
    """A stored checkpoint failed its integrity check."""


@dataclass
class CompletedCheckpoint:
    checkpoint_id: int
    timestamp: float
    # task_id -> task snapshot ({"reader": ..., "chain": {...}})
    task_snapshots: dict[str, dict]
    is_savepoint: bool = False
    external_path: Optional[str] = None
    # topology at snapshot time, for a rescaling restore
    vertex_parallelism: dict[str, int] = field(default_factory=dict)
    # vertex id -> stable uid, for a restore into a resubmitted program
    vertex_uids: dict[str, str] = field(default_factory=dict)


def snapshot_nbytes(obj: Any) -> int:
    """Bytes of every numpy array in a nested snapshot."""
    if isinstance(obj, np.ndarray):
        return obj.nbytes
    if isinstance(obj, dict):
        return sum(snapshot_nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(snapshot_nbytes(v) for v in obj)
    return 0


def _bounded_io(site: str, fn):
    """One storage operation under the stall watchdog: the site's rule is
    visited once per attempt on the caller's thread (a raising trip fails
    the operation, it is not retried; a hang past the deadline retries in
    place up to ``watchdog.stall-retries`` times), then ``fn`` runs under
    the deadline. A stall of ``fn`` itself fails the operation: the
    abandoned write or read may still be running, so it is never run
    again beside it."""
    from ..metrics.device import DEVICE_STATS
    from ..runtime.faults import FAULTS
    from ..runtime.watchdog import WATCHDOG, StallError

    if FAULTS.enabled:
        bound = (site, WATCHDOG.deadline_in_force(site),
                 "checkpoint.storage")
        for attempt in range(WATCHDOG.stall_retries + 1):
            try:
                FAULTS.fire(site, bound)
                break
            except StallError:
                if attempt >= WATCHDOG.stall_retries:
                    raise
                DEVICE_STATS.note_retry(site)
    return WATCHDOG.run(site, fn, scope="checkpoint.storage")


def _fault_mutate(path: str) -> None:
    """The artifact-corruption sites, visited after every file of array
    bytes is written: ``checkpoint.corrupt`` flips one byte mid-file,
    ``checkpoint.truncate`` drops the second half."""
    from ..runtime.faults import FAULTS
    if not FAULTS.enabled:
        return
    if FAULTS.check("checkpoint.corrupt"):
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.seek(size // 2)
            b = f.read(1)
            f.seek(size // 2)
            f.write(bytes([(b[0] if b else 0) ^ 0x40]))
    if FAULTS.check("checkpoint.truncate"):
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(size // 2, 1))


class CheckpointStorage:
    def store(self, checkpoint: CompletedCheckpoint) -> CompletedCheckpoint:
        raise NotImplementedError

    def discard(self, checkpoint: CompletedCheckpoint) -> None:
        pass

    def load(self, path_or_id: Any) -> CompletedCheckpoint:
        raise NotImplementedError


class MemoryCheckpointStorage(CheckpointStorage):
    def __init__(self):
        self._store: dict[int, CompletedCheckpoint] = {}

    def store(self, checkpoint: CompletedCheckpoint) -> CompletedCheckpoint:
        def write():
            self._store[checkpoint.checkpoint_id] = checkpoint
            return checkpoint

        return _bounded_io("checkpoint.write", write)

    def discard(self, checkpoint: CompletedCheckpoint) -> None:
        self._store.pop(checkpoint.checkpoint_id, None)

    def load(self, checkpoint_id: int) -> CompletedCheckpoint:
        return self._store[checkpoint_id]


@dataclass(frozen=True)
class _ArrayRef:
    """An array written inline into the checkpoint's directory."""
    file: str
    dtype: str
    shape: tuple
    nbytes: int
    digest: str


@dataclass(frozen=True)
class _ChunkRef:
    """One key-group page: a chunk of ``<dir>/chunks`` named by its
    content digest (of the bytes, dtype and leading shape)."""
    digest: str
    nbytes: int


@dataclass(frozen=True)
class _PagedState:
    """An array cut into key-group pages along its last axis; pages
    concatenate back in order."""
    pages: tuple
    dtype: str
    lead_shape: tuple


def _digest(data) -> str:
    return hashlib.blake2b(data, digest_size=16).hexdigest()


def _fsync_write(path: str, data: bytes) -> None:
    """Atomic durable publish: write a temporary file, fsync, rename."""
    tmp = f"{path}.part{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _chunk_digest(raw, dtype: np.dtype, lead_shape: tuple) -> str:
    h = hashlib.blake2b(digest_size=16)
    h.update(raw)
    h.update(str((np.dtype(dtype).str, tuple(lead_shape))).encode())
    return h.hexdigest()


def _pageable(snap: dict) -> bool:
    """A device keyed snapshot in canonical group order."""
    groups = snap.get("key_groups")
    return (isinstance(groups, np.ndarray) and groups.ndim == 1
            and isinstance(snap.get("keys"), np.ndarray)
            and len(snap["keys"]) == len(groups) and len(groups) > 0
            and bool(np.all(groups[1:] >= groups[:-1])))


class FsCheckpointStorage(CheckpointStorage):
    def __init__(self, directory: str, incremental: bool = True):
        self.directory = directory
        self.incremental = bool(incremental)
        self.chunk_dir = os.path.join(directory, _CHUNKS)
        os.makedirs(self.chunk_dir, exist_ok=True)
        self._refs_path = os.path.join(self.chunk_dir, _REFS)
        #: chunk digest -> ids of the checkpoints that reference it
        self._refs: dict[str, set] = self._load_refs()
        #: bytes the last ``store`` wrote: new chunks, inline arrays and
        #: the manifest
        self.last_bytes_written = 0

    # -- chunk references --------------------------------------------------
    def _load_refs(self) -> dict[str, set]:
        """The refcounts, or, when the file is lost or unreadable, the
        chunks each stored checkpoint's manifest references."""
        try:
            with open(self._refs_path, "rb") as f:
                refs = pickle.load(f)
            if isinstance(refs, dict):
                return refs
        except (OSError, pickle.UnpicklingError, EOFError):
            pass
        refs: dict[str, set] = {}
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"chk-(\d+)", name)
            if not m:
                continue
            try:
                with open(os.path.join(self.directory, name, _MANIFEST),
                          "rb") as f:
                    manifest = pickle.load(f)
            except (OSError, pickle.UnpicklingError, EOFError):
                continue
            for ref in _walk_chunks(manifest.task_snapshots):
                refs.setdefault(ref.digest, set()).add(int(m.group(1)))
        return refs

    def _save_refs(self) -> None:
        tmp = self._refs_path + ".part"
        with open(tmp, "wb") as f:
            pickle.dump(self._refs, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, self._refs_path)

    def _release_refs(self, checkpoint_id: int) -> None:
        """Drop one checkpoint's references; delete the chunks no other
        checkpoint references."""
        dead = []
        for digest, ids in self._refs.items():
            ids.discard(checkpoint_id)
            if not ids:
                dead.append(digest)
        for digest in dead:
            del self._refs[digest]
            try:
                os.remove(os.path.join(self.chunk_dir, digest))
            except OSError:
                pass
        self._save_refs()

    # -- paging --------------------------------------------------------------
    def _write_chunk(self, arr: np.ndarray) -> tuple[_ChunkRef, int]:
        """Write one page unless a chunk of its digest exists; returns its
        reference and the bytes written (runs on a worker thread: hashing
        and writing release the interpreter lock)."""
        arr = np.ascontiguousarray(arr)
        raw = arr.reshape(-1).view(np.uint8)
        digest = _chunk_digest(raw, arr.dtype, arr.shape[:-1])
        path = os.path.join(self.chunk_dir, digest)
        written = 0
        if not os.path.exists(path):
            part = f"{path}.{threading.get_ident()}.part"
            with open(part, "wb") as f:
                f.write(raw)
            os.replace(part, path)
            _fault_mutate(path)
            written = arr.nbytes
        return _ChunkRef(digest, arr.nbytes), written

    def _page_tpu_snapshot(self, snap: dict, checkpoint_id: int) -> dict:
        """Cut a canonical device keyed snapshot into key-group pages:
        page boundaries are fixed spans of the key-group space, so a
        page's bytes change only when one of its groups changed. Pages
        are hashed and written by a pool of threads."""
        groups = snap["key_groups"]
        mp = int(snap.get("max_parallelism") or int(groups.max()) + 1)
        span = (mp + N_PAGES - 1) // N_PAGES
        bounds = np.searchsorted(groups, np.arange(1, N_PAGES) * span)
        arrays = [snap["keys"], groups] + [np.asarray(sd["values"])
                                           for sd in snap["states"].values()]
        pages = [np.split(a, bounds, axis=-1) for a in arrays]
        with ThreadPoolExecutor(min(len(arrays) * N_PAGES,
                                    os.cpu_count() or 1)) as pool:
            done = list(pool.map(self._write_chunk,
                                 [p for ps in pages for p in ps]))
        paged = []
        for i, a in enumerate(arrays):
            refs = [ref for ref, _w in done[i * N_PAGES:(i + 1) * N_PAGES]]
            paged.append(_PagedState(tuple(refs), a.dtype.str,
                                     tuple(a.shape[:-1])))
        for ref, written in done:
            self._refs.setdefault(ref.digest, set()).add(checkpoint_id)
            self.last_bytes_written += written
        out = dict(snap)
        out["keys"], out["key_groups"] = paged[0], paged[1]
        out["states"] = {name: {**sdata, "values": pv} for (name, sdata), pv
                         in zip(snap["states"].items(), paged[2:])}
        return out

    # -- storage API ---------------------------------------------------------
    def _path(self, checkpoint: CompletedCheckpoint) -> str:
        kind = "sp" if checkpoint.is_savepoint else "chk"
        return os.path.join(self.directory,
                            f"{kind}-{checkpoint.checkpoint_id}")

    def store(self, checkpoint: CompletedCheckpoint) -> CompletedCheckpoint:
        return _bounded_io("checkpoint.write",
                           lambda: self._store_inner(checkpoint))

    def _store_inner(self, checkpoint: CompletedCheckpoint
                     ) -> CompletedCheckpoint:
        final = self._path(checkpoint)
        tmp = final + ".inprogress"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        self.last_bytes_written = 0
        cid = checkpoint.checkpoint_id
        paged = self.incremental and not checkpoint.is_savepoint
        count = [0]

        def encode(obj):
            if isinstance(obj, np.ndarray):
                arr = np.ascontiguousarray(obj)
                name = f"a{count[0]}.bin"
                count[0] += 1
                view = arr.reshape(-1).view(np.uint8)
                with open(os.path.join(tmp, name), "wb") as f:
                    f.write(view)
                _fault_mutate(os.path.join(tmp, name))
                self.last_bytes_written += arr.nbytes
                return _ArrayRef(name, arr.dtype.str, arr.shape, arr.nbytes,
                                 _digest(view))
            if isinstance(obj, dict):
                if paged and obj.get("kind") == "tpu" and _pageable(obj):
                    return self._page_tpu_snapshot(obj, cid)
                return {k: encode(v) for k, v in obj.items()}
            if isinstance(obj, list):
                return [encode(v) for v in obj]
            if isinstance(obj, tuple):
                return tuple(encode(v) for v in obj)
            return obj

        manifest = CompletedCheckpoint(
            cid, checkpoint.timestamp, encode(checkpoint.task_snapshots),
            checkpoint.is_savepoint, final,
            dict(checkpoint.vertex_parallelism),
            dict(checkpoint.vertex_uids))
        data = pickle.dumps(manifest, protocol=pickle.HIGHEST_PROTOCOL)
        with open(os.path.join(tmp, _MANIFEST), "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        self.last_bytes_written += len(data)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        if paged:
            # refs persist once the checkpoint exists: a crash before
            # leaves orphan chunks, never references that pin chunks
            self._save_refs()
        checkpoint.external_path = final
        return checkpoint

    def discard(self, checkpoint: CompletedCheckpoint) -> None:
        if checkpoint.is_savepoint:
            return   # savepoints belong to the user
        shutil.rmtree(checkpoint.external_path or self._path(checkpoint),
                      ignore_errors=True)
        self._release_refs(checkpoint.checkpoint_id)

    def load(self, path: str) -> CompletedCheckpoint:
        return load_checkpoint(path)

    def quarantine(self, checkpoint: CompletedCheckpoint) -> None:
        """Move a checkpoint that failed verification aside to
        ``<dir>.corrupt`` and drop its chunk references."""
        path = checkpoint.external_path or self._path(checkpoint)
        shutil.rmtree(path + ".corrupt", ignore_errors=True)
        if os.path.isdir(path):
            os.replace(path, path + ".corrupt")
        self._release_refs(checkpoint.checkpoint_id)


def _walk_chunks(obj):
    if isinstance(obj, _PagedState):
        yield from obj.pages
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _walk_chunks(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _walk_chunks(v)


def load_checkpoint(path: str) -> CompletedCheckpoint:
    """The checkpoint stored at ``path`` (a ``chk-<id>`` or ``sp-<id>``
    directory), every array read back and its digest checked; pages come
    from the ``chunks`` directory beside it. Site ``checkpoint.load``."""
    return _bounded_io("checkpoint.load", lambda: _load(path))


def verify_checkpoint(path: str) -> None:
    """Read every array of the checkpoint at ``path`` back and check its
    digest; raises CorruptArtifactError on the first that fails."""
    _load(path)


def _load(path: str) -> CompletedCheckpoint:
    path = path.rstrip("/")
    try:
        with open(os.path.join(path, _MANIFEST), "rb") as f:
            manifest = pickle.load(f)
    except (OSError, pickle.UnpicklingError, EOFError) as e:
        raise CorruptArtifactError(
            f"checkpoint manifest at {path} is unreadable: {e}") from e
    chunk_dir = os.path.join(os.path.dirname(os.path.abspath(path)), _CHUNKS)

    def read(file: str, nbytes: int) -> bytes:
        try:
            with open(file, "rb") as f:
                data = f.read()
        except FileNotFoundError as e:
            raise CorruptArtifactError(f"{file} is missing") from e
        if len(data) != nbytes:
            raise CorruptArtifactError(
                f"{file}: {len(data)} bytes where {nbytes} were written")
        return data

    def decode(obj):
        if isinstance(obj, _ArrayRef):
            data = read(os.path.join(path, obj.file), obj.nbytes)
            if _digest(data) != obj.digest:
                raise CorruptArtifactError(
                    f"{path}/{obj.file}: payload differs from the "
                    "manifest's size or digest")
            return np.frombuffer(data, dtype=np.dtype(obj.dtype)) \
                .reshape(obj.shape).copy()
        if isinstance(obj, _PagedState):
            dtype = np.dtype(obj.dtype)
            parts = []
            for ref in obj.pages:
                data = read(os.path.join(chunk_dir, ref.digest), ref.nbytes)
                if _chunk_digest(data, dtype, obj.lead_shape) != ref.digest:
                    raise CorruptArtifactError(
                        f"chunk {ref.digest} failed its content digest")
                parts.append(np.frombuffer(data, dtype=dtype).reshape(
                    *obj.lead_shape, -1))
            return np.ascontiguousarray(np.concatenate(parts, axis=-1))
        if isinstance(obj, dict):
            return {k: decode(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [decode(v) for v in obj]
        if isinstance(obj, tuple):
            return tuple(decode(v) for v in obj)
        return obj

    manifest.task_snapshots = decode(manifest.task_snapshots)
    manifest.external_path = path
    return manifest
