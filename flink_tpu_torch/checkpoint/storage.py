"""Checkpoint storage: where completed snapshots live (trimmed port of
``flink_tpu/checkpoint/storage.py``).

* ``MemoryCheckpointStorage`` keeps them in a dict.
* ``FsCheckpointStorage`` writes one full checkpoint per directory,
  ``<dir>/chk-<id>/``: every numpy array of the task snapshots as a raw
  file (``a<k>.bin``), and a pickled manifest (``_manifest.pkl``) holding
  the checkpoint with each array replaced by a reference (file, dtype,
  shape, byte count, blake2b digest of the payload). A checkpoint is
  written into a temporary directory and renamed into place, so a
  directory that exists is complete; ``load`` recomputes every digest and
  raises ``CorruptArtifactError`` on a mismatch. No chunk deduplication
  or compression: the on-disk format is the port's own.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import shutil
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

__all__ = ["CompletedCheckpoint", "CheckpointStorage",
           "MemoryCheckpointStorage", "FsCheckpointStorage",
           "CorruptArtifactError", "load_checkpoint", "snapshot_nbytes"]

_MANIFEST = "_manifest.pkl"


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
        self._store[checkpoint.checkpoint_id] = checkpoint
        return checkpoint

    def discard(self, checkpoint: CompletedCheckpoint) -> None:
        self._store.pop(checkpoint.checkpoint_id, None)

    def load(self, checkpoint_id: int) -> CompletedCheckpoint:
        return self._store[checkpoint_id]


@dataclass(frozen=True)
class _ArrayRef:
    file: str
    dtype: str
    shape: tuple
    nbytes: int
    digest: str


def _digest(data) -> str:
    return hashlib.blake2b(data, digest_size=16).hexdigest()


class FsCheckpointStorage(CheckpointStorage):
    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, checkpoint: CompletedCheckpoint) -> str:
        kind = "sp" if checkpoint.is_savepoint else "chk"
        return os.path.join(self.directory,
                            f"{kind}-{checkpoint.checkpoint_id}")

    def store(self, checkpoint: CompletedCheckpoint) -> CompletedCheckpoint:
        final = self._path(checkpoint)
        tmp = final + ".inprogress"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        count = [0]

        def encode(obj):
            if isinstance(obj, np.ndarray):
                arr = np.ascontiguousarray(obj)
                name = f"a{count[0]}.bin"
                count[0] += 1
                view = arr.reshape(-1).view(np.uint8)
                with open(os.path.join(tmp, name), "wb") as f:
                    f.write(view)
                return _ArrayRef(name, arr.dtype.str, arr.shape, arr.nbytes,
                                 _digest(view))
            if isinstance(obj, dict):
                return {k: encode(v) for k, v in obj.items()}
            if isinstance(obj, list):
                return [encode(v) for v in obj]
            if isinstance(obj, tuple):
                return tuple(encode(v) for v in obj)
            return obj

        manifest = CompletedCheckpoint(
            checkpoint.checkpoint_id, checkpoint.timestamp,
            encode(checkpoint.task_snapshots), checkpoint.is_savepoint,
            final, dict(checkpoint.vertex_parallelism),
            dict(checkpoint.vertex_uids))
        with open(os.path.join(tmp, _MANIFEST), "wb") as f:
            pickle.dump(manifest, f, protocol=pickle.HIGHEST_PROTOCOL)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        checkpoint.external_path = final
        return checkpoint

    def discard(self, checkpoint: CompletedCheckpoint) -> None:
        if checkpoint.external_path and not checkpoint.is_savepoint:
            shutil.rmtree(checkpoint.external_path, ignore_errors=True)

    def load(self, path: str) -> CompletedCheckpoint:
        return load_checkpoint(path)


def load_checkpoint(path: str) -> CompletedCheckpoint:
    """The checkpoint stored at ``path`` (a ``chk-<id>`` directory),
    every array read back and its digest checked."""
    try:
        with open(os.path.join(path, _MANIFEST), "rb") as f:
            manifest = pickle.load(f)
    except (OSError, pickle.UnpicklingError, EOFError) as e:
        raise CorruptArtifactError(
            f"checkpoint manifest at {path} is unreadable: {e}") from e

    def decode(obj):
        if isinstance(obj, _ArrayRef):
            with open(os.path.join(path, obj.file), "rb") as f:
                data = f.read()
            if len(data) != obj.nbytes or _digest(data) != obj.digest:
                raise CorruptArtifactError(
                    f"{path}/{obj.file}: payload differs from the "
                    "manifest's size or digest")
            return np.frombuffer(data, dtype=np.dtype(obj.dtype)) \
                .reshape(obj.shape).copy()
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
