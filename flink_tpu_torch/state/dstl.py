"""The durable short-term log of the changelog backend (port of
``flink_tpu/state/dstl.py``).

A checkpoint of the changelog backend ships a handle to its materialized
base and handles to the log segments past it, so the bytes it writes are
in proportion to the change rate, while the base is written once per
materialization and shared by handle by every checkpoint in between.

* Every change record gets an increasing ``seq``.
* The writer buffers records and writes a segment (an immutable blob of
  the records [from_seq, to_seq]) when its buffer passes ``flush_bytes``
  or a checkpoint persists it: batched uploads keep small files off the
  store.
* ``persist(base_seq)`` returns the handles of every live segment past the
  materialization point; ``detach(base_seq)`` hands the covered ones to
  the caller, which owns their deletion (a retained checkpoint may still
  reference them).
* A segment handle carries a blake2b digest of its stored bytes; a read
  that fails it raises ``CorruptArtifactError``.

Two drivers: files under a directory (``FsChangelogStorage``: segment and
base names relative to it, so a checkpoint directory can move) and a
process-global table (``InMemoryChangelogStorage``).
``changelog_storage_for(config)`` takes ``<execution.checkpointing.dir>/
changelog`` when a checkpoint directory is set, else the table.
"""

from __future__ import annotations

import os
import pickle
import threading
import uuid
from dataclasses import dataclass, field
from typing import Any, Optional

__all__ = ["ChangelogWriter", "FsChangelogStorage", "InMemoryChangelogStorage",
           "SegmentHandle", "changelog_storage_for", "read_any_segment",
           "read_any_base"]


@dataclass(frozen=True)
class SegmentHandle:
    """One immutable stored segment. ``digest`` is a blake2b checksum of
    the stored bytes, checked by readers; empty for the in-memory driver
    and for handles of older snapshots."""

    segment_id: str
    from_seq: int
    to_seq: int
    driver: str                 # "fs" | "mem"
    location: str = ""          # fs: file path; mem: store key
    digest: str = ""            # blake2b-128 hex of the stored payload


def _segment_digest(payload: bytes) -> str:
    import hashlib
    return hashlib.blake2b(payload, digest_size=16).hexdigest()


def _verified_segment_loads(data: bytes, digest: str, what: str) -> list:
    """Unpickle a segment after checking its handle's checksum: a flipped
    or truncated segment raises CorruptArtifactError, never replays
    garbage."""
    from ..checkpoint.storage import CorruptArtifactError

    if digest and _segment_digest(data) != digest:
        raise CorruptArtifactError(
            f"changelog segment {what} failed its checksum "
            "(stored bytes do not match the handle digest)")
    try:
        return pickle.loads(data)
    except Exception as e:  # noqa: BLE001 - truncated/garbled payload
        raise CorruptArtifactError(
            f"changelog segment {what} is undecodable "
            f"({type(e).__name__}: {e})") from e


class _Store:
    def write_segment(self, records: list) -> SegmentHandle:
        raise NotImplementedError

    def read_segment(self, handle: SegmentHandle) -> list:
        raise NotImplementedError

    def delete_segment(self, handle: SegmentHandle) -> None:
        raise NotImplementedError

    def write_base(self, base_id: str, payload: bytes) -> str:
        raise NotImplementedError

    def read_base(self, location: str) -> bytes:
        raise NotImplementedError


class FsChangelogStorage(_Store):
    """Segment and base files under a directory."""

    driver = "fs"

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def _resolve(self, location: str) -> str:
        # handles keep names relative to the directory, so a checkpoint
        # directory restores from where it was moved; absolute locations
        # (older snapshots) resolve as they are
        return (location if os.path.isabs(location)
                else os.path.join(self.dir, location))

    def write_segment(self, records: list) -> SegmentHandle:
        seg_id = uuid.uuid4().hex[:16]
        name = f"seg-{records[0][0]}-{seg_id}"
        path = os.path.join(self.dir, name)
        payload = pickle.dumps(records, protocol=pickle.HIGHEST_PROTOCOL)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)
        return SegmentHandle(seg_id, records[0][0], records[-1][0],
                             "fs", name, digest=_segment_digest(payload))

    def read_segment(self, handle: SegmentHandle) -> list:
        with open(self._resolve(handle.location), "rb") as f:
            data = f.read()
        return _verified_segment_loads(data, handle.digest, handle.location)

    def delete_segment(self, handle: SegmentHandle) -> None:
        try:
            os.unlink(self._resolve(handle.location))
        except OSError:
            pass

    def write_base(self, base_id: str, payload: bytes) -> str:
        name = f"base-{base_id}"
        path = os.path.join(self.dir, name)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)
        return name

    def read_base(self, location: str) -> bytes:
        with open(self._resolve(location), "rb") as f:
            return f.read()

    def delete_base(self, location: str) -> None:
        try:
            os.unlink(self._resolve(location))
        except OSError:
            pass


# the in-memory driver's process-global table (the scope of
# MemoryCheckpointStorage: a restore in the same process)
_MEM: dict[str, Any] = {}
_MEM_LOCK = threading.Lock()


class InMemoryChangelogStorage(_Store):
    driver = "mem"

    def write_segment(self, records: list) -> SegmentHandle:
        key = f"seg-{uuid.uuid4().hex}"
        with _MEM_LOCK:
            _MEM[key] = list(records)
        return SegmentHandle(key, records[0][0], records[-1][0], "mem", key)

    def read_segment(self, handle: SegmentHandle) -> list:
        with _MEM_LOCK:
            return list(_MEM[handle.location])

    def delete_segment(self, handle: SegmentHandle) -> None:
        with _MEM_LOCK:
            _MEM.pop(handle.location, None)

    def write_base(self, base_id: str, payload: bytes) -> str:
        key = f"base-{base_id}"
        with _MEM_LOCK:
            _MEM[key] = payload
        return key

    def read_base(self, location: str) -> bytes:
        with _MEM_LOCK:
            return _MEM[location]

    def delete_base(self, location: str) -> None:
        with _MEM_LOCK:
            _MEM.pop(location, None)


def _resolve_any(location: str, root: Optional[str]) -> str:
    if os.path.isabs(location) or root is None:
        return location
    return os.path.join(root, location)


def read_any_segment(handle_dict: dict, root: Optional[str] = None) -> list:
    """Read a segment from its serialized handle, creating no storage (a
    read-only copy of a checkpoint directory restores). ``root`` resolves
    relative locations against the restoring job's changelog directory;
    absolute ones pass through."""
    h = SegmentHandle(**handle_dict)
    if h.driver == "fs":
        with open(_resolve_any(h.location, root), "rb") as f:
            data = f.read()
        return _verified_segment_loads(data, h.digest, h.location)
    return InMemoryChangelogStorage().read_segment(h)


def read_any_base(driver: str, location: str,
                  root: Optional[str] = None) -> bytes:
    if driver == "fs":
        with open(_resolve_any(location, root), "rb") as f:
            return f.read()
    return InMemoryChangelogStorage().read_base(location)


def changelog_storage_for(config) -> _Store:
    """The checkpoint directory's ``changelog`` folder when a directory is
    configured, else the in-memory table."""
    directory = None
    if config is not None:
        directory = config.get("execution.checkpointing.dir")
    if directory:
        return FsChangelogStorage(os.path.join(directory, "changelog"))
    return InMemoryChangelogStorage()


class ChangelogWriter:
    """A buffered, batching appender: appends gather in memory, and a
    segment is written when the buffer passes ``flush_bytes`` or a
    checkpoint calls ``persist``."""

    def __init__(self, store: _Store, flush_bytes: int = 1 << 20):
        self.store = store
        self.flush_bytes = flush_bytes
        self._buf: list[tuple[int, Any]] = []    # [(seq, record)]
        self._buf_bytes = 0
        self._next_seq = 1
        self._segments: list[SegmentHandle] = []
        self.bytes_uploaded = 0                  # observability
        self.segments_uploaded = 0

    @property
    def last_seq(self) -> int:
        return self._next_seq - 1

    def append(self, record: tuple, nbytes: int) -> int:
        seq = self._next_seq
        self._next_seq += 1
        self._buf.append((seq, record))
        self._buf_bytes += nbytes
        if self._buf_bytes >= self.flush_bytes:
            self.flush()
        return seq

    def flush(self) -> None:
        if not self._buf:
            return
        handle = self.store.write_segment(self._buf)
        self._segments.append(handle)
        self.segments_uploaded += 1
        self.bytes_uploaded += self._buf_bytes
        self._buf = []
        self._buf_bytes = 0

    def persist(self, base_seq: int) -> list[SegmentHandle]:
        """Upload the remainder; return handles for every segment holding
        records past ``base_seq`` (what one checkpoint must reference)."""
        self.flush()
        return [h for h in self._segments if h.to_seq > base_seq]

    def detach(self, base_seq: int) -> list[SegmentHandle]:
        """Take the segments ``base_seq`` covers off the live list without
        deleting them: a retained checkpoint may still reference them, so
        the caller deletes them later."""
        dead = [h for h in self._segments if h.to_seq <= base_seq]
        self._segments = [h for h in self._segments if h.to_seq > base_seq]
        return dead

    def drop_buffered(self) -> None:
        """Drop the buffered records a materialization just covered."""
        self._buf = []
        self._buf_bytes = 0
