"""File source and sink with exactly-once commit over the FileSystem SPI
(port of ``flink_tpu/connectors/file.py``).

* ``FileSource``: one split a file (files dealt round-robin over the
  subtasks) from a path, a directory, a glob or a scheme glob
  (``mem://dir/*.csv``), through any text, binary or whole-file
  ``Format``. A reader's snapshot is ``{"file": index, "pos": offset}``:
  the byte offset of the next line (text), of the first byte not yet
  decoded (binary) or the next row group (whole-file formats).
* ``FileSink``: records append to a hidden ``.part-*.inprogress`` file;
  each checkpoint stages it as pending (``prepare_commit``) and the
  checkpoint's completion renames the pending files into visible part
  files (``commit``). Files left in progress by a failed attempt are
  ignored by readers and removed when the subtask writes again.

Paths resolve through ``core/fs.py``, so ``mem://`` paths work wherever
local ones do, SQL filesystem tables included.

Kept difference from the reference's binary reader, which reads 1 MiB at
a time, skips the rest of a file when no whole frame fits in that, and
snapshots the offset past the bytes it holds undecoded: here a read goes
on until at least one frame decodes or the file ends (a truncated tail
raises, naming the file and the offset), and ``pos`` is the offset of the
first byte not yet decoded, so a restore taken mid-frame resumes exactly.
A length-prefixed format (``framed``: binary, columnar, avro) is read a
frame a batch from its prefix; the reference's batch is every whole frame
of its 1 MiB read.
"""

from __future__ import annotations

import fnmatch
import glob as _glob
import io
import os
import struct
import time
from typing import Any, Optional

from ..core.fs import get_file_system
from ..core.records import RecordBatch
from ..formats.core import Format
from .core import Sink, SinkWriter, Source, SourceReader, SourceSplit

__all__ = ["FileSource", "FileSink"]

#: bytes of the first read of a binary file of a format without a length
#: prefix; a read that finds no whole frame doubles until one fits or the
#: file ends
_READ_BYTES = 1 << 20
_FRAME = struct.Struct("<I")  # a framed format's length prefix


def _join(base: str, name: str) -> str:
    return base.rstrip("/") + "/" + name


class FileSource(Source):
    """Bounded source over a file path, directory or glob."""

    bounded = True

    def __init__(self, path: str, fmt: Format, batch_lines: int = 4096):
        self._path = path
        self._fmt = fmt
        self.schema = fmt.schema
        self._batch_lines = batch_lines

    def _files(self) -> list[str]:
        fs, p = get_file_system(self._path)
        if fs.is_dir(p):
            return [_join(self._path, n) for n in fs.listdir(p)
                    if not n.startswith(".")
                    and not n.endswith(".inprogress")
                    and not fs.is_dir(_join(p, n))]
        if "://" not in self._path:
            matches = sorted(_glob.glob(self._path))
            if matches:
                return matches
        elif fs.exists(p) and not any(c in p for c in "*?["):
            return [self._path]
        else:
            # a scheme glob: the last segment against the parent's listing
            # (object stores have no glob of their own)
            parent, _, pattern = p.rpartition("/")
            scheme = self._path.split("://", 1)[0]
            if parent and fs.is_dir(parent):
                matches = sorted(
                    f"{scheme}://{parent}/{n}" for n in fs.listdir(parent)
                    if fnmatch.fnmatch(n, pattern)
                    and not fs.is_dir(_join(parent, n)))
                if matches:
                    return matches
        raise FileNotFoundError(self._path)

    def create_splits(self, parallelism: int) -> list[SourceSplit]:
        files = self._files()
        return [SourceSplit(f"files-{i}", files[i::parallelism])
                for i in range(parallelism)]

    def create_reader(self, split: SourceSplit,
                      device=None) -> SourceReader:
        return _FileReader(self._fmt, split.payload, self._batch_lines)


class _FileReader(SourceReader):
    """Reads its split's files in order. ``stats``: the reading thread's
    CPU seconds in file reads (``read_s``) and in the format's decode
    (``decode_s``), and the bytes read."""

    def __init__(self, fmt: Format, files: list, batch_lines: int):
        self._fmt = fmt
        self._files = list(files)
        self._batch = batch_lines
        self._file_idx = 0
        self._pos = 0
        self._pending = b""   # bytes read from _pos on but not decoded
        self._want = _READ_BYTES
        self.stats = {"read_s": 0.0, "decode_s": 0.0, "bytes": 0}

    def read_batch(self, max_records: int) -> Optional[RecordBatch]:
        while self._file_idx < len(self._files):
            path = self._files[self._file_idx]
            if getattr(self._fmt, "whole_file", False):
                batch = self._read_whole_file(path)
            elif self._fmt.binary:
                batch = self._read_binary(path)
            else:
                batch = self._read_text(path)
            if batch is not None:
                return batch
            self._file_idx += 1
            self._pos = 0
            self._pending = b""
        return None

    def _read_whole_file(self, path: str) -> Optional[RecordBatch]:
        """Whole-file formats (parquet): the position is a row-group
        index."""
        fs, p = get_file_system(path)
        with fs.open_read(p) as f:
            batches, nxt, _eof = self._fmt.read_row_groups(f, self._pos,
                                                           max_groups=1)
        self._pos = nxt
        return RecordBatch.concat(batches) if batches else None

    def _read_text(self, path: str) -> Optional[RecordBatch]:
        """By byte offset (seek, then readline), so a resume and a batch
        cost the batch, not the file."""
        at_start = self._pos == 0
        fs, p = get_file_system(path)
        t0 = time.thread_time()
        with fs.open_read(p) as f:
            f.seek(self._pos)
            lines = []
            for _ in range(self._batch):
                ln = f.readline()
                if not ln:
                    break
                lines.append(ln.decode("utf-8").rstrip("\n"))
            self.stats["bytes"] += f.tell() - self._pos
            self._pos = f.tell()
        t1 = time.thread_time()
        self.stats["read_s"] += t1 - t0
        if not lines:
            return None
        if at_start and getattr(self._fmt, "skip_header", False):
            lines = lines[1:]
        batch = self._fmt.decode_lines(lines)
        self.stats["decode_s"] += time.thread_time() - t1
        return batch

    def _read_binary(self, path: str) -> Optional[RecordBatch]:
        """A frame a batch for length-prefixed formats (``framed``), else
        the whole frames of a chunk that grows until one fits."""
        fs, p = get_file_system(path)
        with fs.open_read(p) as f:
            if getattr(self._fmt, "framed", False):
                return self._read_frame(path, f)
            return self._read_chunk(path, f)

    def _truncated(self, path: str, tail: int) -> ValueError:
        return ValueError(f"{path}: truncated frame at byte {self._pos} "
                          f"({tail} bytes to the end of the file hold no "
                          "whole frame)")

    def _read_frame(self, path: str, f) -> Optional[RecordBatch]:
        """The next frame with rows (a predicate may skip frames): its
        ``uint32`` length, then its body."""
        while True:
            t0 = time.thread_time()
            f.seek(self._pos)
            head = f.read(_FRAME.size)
            body = b""
            if len(head) == _FRAME.size:
                body = f.read(_FRAME.unpack(head)[0])
            t1 = time.thread_time()
            self.stats["read_s"] += t1 - t0
            self.stats["bytes"] += len(head) + len(body)
            if not head:
                return None
            if len(head) < _FRAME.size or \
                    len(body) < _FRAME.unpack(head)[0]:
                raise self._truncated(path, len(head) + len(body))
            batches, _rest = self._fmt.decode_block(head + body)
            self.stats["decode_s"] += time.thread_time() - t1
            self._pos += len(head) + len(body)
            if batches:
                return batches[0]

    def _read_chunk(self, path: str, f) -> Optional[RecordBatch]:
        data = self._pending
        f.seek(self._pos + len(data))
        while True:
            t0 = time.thread_time()
            chunk = f.read(self._want)
            t1 = time.thread_time()
            eof = len(chunk) < self._want
            data += chunk
            batches, rest = self._fmt.decode_block(data)
            self.stats["read_s"] += t1 - t0
            self.stats["decode_s"] += time.thread_time() - t1
            self.stats["bytes"] += len(chunk)
            consumed = len(data) - len(rest)
            self._pos += consumed
            data = rest
            if batches or eof:
                break
            if not consumed:
                # no whole frame yet: read on, twice as much a time, so a
                # frame of any size costs linear copies
                self._want = max(self._want, len(data))
        self._pending = data
        if batches:
            return RecordBatch.concat(batches)
        if data:
            raise self._truncated(path, len(data))
        return None

    def snapshot(self) -> Any:
        return {"file": self._file_idx, "pos": self._pos}

    def restore(self, state: Any) -> None:
        self._file_idx = int(state["file"])
        self._pos = int(state["pos"])
        self._pending = b""


class FileSink(Sink):
    """Exactly-once rolling file sink: a part file rolls at
    ``rolling_size`` bytes and at every checkpoint."""

    def __init__(self, directory: str, fmt: Format,
                 rolling_size: int = 64 << 20, part_prefix: str = "part"):
        self._dir = directory
        self._fmt = fmt
        self._rolling_size = rolling_size
        self._prefix = part_prefix

    def create_writer(self, subtask_index: int) -> SinkWriter:
        fs, p = get_file_system(self._dir)
        fs.makedirs(p)
        return _FileWriter(self._dir, self._fmt, subtask_index,
                           self._rolling_size, self._prefix)


class _FileWriter(SinkWriter):
    def __init__(self, directory: str, fmt: Format, subtask: int,
                 rolling_size: int, prefix: str):
        self._fs, self._dir_path = get_file_system(directory)
        self._fmt = fmt
        self._subtask = subtask
        self._rolling = rolling_size
        self._prefix = prefix
        self._seq = 0
        self._fh = None
        self._session = None
        self._in_progress: Optional[str] = None
        self._final: Optional[str] = None
        # checkpoint id (-1: rolled by size, not staged yet) ->
        # [(in-progress path, final path)], paths without the scheme
        self._pending: dict[int, list[tuple[str, str]]] = {}
        self._cleaned = False

    def _clean_stale(self) -> None:
        """Remove this subtask's in-progress files of a failed attempt.
        Runs at the first write, after ``restore`` committed the restored
        pending files, and spares any file still pending."""
        self._cleaned = True
        keep = {tmp for entries in self._pending.values()
                for tmp, _ in entries}
        pat = f".{self._prefix}-{self._subtask}-*.inprogress"
        try:
            names = self._fs.listdir(self._dir_path)
        except OSError:
            return
        for name in names:
            stale = _join(self._dir_path, name)
            if fnmatch.fnmatch(name, pat) and stale not in keep:
                try:
                    self._fs.remove(stale)
                except OSError:
                    pass

    def _open(self) -> None:
        if not self._cleaned:
            self._clean_stale()
        final = f"{self._prefix}-{self._subtask}-{self._seq}"
        self._in_progress = _join(self._dir_path, f".{final}.inprogress")
        self._final = _join(self._dir_path, final)
        self._fh = self._fs.open_write(self._in_progress, append=True)
        self._seq += 1
        if getattr(self._fmt, "whole_file", False):
            self._session = self._fmt.open_writer(self._fh)

    def write_batch(self, batch: RecordBatch) -> None:
        if batch.n == 0:
            return
        if self._fh is None:
            self._open()
        if self._session is not None:
            self._session.write(batch)
        elif self._fmt.binary:
            self._fh.write(self._fmt.encode_block(batch))
        else:
            self._fh.write(self._fmt.encode_batch(batch).encode("utf-8"))
        if self._fh.tell() >= self._rolling:
            self._roll_pending_file(checkpoint_id=None)

    def _roll_pending_file(self, checkpoint_id: Optional[int]) -> None:
        """Close the in-progress file; it commits with the next
        checkpoint (a roll by size stages under -1 until then)."""
        if self._fh is None:
            return
        if self._session is not None:
            self._session.close()        # the parquet footer, before rename
            self._session = None
        self._fh.close()
        self._pending.setdefault(-1 if checkpoint_id is None
                                 else checkpoint_id, []).append(
            (self._in_progress, self._final))
        self._fh = None
        self._in_progress = None

    def flush(self) -> None:
        if self._fh is not None:
            self._fh.flush()
            try:
                os.fsync(self._fh.fileno())
            except io.UnsupportedOperation:
                pass  # a memory stream has no descriptor to sync; a real
                # fsync failure (EIO) still fails the checkpoint

    def prepare_commit(self, checkpoint_id: int) -> None:
        self._roll_pending_file(checkpoint_id)
        # files rolled by size ride along with this checkpoint
        rolled = self._pending.pop(-1, [])
        if rolled:
            self._pending.setdefault(checkpoint_id, []).extend(rolled)

    def commit(self, checkpoint_id: int) -> None:
        # -1 holds files rolled by size since the last prepare_commit:
        # they hold records after the barrier and must not commit yet
        for cid in sorted(k for k in self._pending
                          if 0 <= k <= checkpoint_id):
            for tmp, final in self._pending.pop(cid):
                if self._fs.exists(tmp):  # a redelivered commit: no-op
                    self._fs.rename(tmp, final)

    def snapshot(self) -> Any:
        return {"seq": self._seq,
                "pending": {cid: list(v)
                            for cid, v in self._pending.items()}}

    def restore(self, state: Any) -> None:
        self._seq = int(state["seq"])
        # the snapshot's pending files commit now: their checkpoint
        # completed, since the job restores from it
        for entries in state.get("pending", {}).values():
            for tmp, final in entries:
                if self._fs.exists(tmp):
                    self._fs.rename(tmp, final)

    def close(self) -> None:
        if self._session is not None:
            self._session.close()
            self._session = None
        if self._fh is not None:
            self._fh.close()
            self._fh = None
