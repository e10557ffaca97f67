"""Socket text source (port of ``flink_tpu/connectors/socket.py``):
unbounded newline-delimited text over TCP, with a bounded number of
reconnect tries. One split reads (the reference's socket source is of
parallelism 1); every other subtask gets an idle split. The input ends
when the peer closes the connection or the tries run out.
"""

from __future__ import annotations

import socket
import time
from typing import Optional

import numpy as np

from ..core.records import RecordBatch, Schema
from .core import Source, SourceReader, SourceSplit

__all__ = ["SocketSource"]


class SocketSource(Source):
    bounded = False

    def __init__(self, host: str, port: int,
                 schema: Optional[Schema] = None,
                 max_retries: int = 3, retry_delay: float = 0.5):
        self._host = host
        self._port = port
        self.schema = schema or Schema([("line", object)])
        self._max_retries = max_retries
        self._retry_delay = retry_delay

    def create_splits(self, parallelism: int) -> list[SourceSplit]:
        return [SourceSplit(f"socket-{i}", i == 0)
                for i in range(parallelism)]

    def create_reader(self, split: SourceSplit,
                      device=None) -> SourceReader:
        if not split.payload:
            return _IdleReader(self.schema)
        return _SocketReader(self._host, self._port, self.schema,
                             self._max_retries, self._retry_delay)


class _IdleReader(SourceReader):
    """A subtask other than the first idles."""

    def __init__(self, schema: Schema):
        self._schema = schema

    def read_batch(self, max_records: int) -> Optional[RecordBatch]:
        return RecordBatch.empty(self._schema)


class _SocketReader(SourceReader):
    def __init__(self, host: str, port: int, schema: Schema,
                 max_retries: int, retry_delay: float):
        self._host = host
        self._port = port
        self._schema = schema
        self._max_retries = max_retries
        self._retry_delay = retry_delay
        self._sock: Optional[socket.socket] = None
        self._buf = b""
        self._overflow: list[str] = []  # decoded lines past max_records
        self._retries = 0
        self._eof = False

    def _connect(self) -> bool:
        try:
            self._sock = socket.create_connection(
                (self._host, self._port), timeout=1.0)
            self._sock.setblocking(False)
            self._retries = 0
            return True
        except OSError:
            self._sock = None
            self._retries += 1
            if self._retries > self._max_retries:
                self._eof = True
            else:
                time.sleep(self._retry_delay)
            return False

    def read_batch(self, max_records: int) -> Optional[RecordBatch]:
        if self._eof and not self._buf and not self._overflow:
            return None
        if self._sock is None and not self._eof:
            if not self._connect():
                return RecordBatch.empty(self._schema)
        data = b""
        if self._sock is not None:
            try:
                data = self._sock.recv(1 << 16)
                if data == b"":            # an orderly close
                    self._sock.close()
                    self._sock = None
                    self._eof = True
            except BlockingIOError:
                pass
            except OSError:
                self._sock = None          # reconnect at the next call
        self._buf += data
        rows = self._overflow
        self._overflow = []
        if b"\n" in self._buf or (self._eof and self._buf):
            *lines, self._buf = self._buf.split(b"\n")
            if self._eof and self._buf:
                lines.append(self._buf)
                self._buf = b""
            rows += [ln.decode("utf-8", "replace") for ln in lines if ln]
        if not rows:
            return RecordBatch.empty(self._schema)
        if max_records and len(rows) > max_records:
            rows, self._overflow = rows[:max_records], rows[max_records:]
        return RecordBatch(self._schema, {self._schema.fields[0].name:
                                          np.array(rows, dtype=object)})

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
