"""Record formats at the source and sink boundaries (port of
``flink_tpu/formats/core.py``).

A ``Format`` decodes a block of lines or bytes into one columnar
``RecordBatch`` and encodes a batch back, so the path stays columnar end
to end. Text formats implement ``decode_lines``/``encode_batch``; binary
ones (``binary = True``) ``decode_block``/``encode_block``, where
``decode_block`` consumes whole frames and returns the bytes left over.

``BinaryFormat`` frames the batch codec of ``core/serializers.py``
behind a little-endian ``uint32`` length, self-describing on read.
"""

from __future__ import annotations

import json
import struct
from typing import Optional

import numpy as np

from ..core.records import RecordBatch, Schema
from ..core.serializers import deserialize_batch, serialize_batch

__all__ = ["Format", "CsvFormat", "JsonFormat", "BinaryFormat"]


class Format:
    """Bidirectional text or binary <-> RecordBatch codec."""

    schema: Schema
    binary: bool = False
    #: binary frames each behind a little-endian uint32 length, so a
    #: reader can take them one at a time
    framed: bool = False

    def decode_lines(self, lines: list[str]) -> RecordBatch:
        raise NotImplementedError

    def encode_batch(self, batch: RecordBatch) -> str:
        """Batch -> text block (newline-terminated)."""
        raise NotImplementedError

    def decode_block(self, data: bytes) -> tuple[list[RecordBatch], bytes]:
        """Consume whole frames from ``data``; return (batches, rest)."""
        raise NotImplementedError

    def encode_block(self, batch: RecordBatch) -> bytes:
        raise NotImplementedError


def _unescape_nl(s: str) -> str:
    """Undo CsvFormat's backslash escaping of newlines."""
    if "\\" not in s:
        return s
    out = []
    i = 0
    while i < len(s):
        if s[i] == "\\" and i + 1 < len(s) and s[i + 1] in "n\\":
            out.append("\n" if s[i + 1] == "n" else "\\")
            i += 2
            continue
        out.append(s[i])
        i += 1
    return "".join(out)


def _parse_column(vals: list[str], dtype) -> np.ndarray:
    if dtype is object:
        return np.array([v if v != "" else None for v in vals], dtype=object)
    if np.issubdtype(np.dtype(dtype), np.bool_):
        return np.array([v.lower() in ("true", "1") for v in vals],
                        dtype=np.bool_)
    # numeric: an empty field is NaN, which an int column refuses loudly
    arr = np.array([v if v != "" else "nan" for v in vals], dtype=object)
    return arr.astype(np.float64).astype(dtype)


class CsvFormat(Format):
    """Delimiter-separated text. A field holding the delimiter or a quote
    is double-quoted on write (a quote doubled inside) and unquoted on
    read; an empty field is a null. Newlines inside a field are
    backslash-escaped (``\\n``) rather than quoted, so every consumer stays
    line-based (the reference's divergence from RFC 4180, kept).
    ``skip_header`` drops the first line of each file: the file reader
    passes ``at_file_start``."""

    def __init__(self, schema: Schema, delimiter: str = ",",
                 skip_header: bool = False):
        self.schema = schema
        self.delimiter = delimiter
        self.skip_header = skip_header

    def _split(self, line: str) -> list[str]:
        d = self.delimiter
        if '"' not in line:
            return [_unescape_nl(s) for s in line.split(d)]
        out, cur, in_q, i = [], [], False, 0
        while i < len(line):
            c = line[i]
            if in_q:
                if c == '"':
                    if i + 1 < len(line) and line[i + 1] == '"':
                        cur.append('"')
                        i += 1
                    else:
                        in_q = False
                else:
                    cur.append(c)
            elif c == '"':
                in_q = True
            elif c == d:
                out.append("".join(cur))
                cur = []
            else:
                cur.append(c)
            i += 1
        out.append("".join(cur))
        return [_unescape_nl(s) for s in out]

    def decode_lines(self, lines: list[str],
                     at_file_start: bool = False) -> RecordBatch:
        if self.skip_header and at_file_start and lines:
            lines = lines[1:]
        rows = [self._split(ln) for ln in lines if ln]
        if not rows:
            return RecordBatch.empty(self.schema)
        cols = {}
        for j, f in enumerate(self.schema.fields):
            vals = [r[j] if j < len(r) else "" for r in rows]
            cols[f.name] = _parse_column(vals, f.dtype)
        return RecordBatch(self.schema, cols)

    def encode_batch(self, batch: RecordBatch) -> str:
        d = self.delimiter
        out = []
        for row in batch.iter_rows():
            if not isinstance(row, tuple):
                row = (row,)
            fields = []
            for v in row:
                s = "" if v is None else str(v)
                if "\\" in s or "\n" in s:
                    s = s.replace("\\", "\\\\").replace("\n", "\\n")
                if d in s or '"' in s:
                    s = '"' + s.replace('"', '""') + '"'
                fields.append(s)
            out.append(d.join(fields))
        return "\n".join(out) + ("\n" if out else "")


class JsonFormat(Format):
    """Newline-delimited JSON objects; a missing or null field is a
    null."""

    def __init__(self, schema: Schema):
        self.schema = schema

    def decode_lines(self, lines: list[str]) -> RecordBatch:
        objs = [json.loads(ln) for ln in lines if ln.strip()]
        if not objs:
            return RecordBatch.empty(self.schema)
        cols = {}
        for f in self.schema.fields:
            vals = [o.get(f.name) for o in objs]
            if f.dtype is object:
                cols[f.name] = np.array(vals, dtype=object)
            else:
                cols[f.name] = np.array(
                    [v if v is not None else np.nan for v in vals]
                ).astype(f.dtype)
        return RecordBatch(self.schema, cols)

    def encode_batch(self, batch: RecordBatch) -> str:
        names = batch.schema.names
        out = []
        for row in batch.iter_rows():
            if not isinstance(row, tuple):
                row = (row,)
            out.append(json.dumps(dict(zip(names, row)),
                                  default=_json_default))
        return "\n".join(out) + ("\n" if out else "")


def _json_default(v):
    if isinstance(v, np.generic):
        return v.item()
    raise TypeError(f"not JSON serializable: {type(v)}")


_FRAME = struct.Struct("<I")  # a frame's length prefix


class BinaryFormat(Format):
    """Length-prefixed frames of the native batch codec."""

    binary = True
    framed = True   # a uint32 length before each frame

    def __init__(self, schema: Optional[Schema] = None):
        self.schema = schema

    def encode_block(self, batch: RecordBatch) -> bytes:
        payload = serialize_batch(batch)
        return _FRAME.pack(len(payload)) + payload

    def decode_block(self, data: bytes) -> tuple[list[RecordBatch], bytes]:
        batches = []
        pos = 0
        while len(data) - pos >= _FRAME.size:
            (ln,) = _FRAME.unpack_from(data, pos)
            if len(data) - pos < _FRAME.size + ln:
                break
            start = pos + _FRAME.size
            batches.append(deserialize_batch(data[start:start + ln]))
            pos = start + ln
        return batches, data[pos:]
