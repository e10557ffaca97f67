"""Avro-shaped binary row format with schema evolution (port of
``flink_tpu/formats/avro.py``).

Each block embeds the WRITER schema (per block rather than per file,
because the file sink appends blocks as batches come: the reference's
divergence, kept). The reader resolves it against its own READER schema
by avro's rules: a field in both is decoded and cast to the reader's
dtype, a field only the writer has is decoded and dropped, a field only
the reader has takes the reader's default. Scalars are avro's:
zigzag-varint int64, little-endian double, a byte a bool, length-prefixed
utf-8 strings.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Optional

import numpy as np

from ..core.records import RecordBatch, Schema
from .core import Format

__all__ = ["AvroFormat"]

_FRAME = struct.Struct("<I")
_DOUBLE = struct.Struct("<d")


def _zigzag_encode(v: int) -> bytes:
    u = (v << 1) ^ (v >> 63)
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag_decode(data: bytes, pos: int) -> tuple[int, int]:
    shift = u = 0
    while True:
        b = data[pos]
        pos += 1
        u |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    return (u >> 1) ^ -(u & 1), pos


def _wire_type(dtype) -> str:
    if dtype is object:
        return "string"
    kind = np.dtype(dtype).kind
    if kind == "f":
        return "double"
    if kind == "b":
        return "boolean"
    return "long"


class AvroFormat(Format):
    """``schema`` is the READER schema; ``defaults`` fills the fields the
    writer did not know."""

    binary = True
    framed = True   # a uint32 length before each frame

    def __init__(self, schema: Schema,
                 defaults: Optional[dict[str, Any]] = None):
        self.schema = schema
        self.defaults = dict(defaults or {})

    def encode_block(self, batch: RecordBatch) -> bytes:
        fields = [(f.name, _wire_type(f.dtype)) for f in self.schema.fields]
        header = json.dumps({"fields": fields}).encode()
        out = bytearray(_FRAME.pack(len(header)) + header
                        + _zigzag_encode(batch.n))
        cols = [batch.columns[n] for n, _ in fields]
        for i in range(batch.n):
            for (_name, wt), col in zip(fields, cols):
                v = col[i]
                if wt == "long":
                    out += _zigzag_encode(int(v))
                elif wt == "double":
                    out += _DOUBLE.pack(float(v))
                elif wt == "boolean":
                    out.append(1 if v else 0)
                else:
                    b = ("" if v is None else str(v)).encode("utf-8")
                    out += _zigzag_encode(len(b)) + b
        return _FRAME.pack(len(out)) + bytes(out)

    @staticmethod
    def _decode_value(wt: str, data: bytes, pos: int) -> tuple[Any, int]:
        if wt == "long":
            return _zigzag_decode(data, pos)
        if wt == "double":
            return _DOUBLE.unpack_from(data, pos)[0], pos + _DOUBLE.size
        if wt == "boolean":
            return bool(data[pos]), pos + 1
        ln, pos = _zigzag_decode(data, pos)
        return bytes(data[pos:pos + ln]).decode("utf-8"), pos + ln

    def _default_for(self, f) -> Any:
        if f.name in self.defaults:
            return self.defaults[f.name]
        if f.dtype is object:
            return ""
        return np.dtype(f.dtype).type(0)

    def decode_block(self, data: bytes) -> tuple[list[RecordBatch], bytes]:
        batches = []
        start = 0
        while len(data) - start >= _FRAME.size:
            (ln,) = _FRAME.unpack_from(data, start)
            if len(data) - start < _FRAME.size + ln:
                break
            body = data[start + _FRAME.size:start + _FRAME.size + ln]
            start += _FRAME.size + ln
            (hlen,) = _FRAME.unpack_from(body)
            writer_fields = json.loads(
                body[_FRAME.size:_FRAME.size + hlen])["fields"]
            pos = _FRAME.size + hlen
            n, pos = _zigzag_decode(body, pos)
            rows: dict[str, list] = {f.name: [] for f in self.schema.fields}
            for _ in range(n):
                rec: dict[str, Any] = {}
                for name, wt in writer_fields:
                    rec[name], pos = self._decode_value(wt, body, pos)
                for f in self.schema.fields:
                    rows[f.name].append(rec[f.name] if f.name in rec
                                        else self._default_for(f))
            cols = {f.name: (np.array(rows[f.name], dtype=object)
                             if f.dtype is object
                             else np.asarray(rows[f.name]).astype(f.dtype))
                    for f in self.schema.fields}
            batches.append(RecordBatch(self.schema, cols))
        return batches, data[start:]
