"""Protobuf format: length-delimited messages <-> RecordBatches (port of
``flink_tpu/formats/protobuf.py``).

A row is one message. The message type is a compiled class whose field
names match the schema's columns (``message_cls``), or, by default, one
built from the schema through a descriptor pool (int64 -> int64, float ->
double, bool -> bool, object -> string). Each message is preceded by its
varint length (what ``parseDelimitedFrom`` reads), so the format streams
through the file and socket connectors. Event timestamps ride a reserved
``__ts__`` int64 field when ``write_timestamps`` is on. google.protobuf
is optional: without it the format raises an ``ImportError`` that names
it.
"""

from __future__ import annotations

import numpy as np

from ..core.records import RecordBatch, Schema
from .core import Format

__all__ = ["ProtobufFormat"]

_TS_FIELD = "__ts__"


def _require_protobuf():
    try:
        from google.protobuf import descriptor_pb2, descriptor_pool, \
            message_factory
        return descriptor_pb2, descriptor_pool, message_factory
    except ImportError as e:
        raise ImportError("ProtobufFormat needs google.protobuf (the "
                          "protobuf package); it is not installed in this "
                          "environment") from e


def _dtype_to_pb(dp, dtype) -> int:
    t = dp.FieldDescriptorProto
    if dtype is object:
        return t.TYPE_STRING
    d = np.dtype(dtype)
    if d == np.bool_:
        return t.TYPE_BOOL
    if np.issubdtype(d, np.integer):
        return t.TYPE_INT64
    if np.issubdtype(d, np.floating):
        return t.TYPE_DOUBLE
    raise TypeError(f"no protobuf mapping for column dtype {dtype}")


def _build_message_class(schema: Schema, with_ts: bool):
    """A message type built from the schema (descriptor pool route)."""
    import uuid

    dp, descriptor_pool, message_factory = _require_protobuf()
    fd = dp.FileDescriptorProto()
    fd.name = f"flink_tpu_dyn_{uuid.uuid4().hex}.proto"
    fd.package = "flink_tpu.dyn"
    msg = fd.message_type.add()
    msg.name = "Row"
    specs = [(f.name, _dtype_to_pb(dp, f.dtype)) for f in schema.fields]
    if with_ts:
        specs.append((_TS_FIELD, dp.FieldDescriptorProto.TYPE_INT64))
    for num, (name, pb_type) in enumerate(specs, 1):
        fld = msg.field.add()
        fld.name = name
        fld.number = num
        fld.label = dp.FieldDescriptorProto.LABEL_OPTIONAL
        fld.type = pb_type
    pool = descriptor_pool.DescriptorPool()
    pool.Add(fd)
    desc = pool.FindMessageTypeByName("flink_tpu.dyn.Row")
    return message_factory.GetMessageClass(desc)


def _write_varint(n: int, out: bytearray) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    """(value, new position); raises IndexError past the buffer."""
    result = shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


class ProtobufFormat(Format):
    binary = True

    def __init__(self, schema: Schema, message_cls=None,
                 write_timestamps: bool = True):
        self.schema = schema
        self._write_ts = bool(write_timestamps)
        self._cls = message_cls or _build_message_class(schema,
                                                        self._write_ts)
        names = {f.name for f in self._cls.DESCRIPTOR.fields}
        missing = [f.name for f in schema.fields if f.name not in names]
        if missing:
            raise ValueError(f"message type {self._cls.DESCRIPTOR.full_name}"
                             f" lacks fields for columns {missing}")
        self._has_ts = _TS_FIELD in names

        # how each column decodes: "presence" (a string field that tracks
        # presence: unset -> None, '' stays ''), "legacy" (a plain proto3
        # string: '' -> None, as unset and '' look alike on the wire) or
        # "plain" (every other column)
        def mode(f):
            if f.dtype is not object:
                return "plain"
            fd = self._cls.DESCRIPTOR.fields_by_name[f.name]
            return "presence" if fd.has_presence else "legacy"

        self._decode_modes = [(f.name, mode(f)) for f in schema.fields]

    def encode_block(self, batch: RecordBatch) -> bytes:
        out = bytearray()
        cols = [(f.name, batch.columns[f.name], f.is_numeric,
                 f.is_numeric and np.issubdtype(np.dtype(f.dtype),
                                                np.floating))
                for f in batch.schema.fields]
        ts = batch.timestamps
        for i in range(batch.n):
            m = self._cls()
            for name, col, numeric, floating in cols:
                v = col[i]
                if v is None:
                    continue
                if numeric:
                    setattr(m, name,
                            float(v) if floating else
                            bool(v) if isinstance(v, np.bool_) else int(v))
                else:
                    setattr(m, name, str(v))
            if self._write_ts and self._has_ts:
                setattr(m, _TS_FIELD, int(ts[i]))
            payload = m.SerializeToString()
            _write_varint(len(payload), out)
            out += payload
        return bytes(out)

    def decode_block(self, data: bytes) -> tuple[list[RecordBatch], bytes]:
        rows: list = []
        ts: list[int] = []
        pos = 0
        n = len(data)
        while pos < n:
            try:
                length, body = _read_varint(data, pos)
            except IndexError:
                break                       # a partial varint: carry over
            if body + length > n:
                break                       # a partial message
            m = self._cls()
            m.ParseFromString(bytes(data[body:body + length]))
            pos = body + length
            row = []
            for name, mode in self._decode_modes:
                if mode == "presence" and not m.HasField(name):
                    row.append(None)
                elif mode == "legacy":
                    row.append(getattr(m, name) or None)
                else:
                    row.append(getattr(m, name))
            rows.append(tuple(row))
            ts.append(getattr(m, _TS_FIELD) if self._has_ts else 0)
        if not rows:
            return [], data[pos:]
        return [RecordBatch.from_rows(self.schema, rows, ts)], data[pos:]
