"""Serializer registry and the columnar batch codec (port of
``flink_tpu/core/serializers.py``).

``registry`` names each serializer of host state; a heap snapshot records
the (name, version) of the one that wrote each state, and a restore that
meets an older version runs the registered value migrations in order
(v1 -> v2 -> v3). ``serialize_batch`` / ``deserialize_batch`` are the
binary batch format: numeric columns as raw little-endian buffers, object
columns pickled, behind a pickled header that carries the schema. Its
bytes equal the reference's for the same batch.
"""

from __future__ import annotations

import io
import pickle
import struct
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

from .records import RecordBatch, Schema

__all__ = ["Serializer", "PickleSerializer", "SerializerSnapshot",
           "serialize_batch", "deserialize_batch", "registry"]

_MAGIC = b"FTB1"  # batch format v1


class Serializer:
    name = "base"
    version = 1

    def serialize(self, obj: Any) -> bytes:
        raise NotImplementedError

    def deserialize(self, data: bytes) -> Any:
        raise NotImplementedError

    def snapshot(self) -> "SerializerSnapshot":
        return SerializerSnapshot(self.name, self.version)


@dataclass(frozen=True)
class SerializerSnapshot:
    """A serializer's identity as written beside its state: a restore
    accepts the same name at the same or an older version."""

    name: str
    version: int

    def is_compatible(self, current: Serializer) -> bool:
        return self.name == current.name and self.version <= current.version


class PickleSerializer(Serializer):
    """The default serializer."""

    name = "pickle"

    def serialize(self, obj: Any) -> bytes:
        return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)

    def deserialize(self, data: bytes) -> Any:
        return pickle.loads(data)


class _Registry:
    def __init__(self):
        self._by_name: dict[str, Serializer] = {}
        # (serializer name, from_version) -> value migration to from + 1
        self._migrations: dict[tuple[str, int], Callable[[Any], Any]] = {}
        self.register(PickleSerializer())

    def register(self, serializer: Serializer) -> None:
        self._by_name[serializer.name] = serializer

    def get(self, name: str) -> Serializer:
        return self._by_name[name]

    def default(self) -> Serializer:
        return self._by_name["pickle"]

    def register_migration(self, name: str, from_version: int,
                           fn: Callable[[Any], Any]) -> None:
        """A value migration of serializer ``name`` from ``from_version``
        to ``from_version + 1``; longer upgrades chain."""
        self._migrations[(name, int(from_version))] = fn

    def has_migration_path(self, name: str, from_version: int,
                           to_version: int) -> bool:
        return all((name, v) in self._migrations
                   for v in range(from_version, to_version))

    def migrate_value(self, name: str, from_version: int, to_version: int,
                      value: Any) -> Any:
        for v in range(from_version, to_version):
            value = self._migrations[(name, v)](value)
        return value


registry = _Registry()


def serialize_batch(batch: RecordBatch) -> bytes:
    """The batch as bytes: magic, a pickled header (row count and each
    field's name and dtype), the timestamps, then each column."""
    buf = io.BytesIO()
    buf.write(_MAGIC)
    header = {"n": batch.n,
              "fields": [(f.name, np.dtype(f.dtype).str if f.is_numeric
                          else "object") for f in batch.schema.fields]}
    hbytes = pickle.dumps(header, protocol=pickle.HIGHEST_PROTOCOL)
    buf.write(struct.pack("<I", len(hbytes)))
    buf.write(hbytes)
    buf.write(batch.timestamps.astype("<i8").tobytes())
    for f in batch.schema.fields:
        col = batch.columns[f.name]
        if f.is_numeric:
            buf.write(col.astype(np.dtype(f.dtype).newbyteorder("<"))
                      .tobytes())
        else:
            payload = pickle.dumps(col.tolist(),
                                   protocol=pickle.HIGHEST_PROTOCOL)
            buf.write(struct.pack("<I", len(payload)))
            buf.write(payload)
    return buf.getvalue()


def deserialize_batch(data: bytes) -> RecordBatch:
    buf = io.BytesIO(data)
    if buf.read(4) != _MAGIC:
        raise ValueError("Bad batch magic")
    (hlen,) = struct.unpack("<I", buf.read(4))
    header = pickle.loads(buf.read(hlen))
    n = header["n"]
    ts = np.frombuffer(buf.read(8 * n), dtype="<i8").astype(np.int64)
    cols: dict[str, np.ndarray] = {}
    fields = []
    for name, dtype_str in header["fields"]:
        if dtype_str == "object":
            (plen,) = struct.unpack("<I", buf.read(4))
            cols[name] = np.array(pickle.loads(buf.read(plen)), dtype=object)
            fields.append((name, object))
        else:
            dt = np.dtype(dtype_str)
            cols[name] = np.frombuffer(buf.read(dt.itemsize * n),
                                       dtype=dt).astype(dt.newbyteorder("="))
            fields.append((name, dt.type))
    return RecordBatch(Schema(fields), cols, ts)
