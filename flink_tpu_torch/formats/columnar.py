"""Columnar row-group format, the parquet/orc slot (port of
``flink_tpu/formats/columnar.py``).

Each frame is one row group and stands alone: a JSON header with the
schema, per-column min/max statistics and blob lengths, then one zlib
blob per column (numeric columns as raw little-endian arrays, object
columns as length-prefixed utf-8 runs). The file sink writes frames as
batches come and rolls files by size, which is why there is no trailing
footer (the reference's divergence from parquet, kept). The reader has:

* column pruning: only projected columns are inflated;
* predicate skipping: a group whose [min, max] range misses the
  predicate is skipped on its header alone (``groups_skipped``).

The frame layout is the reference's byte for byte; frames carry no
timestamps (a job assigns them from a column).
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Optional

import numpy as np

from ..core.records import RecordBatch, Schema
from .core import Format

__all__ = ["ColumnarFormat"]

_MAGIC = b"FTC1"
_FRAME = struct.Struct("<I")          # frame length
_HEAD = struct.Struct("<I")           # header length


def _encode_object_column(col: np.ndarray) -> bytes:
    out = bytearray()
    for v in col:
        b = ("" if v is None else str(v)).encode("utf-8")
        out += _FRAME.pack(len(b)) + b
    return bytes(out)


def _decode_object_column(data: bytes, n: int) -> np.ndarray:
    out = np.empty(n, dtype=object)
    pos = 0
    for i in range(n):
        (ln,) = _FRAME.unpack_from(data, pos)
        pos += _FRAME.size
        out[i] = data[pos:pos + ln].decode("utf-8")
        pos += ln
    return out


class ColumnarFormat(Format):
    """``columns`` projects a subset (pruning); ``predicate`` maps a
    column name to an inclusive (lo, hi) range, and a group entirely
    outside any range is skipped by its statistics alone."""

    binary = True
    framed = True   # a uint32 length before each frame

    def __init__(self, schema: Schema, columns: Optional[list[str]] = None,
                 predicate: Optional[dict[str, tuple]] = None,
                 compresslevel: int = 1):
        self.full_schema = schema
        self.columns = list(columns) if columns else None
        if self.columns:
            self.schema = Schema([(f.name, f.dtype) for f in schema.fields
                                  if f.name in self.columns])
        else:
            self.schema = schema
        self.predicate = dict(predicate or {})
        self.compresslevel = compresslevel
        self.groups_read = 0
        self.groups_skipped = 0

    def encode_block(self, batch: RecordBatch) -> bytes:
        cols_meta = []
        blobs = []
        for f in self.full_schema.fields:
            col = batch.columns[f.name]
            if f.dtype is object:
                raw = _encode_object_column(col)
                stats = None
            else:
                arr = np.ascontiguousarray(col)
                raw = arr.tobytes()
                stats = ([arr.min().item(), arr.max().item()]
                         if len(arr) else None)
            blob = zlib.compress(raw, self.compresslevel)
            cols_meta.append({"name": f.name,
                              "dtype": ("object" if f.dtype is object
                                        else np.dtype(f.dtype).name),
                              "comp_len": len(blob), "raw_len": len(raw),
                              "stats": stats})
            blobs.append(blob)
        header = json.dumps({"n": batch.n, "cols": cols_meta}).encode()
        body = _MAGIC + _HEAD.pack(len(header)) + header + b"".join(blobs)
        return _FRAME.pack(len(body)) + body

    def _group_passes(self, meta: dict) -> bool:
        for col in meta["cols"]:
            rng = self.predicate.get(col["name"])
            if rng is None or col["stats"] is None:
                continue
            lo, hi = rng
            cmin, cmax = col["stats"]
            if cmax < lo or cmin > hi:
                return False
        return True

    def decode_block(self, data: bytes) -> tuple[list[RecordBatch], bytes]:
        batches = []
        pos = 0
        while len(data) - pos >= _FRAME.size:
            (ln,) = _FRAME.unpack_from(data, pos)
            if len(data) - pos < _FRAME.size + ln:
                break
            body = pos + _FRAME.size
            pos = body + ln
            if data[body:body + 4] != _MAGIC:
                raise ValueError("columnar: bad group magic "
                                 f"{data[body:body + 4]!r} (corrupt or "
                                 "wrong format)")
            (hlen,) = _HEAD.unpack_from(data, body + 4)
            at = body + 4 + _HEAD.size
            meta = json.loads(data[at:at + hlen])
            at += hlen
            if not self._group_passes(meta):
                self.groups_skipped += 1
                continue                     # header-only skip: no inflate
            self.groups_read += 1
            n = meta["n"]
            cols: dict[str, np.ndarray] = {}
            for cm in meta["cols"]:
                blob = data[at:at + cm["comp_len"]]
                at += cm["comp_len"]
                if self.columns is not None \
                        and cm["name"] not in self.columns:
                    continue                 # pruned: never inflated
                raw = zlib.decompress(blob)
                if cm["dtype"] == "object":
                    cols[cm["name"]] = _decode_object_column(raw, n)
                else:
                    cols[cm["name"]] = np.frombuffer(
                        raw, dtype=np.dtype(cm["dtype"])).copy()
            batches.append(RecordBatch(self.schema, cols))
        return batches, data[pos:]
