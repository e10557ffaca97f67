"""Columnar record batches: the unit of data flowing between operators.

Trimmed copy of ``flink_tpu/core/records.py`` (numpy only): records travel
as struct-of-arrays micro-batches, each record with an int64 event
timestamp in milliseconds. Device-resident batches are in
``device_records.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterator, Mapping, Optional, Sequence

import numpy as np

__all__ = ["Schema", "FieldType", "RecordBatch", "MIN_TIMESTAMP",
           "MAX_TIMESTAMP", "scalar"]

MIN_TIMESTAMP = -(1 << 62)
MAX_TIMESTAMP = (1 << 62) - 1


def scalar(v):
    """numpy scalar -> Python scalar (identity otherwise): the row-value
    unwrapper of the host operators."""
    return v.item() if isinstance(v, np.generic) else v

# Canonical dtype aliases accepted in schemas.
_DTYPES = {
    "int32": np.int32, "int64": np.int64, "float32": np.float32,
    "float64": np.float64, "bool": np.bool_,
}


@dataclass(frozen=True)
class FieldType:
    name: str
    dtype: Any  # numpy scalar type


class Schema:
    """Ordered, named, typed fields of a stream."""

    def __init__(self, fields: Sequence[tuple[str, Any]]):
        self.fields: tuple[FieldType, ...] = tuple(
            FieldType(n, _DTYPES.get(d, d) if isinstance(d, str) else d)
            for n, d in fields)
        self._index = {f.name: i for i, f in enumerate(self.fields)}
        if len(self._index) != len(self.fields):
            raise ValueError("Duplicate field names in schema")

    def field(self, name: str) -> FieldType:
        return self.fields[self._index[name]]

    def index_of(self, name: str) -> int:
        return self._index[name]

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(f.name for f in self.fields)

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def __len__(self) -> int:
        return len(self.fields)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Schema) and self.fields == other.fields

    def __repr__(self) -> str:
        return "Schema(" + ", ".join(
            f"{f.name}:{getattr(f.dtype, '__name__', f.dtype)}"
            for f in self.fields) + ")"

    @staticmethod
    def infer(row: Any) -> "Schema":
        """Schema from one sample element: tuples become f0..fN."""
        def dtype_of(v: Any) -> Any:
            if isinstance(v, (bool, np.bool_)):
                return np.bool_
            if isinstance(v, (int, np.integer)):
                return np.int64
            return np.float64

        if isinstance(row, tuple):
            return Schema([(f"f{i}", dtype_of(v)) for i, v in enumerate(row)])
        return Schema([("value", dtype_of(row))])


class RecordBatch:
    """A micro-batch of records: struct-of-arrays + per-record timestamps."""

    __slots__ = ("schema", "columns", "timestamps", "n")

    def __init__(self, schema: Schema, columns: Mapping[str, np.ndarray],
                 timestamps: Optional[np.ndarray] = None):
        self.schema = schema
        self.columns: dict[str, np.ndarray] = {}
        n = None
        for f in schema.fields:
            col = np.asarray(columns[f.name], dtype=f.dtype)
            if n is None:
                n = len(col)
            elif len(col) != n:
                raise ValueError(f"Column {f.name} length {len(col)} != {n}")
            self.columns[f.name] = col
        self.n = n or 0
        if timestamps is None:
            timestamps = np.full(self.n, MIN_TIMESTAMP, dtype=np.int64)
        self.timestamps = np.asarray(timestamps, dtype=np.int64)
        if len(self.timestamps) != self.n:
            raise ValueError("timestamps length mismatch")

    @classmethod
    def from_rows(cls, schema: Schema, rows: Sequence[Any],
                  timestamps: Optional[Sequence[int]] = None) -> "RecordBatch":
        """Build from Python rows (scalars or tuples per the schema)."""
        single = len(schema) == 1
        cols = {f.name: [] for f in schema.fields}
        for row in rows:
            vals = (row,) if single or not isinstance(row, tuple) else row
            for f, v in zip(schema.fields, vals):
                cols[f.name].append(v)
        arrs = {f.name: np.array(cols[f.name], dtype=f.dtype)
                for f in schema.fields}
        ts = None if timestamps is None else np.asarray(timestamps, np.int64)
        return cls(schema, arrs, ts)

    def column(self, name: str) -> np.ndarray:
        return self.columns[name]

    def row(self, i: int) -> Any:
        """Row i as a scalar (1-column schema) or tuple of Python values."""
        vals = tuple(scalar(self.columns[f.name][i])
                     for f in self.schema.fields)
        return vals[0] if len(vals) == 1 else vals

    def iter_rows(self) -> Iterator[Any]:
        for i in range(self.n):
            yield self.row(i)

    def __len__(self) -> int:
        return self.n

    def __repr__(self) -> str:
        return f"RecordBatch(n={self.n}, schema={self.schema!r})"

    def with_timestamps(self, ts: np.ndarray) -> "RecordBatch":
        return RecordBatch(self.schema, self.columns, ts)

    def take(self, indices: np.ndarray) -> "RecordBatch":
        cols = {n: c[indices] for n, c in self.columns.items()}
        return RecordBatch(self.schema, cols, self.timestamps[indices])

    def filter(self, mask: np.ndarray) -> "RecordBatch":
        return self.take(np.flatnonzero(mask))

    @classmethod
    def empty(cls, schema: Schema) -> "RecordBatch":
        return cls(schema, {f.name: np.empty(0, dtype=f.dtype)
                            for f in schema.fields})

    def split_by(self, part: np.ndarray, num_parts: int) -> list["RecordBatch"]:
        """Partition rows by an int partition-id array (stable within
        parts)."""
        order = np.argsort(part, kind="stable")
        bounds = np.searchsorted(part[order], np.arange(num_parts + 1))
        return [self.take(order[bounds[p]:bounds[p + 1]])
                for p in range(num_parts)]
