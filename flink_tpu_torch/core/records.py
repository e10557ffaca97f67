"""Columnar record batches: the unit of data flowing between operators.

Trimmed copy of ``flink_tpu/core/records.py`` (numpy only): records travel
as struct-of-arrays micro-batches, each record with an int64 event
timestamp in milliseconds. A column is a numpy dtype or ``object``
(strings, tuples: the host operators' values). Device-resident batches
are in ``device_records.py``.
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
    "float64": np.float64, "bool": np.bool_, "object": object,
}


@dataclass(frozen=True)
class FieldType:
    name: str
    dtype: Any  # numpy scalar type or ``object``

    @property
    def is_numeric(self) -> bool:
        return self.dtype is not object


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
        """Schema from one sample element: scalars become ('value',),
        tuples f0..fN, dicts their keys; a value neither bool, int nor
        float is an ``object`` column."""
        def dtype_of(v: Any) -> Any:
            if isinstance(v, (bool, np.bool_)):
                return np.bool_
            if isinstance(v, (int, np.integer)):
                return np.int64
            if isinstance(v, (float, np.floating)):
                return np.float64
            return object

        if isinstance(row, tuple):
            return Schema([(f"f{i}", dtype_of(v)) for i, v in enumerate(row)])
        if isinstance(row, dict):
            return Schema([(k, dtype_of(v)) for k, v in row.items()])
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

    @staticmethod
    def _row_columns(schema: Schema, rows: Sequence[Any]) -> dict:
        """Per-column Python lists of scalar, tuple or dict rows."""
        n = len(rows)
        cols: dict[str, list] = {f.name: [None] * n for f in schema.fields}
        single = len(schema) == 1
        for i, row in enumerate(rows):
            if isinstance(row, dict):
                for f in schema.fields:
                    cols[f.name][i] = row[f.name]
            elif isinstance(row, tuple) and not single:
                for f, v in zip(schema.fields, row):
                    cols[f.name][i] = v
            else:
                cols[schema.fields[0].name][i] = row
        return cols

    @classmethod
    def from_rows(cls, schema: Schema, rows: Sequence[Any],
                  timestamps: Optional[Sequence[int]] = None) -> "RecordBatch":
        """Build from Python rows (scalars, tuples or dicts per the
        schema)."""
        cols = cls._row_columns(schema, rows)
        arrs = {f.name: _column(cols[f.name], f.dtype)
                for f in schema.fields}
        ts = None if timestamps is None else np.asarray(timestamps, np.int64)
        return cls(schema, arrs, ts)

    @classmethod
    def from_rows_infer(cls, schema: Optional[Schema], rows: Sequence[Any],
                        timestamps: Optional[Sequence[int]] = None
                        ) -> tuple["RecordBatch", Schema]:
        """``from_rows`` with inference and per-column promotion: a column
        that stops fitting its dtype widens along int64 -> float64 ->
        object (never silently truncated); the widened schema is returned
        for the next batch. Only the offending column widens."""
        if not rows:
            if schema is None:
                raise ValueError(
                    "from_rows_infer needs a schema to build an empty batch")
            return cls.empty(schema), schema
        if schema is None:
            schema = Schema.infer(rows[0])
        cols = cls._row_columns(schema, rows)
        out_fields: list[tuple[str, Any]] = []
        arrs: dict[str, np.ndarray] = {}
        for f in schema.fields:
            vals = cols[f.name]
            if not f.is_numeric:
                arrs[f.name] = _column(vals, object)
                out_fields.append((f.name, object))
                continue
            try:
                natural = np.asarray(vals)
            except (ValueError, TypeError):
                natural = _column(vals, object)
            if natural.dtype == object or natural.dtype.kind in "USV":
                arrs[f.name] = _column(vals, object)
                out_fields.append((f.name, object))
            elif np.can_cast(natural.dtype, f.dtype, "safe"):
                arrs[f.name] = natural.astype(f.dtype)
                out_fields.append((f.name, f.dtype))
            else:
                promoted = np.promote_types(natural.dtype, np.dtype(f.dtype))
                arrs[f.name] = natural.astype(promoted)
                out_fields.append((f.name, promoted.type))
        out_schema = Schema(out_fields)
        ts = None if timestamps is None else np.asarray(timestamps, np.int64)
        return cls(out_schema, arrs, ts), out_schema

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
                            for f in schema.fields},
                   np.empty(0, dtype=np.int64))

    @classmethod
    def concat(cls, batches: Sequence["RecordBatch"]) -> "RecordBatch":
        """The batches' rows in order, under the first batch's schema."""
        if not batches:
            raise ValueError("concat of zero batches")
        if len(batches) == 1:
            return batches[0]
        schema = batches[0].schema
        cols = {name: np.concatenate([b.columns[name] for b in batches])
                for name in schema.names}
        ts = np.concatenate([b.timestamps for b in batches])
        return cls(schema, cols, ts)

    def split_by(self, part: np.ndarray, num_parts: int) -> list["RecordBatch"]:
        """Partition rows by an int partition-id array (stable within
        parts)."""
        order = np.argsort(part, kind="stable")
        bounds = np.searchsorted(part[order], np.arange(num_parts + 1))
        return [self.take(order[bounds[p]:bounds[p + 1]])
                for p in range(num_parts)]


def _column(values: list, dtype) -> np.ndarray:
    """A column of ``dtype`` from Python values; an ``object`` column
    keeps each value as it is (a tuple stays one element)."""
    if dtype is object:
        return np.fromiter(values, dtype=object, count=len(values))
    return np.array(values, dtype=dtype)
