"""Parquet format: parquet files <-> columnar RecordBatches (port of
``flink_tpu/formats/parquet.py``), through pyarrow column for column.

Parquet is a whole-file format (``whole_file = True``: the footer indexes
the row groups), so the file connectors call ``read_row_groups`` and
``open_writer`` instead of the streaming block path:

* a read yields one batch a row group, and the reader's position is the
  row-group index, so a restore resumes at group granularity;
* a write appends a row group per micro-batch (or per
  ``row_group_batches``) to the sink's in-progress file, whose footer is
  written when the part rolls, before the two-phase rename.

Event timestamps ride a reserved ``__ts__`` column and come back on read.
pyarrow is optional: without it every read or write raises an
``ImportError`` that names it.
"""

from __future__ import annotations

import numpy as np

from ..core.records import RecordBatch, Schema
from .core import Format

__all__ = ["ParquetFormat"]

_TS_COLUMN = "__ts__"


def _require_pyarrow():
    try:
        import pyarrow
        import pyarrow.parquet  # noqa: F401
        return pyarrow
    except ImportError as e:
        raise ImportError("ParquetFormat needs pyarrow; it is not installed "
                          "in this environment") from e


class ParquetFormat(Format):
    binary = True
    whole_file = True

    def __init__(self, schema: Schema, write_timestamps: bool = True,
                 compression: str = "snappy", row_group_batches: int = 1):
        """``row_group_batches``: micro-batches gathered into one written
        row group."""
        self.schema = schema
        self._write_ts = bool(write_timestamps)
        self._compression = compression
        self._coalesce = max(1, int(row_group_batches))

    def _to_arrow(self, batch: RecordBatch):
        pa = _require_pyarrow()
        cols, names = [], []
        for f in batch.schema.fields:
            col = batch.columns[f.name]
            if f.is_numeric:
                cols.append(pa.array(col))
            else:
                cols.append(pa.array(
                    [None if v is None else str(v) for v in col],
                    type=pa.string()))
            names.append(f.name)
        if self._write_ts:
            cols.append(pa.array(batch.timestamps.astype(np.int64)))
            names.append(_TS_COLUMN)
        return pa.table(dict(zip(names, cols)))

    def _from_arrow(self, table) -> RecordBatch:
        cols: dict[str, np.ndarray] = {}
        fields = []
        ts = None
        for name in table.column_names:
            arr = table.column(name).to_numpy(zero_copy_only=False)
            if name == _TS_COLUMN:
                ts = arr.astype(np.int64)
                continue
            fields.append((name, object if arr.dtype == object
                           else arr.dtype.type))
            cols[name] = arr
        n = len(next(iter(cols.values()))) if cols else 0
        if ts is None:
            ts = np.zeros(n, np.int64)
        return RecordBatch(Schema(fields), cols, ts)

    def read_row_groups(self, fileobj, start_group: int,
                        max_groups: int = 1
                        ) -> tuple[list[RecordBatch], int, bool]:
        """Up to ``max_groups`` row groups from index ``start_group`` of a
        seekable binary file: (batches, next group, at the end)."""
        pa = _require_pyarrow()
        pf = pa.parquet.ParquetFile(fileobj)
        total = pf.num_row_groups
        out = []
        g = start_group
        while g < total and len(out) < max_groups:
            out.append(self._from_arrow(pf.read_row_group(g)))
            g += 1
        return out, g, g >= total

    def open_writer(self, fileobj) -> "_ParquetWriterSession":
        return _ParquetWriterSession(self, fileobj)


class _ParquetWriterSession:
    """One part file: row groups append per micro-batch; the footer lands
    on close."""

    def __init__(self, fmt: ParquetFormat, fileobj):
        self._fmt = fmt
        self._fileobj = fileobj
        self._writer = None
        self._buf: list[RecordBatch] = []

    def write(self, batch: RecordBatch) -> None:
        self._buf.append(batch)
        if len(self._buf) >= self._fmt._coalesce:
            self._flush()

    def _flush(self) -> None:
        if not self._buf:
            return
        pa = _require_pyarrow()
        batch = RecordBatch.concat(self._buf)
        self._buf.clear()
        table = self._fmt._to_arrow(batch)
        if self._writer is None:
            self._writer = pa.parquet.ParquetWriter(
                self._fileobj, table.schema,
                compression=self._fmt._compression)
        self._writer.write_table(table)

    def close(self) -> None:
        self._flush()
        if self._writer is not None:
            self._writer.close()
            self._writer = None
