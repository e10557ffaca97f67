"""Generator and in-memory collection sources (port of the datagen and
collection parts of ``flink_tpu/connectors/core.py``).

``DataGenSource(gen_fn, ...)`` calls ``gen_fn(idx) -> {column: values}``
on a batch of global record indices; its only state is the next index, so
resume is exact.

* Host reader: ``idx`` is an int64 numpy array, columns come back as
  numpy.
* Device reader (``device=True``): ``idx`` is an int64 torch tensor on the
  job's device and ``gen_fn`` returns torch columns there, so the batch
  never touches the host. A batch's event-time bounds come from calling
  ``gen_fn`` on a 2-element CPU tensor of its endpoint indices, which is
  why the timestamp column must be non-decreasing in the index. That
  contract is checked on the device for every batch (within the batch and
  against the previous batch's tail) into a running flag that is read
  once, when the source is exhausted or closed.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from ..core.device_records import DeviceRecordBatch
from ..core.records import MIN_TIMESTAMP, RecordBatch, Schema
from ..device import torch_dtype

__all__ = ["DataGenSource", "CollectionSource", "SourceReader"]


class SourceReader:
    def read_batch(self, max_records: int) -> Optional[RecordBatch]:
        """Next batch, or None when the source is exhausted."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class DataGenSource:
    def __init__(self, gen_fn: Callable[[Any], dict], schema: Schema,
                 count: Optional[int] = None,
                 timestamp_column: Optional[str] = None,
                 device: bool = False):
        self._gen = gen_fn
        self.schema = schema
        self._count = count
        self._ts_col = timestamp_column
        self._device = bool(device)

    def create_reader(self, device: torch.device) -> SourceReader:
        """Reader of the single subtask; ``device`` is the job's device,
        used when the source generates on the device."""
        if self._device:
            return _DeviceDataGenReader(self, device)
        return _DataGenReader(self)


class _DataGenReader(SourceReader):
    def __init__(self, source: DataGenSource):
        self._s = source
        self._next = 0

    def _plan_batch(self, max_records: int) -> Optional[int]:
        """How many records the next batch holds (None = exhausted)."""
        if self._s._count is None:
            return max_records
        if self._next >= self._s._count:
            return None
        return min(max_records, self._s._count - self._next)

    def read_batch(self, max_records: int) -> Optional[RecordBatch]:
        n = self._plan_batch(max_records)
        if n is None:
            return None
        idx = self._next + np.arange(n, dtype=np.int64)
        cols = self._s._gen(idx)
        self._next += n
        batch = RecordBatch(self._s.schema, cols)
        if self._s._ts_col is not None:
            batch = batch.with_timestamps(
                batch.column(self._s._ts_col).astype(np.int64))
        return batch


class _DeviceDataGenReader(_DataGenReader):
    def __init__(self, source: DataGenSource, device: torch.device):
        super().__init__(source)
        self._dev = torch.device(device)
        self._viol: Optional[torch.Tensor] = None   # device contract flag
        self._prev_last = torch.full((), MIN_TIMESTAMP, dtype=torch.int64,
                                     device=self._dev)

    def _check_monotonic(self) -> None:
        if self._viol is not None and bool(self._viol):
            raise ValueError(
                "DataGenSource(device=True) contract violated: the "
                f"timestamp column {self._s._ts_col!r} is not non-decreasing "
                "in the index (detected on the device); window results of "
                "this run are unreliable")
        self._viol = None

    def read_batch(self, max_records: int):
        n = self._plan_batch(max_records)
        if n is None:
            self._check_monotonic()
            return None
        if n != max_records:
            n = 1 << (n.bit_length() - 1)   # power-of-two tail batches
        first, last = self._next, self._next + n - 1
        idx = first + torch.arange(n, dtype=torch.int64, device=self._dev)
        cols = self._s._gen(idx)
        out = {f.name: torch.as_tensor(cols[f.name], device=self._dev).to(
                   torch_dtype(f.dtype))
               for f in self._s.schema.fields}
        self._next += n
        ts_col = self._s._ts_col
        if ts_col is None:
            return DeviceRecordBatch(self._s.schema, out, None,
                                     MIN_TIMESTAMP, MIN_TIMESTAMP)
        ts = out[ts_col].to(torch.int64)
        viol = (ts[1:] < ts[:-1]).any() | (ts[0] < self._prev_last)
        self._viol = viol if self._viol is None else self._viol | viol
        self._prev_last = ts[-1]
        ends = self._s._gen(torch.tensor([first, last], dtype=torch.int64))
        ts_min, ts_max = (int(v) for v in ends[ts_col])
        if ts_min > ts_max:
            raise ValueError(
                "DataGenSource(device=True) needs a timestamp column "
                f"non-decreasing in the index; got ts({first})={ts_min} "
                f"> ts({last})={ts_max}")
        return DeviceRecordBatch(self._s.schema, out, ts, ts_min, ts_max,
                                 ts_column=ts_col)

    def close(self) -> None:
        self._check_monotonic()


class CollectionSource:
    """Bounded source over an in-memory collection of rows."""

    def __init__(self, elements: Sequence[Any],
                 schema: Optional[Schema] = None,
                 timestamps: Optional[Sequence[int]] = None):
        self._elements = list(elements)
        self.schema = schema or Schema.infer(self._elements[0])
        self._timestamps = (list(timestamps) if timestamps is not None
                            else None)

    def create_reader(self, device: torch.device) -> SourceReader:
        return _CollectionReader(self)


class _CollectionReader(SourceReader):
    def __init__(self, source: CollectionSource):
        self._s = source
        self._pos = 0

    def read_batch(self, max_records: int) -> Optional[RecordBatch]:
        rows = self._s._elements[self._pos:self._pos + max_records]
        if not rows:
            return None
        ts = (self._s._timestamps[self._pos:self._pos + len(rows)]
              if self._s._timestamps is not None else None)
        self._pos += len(rows)
        return RecordBatch.from_rows(self._s.schema, rows, ts)
