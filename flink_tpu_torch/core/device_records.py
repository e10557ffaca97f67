"""Device-resident record batches (port of
``flink_tpu/core/device_records.py``).

Columns born on the device stay there and flow by reference. The host
sees only metadata (row count, event-time bounds as host ints), so
watermark generation and pane bookkeeping never synchronize with the
device. Host columns materialize lazily, once, for any consumer that
genuinely needs host values.

A device batch pickles as the host batch of its columns (``__reduce__``):
an unaligned checkpoint's in-flight batches are written by the fs
storage that way, and restore as host batches. A lazy batch realizes
its columns first.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from .records import RecordBatch, Schema

__all__ = ["DeviceRecordBatch", "LazyDeviceBatch"]


class DeviceRecordBatch(RecordBatch):
    """A RecordBatch whose columns are torch tensors on a device."""

    __slots__ = ("dcolumns", "dtimestamps", "ts_min", "ts_max", "ts_column",
                 "_host")

    is_device = True
    lazy = False

    def __init__(self, schema: Schema, dcolumns: Mapping[str, torch.Tensor],
                 dtimestamps: Optional[torch.Tensor], ts_min: int,
                 ts_max: int, ts_column: Optional[str] = None):
        # RecordBatch.__init__ is not called: columns stay on the device
        # and the parent's columns/timestamps are the lazy properties below
        self.schema = schema
        self.dcolumns = dict(dcolumns)
        self.dtimestamps = dtimestamps
        self.n = int(next(iter(self.dcolumns.values())).shape[0])
        self.ts_min = int(ts_min)
        self.ts_max = int(ts_max)
        self.ts_column = ts_column
        self._host = None

    def device_column(self, name: str) -> torch.Tensor:
        return self.dcolumns[name]

    def _materialize(self) -> RecordBatch:
        if self._host is None:
            cols = {n: c.cpu().numpy() for n, c in self.dcolumns.items()}
            ts = (self.dtimestamps.cpu().numpy()
                  if self.dtimestamps is not None
                  else np.full(self.n, self.ts_min, np.int64))
            self._host = RecordBatch(self.schema, cols, ts)
        return self._host

    @property
    def columns(self) -> dict[str, np.ndarray]:
        return self._materialize().columns

    @property
    def timestamps(self) -> np.ndarray:
        return self._materialize().timestamps

    def __reduce__(self):
        # tensors on a card do not survive a process: ship the host batch
        host = self._materialize()
        return (RecordBatch, (host.schema, host.columns, host.timestamps))

    def compact(self, mask: torch.Tensor) -> "DeviceRecordBatch":
        """The rows where ``mask`` (bool, on this batch's device) holds,
        in batch order, compacted on the device. One host read: the kept
        row count and the kept rows' event-time bounds together."""
        mask = mask.to(torch.bool)
        ts = self.dtimestamps
        count = mask.sum()
        if ts is None:
            stats = count.reshape(1)
        else:
            big = torch.iinfo(torch.int64).max
            stats = torch.stack([count,
                                 torch.where(mask, ts, big).min(),
                                 torch.where(mask, ts, -big - 1).max()])
        # lint: sync-ok a filter's kept rows size its output: one read a batch
        got = stats.tolist()
        n = got[0]
        ts_min, ts_max = (got[1], got[2]) if ts is not None and n else \
            (self.ts_min, self.ts_max)
        # each kept row's place; a dropped row goes to a spare slot n
        dest = torch.where(mask, torch.cumsum(mask, 0) - 1,
                           torch.full_like(mask, n, dtype=torch.int64))

        def pack(col: torch.Tensor) -> torch.Tensor:
            out = torch.empty((n + 1,) + tuple(col.shape[1:]),
                              dtype=col.dtype, device=col.device)
            return out.index_copy_(0, dest, col)[:n]

        return DeviceRecordBatch(
            self.schema, {k: pack(c) for k, c in self.dcolumns.items()},
            None if ts is None else pack(ts), ts_min, ts_max,
            self.ts_column)

    def __repr__(self) -> str:
        return (f"DeviceRecordBatch(n={self.n}, schema={self.schema!r}, "
                f"ts=[{self.ts_min},{self.ts_max}])")


class LazyDeviceBatch(DeviceRecordBatch):
    """A device batch that has not been generated yet: the handle a
    certified fused chain moves instead of data. It carries the reader's
    index of its first record, its length, the previous batch's tail
    timestamp and its analytic event-time bounds; the chained window
    operator decodes and folds it in one dispatch (runtime/compiled.py).

    Any other consumer realizes the columns on first touch by running the
    reader's ordinary decode for this batch."""

    __slots__ = ("reader", "start", "prev_last", "_realized")

    lazy = True

    def __init__(self, schema: Schema, reader, start: int, n: int,
                 prev_last: int, ts_min: int, ts_max: int,
                 ts_column: Optional[str] = None):
        self.schema = schema
        self.reader = reader
        self.start = int(start)
        self.prev_last = int(prev_last)
        self.n = int(n)
        self.ts_min = int(ts_min)
        self.ts_max = int(ts_max)
        self.ts_column = ts_column
        self._host = None
        self._realized = None

    @property
    def realized(self) -> bool:
        return self._realized is not None

    def realize(self) -> tuple:
        """Run the reader's decode for this batch (the unfused fallback)."""
        if self._realized is None:
            self._realized = self.reader.decode(self.start, self.n,
                                                self.prev_last)
        return self._realized

    # the parent's slot descriptors are shadowed by these properties: the
    # columns do not exist until someone needs them
    @property
    def dcolumns(self):
        return self.realize()[0]

    @property
    def dtimestamps(self):
        return self.realize()[1]

    def device_column(self, name: str) -> torch.Tensor:
        return self.realize()[0][name]

    def __repr__(self) -> str:
        state = "realized" if self._realized is not None else "lazy"
        return (f"LazyDeviceBatch(n={self.n}, start={self.start}, {state}, "
                f"ts=[{self.ts_min},{self.ts_max}])")
