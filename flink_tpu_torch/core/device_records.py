"""Device-resident record batches (port of
``flink_tpu/core/device_records.py``).

Columns born on the device stay there and flow by reference. The host
sees only metadata (row count, event-time bounds as host ints), so
watermark generation and pane bookkeeping never synchronize with the
device. Host columns materialize lazily, once, for any consumer that
genuinely needs host values.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from .records import RecordBatch, Schema

__all__ = ["DeviceRecordBatch"]


class DeviceRecordBatch(RecordBatch):
    """A RecordBatch whose columns are torch tensors on a device."""

    __slots__ = ("dcolumns", "dtimestamps", "ts_min", "ts_max", "ts_column",
                 "_host")

    is_device = True

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

    def __repr__(self) -> str:
        return (f"DeviceRecordBatch(n={self.n}, schema={self.schema!r}, "
                f"ts=[{self.ts_min},{self.ts_max}])")
