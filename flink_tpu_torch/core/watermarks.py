"""Event-time watermark strategies (trimmed copy of
``flink_tpu/core/watermarks.py``).

Generators observe whole batches and emit on batch boundaries. A device
batch carries host-int event-time bounds, so the generator never reads
its timestamps back from the device.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional

import numpy as np
import torch

from .records import MIN_TIMESTAMP, RecordBatch

__all__ = ["WatermarkStrategy", "WatermarkGenerator"]


class WatermarkGenerator:
    def on_batch(self, batch: RecordBatch) -> None:
        raise NotImplementedError

    def current_watermark(self) -> int:
        raise NotImplementedError


class _BoundedOutOfOrderness(WatermarkGenerator):
    """max seen ts - delay - 1."""

    def __init__(self, max_out_of_orderness_ms: int):
        self._delay = int(max_out_of_orderness_ms)
        self._max_ts = MIN_TIMESTAMP + self._delay + 1

    def on_batch(self, batch: RecordBatch) -> None:
        if batch.n:
            mx = getattr(batch, "ts_max", None)
            if mx is None:
                mx = int(batch.timestamps.max())
            self._max_ts = max(self._max_ts, mx)

    def current_watermark(self) -> int:
        return self._max_ts - self._delay - 1


class _NoWatermarks(WatermarkGenerator):
    def on_batch(self, batch: RecordBatch) -> None:
        pass

    def current_watermark(self) -> int:
        return MIN_TIMESTAMP


@dataclass(frozen=True)
class WatermarkStrategy:
    _gen_factory: Callable[[], WatermarkGenerator]
    timestamp_column: Optional[str] = None
    # watermark alignment: sources of one group pause while their
    # watermark runs more than the drift ahead of the group's slowest
    alignment_group: Optional[str] = None
    alignment_max_drift_ms: int = 0

    @staticmethod
    def for_bounded_out_of_orderness(max_out_of_orderness_ms: int
                                     ) -> "WatermarkStrategy":
        return WatermarkStrategy(
            lambda: _BoundedOutOfOrderness(max_out_of_orderness_ms))

    @staticmethod
    def for_monotonous_timestamps() -> "WatermarkStrategy":
        return WatermarkStrategy(lambda: _BoundedOutOfOrderness(0))

    @staticmethod
    def no_watermarks() -> "WatermarkStrategy":
        return WatermarkStrategy(lambda: _NoWatermarks())

    def with_timestamp_column(self, column: str) -> "WatermarkStrategy":
        """Event time = this int64 column (ms)."""
        return replace(self, timestamp_column=column)

    def with_watermark_alignment(self, group: str,
                                 max_drift_ms: int) -> "WatermarkStrategy":
        """Sources of ``group`` pause reading while their watermark is
        ahead of the group's minimum by more than ``max_drift_ms``
        (``runtime/alignment.py``)."""
        return replace(self, alignment_group=group,
                       alignment_max_drift_ms=int(max_drift_ms))

    def create_generator(self) -> WatermarkGenerator:
        return self._gen_factory()

    def assign_timestamps(self, batch: RecordBatch) -> RecordBatch:
        if self.timestamp_column is None:
            return batch
        if getattr(batch, "is_device", False):
            # the source usually bound this column with analytic bounds; a
            # late bind (another column, or none yet) repairs ts_min/ts_max
            # with one device min/max: correctness over speed, rare path
            if batch.ts_column == self.timestamp_column and (
                    batch.lazy or batch.dtimestamps is not None):
                return batch   # bound at the source (a lazy batch: unread)
            col = batch.device_column(self.timestamp_column)
            batch.dtimestamps = col.to(torch.int64)
            batch.ts_column = self.timestamp_column
            batch.ts_min = int(col.min())
            batch.ts_max = int(col.max())
            return batch
        return batch.with_timestamps(
            batch.column(self.timestamp_column).astype(np.int64))
