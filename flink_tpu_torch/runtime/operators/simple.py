"""Stateless batch operator (trimmed port of
``flink_tpu/runtime/operators/simple.py``): the SQL planner's calc,
projections and filters are each one ``BatchFnOperator`` over a
batch -> batch callable on numpy columns."""

from __future__ import annotations

import time
from typing import Callable, Optional

from ...core.records import RecordBatch
from .base import OneInputOperator

__all__ = ["BatchFnOperator"]


class BatchFnOperator(OneInputOperator):
    """Operator over a raw batch -> batch callable; an empty or None
    result emits nothing. ``busy_s`` sums the seconds spent in the
    callable."""

    def __init__(self, fn: Callable[[RecordBatch], Optional[RecordBatch]],
                 name: str = "BatchFn"):
        super().__init__(name)
        self._fn = fn
        self.busy_s = 0.0

    def process_batch(self, batch: RecordBatch) -> None:
        t0 = time.perf_counter()
        out = self._fn(batch)
        self.busy_s += time.perf_counter() - t0
        if out is not None and out.n:
            self.output.emit(out)
