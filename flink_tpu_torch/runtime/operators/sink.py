"""Sink operator: hands every batch to a user sink (trimmed port of
``flink_tpu/runtime/operators/sink.py``)."""

from __future__ import annotations

import threading

from ...core.records import RecordBatch
from .base import OneInputOperator

__all__ = ["SinkOperator", "CollectSink"]


class SinkOperator(OneInputOperator):
    """``sink`` is an object with ``invoke_batch(batch)`` or a callable
    taking a batch."""

    def __init__(self, sink, name: str = "Sink"):
        super().__init__(name)
        self._invoke = getattr(sink, "invoke_batch", sink)
        if not callable(self._invoke):
            raise TypeError("a sink is a callable or has invoke_batch(batch)")

    def process_batch(self, batch: RecordBatch) -> None:
        if batch.n:
            self._invoke(batch)

    def process_watermark(self, watermark) -> None:
        self.current_watermark = watermark.timestamp


class CollectSink:
    """Collects every row (the execute_and_collect sink), from any number
    of sink subtasks."""

    def __init__(self):
        self.rows: list = []
        self._lock = threading.Lock()

    def invoke_batch(self, batch: RecordBatch) -> None:
        rows = list(batch.iter_rows())
        with self._lock:
            self.rows.extend(rows)
