"""Sink operator: hands every batch to a user sink (trimmed port of
``flink_tpu/runtime/operators/sink.py``)."""

from __future__ import annotations

from ...connectors.core import CollectSink
from ...core.records import RecordBatch
from .base import OneInputOperator

__all__ = ["SinkOperator", "CollectSink"]


class SinkOperator(OneInputOperator):
    """``sink`` is a ``connectors.core.Sink`` (one writer per subtask), an
    object with ``invoke_batch(batch)``, or a callable taking a batch."""

    def __init__(self, sink, name: str = "Sink"):
        super().__init__(name)
        self._sink = sink
        self._writer = None
        self._invoke = None
        if not hasattr(sink, "create_writer"):
            self._invoke = getattr(sink, "invoke_batch", sink)
            if not callable(self._invoke):
                raise TypeError("a sink is a Sink, a callable or has "
                                "invoke_batch(batch)")

    def open(self) -> None:
        if self._invoke is None:
            self._writer = self._sink.create_writer(self.ctx.subtask_index)
            self._invoke = self._writer.write_batch

    def process_batch(self, batch: RecordBatch) -> None:
        if batch.n:
            self._invoke(batch)

    def process_watermark(self, watermark) -> None:
        self.current_watermark = watermark.timestamp

    def finish(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
