"""Sink operator: hands every batch to a user sink (trimmed port of
``flink_tpu/runtime/operators/sink.py``).

Each batch visits the ``sink.invoke`` fault site first. A ``Sink``'s
writer takes part in checkpoints as the reference's does: a snapshot
flushes it and prepares the checkpoint's commit, the checkpoint's
completion commits it, and the end of input commits whatever is left, so
a two-phase writer (``connectors.core.TransactionalCollectSink``) shows
each row once across a restart from a checkpoint."""

from __future__ import annotations

from ...connectors.core import CollectSink
from ...core.records import RecordBatch
from ..faults import fire_with_retries
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

    def setup(self, ctx, output) -> None:
        super().setup(ctx, output)
        if self._invoke is None:
            self._writer = self._sink.create_writer(ctx.subtask_index)
            self._invoke = self._writer.write_batch

    def initialize_state(self, keyed_snapshots: list,
                         operator_snapshot) -> None:
        if self._writer is not None and operator_snapshot is not None:
            self._writer.restore(operator_snapshot)

    def snapshot_state(self, checkpoint_id: int) -> dict:
        if self._writer is None:
            return {}
        self._writer.flush()
        self._writer.prepare_commit(checkpoint_id)
        return {"operator": self._writer.snapshot()}

    def notify_checkpoint_complete(self, checkpoint_id: int) -> None:
        if self._writer is not None:
            self._writer.commit(checkpoint_id)

    def process_batch(self, batch: RecordBatch) -> None:
        if batch.n:
            fire_with_retries("sink.invoke")
            self._invoke(batch)

    def process_watermark(self, watermark) -> None:
        self.current_watermark = watermark.timestamp

    def finish(self) -> None:
        if self._writer is not None:
            # end of input: prepare and commit everything outstanding
            self._writer.flush()
            self._writer.prepare_commit(1 << 62)
            self._writer.commit(1 << 62)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
