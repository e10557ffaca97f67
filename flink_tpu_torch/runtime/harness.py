"""Deterministic single-operator test harness (minimal port of
``flink_tpu/runtime/harness.py``): drive one operator with batches and
watermarks, and round-trip snapshots, with no runner and no threads."""

from __future__ import annotations

from typing import Any, Optional, Sequence

from ..core.config import Configuration
from ..core.elements import Watermark
from ..core.records import RecordBatch, Schema
from .operators.base import CollectingOutput, OneInputOperator, \
    OperatorContext

__all__ = ["OneInputOperatorTestHarness"]


class OneInputOperatorTestHarness:
    def __init__(self, operator: OneInputOperator,
                 schema: Optional[Schema] = None,
                 config: Optional[Configuration] = None,
                 subtask_index: int = 0, parallelism: int = 1,
                 max_parallelism: int = 128, task_name: str = "harness"):
        self.operator = operator
        self.schema = schema
        self.output = CollectingOutput()
        self.ctx = OperatorContext(task_name, subtask_index, parallelism,
                                   max_parallelism, config or Configuration())
        operator.setup(self.ctx, self.output)
        self._opened = False

    def open(self, keyed_snapshots: Optional[list] = None,
             operator_snapshot: Any = None) -> None:
        self.operator.initialize_state(keyed_snapshots or [],
                                       operator_snapshot)
        self.operator.open()
        self._opened = True

    def _ensure_open(self) -> None:
        if not self._opened:
            self.open()

    def process_elements(self, values: Sequence[Any],
                         timestamps: Optional[Sequence[int]] = None) -> None:
        self._ensure_open()
        if self.schema is None:
            self.schema = Schema.infer(values[0])
        self.operator.process_batch(RecordBatch.from_rows(
            self.schema, list(values),
            list(timestamps) if timestamps is not None else None))

    def process_batch(self, batch: RecordBatch) -> None:
        self._ensure_open()
        self.operator.process_batch(batch)

    def process_watermark(self, ts: int) -> None:
        self._ensure_open()
        self.operator.process_watermark(Watermark(int(ts)))

    def snapshot(self, checkpoint_id: int = 1) -> dict:
        return self.operator.snapshot_state(checkpoint_id)

    @staticmethod
    def restored(operator_factory, snapshot: dict, **kwargs
                 ) -> "OneInputOperatorTestHarness":
        """New harness whose operator starts from ``snapshot``."""
        h = OneInputOperatorTestHarness(operator_factory(), **kwargs)
        keyed = [snapshot["keyed"]] if snapshot.get("keyed") else []
        h.open(keyed, snapshot.get("operator"))
        return h

    def close(self) -> None:
        self.operator.finish()
        self.operator.close()
