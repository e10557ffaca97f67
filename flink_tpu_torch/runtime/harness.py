"""Deterministic single-operator test harnesses (minimal port of
``flink_tpu/runtime/harness.py``): drive one operator, of one input or of
two, with batches and watermarks, and round-trip snapshots, with no
runner and no threads."""

from __future__ import annotations

from typing import Any, Optional, Sequence

from ..core.config import Configuration
from ..core.elements import Watermark
from ..core.records import RecordBatch, Schema
from .operators.base import CollectingOutput, OneInputOperator, \
    OperatorContext, TwoInputOperator

__all__ = ["OneInputOperatorTestHarness", "TwoInputOperatorTestHarness"]


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

    def get_output(self) -> list:
        return self.output.rows()

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


class TwoInputOperatorTestHarness:
    """Drive one TwoInputOperator: elements, batches and watermarks per
    input, snapshot/restore round-trips."""

    def __init__(self, operator: TwoInputOperator,
                 schema1: Optional[Schema] = None,
                 schema2: Optional[Schema] = None,
                 config: Optional[Configuration] = None,
                 subtask_index: int = 0, parallelism: int = 1,
                 max_parallelism: int = 128, task_name: str = "harness2"):
        self.operator = operator
        self.schemas = [schema1, schema2]
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

    def process_batch1(self, batch: RecordBatch) -> None:
        self._ensure_open()
        self.operator.process_batch1(batch)

    def process_batch2(self, batch: RecordBatch) -> None:
        self._ensure_open()
        self.operator.process_batch2(batch)

    def _process(self, input_index: int, values: Sequence[Any],
                 timestamps: Optional[Sequence[int]]) -> None:
        if self.schemas[input_index] is None:
            self.schemas[input_index] = Schema.infer(values[0])
        batch = RecordBatch.from_rows(
            self.schemas[input_index], list(values),
            list(timestamps) if timestamps is not None else None)
        (self.process_batch1 if input_index == 0
         else self.process_batch2)(batch)

    def process_element1(self, value: Any, timestamp: int) -> None:
        self._process(0, [value], [timestamp])

    def process_element2(self, value: Any, timestamp: int) -> None:
        self._process(1, [value], [timestamp])

    def process_elements1(self, values, timestamps=None) -> None:
        self._process(0, values, timestamps)

    def process_elements2(self, values, timestamps=None) -> None:
        self._process(1, values, timestamps)

    def process_watermark1(self, ts: int) -> None:
        self._ensure_open()
        self.operator.process_watermark_n(0, Watermark(int(ts)))

    def process_watermark2(self, ts: int) -> None:
        self._ensure_open()
        self.operator.process_watermark_n(1, Watermark(int(ts)))

    def snapshot(self, checkpoint_id: int = 1) -> dict:
        return self.operator.snapshot_state(checkpoint_id)

    @staticmethod
    def restored(operator_factory, snapshot: dict, **kwargs
                 ) -> "TwoInputOperatorTestHarness":
        """New harness whose operator starts from ``snapshot``."""
        h = TwoInputOperatorTestHarness(operator_factory(), **kwargs)
        keyed = [snapshot["keyed"]] if snapshot.get("keyed") else []
        h.open(keyed, snapshot.get("operator"))
        return h

    def get_output(self) -> list:
        return self.output.rows()

    def get_watermarks(self) -> list[int]:
        return [w.timestamp for w in self.output.watermarks]

    def clear_output(self) -> None:
        self.output.clear()

    def close(self) -> None:
        self.operator.finish()
        self.operator.close()
