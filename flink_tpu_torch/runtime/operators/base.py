"""Stream operator base (trimmed port of
``flink_tpu/runtime/operators/base.py``).

Operators are batch-oriented: ``process_batch`` receives a whole
RecordBatch and watermarks arrive through ``process_watermark`` in channel
order. Chained operators call each other directly.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ...core.config import Configuration
from ...core.elements import Watermark
from ...core.keygroups import KeyGroupRange, key_group_range_for_operator
from ...core.records import MIN_TIMESTAMP, RecordBatch

__all__ = ["OperatorContext", "Output", "CollectingOutput", "StreamOperator",
           "OneInputOperator", "chain_operators"]


@dataclass
class OperatorContext:
    """What an operator needs from its task."""

    task_name: str
    subtask_index: int
    parallelism: int
    max_parallelism: int
    config: Configuration = field(default_factory=Configuration)

    @property
    def key_group_range(self) -> KeyGroupRange:
        return key_group_range_for_operator(
            self.max_parallelism, self.parallelism, self.subtask_index)


class Output:
    """Downstream edge of an operator."""

    def emit(self, batch: RecordBatch) -> None:
        raise NotImplementedError

    def emit_watermark(self, watermark: Watermark) -> None:
        raise NotImplementedError


class CollectingOutput(Output):
    """Buffers everything: the tail of the test harness."""

    def __init__(self):
        self.batches: list[RecordBatch] = []
        self.watermarks: list[Watermark] = []

    def emit(self, batch: RecordBatch) -> None:
        if batch.n:
            self.batches.append(batch)

    def emit_watermark(self, watermark: Watermark) -> None:
        self.watermarks.append(watermark)


class StreamOperator:
    """Lifecycle: setup -> initialize_state -> open -> process -> finish
    -> close."""

    def __init__(self, name: str = ""):
        self.name = name or type(self).__name__
        self.ctx: OperatorContext = None  # type: ignore[assignment]
        self.output: Output = None  # type: ignore[assignment]
        self.current_watermark: int = MIN_TIMESTAMP

    def setup(self, ctx: OperatorContext, output: Output) -> None:
        self.ctx = ctx
        self.output = output

    def initialize_state(self, keyed_snapshots: list,
                         operator_snapshot) -> None:
        pass

    def open(self) -> None:
        pass

    def finish(self) -> None:
        """End of input: flush buffers."""

    def close(self) -> None:
        pass

    def process_watermark(self, watermark: Watermark) -> None:
        self.current_watermark = watermark.timestamp
        self.output.emit_watermark(watermark)

    def snapshot_state(self, checkpoint_id: int) -> dict:
        return {}


class OneInputOperator(StreamOperator):
    def process_batch(self, batch: RecordBatch) -> None:
        raise NotImplementedError


class _ChainingOutput(Output):
    """Direct-call edge between chained operators."""

    def __init__(self, downstream: OneInputOperator):
        self._op = downstream

    def emit(self, batch: RecordBatch) -> None:
        if batch.n:
            self._op.process_batch(batch)

    def emit_watermark(self, watermark: Watermark) -> None:
        self._op.process_watermark(watermark)


def chain_operators(operators: list, ctx: OperatorContext,
                    tail: Output) -> None:
    """Wire ``operators`` back to front: each one's output feeds the next,
    the last one's feeds ``tail``."""
    out = tail
    for op in reversed(operators):
        op.setup(ctx, out)
        out = _ChainingOutput(op)
