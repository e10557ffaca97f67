"""Stream operator base (trimmed port of
``flink_tpu/runtime/operators/base.py``).

Operators are batch-oriented: ``process_batch`` receives a whole
RecordBatch and watermarks arrive through ``process_watermark`` in channel
order. Chained operators call each other directly; ``OperatorChain`` is
the fused sequence one task runs. A ``TwoInputOperator`` heads a chain of
a two-input task: ``process_batch1/2`` per input, and its watermark is
the min across the inputs.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ...core.config import Configuration
from ...core.elements import Watermark
from ...core.keygroups import KeyGroupRange, key_group_range_for_operator
from ...core.records import MIN_TIMESTAMP, RecordBatch

__all__ = ["OperatorContext", "Output", "CollectingOutput", "StreamOperator",
           "OneInputOperator", "TwoInputOperator", "OperatorChain"]


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

    def emit_side(self, tag: str, batch: RecordBatch) -> None:
        """A tagged side output (``dead-letter``); the port's runtime wires
        none, the test harness collects them."""
        raise NotImplementedError(f"no side output wired for tag {tag!r}")


class CollectingOutput(Output):
    """Buffers everything: the tail of the test harness."""

    def __init__(self):
        self.batches: list[RecordBatch] = []
        self.watermarks: list[Watermark] = []
        self.side: dict[str, list[RecordBatch]] = {}

    def emit_side(self, tag: str, batch: RecordBatch) -> None:
        self.side.setdefault(tag, []).append(batch)

    def emit(self, batch: RecordBatch) -> None:
        if batch.n:
            self.batches.append(batch)

    def emit_watermark(self, watermark: Watermark) -> None:
        self.watermarks.append(watermark)

    def rows(self) -> list:
        return [r for b in self.batches for r in b.iter_rows()]

    def clear(self) -> None:
        self.batches.clear()
        self.watermarks.clear()


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

    def notify_checkpoint_complete(self, checkpoint_id: int) -> None:
        """Every task acknowledged ``checkpoint_id`` and it is stored (a
        two-phase sink commits here)."""


class OneInputOperator(StreamOperator):
    def process_batch(self, batch: RecordBatch) -> None:
        raise NotImplementedError


class TwoInputOperator(StreamOperator):
    """Two-input operator: each input's watermark is kept, and the
    operator's watermark advances to the min across both."""

    def __init__(self, name: str = ""):
        super().__init__(name)
        self._input_watermarks = [MIN_TIMESTAMP, MIN_TIMESTAMP]

    def process_batch1(self, batch: RecordBatch) -> None:
        raise NotImplementedError

    def process_batch2(self, batch: RecordBatch) -> None:
        raise NotImplementedError

    def process_watermark_n(self, input_index: int,
                            watermark: Watermark) -> None:
        self._input_watermarks[input_index] = watermark.timestamp
        combined = min(self._input_watermarks)
        if combined > self.current_watermark:
            self.process_watermark(Watermark(combined))


class _ChainingOutput(Output):
    """Direct-call edge between chained operators."""

    def __init__(self, downstream: OneInputOperator):
        self._op = downstream

    def emit(self, batch: RecordBatch) -> None:
        if batch.n:
            self._op.process_batch(batch)

    def emit_watermark(self, watermark: Watermark) -> None:
        self._op.process_watermark(watermark)


class OperatorChain:
    """A fused sequence of operators run by one task. The head receives
    the task's input; the tail writes the task's output."""

    def __init__(self, operators: list, ctx: OperatorContext,
                 tail_output: Output):
        self.operators = operators
        self.ctx = ctx
        for i, op in enumerate(operators):
            # stable per-operator id for state snapshots (unique in the
            # chain): the reference's key, so checkpoints map across
            op._op_key = f"{i}:{op.name}"
        out = tail_output
        for op in reversed(operators):
            op.setup(ctx, out)
            out = _ChainingOutput(op)
        self.head = operators[0]

    def initialize_state(self, per_operator_snapshots) -> None:
        for op in self.operators:
            snaps = (per_operator_snapshots or {}).get(_op_key(op))
            op.initialize_state(
                snaps.get("keyed_list", []) if snaps else [],
                snaps.get("operator") if snaps else None)

    def open(self) -> None:
        for op in reversed(self.operators):  # downstream first
            op.open()

    def process_batch(self, batch: RecordBatch) -> None:
        self.head.process_batch(batch)

    def process_watermark(self, watermark: Watermark) -> None:
        self.head.process_watermark(watermark)

    def process_batch_n(self, input_index: int, batch: RecordBatch) -> None:
        """A batch to input 0 or 1 of a two-input head."""
        if input_index == 0:
            self.head.process_batch1(batch)
        else:
            self.head.process_batch2(batch)

    def process_watermark_n(self, input_index: int,
                            watermark: Watermark) -> None:
        self.head.process_watermark_n(input_index, watermark)

    def snapshot_state(self, checkpoint_id: int) -> dict:
        return {_op_key(op): op.snapshot_state(checkpoint_id)
                for op in self.operators}

    def notify_checkpoint_complete(self, checkpoint_id: int) -> None:
        for op in self.operators:
            op.notify_checkpoint_complete(checkpoint_id)

    def finish(self) -> None:
        for op in self.operators:
            op.finish()

    def close(self) -> None:
        for op in self.operators:
            op.close()


def _op_key(op: StreamOperator) -> str:
    return getattr(op, "_op_key", op.name)
