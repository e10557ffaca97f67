"""Stream operator base (trimmed port of
``flink_tpu/runtime/operators/base.py``).

Operators are batch-oriented: ``process_batch`` receives a whole
RecordBatch and watermarks arrive through ``process_watermark`` in channel
order. Chained operators call each other directly; ``OperatorChain`` is
the fused sequence one task runs, and it routes tagged side outputs to
the task's side writers. A ``TwoInputOperator`` heads a chain of a
two-input task: ``process_batch1/2`` per input, and its watermark is the
min across the inputs. The task's loop advances processing time through
the chain (``advance_processing_time``), which fires processing-time
timers.

Each operator pins itself as the device-time ledger's owner of the work
it dispatches while it runs. A chained call hands the pin to the
downstream operator and gives it back when that call returns, so work
an operator dispatches after it emits stays its own (the reference
leaves the downstream operator pinned, ROADMAP Queue 3's kept
differences).

Latency markers ride the chain: every operator counts a marker
(``latency_markers_seen``), records the ms since the source marked it
into its ``latency`` histogram when the job has a metric registry, and
forwards it. A marker touches no device work, so on a device window's
chain it costs no host sync. A completed or aborted checkpoint reaches
an operator's keyed backend (``_backend``), which may prune artifacts
then (the changelog backend's generations).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ...core.config import Configuration
from ...core.elements import LatencyMarker, Watermark
from ...core.keygroups import KeyGroupRange, key_group_range_for_operator
from ...core.records import MIN_TIMESTAMP, RecordBatch
from ...metrics.profiler import DEVICE_LEDGER, dispatch_context, \
    set_dispatch_context

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
    #: the task's clock in ms (the harness injects a manual one)
    processing_time: Callable[[], int] = lambda: int(time.time() * 1000)
    #: the task's ``TaskMetrics`` (a job run with a metric registry)
    metrics: Any = None
    #: the job's queryable-state registry (``state/queryable.py``)
    kv_registry: Any = None

    @property
    def key_group_range(self) -> KeyGroupRange:
        return key_group_range_for_operator(
            self.max_parallelism, self.parallelism, self.subtask_index)

    def create_keyed_backend(self, name: Optional[str] = None, **kwargs):
        """The keyed backend of this subtask's range: ``name`` overrides
        the configured ``state.backend.type`` (an operator whose state
        shapes a partial backend cannot hold pins one that can);
        ``kwargs`` go to the backend (the device backend's ``device``)."""
        from ...state.backend import create_backend
        if name is None:
            name = self.config.get("state.backend.type")
        backend = create_backend(name, self.key_group_range,
                                 self.max_parallelism, config=self.config,
                                 **kwargs)
        backend.kv_registry = self.kv_registry
        return backend


class Output:
    """Downstream edge of an operator."""

    def emit(self, batch: RecordBatch) -> None:
        raise NotImplementedError

    def emit_watermark(self, watermark: Watermark) -> None:
        raise NotImplementedError

    def emit_latency_marker(self, marker: LatencyMarker) -> None:
        pass

    def emit_side(self, tag: str, batch: RecordBatch) -> None:
        """A tagged side output (``late-data``, ``dead-letter``, a process
        function's tags); the runtime routes it to the edges that
        ``get_side_output(tag)`` made."""
        raise NotImplementedError(f"no side output wired for tag {tag!r}")


class CollectingOutput(Output):
    """Buffers everything: the tail of the test harness."""

    def __init__(self):
        self.batches: list[RecordBatch] = []
        self.watermarks: list[Watermark] = []
        self.latency_markers: list[LatencyMarker] = []
        self.side: dict[str, list[RecordBatch]] = {}

    def emit_latency_marker(self, marker: LatencyMarker) -> None:
        self.latency_markers.append(marker)

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
        self.side.clear()


class StreamOperator:
    """Lifecycle: setup -> initialize_state -> open -> process -> finish
    -> close."""

    def __init__(self, name: str = ""):
        self.name = name or type(self).__name__
        self.ctx: OperatorContext = None  # type: ignore[assignment]
        self.output: Output = None  # type: ignore[assignment]
        self.current_watermark: int = MIN_TIMESTAMP
        self._ledger_job = ""
        self._ledger_ident = self.name
        self._latency_hist = None
        self.latency_markers_seen = 0

    def setup(self, ctx: OperatorContext, output: Output) -> None:
        self.ctx = ctx
        self.output = output
        # device-time ledger attribution: the owning job's name and the
        # chain-stable operator key (see OperatorChain)
        self._ledger_job = str(ctx.config.get("pipeline.name"))
        self._ledger_ident = getattr(self, "_op_key", self.name)
        metrics = ctx.metrics
        if metrics is not None:
            # the operator's scope under its task: watermark gauges and
            # the latency histogram
            g = metrics.operator_group(self._ledger_ident)
            g.gauge("currentInputWatermark", lambda: self.current_watermark)
            g.gauge("watermarkLag", self._watermark_lag_ms)
            self._latency_hist = g.histogram("latency")

    def _watermark_lag_ms(self) -> float:
        """Wall ms behind the operator's watermark; NaN before the first."""
        if self.current_watermark <= MIN_TIMESTAMP:
            return float("nan")
        return max(0, int(time.time() * 1000) - self.current_watermark)

    def _enter_dispatch(self) -> None:
        """Pin this operator as the (job, operator) owner of the ledger
        samples recorded on this thread: called at every batch and
        watermark entry. One attribute read when the ledger is off."""
        if DEVICE_LEDGER.enabled:
            set_dispatch_context(self._ledger_job, self._ledger_ident)

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

    def process_latency_marker(self, marker: LatencyMarker) -> None:
        """Count the marker, record the ms since the source marked it,
        and forward it."""
        self.latency_markers_seen += 1
        if self._latency_hist is not None:
            self._latency_hist.update(
                (time.time() - marker.marked_time) * 1e3)
        self.output.emit_latency_marker(marker)

    def advance_processing_time(self, now_ms: int) -> None:
        """Driven by the task's loop: fires processing-time timers."""

    def snapshot_state(self, checkpoint_id: int) -> dict:
        return {}

    def notify_checkpoint_complete(self, checkpoint_id: int,
                                   is_savepoint: bool = False) -> None:
        """Every task acknowledged ``checkpoint_id`` and it is stored (a
        two-phase sink commits here). A keyed backend that prunes on
        subsumption (the changelog backend) hears of it."""
        backend = getattr(self, "_backend", None)
        if backend is not None and hasattr(backend,
                                           "notify_checkpoint_complete"):
            backend.notify_checkpoint_complete(checkpoint_id,
                                               is_savepoint=is_savepoint)

    def notify_checkpoint_aborted(self, checkpoint_id: int) -> None:
        """``checkpoint_id`` will not complete (declined, timed out or
        paused): a backend drops what it pinned for it."""
        backend = getattr(self, "_backend", None)
        if backend is not None and hasattr(backend,
                                           "notify_checkpoint_aborted"):
            backend.notify_checkpoint_aborted(checkpoint_id)


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
    """Direct-call edge between chained operators; tagged side outputs go
    to the task's side outputs."""

    def __init__(self, downstream: OneInputOperator,
                 side_router: Optional[dict] = None):
        self._op = downstream
        self._side = side_router or {}

    def _call(self, fn, arg) -> None:
        """Run the downstream ``fn(arg)`` as the ledger's owner, then give
        the pin back to the caller."""
        if not DEVICE_LEDGER.enabled:
            fn(arg)
            return
        caller = dispatch_context()
        self._op._enter_dispatch()
        try:
            fn(arg)
        finally:
            set_dispatch_context(*caller)

    def emit(self, batch: RecordBatch) -> None:
        if batch.n:
            self._call(self._op.process_batch, batch)

    def emit_watermark(self, watermark: Watermark) -> None:
        self._call(self._op.process_watermark, watermark)

    def emit_latency_marker(self, marker: LatencyMarker) -> None:
        self._op.process_latency_marker(marker)

    def emit_side(self, tag: str, batch: RecordBatch) -> None:
        out = self._side.get(tag)
        if out is not None:
            out.emit(batch)


class OperatorChain:
    """A fused sequence of operators run by one task. The head receives
    the task's input; the tail writes the task's output."""

    def __init__(self, operators: list, ctx: OperatorContext,
                 tail_output: Output, side_outputs: Optional[dict] = None):
        self.operators = operators
        self.ctx = ctx
        for i, op in enumerate(operators):
            # stable per-operator id for state snapshots (unique in the
            # chain): the reference's key, so checkpoints map across
            op._op_key = f"{i}:{op.name}"
        out = tail_output
        for op in reversed(operators):
            op.setup(ctx, out)
            out = _ChainingOutput(op, side_outputs)
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
        self.head._enter_dispatch()
        self.head.process_batch(batch)

    def process_watermark(self, watermark: Watermark) -> None:
        self.head._enter_dispatch()
        self.head.process_watermark(watermark)

    def process_batch_n(self, input_index: int, batch: RecordBatch) -> None:
        """A batch to input 0 or 1 of a two-input head."""
        self.head._enter_dispatch()
        if input_index == 0:
            self.head.process_batch1(batch)
        else:
            self.head.process_batch2(batch)

    def process_watermark_n(self, input_index: int,
                            watermark: Watermark) -> None:
        self.head._enter_dispatch()
        self.head.process_watermark_n(input_index, watermark)

    def process_latency_marker(self, marker: LatencyMarker) -> None:
        """A latency marker through every chained operator (each records
        its latency) out to the tail."""
        self.head.process_latency_marker(marker)

    def advance_processing_time(self, now_ms: int) -> None:
        for op in self.operators:
            op.advance_processing_time(now_ms)

    def snapshot_state(self, checkpoint_id: int) -> dict:
        return {_op_key(op): op.snapshot_state(checkpoint_id)
                for op in self.operators}

    def notify_checkpoint_complete(self, checkpoint_id: int,
                                   is_savepoint: bool = False) -> None:
        for op in self.operators:
            op.notify_checkpoint_complete(checkpoint_id,
                                          is_savepoint=is_savepoint)

    def notify_checkpoint_aborted(self, checkpoint_id: int) -> None:
        for op in self.operators:
            op.notify_checkpoint_aborted(checkpoint_id)

    def finish(self) -> None:
        for op in self.operators:
            op.finish()

    def close(self) -> None:
        for op in self.operators:
            op.close()


def _op_key(op: StreamOperator) -> str:
    return getattr(op, "_op_key", op.name)
