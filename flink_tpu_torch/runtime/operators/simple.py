"""Stateless and keyed-process operators (port of
``flink_tpu/runtime/operators/simple.py``).

``MapOperator``, ``FilterOperator`` and ``FlatMapOperator`` take the
function's vectorized batch path when it answers and fall back to a row
loop. A vectorized map or filter of a ``DeviceRecordBatch`` runs torch
ops where the batch lies; a filter's torch mask compacts the device batch
on the device, in batch order (the reference copies the batch home
first, ``RecordBatch.filter``; the rows and their order are the same).
``KeyedProcessOperator`` runs a process function a record at a time with
keyed state on the configured backend (``tpu``: the device row plane,
whose ``ValueState`` is ``row_get`` / ``row_set`` / ``row_unset``;
``hashmap``: the heap) and event- and processing-time timers.
``BatchFnOperator`` is the SQL planner's batch -> batch step.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional

import numpy as np

from ...core.elements import Watermark
from ...core.functions import Collector, FilterFunction, FlatMapFunction, \
    MapFunction, ProcessFunction, RuntimeContext, copy_per_subtask
from ...core.records import MIN_TIMESTAMP, RecordBatch, Schema, scalar
from ..timers import InternalTimerService, Timer
from .base import OneInputOperator, OperatorContext, Output

__all__ = ["MapOperator", "FilterOperator", "FlatMapOperator",
           "KeyedProcessOperator", "BatchFnOperator", "KeyExtractor"]

# KeyExtractor: RecordBatch -> np.ndarray of keys (one per row)
KeyExtractor = Callable[[RecordBatch], np.ndarray]


def _runtime_context(op: OneInputOperator,
                     state_backend=None) -> RuntimeContext:
    ctx = op.ctx
    return RuntimeContext(ctx.task_name, ctx.subtask_index, ctx.parallelism,
                          ctx.max_parallelism, state_backend=state_backend)


class MapOperator(OneInputOperator):
    def __init__(self, fn: MapFunction, out_schema: Optional[Schema] = None,
                 name: str = "Map"):
        super().__init__(name)
        self._fn = fn
        self._out_schema = out_schema

    def open(self) -> None:
        self._fn.open(_runtime_context(self))

    def process_batch(self, batch: RecordBatch) -> None:
        vec = self._fn.map_batch(batch)
        if vec is not None:
            self.output.emit(vec)
            return
        rows = [self._fn.map(r) for r in batch.iter_rows()]
        if not rows:
            return
        schema = self._out_schema
        if schema is None and isinstance(rows[0], tuple) \
                and len(rows[0]) == len(batch.schema) > 1:
            # a same-arity tuple keeps the input's column names, so a
            # later key_by("col") still finds its column
            schema = batch.schema
        out, self._out_schema = RecordBatch.from_rows_infer(
            schema, rows, batch.timestamps)
        self.output.emit(out)

    def close(self) -> None:
        self._fn.close()


class FilterOperator(OneInputOperator):
    def __init__(self, fn: FilterFunction, name: str = "Filter"):
        super().__init__(name)
        self._fn = fn

    def open(self) -> None:
        self._fn.open(_runtime_context(self))

    def process_batch(self, batch: RecordBatch) -> None:
        mask = self._fn.filter_batch(batch)
        if mask is None:
            mask = np.fromiter((bool(self._fn.filter(r))
                                for r in batch.iter_rows()),
                               dtype=bool, count=batch.n)
        if getattr(batch, "is_device", False) and not isinstance(
                mask, np.ndarray):
            self.output.emit(batch.compact(mask))
        else:
            self.output.emit(batch.filter(np.asarray(mask)))

    def close(self) -> None:
        self._fn.close()


class FlatMapOperator(OneInputOperator):
    def __init__(self, fn: FlatMapFunction,
                 out_schema: Optional[Schema] = None, name: str = "FlatMap"):
        super().__init__(name)
        self._fn = fn
        self._out_schema = out_schema

    def open(self) -> None:
        self._fn.open(_runtime_context(self))

    def process_batch(self, batch: RecordBatch) -> None:
        rows: list = []
        ts: list[int] = []
        stamps = batch.timestamps
        for i, r in enumerate(batch.iter_rows()):
            t = int(stamps[i])
            for out in self._fn.flat_map(r):
                rows.append(out)
                ts.append(t)
        if not rows:
            return
        out, self._out_schema = RecordBatch.from_rows_infer(
            self._out_schema, rows, ts)
        self.output.emit(out)

    def close(self) -> None:
        self._fn.close()


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


class _TimerApi:
    """The timer service a process function sees for one key."""

    __slots__ = ("_timers", "_key")

    def __init__(self, timers: InternalTimerService, key):
        self._timers, self._key = timers, key

    @property
    def current_watermark(self) -> int:
        return self._timers.current_watermark

    def register_event_time_timer(self, ts, namespace=None):
        self._timers.register_event_time_timer(self._key, ts, namespace)

    def register_processing_time_timer(self, ts, namespace=None):
        self._timers.register_processing_time_timer(self._key, ts, namespace)

    def delete_event_time_timer(self, ts, namespace=None):
        self._timers.delete_event_time_timer(self._key, ts, namespace)

    def delete_processing_time_timer(self, ts, namespace=None):
        self._timers.delete_processing_time_timer(self._key, ts, namespace)


class KeyedProcessOperator(OneInputOperator):
    """Keyed per-record processing with timers and keyed state. The
    backend is the configured one; ``device`` is where the device
    backend keeps it (the card unless the caller asks for the CPU)."""

    def __init__(self, fn: ProcessFunction, key_extractor: KeyExtractor,
                 out_schema: Optional[Schema] = None,
                 name: str = "KeyedProcess", device=None):
        super().__init__(name)
        # a copy per subtask: a shared instance would cross-wire the state
        # handles cached in open() between subtasks
        self._fn = copy_per_subtask(fn)
        self._key_extractor = key_extractor
        self._out_schema = out_schema
        self._device = device
        self._backend = None
        self._timers: Optional[InternalTimerService] = None
        self._pending_rows: list = []
        self._pending_ts: list[int] = []

    # -- lifecycle ---------------------------------------------------------
    def setup(self, ctx: OperatorContext, output: Output) -> None:
        super().setup(ctx, output)
        kw = {} if self._device is None else {"device": self._device}
        self._backend = ctx.create_keyed_backend(**kw)
        self._timers = InternalTimerService(
            ctx.key_group_range, ctx.max_parallelism,
            on_event_time=self._fire_timer_event,
            on_processing_time=self._fire_timer_proc)

    def initialize_state(self, keyed_snapshots: list,
                         operator_snapshot) -> None:
        if keyed_snapshots:
            self._backend.restore([s["backend"] for s in keyed_snapshots])
            self._timers.restore([s["timers"] for s in keyed_snapshots])

    def open(self) -> None:
        self._fn.open(_runtime_context(self, self._backend))

    # -- helpers -----------------------------------------------------------
    def _collector(self) -> Collector:
        def sink(value, timestamp):
            self._pending_rows.append(value)
            self._pending_ts.append(
                MIN_TIMESTAMP if timestamp is None else int(timestamp))
        return Collector(sink)

    def _side_collector(self, tag: str, value: Any, timestamp) -> None:
        # a schema per value, as the reference infers one
        schema = Schema.infer(value)
        self.output.emit_side(tag, RecordBatch.from_rows(
            schema, [value],
            [MIN_TIMESTAMP if timestamp is None else timestamp]))

    def _flush_pending(self) -> None:
        if not self._pending_rows:
            return
        out, self._out_schema = RecordBatch.from_rows_infer(
            self._out_schema, self._pending_rows, self._pending_ts)
        self.output.emit(out)
        self._pending_rows, self._pending_ts = [], []

    # -- data path ---------------------------------------------------------
    def process_batch(self, batch: RecordBatch) -> None:
        keys = self._key_extractor(batch)
        stamps = batch.timestamps
        out = self._collector()
        for i, row in enumerate(batch.iter_rows()):
            key = scalar(keys[i])
            self._backend.set_current_key(key)
            ts = int(stamps[i])
            ctx = ProcessFunction.Context(
                None if ts == MIN_TIMESTAMP else ts,
                _TimerApi(self._timers, key), current_key=key,
                side_collector=self._side_collector)
            self._fn.process_element(row, ctx, out)
        self._flush_pending()

    def _fire_timer_event(self, timer: Timer) -> None:
        self._fire_timer(timer, "event")

    def _fire_timer_proc(self, timer: Timer) -> None:
        self._fire_timer(timer, "processing")

    def _fire_timer(self, timer: Timer, domain: str) -> None:
        self._backend.set_current_key(timer.key)
        ctx = ProcessFunction.OnTimerContext(
            timer.timestamp, _TimerApi(self._timers, timer.key), domain,
            timer.key, side_collector=self._side_collector)
        self._fn.on_timer(timer.timestamp, ctx, self._collector())

    def process_watermark(self, watermark: Watermark) -> None:
        self._timers.advance_watermark(watermark.timestamp)
        self._flush_pending()
        super().process_watermark(watermark)

    def advance_processing_time(self, now_ms: int) -> None:
        self._timers.advance_processing_time(now_ms)
        self._flush_pending()

    # -- checkpointing -----------------------------------------------------
    def snapshot_state(self, checkpoint_id: int) -> dict:
        return {"keyed": {"backend": self._backend.snapshot(checkpoint_id),
                          "timers": self._timers.snapshot()}}

    def close(self) -> None:
        self._fn.close()
