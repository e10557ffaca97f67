"""Keyed window operator on the host (port of
``flink_tpu/runtime/operators/window.py``).

The general window path: any assigner (merging session windows through a
merging-window set, processing-time windows, global windows, CUMULATE),
any trigger, evictors, allowed lateness and the ``late-data`` side
output. Window contents live in keyed state under namespace = window;
cleanup timers are (key, window.max_timestamp + allowed_lateness). A
non-merging event-time assigner with the default trigger, an incremental
aggregate, no evictor and lateness 0 takes the grouped path
(``_process_batch_grouped``): one state access and one timer a distinct
(key, window) of a batch, numpy partial folds for builtin aggregates.

When the configured backend is the partial device one (``tpu``), the
namespaced list, aggregating and map state goes to the heap backend
(``hashmap``), as in the reference; a full backend keeps it.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Optional

import numpy as np

from ...core.elements import Watermark
from ...core.functions import AggregateFunction, ReduceAggregate, \
    ReduceFunction
from ...core.records import MAX_TIMESTAMP, MIN_TIMESTAMP, RecordBatch, \
    Schema, scalar
from ...state.backend import backend_supports_general_state
from ...state.descriptors import (
    AggregatingStateDescriptor, ListStateDescriptor, MapStateDescriptor,
)
from ...window.assigners import TimeWindow, WindowAssigner
from ...window.triggers import Evictor, Trigger, TriggerContext, TriggerResult
from ..timers import InternalTimerService, Timer
from .base import OneInputOperator, OperatorContext, Output
from .simple import KeyExtractor, _runtime_context

__all__ = ["WindowOperator", "WindowFunction", "LATE_DATA_TAG"]

LATE_DATA_TAG = "late-data"

# (key, window, result_or_elements) -> iterable of output rows
WindowFunction = Callable[[Any, Any, Any], Iterable[Any]]


def _default_window_fn(key, window, result):
    yield (key, result)


class _TriggerStateAccessor:
    def __init__(self, op: "WindowOperator", window):
        self._op, self._window = op, window

    def _map(self):
        self._op._backend.set_current_namespace(self._window)
        return self._op._backend.get_partitioned_state(self._op._trigger_desc)

    def get(self, name, default=None):
        v = self._map().get(name)
        return default if v is None else v

    def set(self, name, value):
        self._map().put(name, value)

    def clear(self, name):
        self._map().remove(name)


class WindowOperator(OneInputOperator):
    def __init__(self, assigner: WindowAssigner, key_extractor: KeyExtractor,
                 aggregate: Optional[AggregateFunction] = None,
                 reduce: Optional[ReduceFunction] = None,
                 window_fn: Optional[WindowFunction] = None,
                 trigger: Optional[Trigger] = None,
                 evictor: Optional[Evictor] = None,
                 allowed_lateness: int = 0,
                 emit_late_data: bool = False,
                 out_schema: Optional[Schema] = None,
                 name: str = "Window"):
        super().__init__(name)
        if aggregate is not None and reduce is not None:
            raise ValueError("Provide aggregate or reduce, not both")
        if reduce is not None:
            aggregate = ReduceAggregate(reduce)
        # evictor path keeps raw elements in list state (reference
        # EvictingWindowOperator); otherwise incremental aggregation
        self._evictor = evictor
        self._aggregate = aggregate
        self._assigner = assigner
        self._key_extractor = key_extractor
        self._window_fn = window_fn or _default_window_fn
        self._trigger = trigger or assigner.default_trigger()
        self._allowed_lateness = int(allowed_lateness)
        self._emit_late_data = emit_late_data
        self._out_schema = out_schema
        if assigner.is_merging and evictor is not None:
            raise ValueError("Evictors are not supported with merging windows")
        if assigner.is_merging and not self._trigger.can_merge():
            raise ValueError("Trigger cannot merge for merging window assigner")

        if self._evictor is not None or self._aggregate is None:
            self._contents_desc = ListStateDescriptor("window-contents")
        else:
            self._contents_desc = AggregatingStateDescriptor(
                "window-contents", self._aggregate)
        self._trigger_desc = MapStateDescriptor("window-trigger-state")
        self._merging_desc = MapStateDescriptor("merging-window-set")

        self._backend = None
        self._timers: Optional[InternalTimerService] = None
        self._pending_rows: list = []
        self._pending_ts: list[int] = []

    # -- lifecycle ---------------------------------------------------------
    def setup(self, ctx: OperatorContext, output: Output) -> None:
        super().setup(ctx, output)
        # per-(key, window) namespaced list/aggregating state: the heap
        # backend when the configured one is partial (the device value
        # plane)
        configured = ctx.config.get("state.backend.type")
        self._backend = ctx.create_keyed_backend(
            name=None if backend_supports_general_state(configured)
            else "hashmap")
        self._timers = InternalTimerService(
            ctx.key_group_range, ctx.max_parallelism,
            on_event_time=self._on_event_time,
            on_processing_time=self._on_processing_time)

    def initialize_state(self, keyed_snapshots: list, operator_snapshot) -> None:
        if keyed_snapshots:
            self._backend.restore([s["backend"] for s in keyed_snapshots])
            self._timers.restore([s["timers"] for s in keyed_snapshots])

    def open(self) -> None:
        if self._aggregate is not None:
            self._aggregate.open(_runtime_context(self, self._backend))

    # -- state helpers -----------------------------------------------------
    def _contents(self, window):
        self._backend.set_current_namespace(window)
        return self._backend.get_partitioned_state(self._contents_desc)

    def _trigger_ctx(self, key, window) -> TriggerContext:
        return TriggerContext(key, window, self._timers,
                              _TriggerStateAccessor(self, window),
                              self.current_watermark)

    def _cleanup_time(self, window) -> int:
        if self._assigner.is_event_time:
            t = window.max_timestamp + self._allowed_lateness
            return t if t >= window.max_timestamp else MAX_TIMESTAMP
        return window.max_timestamp

    def _register_cleanup(self, key, window) -> None:
        """Cleanup timer uses namespace=window, same as trigger timers, so at
        allowed_lateness=0 the fire timer and the cleanup timer are ONE timer
        (exactly the reference's registerCleanupTimer behavior)."""
        t = self._cleanup_time(window)
        if t == MAX_TIMESTAMP:
            return
        if self._assigner.is_event_time:
            self._timers.register_event_time_timer(key, t, window)
        else:
            self._timers.register_processing_time_timer(key, t, window)

    def _is_window_late(self, window) -> bool:
        return (self._assigner.is_event_time and
                self._cleanup_time(window) <= self.current_watermark)

    # -- merging window set (reference MergingWindowSet) -------------------
    def _merge_set(self):
        self._backend.set_current_namespace(None)
        return self._backend.get_partitioned_state(self._merging_desc)

    def _add_merging_window(self, key, new_window: TimeWindow) -> Optional[TimeWindow]:
        """Insert new_window, merging any overlapping windows. Returns the
        actual (possibly merged) window, or None if the element is too late.
        Window contents stay under a stable 'state window' namespace; merges
        fold accumulators together."""
        mset = self._merge_set()
        mapping: dict = dict(mset.items())  # actual window -> state window
        overlapping = [w for w in mapping if w.intersects(new_window)]
        merged = new_window
        for w in overlapping:
            merged = merged.cover(w)

        if not overlapping:
            mapping[new_window] = new_window
            actual = new_window
        elif len(overlapping) == 1 and overlapping[0] == merged:
            actual = merged
        else:
            # merge state: fold all state windows into the first's. NOTE the
            # state handle is namespace-context-sensitive — switch the
            # backend's current namespace around every access.
            state_windows = [mapping[w] for w in overlapping]
            target_state = state_windows[0]
            handle = self._contents(target_state)
            for sw in state_windows[1:]:
                self._backend.set_current_namespace(sw)
                if self._contents_desc.kind == "aggregating":
                    acc = handle.get_accumulator()
                    self._backend.set_current_namespace(sw)
                    handle.clear()
                    if acc is not None:
                        self._backend.set_current_namespace(target_state)
                        handle.merge_accumulator(acc)
                else:
                    items = list(handle.get())
                    self._backend.set_current_namespace(sw)
                    handle.clear()
                    if items:
                        self._backend.set_current_namespace(target_state)
                        for it in items:
                            handle.add(it)
            for w in overlapping:
                ctx = self._trigger_ctx(key, w)
                self._trigger.clear(w, ctx)
                # the absorbed window's CLEANUP timer lives in the time
                # domain the assigner registered it in — deleting only the
                # event-time one would leave a stale processing-time timer
                # that later wipes the merged session's state
                if self._assigner.is_event_time:
                    self._timers.delete_event_time_timer(
                        key, self._cleanup_time(w), w)
                else:
                    self._timers.delete_processing_time_timer(
                        key, self._cleanup_time(w), w)
                del mapping[w]
            mapping[merged] = target_state
            self._trigger.on_merge(merged, self._trigger_ctx(key, merged))
            actual = merged

        new_map = self._merge_set()
        new_map.clear()
        for aw, sw in mapping.items():
            new_map.put(aw, sw)
        return actual

    def _state_window_for(self, actual_window):
        if not self._assigner.is_merging:
            return actual_window
        sw = self._merge_set().get(actual_window)
        return sw if sw is not None else actual_window

    # -- data path ---------------------------------------------------------
    def process_batch(self, batch: RecordBatch) -> None:
        if self._aggregate is not None and hasattr(self._aggregate, "bind_schema"):
            self._aggregate.bind_schema(batch.schema)
        keys = self._key_extractor(batch)
        if self._process_batch_grouped(batch, keys):
            return
        stamps = batch.timestamps
        for i in range(batch.n):
            key = scalar(keys[i])
            ts = int(stamps[i])
            if ts == MIN_TIMESTAMP and self._assigner.is_event_time:
                ts = self.current_watermark  # no timestamp: treat as on-time
            row = batch.row(i)
            self._backend.set_current_key(key)
            element_ts = ts if self._assigner.is_event_time \
                else self.ctx.processing_time()
            windows = self._assigner.assign_windows(element_ts)

            handled_any = False
            for window in windows:
                if self._assigner.is_merging:
                    window = self._add_merging_window(key, window)
                    if window is None:
                        continue
                if self._is_window_late(window):
                    continue
                handled_any = True
                state_window = self._state_window_for(window)
                contents = self._contents(state_window)
                if self._contents_desc.kind == "aggregating":
                    contents.add(row)
                else:
                    contents.add((row, ts))
                self._register_cleanup(key, window)
                result = self._trigger.on_element(
                    ts, window, self._trigger_ctx(key, window))
                self._handle_trigger_result(key, window, result)

            if not handled_any and self._assigner.is_event_time:
                if self._emit_late_data:
                    self.output.emit_side(
                        LATE_DATA_TAG,
                        RecordBatch.from_rows(batch.schema, [row], [ts]))
        self._flush_pending()

    def _process_batch_grouped(self, batch: RecordBatch, keys) -> bool:
        """Grouped fast path for the common window shape — non-merging
        event-time assigner, default EventTimeTrigger, incremental
        aggregation, no evictor, allowed_lateness 0: ONE state resolution
        and ONE timer registration per distinct (key, window) per batch
        instead of per record, with numpy partial folds for builtin
        aggregates (the host twin of the device operator's batch fold;
        reference shape: MiniBatch windowed aggregation). Returns False
        when the configuration needs the per-record path."""
        from ...window.assigners import (
            SlidingEventTimeWindows, TumblingEventTimeWindows,
        )
        from ...window.triggers import EventTimeTrigger

        a = self._assigner
        if (a.is_merging or self._evictor is not None
                or self._contents_desc.kind != "aggregating"
                or type(self._trigger) is not EventTimeTrigger
                or not a.is_event_time
                or self._allowed_lateness != 0
                or batch.n == 0):
            return False
        if isinstance(a, TumblingEventTimeWindows):
            size, slide, offset = a.size, a.size, a.offset
        elif isinstance(a, SlidingEventTimeWindows):
            size, slide, offset = a.size, a.slide, a.offset
            if size % slide != 0:
                return False
        else:
            return False
        ts = batch.timestamps
        if bool((ts == MIN_TIMESTAMP).any()):
            return False
        nwin = size // slide
        last_start = (ts - ((ts - offset) % slide)).astype(np.int64)
        wm = self.current_watermark
        # vectorizable builtin fold? (sum/min/max/count over one column)
        bk = getattr(self._aggregate, "builtin_kind", None)
        bf = getattr(self._aggregate, "builtin_field", None)
        col = None
        if bk in ("sum", "min", "max") or (bk == "count" and bf is None):
            if bk == "count":
                col = np.ones(batch.n, np.int64)
            elif isinstance(bf, str) and bf in batch.schema:
                col = np.asarray(batch.column(bf))
            elif isinstance(bf, int):
                col = np.asarray(
                    batch.columns[batch.schema.fields[bf].name])
            elif isinstance(bf, str) and len(batch.schema) == 1:
                col = np.asarray(batch.column(batch.schema.fields[0].name))
            if col is not None and col.dtype == object:
                col = None
        rows = None if col is not None else list(batch.iter_rows())
        # group (key, window_start) -> row indices; at lateness 0 the
        # EventTimeTrigger never fires on add (a passed window is late),
        # so grouping changes no observable behavior, only the number of
        # state/namespace round-trips
        groups: dict = {}
        newest_late = None
        for j in range(nwin):
            starts = last_start - j * slide
            late = starts + size - 1 <= wm
            if j == 0:
                newest_late = late
            for i in np.flatnonzero(~late):
                k = scalar(keys[i])
                groups.setdefault((k, int(starts[i])), []).append(i)
        if self._emit_late_data and newest_late is not None \
                and newest_late.any():
            idx = np.flatnonzero(newest_late)
            self.output.emit_side(LATE_DATA_TAG, batch.take(idx))
        reducers = {"sum": np.sum, "min": np.min, "max": np.max,
                    "count": np.sum}
        reduce_fn = reducers[bk] if col is not None else None
        backend = self._backend
        # state handles read the backend's CURRENT key/namespace at access
        # time, so one handle serves every group (resolving it per group
        # was ~15% of this loop)
        backend.set_current_namespace(TimeWindow(0, size))
        contents = backend.get_partitioned_state(self._contents_desc)
        can_merge = hasattr(contents, "merge_accumulator")
        register = self._timers.register_event_time_timer
        for (key, start), idxs in groups.items():
            window = TimeWindow(start, start + size)
            backend.set_current_key(key)
            backend.set_current_namespace(window)
            if col is not None and can_merge:
                part = reduce_fn(col[idxs])
                contents.merge_accumulator(scalar(part))
            else:
                for i in idxs:
                    contents.add(rows[i])
            # at allowed_lateness 0 the trigger's fire timer and the
            # cleanup timer are ONE timer at window.max_timestamp (the
            # per-record path documents the same collapse)
            register(key, window.max_timestamp, window)
        self._flush_pending()
        return True

    # -- firing ------------------------------------------------------------
    def _handle_trigger_result(self, key, window, result: TriggerResult) -> None:
        if result.fires:
            self._emit_window_contents(key, window)
        if result.purges:
            self._clear_window_contents(key, window)

    def _emit_window_contents(self, key, window) -> None:
        state_window = self._state_window_for(window)
        contents = self._contents(state_window)
        if self._contents_desc.kind == "aggregating":
            result = contents.get()
            if result is None:
                return
            out_rows = list(self._window_fn(key, window, result))
        else:
            elements = list(contents.get())
            if not elements:
                return
            if self._evictor is not None:
                elements = self._evictor.evict_before(
                    elements, window, self.current_watermark)
            if self._aggregate is not None:
                acc = self._aggregate.create_accumulator()
                for v, _ts in elements:
                    acc = self._aggregate.add(v, acc)
                payload = self._aggregate.get_result(acc)
            else:
                payload = [v for v, _ts in elements]
            out_rows = list(self._window_fn(key, window, payload))
            if self._evictor is not None:
                remaining = self._evictor.evict_after(
                    elements, window, self.current_watermark)
                contents.update(remaining)
        ts = window.max_timestamp if window.max_timestamp < MAX_TIMESTAMP \
            else self.current_watermark
        self._pending_rows.extend(out_rows)
        self._pending_ts.extend([ts] * len(out_rows))

    def _clear_window_contents(self, key, window) -> None:
        self._contents(self._state_window_for(window)).clear()

    def _clear_all_state(self, key, window) -> None:
        self._clear_window_contents(key, window)
        ctx = self._trigger_ctx(key, window)
        self._trigger.clear(window, ctx)
        self._backend.set_current_namespace(window)
        self._backend.get_partitioned_state(self._trigger_desc).clear()
        if self._assigner.is_merging:
            mset = self._merge_set()
            mset.remove(window)

    # -- timers ------------------------------------------------------------
    def _on_event_time(self, timer: Timer) -> None:
        self._fire_timer(timer, event_time=True)

    def _on_processing_time(self, timer: Timer) -> None:
        self._fire_timer(timer, event_time=False)

    def _fire_timer(self, timer: Timer, event_time: bool) -> None:
        key = timer.key
        window = timer.namespace
        if window is None:
            return
        self._backend.set_current_key(key)
        self._fire_via_trigger(key, window, timer.timestamp, event_time)
        # reference onEventTime/onProcessingTime: after the trigger runs, a
        # timer at cleanup time clears all window state
        if (event_time == self._assigner.is_event_time
                and timer.timestamp == self._cleanup_time(window)):
            self._clear_all_state(key, window)
        # no flush here: one watermark advance fires MANY timers (every
        # closed window of every key) and process_watermark flushes once
        # after the sweep — a per-timer flush built a one-row RecordBatch
        # per fired window

    def _fire_via_trigger(self, key, window, ts: int, event_time: bool) -> None:
        ctx = self._trigger_ctx(key, window)
        if event_time:
            result = self._trigger.on_event_time(ts, window, ctx)
        else:
            result = self._trigger.on_processing_time(ts, window, ctx)
        self._handle_trigger_result(key, window, result)

    def process_watermark(self, watermark: Watermark) -> None:
        self.current_watermark = watermark.timestamp
        self._timers.advance_watermark(watermark.timestamp)
        self._flush_pending()
        self.output.emit_watermark(watermark)

    def advance_processing_time(self, now_ms: int) -> None:
        self._timers.advance_processing_time(now_ms)
        self._flush_pending()

    def _flush_pending(self) -> None:
        if not self._pending_rows:
            return
        out, self._out_schema = RecordBatch.from_rows_infer(
            self._out_schema, self._pending_rows, self._pending_ts)
        self.output.emit(out)
        self._pending_rows, self._pending_ts = [], []

    # -- checkpointing -----------------------------------------------------
    def snapshot_state(self, checkpoint_id: int) -> dict:
        return {"keyed": {"backend": self._backend.snapshot(checkpoint_id),
                          "timers": self._timers.snapshot()}}
