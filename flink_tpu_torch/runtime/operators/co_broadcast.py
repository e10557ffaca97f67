"""A keyed stream connected to a broadcast stream (port of
``flink_tpu/runtime/operators/co_broadcast.py``).

Flink's CoBroadcastWithKeyedOperator, behind
``BroadcastConnectedStream.process``: input 1 is the keyed stream, input
2 the broadcast one. Every subtask receives every broadcast record and
applies it to its own replica of the broadcast maps, so the replicas
stay equal as long as the function's broadcast-side updates are
deterministic. The keyed side has the keyed state of the configured
backend and event-time timers, as ``KeyedProcessOperator``.

The broadcast maps go in the operator snapshot under ``"broadcast"``;
every subtask writes an equal copy. A restore at the same parallelism
takes each subtask's own copy; on a rescale every new subtask takes the
first (``checkpoint/coordinator.py::redistribute_operator_state``).
"""

from __future__ import annotations

from typing import Optional

from ...core.functions import Collector, KeyedBroadcastProcessFunction, \
    _ReadOnlyMap, copy_per_subtask
from ...core.records import MIN_TIMESTAMP, RecordBatch, Schema, scalar
from ..timers import InternalTimerService, Timer
from .base import OperatorContext, Output, TwoInputOperator
from .simple import _runtime_context, _TimerApi

__all__ = ["CoBroadcastWithKeyedOperator"]


class CoBroadcastWithKeyedOperator(TwoInputOperator):
    def __init__(self, fn: KeyedBroadcastProcessFunction, key_extractor,
                 descriptors, out_schema: Optional[Schema] = None,
                 name: str = "CoBroadcastWithKeyed", device=None):
        super().__init__(name)
        self._fn = copy_per_subtask(fn)
        self._key_extractor = key_extractor
        self._descriptors = list(descriptors)
        self._maps: dict[str, dict] = {d.name: {} for d in self._descriptors}
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
            on_event_time=self._fire_timer, on_processing_time=None)

    def initialize_state(self, keyed_snapshots: list,
                         operator_snapshot) -> None:
        if keyed_snapshots:
            self._backend.restore([s["backend"] for s in keyed_snapshots])
            self._timers.restore([s["timers"] for s in keyed_snapshots])
        for name, m in ((operator_snapshot or {}).get("broadcast")
                        or {}).items():
            self._maps[name] = dict(m)

    def open(self) -> None:
        self._fn.open(_runtime_context(self, self._backend))

    def close(self) -> None:
        self._fn.close()

    # -- the broadcast maps ------------------------------------------------
    def _view(self, name: str) -> _ReadOnlyMap:
        return _ReadOnlyMap(self._maps[name])

    def _rw(self, name: str) -> dict:
        return self._maps[name]

    def _collector(self) -> Collector:
        def sink(value, timestamp):
            self._pending_rows.append(value)
            self._pending_ts.append(
                MIN_TIMESTAMP if timestamp is None else int(timestamp))
        return Collector(sink)

    def _flush_pending(self) -> None:
        if not self._pending_rows:
            return
        out, self._out_schema = RecordBatch.from_rows_infer(
            self._out_schema, self._pending_rows, self._pending_ts)
        self.output.emit(out)
        self._pending_rows, self._pending_ts = [], []

    # -- data path ---------------------------------------------------------
    def process_batch1(self, batch: RecordBatch) -> None:
        keys = self._key_extractor(batch)
        stamps = batch.timestamps.tolist()
        out = self._collector()
        for i, row in enumerate(batch.iter_rows()):
            key = scalar(keys[i])
            self._backend.set_current_key(key)
            ts = stamps[i]
            ctx = KeyedBroadcastProcessFunction.ReadOnlyContext(
                None if ts == MIN_TIMESTAMP else ts, key, self._view,
                timer_service=_TimerApi(self._timers, key))
            self._fn.process_element(row, ctx, out)
        self._flush_pending()

    def process_batch2(self, batch: RecordBatch) -> None:
        stamps = batch.timestamps.tolist()
        out = self._collector()
        for i, row in enumerate(batch.iter_rows()):
            ts = stamps[i]
            ctx = KeyedBroadcastProcessFunction.Context(
                None if ts == MIN_TIMESTAMP else ts, self._rw,
                apply_keyed=self._apply_to_keyed_state)
            self._fn.process_broadcast_element(row, ctx, out)
        self._flush_pending()

    def _apply_to_keyed_state(self, descriptor, fn) -> None:
        for key in list(self._backend.keys(descriptor.name)):
            self._backend.set_current_key(key)
            fn(key, self._backend.get_partitioned_state(descriptor))

    # -- timers ------------------------------------------------------------
    def _fire_timer(self, timer: Timer) -> None:
        self._backend.set_current_key(timer.key)
        ctx = KeyedBroadcastProcessFunction.ReadOnlyContext(
            timer.timestamp, timer.key, self._view,
            timer_service=_TimerApi(self._timers, timer.key))
        self._fn.on_timer(timer.timestamp, ctx, self._collector())
        self._flush_pending()

    def process_watermark_n(self, input_index: int, watermark) -> None:
        # timers fire, and their rows go out, before the watermark does:
        # they carry ts <= the watermark and would be late behind it
        wms = list(self._input_watermarks)
        wms[input_index] = watermark.timestamp
        self._timers.advance_watermark(min(wms))
        self._flush_pending()
        super().process_watermark_n(input_index, watermark)

    # -- checkpointing -----------------------------------------------------
    def snapshot_state(self, checkpoint_id: int) -> dict:
        return {
            "keyed": {"backend": self._backend.snapshot(checkpoint_id),
                      "timers": self._timers.snapshot()},
            "operator": {"broadcast": {n: dict(m)
                                       for n, m in self._maps.items()}},
        }
