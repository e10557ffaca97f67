"""Host control plane of the slice-window device operator (port of
``flink_tpu/runtime/operators/slice_control.py``): pane arithmetic, the
host late filter, the watermark-driven fire loop, the fired/seen-pane
metadata that rides with keyed snapshots, asynchronous fire emission and
coalesced ingest.

Subclasses provide ``_fold(batch, keys, panes)``, ``_fire(p_end)``,
``_materialize(item)`` and ``_process_batch_now(batch)``, and may hook
``_note_open_ingest(min_pane)`` and ``_pre_fire_flush()``.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from ...core.device_records import DeviceRecordBatch
from ...core.elements import Watermark
from ...core.records import RecordBatch
from ...metrics.device import DEVICE_STATS

__all__ = ["SliceControlPlane", "AsyncFireQueue", "CoalescingIngest"]

_MAX_FIRE_SAMPLES = 65536


def _to_host(tree):
    """Start the device->host copy of every tensor in a nested
    tuple/list/dict. CUDA tensors copy into pinned buffers with
    ``non_blocking=True`` (ordered on the current stream before any later
    in-place state update); CPU tensors are cloned so later in-place folds
    cannot change a queued result."""
    if isinstance(tree, torch.Tensor):
        if tree.device.type == "cpu":
            return tree.clone()
        host = torch.empty(tree.shape, dtype=tree.dtype, pin_memory=True)
        host.copy_(tree, non_blocking=True)
        return host
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


class CoalescingIngest:
    """Coalesced ingest: consecutive same-schema micro-batches gather on
    the host up to a record target, so one ingest step amortizes its fixed
    cost (launch, pane bookkeeping) over several upstream batches. The
    buffer flushes when the target is reached, when a batch of another
    schema arrives, when its age deadline has passed (checked at the next
    admit: no timer thread), and always before fires, snapshots and finish,
    so a record admitted before a watermark folds before that watermark's
    fires."""

    def _init_coalescer(self) -> None:
        self._coalesce_target = 0     # records; <= 1 disables
        self._coalesce_timeout_s = 0.0
        self._co_buf: list = []
        self._co_records = 0
        self._co_deadline: Optional[float] = None

    @staticmethod
    def _co_signature(batch) -> tuple:
        return (type(batch).__name__,
                tuple((f.name, np.dtype(f.dtype).str)
                      for f in batch.schema.fields))

    def _coalesce_admit(self, batch) -> None:
        if self._co_buf and self._co_signature(self._co_buf[0]) != \
                self._co_signature(batch):
            self._coalesce_flush()
        self._co_buf.append(batch)
        self._co_records += batch.n
        now = time.monotonic()
        if self._co_deadline is None and self._coalesce_timeout_s > 0:
            self._co_deadline = now + self._coalesce_timeout_s
        if self._co_records >= self._coalesce_target or (
                self._co_deadline is not None and now >= self._co_deadline):
            self._coalesce_flush()

    def _coalesce_flush(self) -> None:
        buf, self._co_buf = self._co_buf, []
        self._co_records = 0
        self._co_deadline = None
        if not buf:
            return
        if len(buf) == 1:
            self._process_batch_now(buf[0])
            return
        DEVICE_STATS.note_batches_coalesced(len(buf))
        self._process_batch_now(self._co_merge(buf))

    @staticmethod
    def _co_merge(buf: list) -> RecordBatch:
        """One batch of the buffered batches, in arrival order: device
        columns join with ``torch.cat`` on the device, and the event-time
        bounds stay host ints."""
        first = buf[0]
        if isinstance(first, DeviceRecordBatch):
            cols = {f.name: torch.cat([b.device_column(f.name) for b in buf])
                    for f in first.schema.fields}
            dts = (torch.cat([b.dtimestamps for b in buf])
                   if first.dtimestamps is not None else None)
            return DeviceRecordBatch(
                first.schema, cols, dts, min(b.ts_min for b in buf),
                max(b.ts_max for b in buf), ts_column=first.ts_column)
        cols = {f.name: np.concatenate([b.column(f.name) for b in buf])
                for f in first.schema.fields}
        return RecordBatch(first.schema, cols,
                           np.concatenate([b.timestamps for b in buf]))

    def _process_batch_now(self, batch) -> None:
        raise NotImplementedError


class AsyncFireQueue:
    """Asynchronous fire emission: a fire's outputs start copying to
    pinned host memory at dispatch and a CUDA event marks the copy's end;
    the emission is queued and drained once ``event.query()`` says it
    landed. Watermarks are held behind their pending fires so they never
    overtake results downstream. The hot loop never blocks on a fire.
    An item is ``(p_end, outputs, ...)``; ``_materialize`` receives it
    with ``outputs`` already on the host."""

    _async: bool

    def _init_async_fires(self) -> None:
        self._pending: deque = deque()

    def _enqueue_fire(self, item: tuple) -> None:
        host = _to_host(item[1])
        event = None
        if any(isinstance(t, torch.Tensor) and t.is_pinned()
               for t in _leaves(host)):
            event = torch.cuda.Event()
            event.record()
        item = (item[0], host, event) + tuple(item[2:])
        if self._async:
            self._pending.append(item)
        else:
            self._await_copy(event)
            self._materialize(item)

    def _drain(self, block: bool = False) -> None:
        while self._pending:
            head = self._pending[0]
            if isinstance(head, Watermark):
                self.output.emit_watermark(head)
                self._pending.popleft()
                continue
            event = head[2]
            if event is not None and not block and not event.query():
                return
            self._await_copy(event)
            self._pending.popleft()
            self._materialize(head)

    def _await_copy(self, event) -> None:
        """Wait for a queued fire's copy to land (``event`` None: nothing
        to wait for). Operators may bound the wait."""
        if event is not None:
            event.synchronize()

    def _emit_watermark_out(self, watermark: Watermark) -> None:
        if self._async and self._pending:
            self._pending.append(watermark)
        else:
            self.output.emit_watermark(watermark)

    def _note_latency(self, t0: float) -> None:
        if self._async and len(self.fire_latencies_ms) < _MAX_FIRE_SAMPLES:
            self.fire_latencies_ms.append((time.perf_counter() - t0) * 1e3)

    def _materialize(self, item: tuple) -> None:
        raise NotImplementedError


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


class SliceControlPlane:
    # set by subclass __init__
    _pane: int
    _offset: int
    _window_panes: int
    _ring: int

    def _init_control_plane(self) -> None:
        # windows ending at pane boundary p_end < _fired_boundary have
        # fired; panes < _fired_boundary - W are retired (ring rows
        # reusable, records late)
        self._fired_boundary: Optional[int] = None
        self._min_seen_pane: Optional[int] = None
        self._max_seen_pane: Optional[int] = None
        self._late_dropped = 0
        # wall-clock ms of each window fire; async operators record
        # dispatch -> drain themselves
        self.fire_latencies_ms: list[float] = []
        self._record_fire_latency = True

    # -- metadata ----------------------------------------------------------
    def _control_meta(self) -> dict:
        return {"fired_boundary": self._fired_boundary,
                "min_seen_pane": self._min_seen_pane,
                "max_seen_pane": self._max_seen_pane,
                "watermark": self.current_watermark}

    def _restore_control_meta(self, metas: list[dict]) -> None:
        fires = [m["fired_boundary"] for m in metas
                 if m.get("fired_boundary") is not None]
        seens = [m["max_seen_pane"] for m in metas
                 if m.get("max_seen_pane") is not None]
        mins = [m["min_seen_pane"] for m in metas
                if m.get("min_seen_pane") is not None]
        self._fired_boundary = min(fires) if fires else None
        self._max_seen_pane = max(seens) if seens else None
        self._min_seen_pane = min(mins) if mins else None
        self.current_watermark = max(m["watermark"] for m in metas)

    # -- data path ---------------------------------------------------------
    def _ingest(self, batch: RecordBatch, keys: np.ndarray) -> None:
        """Host late filter + pane-span bookkeeping, then the subclass's
        ``_fold`` of the surviving records."""
        panes = ((batch.timestamps - self._offset) // self._pane).astype(
            np.int64)
        if self._fired_boundary is not None:
            # late = every window containing the pane has fired
            first_open = self._fired_boundary - self._window_panes
            late = panes < first_open
            n_late = int(late.sum())
            if n_late:
                self._late_dropped += n_late
                keep = ~late
                keys, panes = keys[keep], panes[keep]
                batch = batch.filter(keep)
                if batch.n == 0:
                    return
        max_pane = int(panes.max())
        min_pane = int(panes.min())
        self._max_seen_pane = (max_pane if self._max_seen_pane is None
                               else max(self._max_seen_pane, max_pane))
        self._min_seen_pane = (min_pane if self._min_seen_pane is None
                               else min(self._min_seen_pane, min_pane))
        self._check_ring(max_pane)
        self._note_open_ingest(min_pane)
        self._fold(batch, keys, panes)

    def _note_open_ingest(self, min_pane: int) -> None:
        """Hook: the incremental fire engine invalidates its running window
        state when a batch writes into a pane it already sealed."""

    def _check_ring(self, max_pane: int) -> None:
        """Two open panes must never share a ring row."""
        low = (self._fired_boundary - self._window_panes
               if self._fired_boundary is not None else self._min_seen_pane)
        if max_pane - low >= self._ring:
            raise RuntimeError(
                f"pane ring overflow: open span [{low},{max_pane}] exceeds "
                f"ring {self._ring}; increase ring_size or reduce "
                "watermark lag")

    # -- firing ------------------------------------------------------------
    def process_watermark(self, watermark: Watermark) -> None:
        self.current_watermark = watermark.timestamp
        self._pre_fire_flush()
        # a window ending at pane boundary p_end fires when
        # wm >= p_end*pane + offset - 1
        wm_pane_end = (watermark.timestamp - self._offset + 1) // self._pane
        if self._max_seen_pane is not None:
            # windows ending at or below min_seen hold no data, and their
            # ring rows may alias future panes: never reach below
            start = self._min_seen_pane + 1
            if self._fired_boundary is not None:
                start = max(start, self._fired_boundary)
            last = min(wm_pane_end, self._max_seen_pane + self._window_panes)
            for p_end in range(start, last + 1):
                t0 = time.perf_counter()
                self._fire(p_end)
                if (self._record_fire_latency
                        and len(self.fire_latencies_ms) < _MAX_FIRE_SAMPLES):
                    self.fire_latencies_ms.append(
                        (time.perf_counter() - t0) * 1e3)
        # the boundary tracks the watermark even when nothing fired, so
        # records behind the watermark are dropped as late
        if (self._fired_boundary is None
                or wm_pane_end + 1 > self._fired_boundary):
            self._fired_boundary = wm_pane_end + 1
        self._emit_watermark_out(watermark)

    def _emit_watermark_out(self, watermark: Watermark) -> None:
        self.output.emit_watermark(watermark)

    def _pre_fire_flush(self) -> None:
        """Hook: fold any buffered input before the fires."""

    def _fold(self, batch: RecordBatch, keys: np.ndarray,
              panes: np.ndarray) -> None:
        raise NotImplementedError

    def _fire(self, p_end: int) -> None:
        raise NotImplementedError
