"""Device slice-window operator (port of
``flink_tpu/runtime/operators/device_window.py``): the Nexmark Q5 path.

* Each micro-batch of device-born columns runs one ingest step on the
  device (``_step``, the reference's ``_step_body``): pane assignment, the
  late mask, the hash-table lookup-or-insert (hand-written CUDA kernel)
  and one in-place scatter fold per aggregate into ``[ring, capacity]``
  pane planes. The step never syncs with the host: no ``.item()``, no
  boolean-mask indexing, no ``nonzero``; its only host inputs are the
  batch's host-int event-time bounds.
* A window ending at pane boundary ``p_end`` fires when the watermark
  passes ``p_end * pane - 1``. The fire (``_fire_outputs``, the
  reference's ``_fire_program``) merges the window's pane rows for every
  aggregate, builds the emit mask, optionally ranks the top k on the
  device (radix select on the hand-written histogram kernel) and carries
  the health scalars; its outputs copy to the host asynchronously and are
  emitted when they land. The oldest pane's ring row is then retired.
* In-flight window: after each step a CUDA event is recorded; the host
  waits on the event of the step ``max_inflight`` batches back before it
  admits more work, so the device stays fed while the backlog (and the
  fire latency behind it) stays bounded.

Late records (pane already fired) are dropped and counted. Host batches
(the test harness, host sources) take the host late filter and upload
their columns; the incremental fire engine, coalesced ingest, the spill
tier and the fused chain are later slices.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ...core.device_records import DeviceRecordBatch
from ...core.records import MIN_TIMESTAMP, RecordBatch, Schema
from ...device import resolve_device, torch_dtype
from ...ops.hash_table import EMPTY_KEY, sanitize_keys_device
from ...ops.segment_ops import AGG_COMBINE2, AGG_MERGES
from ...ops.topk import masked_topk
from ...state.device_backend import DeviceKeyedStateBackend
from ...window.assigners import WindowAssigner
from .base import OneInputOperator, OperatorContext, Output
from .slice_control import AsyncFireQueue, SliceControlPlane

__all__ = ["DeviceWindowAggOperator", "AggSpec"]


class AggSpec:
    """One aggregate column: kind in sum|count|min|max|avg over field.

    ``value_bits``: bound on the aggregate's non-negative RESULT domain
    (below 2^value_bits), which shortens the top-k radix select: each 8
    bits saved drops one histogram pass. Defaults: 48 for count, 64
    (always safe) otherwise."""

    def __init__(self, kind: str, field: Optional[str] = None,
                 out_name: Optional[str] = None, dtype=torch.float32,
                 value_bits: Optional[int] = None):
        if kind not in ("sum", "count", "min", "max", "avg"):
            raise ValueError(f"unsupported device aggregate {kind}")
        self.kind = kind
        self.field = field
        self.out_name = out_name or (f"{kind}_{field}" if field else kind)
        self.dtype = torch_dtype(dtype)
        self.value_bits = (value_bits if value_bits is not None
                           else 48 if kind == "count" else 64)


def _runs(rows: list[int]) -> list[tuple[int, int]]:
    """Consecutive ring rows as [start, stop) runs (a window wraps the ring
    at most once), so a merge reads each row once through slicing and
    needs no index tensor on the device."""
    runs: list[tuple[int, int]] = []
    for r in rows:
        if runs and runs[-1][1] == r:
            runs[-1] = (runs[-1][0], r + 1)
        else:
            runs.append((r, r + 1))
    return runs


def _merge(kind: str, arr: torch.Tensor, rows: list[int],
           idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Merge the pane rows ``rows`` of a [ring, capacity] plane; with
    ``idx``, only at those slots (the winner-only merge of a top-k fire)."""
    out = None
    for a, b in _runs(rows):
        block = arr[a:b] if idx is None else arr[a:b].index_select(1, idx)
        part = AGG_MERGES[kind](block)
        out = part if out is None else AGG_COMBINE2[kind](out, part)
    return out


class DeviceWindowAggOperator(AsyncFireQueue, SliceControlPlane,
                              OneInputOperator):
    def __init__(self, assigner: WindowAssigner, key_column: str,
                 aggs: Sequence[AggSpec],
                 capacity: int = 1 << 16,
                 ring_size: int = 64,
                 emit_window_bounds: bool = True,
                 emit_topk: Optional[int] = None,
                 defer_overflow: bool = False,
                 async_fire: bool = False,
                 device=None,
                 name: str = "DeviceWindowAgg"):
        """``emit_topk``: emit only the k keys with the largest value of the
        FIRST aggregate per window (the Q5 hot-items fire).
        ``defer_overflow``: the hot path never syncs with the host; failed
        inserts count on the device and fail loudly at the next fire.
        ``async_fire``: fires emit once their device->host copy lands,
        with watermarks held behind them. ``device``: ``cuda`` unless
        ``"cpu"`` is asked for."""
        super().__init__(name)
        pane = assigner.pane_size
        if pane is None:
            raise ValueError(
                "Device window operator needs a pane-decomposable assigner "
                "(tumbling, or sliding with size % slide == 0)")
        self._device = resolve_device(device)
        self._pane = int(pane)
        self._offset = int(getattr(assigner, "offset", 0))
        size = getattr(assigner, "size", self._pane)
        self._window_panes = int(size) // self._pane
        self._ring = int(ring_size)
        if self._ring < self._window_panes + 1:
            raise ValueError("ring_size must exceed panes per window")
        self._key_column = key_column
        self._aggs = list(aggs)
        self._capacity = capacity
        self._emit_bounds = emit_window_bounds
        self._topk = emit_topk
        self._defer = bool(defer_overflow)
        self._async = bool(async_fire)
        self._backend: Optional[DeviceKeyedStateBackend] = None
        self._init_control_plane()
        if self._async:
            self._record_fire_latency = False
        self._init_async_fires()
        self._inflight: deque = deque()
        self._max_inflight = 2
        self._late_dev: Optional[torch.Tensor] = None
        self._late_cached = 0
        self._registered = False

    # -- lifecycle ---------------------------------------------------------
    def setup(self, ctx: OperatorContext, output: Output) -> None:
        super().setup(ctx, output)
        self._max_inflight = max(1, int(ctx.config.get("task.max-inflight")))
        self._backend = DeviceKeyedStateBackend(
            ctx.key_group_range, ctx.max_parallelism,
            capacity=self._capacity, device=self._device,
            defer_overflow=self._defer)
        # a COUNT with value_bits <= 31 promises every per-window count
        # fits int32: the count plane halves its traffic
        cvb = min((a.value_bits for a in self._aggs if a.kind == "count"),
                  default=64)
        count_dtype = torch.int32 if cvb <= 31 else torch.int64
        self._backend.register_array_state("__count__", "count", count_dtype,
                                           ring=self._ring)

    def _register_aggs(self, schema: Schema) -> None:
        """Accumulator dtypes follow the input columns; avg accumulates a
        float32 sum."""
        for a in self._aggs:
            if a.field is not None and a.field in schema:
                a.dtype = (torch.float32 if a.kind == "avg"
                           else torch_dtype(schema.field(a.field).dtype))
            if a.kind == "avg":
                self._backend.register_array_state(
                    f"{a.out_name}.sum", "sum", a.dtype, ring=self._ring)
            elif a.kind != "count":
                self._backend.register_array_state(
                    a.out_name, a.kind, a.dtype, ring=self._ring)
        self._registered = True

    def initialize_state(self, keyed_snapshots: list,
                         operator_snapshot) -> None:
        if keyed_snapshots:
            self._backend.restore([s["backend"] for s in keyed_snapshots])
            self._restore_control_meta([s["meta"] for s in keyed_snapshots])
            first = self._min_seen_pane
            if first is not None and self._fired_boundary is not None:
                first = max(first, self._fired_boundary - self._window_panes)
            live = (range(first, self._max_seen_pane + 1)
                    if first is not None else range(0))
            self._backend.conform_ring(self._ring, live)

    # -- data path ---------------------------------------------------------
    def process_batch(self, batch: RecordBatch) -> None:
        if self._pending:
            self._drain(block=False)
        if batch.n == 0:
            return
        if not self._registered:
            key_dtype = np.dtype(batch.schema.field(self._key_column).dtype)
            if not np.issubdtype(key_dtype, np.integer):
                raise TypeError(
                    "device window aggregation needs an integer key column; "
                    f"{self._key_column!r} is {key_dtype}")
            self._register_aggs(batch.schema)
        if (isinstance(batch, DeviceRecordBatch) and self._defer
                and batch.dtimestamps is not None):
            self._ingest_device(batch)
        else:
            keys = np.asarray(batch.column(self._key_column)).astype(
                np.int64, copy=False)
            self._ingest(batch, keys)

    def _fold_sig(self) -> list[tuple[str, str, str]]:
        """(fold kind, plane name, field) per non-count aggregate."""
        sig = []
        for a in self._aggs:
            if a.kind == "count":
                continue
            name = f"{a.out_name}.sum" if a.kind == "avg" else a.out_name
            sig.append(("sum" if a.kind == "avg" else a.kind, name, a.field))
        return sig

    def _plane_names(self) -> list[str]:
        return ["__count__"] + [name for _k, name, _f in self._fold_sig()]

    def _upload(self, col: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(col)).to(self._device)

    def _fold(self, batch: RecordBatch, keys: np.ndarray,
              panes: np.ndarray) -> None:
        """Host-batch fold: upload keys, ring rows and value columns, then
        slot resolution and one scatter per plane on the device."""
        backend = self._backend
        slots = backend.slots_for_batch(self._upload(keys))
        ring_idx = self._upload(panes % self._ring)
        valid = slots >= 0
        backend.fold_batch("__count__", slots,
                           torch.ones_like(slots), valid, ring_idx)
        for _kind, name, field in self._fold_sig():
            backend.fold_batch(name, slots, self._upload(batch.column(field)),
                               valid, ring_idx)
        self._admit_token()

    def _ingest_device(self, batch: DeviceRecordBatch) -> None:
        """Device-born batch: the host does pane bookkeeping on the batch's
        event-time BOUNDS only, the data plane is ``_step``. A batch wholly
        behind the fired boundary is dropped without device work."""
        pane_lo = (batch.ts_min - self._offset) // self._pane
        pane_hi = (batch.ts_max - self._offset) // self._pane
        first_open = (self._fired_boundary - self._window_panes
                      if self._fired_boundary is not None else None)
        if first_open is not None and pane_hi < first_open:
            self._late_dropped += batch.n
            return
        eff_lo = pane_lo if first_open is None else max(pane_lo, first_open)
        self._max_seen_pane = (pane_hi if self._max_seen_pane is None
                               else max(self._max_seen_pane, pane_hi))
        self._min_seen_pane = (eff_lo if self._min_seen_pane is None
                               else min(self._min_seen_pane, eff_lo))
        self._check_ring(pane_hi)
        if self._late_dev is None:
            self._late_dev = torch.zeros((), dtype=torch.int64,
                                         device=self._device)
        self._step(batch, first_open if first_open is not None
                   else MIN_TIMESTAMP)
        self._admit_token()

    def _step(self, batch: DeviceRecordBatch, first_open: int) -> None:
        """The ingest step on the device; no host sync anywhere."""
        backend = self._backend
        ts = batch.dtimestamps
        panes = torch.div(ts - self._offset, self._pane, rounding_mode="floor")
        fresh = panes >= first_open
        self._late_dev += (~fresh).sum()
        keys = sanitize_keys_device(batch.device_column(self._key_column))
        slots = backend.insert_deferred(keys, fresh)
        ok = slots >= 0
        ring_idx = panes % self._ring
        backend.fold_batch("__count__", slots, torch.ones_like(slots), ok,
                           ring_idx)
        for _kind, name, field in self._fold_sig():
            backend.fold_batch(name, slots, batch.device_column(field), ok,
                               ring_idx)

    def _admit_token(self) -> None:
        """Bounded in-flight window: wait for the step ``max_inflight``
        batches back, then drain any fires that landed."""
        if self._device.type != "cuda":
            return
        event = torch.cuda.Event()
        event.record()
        self._inflight.append(event)
        if len(self._inflight) > self._max_inflight:
            self._inflight.popleft().synchronize()
            if self._pending:
                self._drain(block=False)

    # -- firing ------------------------------------------------------------
    def _fire(self, p_end: int) -> None:
        W = self._window_panes
        # never read panes below min_seen: they hold no data and their ring
        # rows may be occupied by live FUTURE panes
        first = max(p_end - W, self._min_seen_pane)
        if first >= p_end:
            return
        rows = [p % self._ring for p in range(first, p_end)]
        outs = self._fire_outputs(rows)
        self._enqueue_fire((p_end, outs, time.perf_counter()))
        # retire the oldest pane of this window: no later window needs it
        if p_end - W >= self._min_seen_pane:
            self._backend.reset_ring_row((p_end - W) % self._ring)

    def _fire_outputs(self, rows: list[int]) -> tuple:
        """The whole fire on the device: merge + emit mask + optional
        top-k + health scalars (dropped inserts, occupancy, late rows)."""
        backend = self._backend
        table = backend.table
        count = _merge("count", backend.get_array("__count__"), rows)
        occupied = table != EMPTY_KEY
        emit = occupied & (count > 0)
        health = (backend.dropped_device.clone(), occupied.sum(),
                  self._late_dev.clone() if self._late_dev is not None
                  else None)
        if self._topk is not None:
            # rank on the FIRST aggregate; the others gather at the winners
            first = self._aggs[0]
            if first.kind == "count":
                ranked = count
            elif first.kind == "avg":
                s = _merge("sum", backend.get_array(f"{first.out_name}.sum"),
                           rows)
                ranked = s / count.clamp(min=1).to(s.dtype)
            else:
                ranked = _merge(first.kind, backend.get_array(first.out_name),
                                rows)
            _vals, idx, ok = masked_topk(ranked, emit, self._topk,
                                         value_bits=first.value_bits)
            count_k = count[idx]
            out = {}
            for a in self._aggs:
                if a.out_name == first.out_name:
                    out[a.out_name] = ranked[idx]
                elif a.kind == "count":
                    out[a.out_name] = count_k
                elif a.kind == "avg":
                    s = _merge("sum", backend.get_array(f"{a.out_name}.sum"),
                               rows, idx)
                    out[a.out_name] = s / count_k.clamp(min=1).to(s.dtype)
                else:
                    out[a.out_name] = _merge(
                        a.kind, backend.get_array(a.out_name), rows, idx)
            return table[idx], ok, out, health
        results = {}
        for a in self._aggs:
            if a.kind == "count":
                results[a.out_name] = count
            elif a.kind == "avg":
                s = _merge("sum", backend.get_array(f"{a.out_name}.sum"), rows)
                results[a.out_name] = s / count.clamp(min=1).to(s.dtype)
            else:
                results[a.out_name] = _merge(
                    a.kind, backend.get_array(a.out_name), rows)
        return table, emit, results, health

    def _materialize(self, item) -> None:
        p_end, host, _event, t0 = item
        keys_or_table, mask, results, (dropped, occ, late) = host
        self._backend.apply_health(int(dropped), int(occ))
        if late is not None:
            self._late_cached = int(late)
        sel = mask.numpy()
        if self._topk is not None:
            keys = keys_or_table.numpy()[sel]
            results = {n: v.numpy()[sel] for n, v in results.items()}
        else:
            # canonical emission order: raw slot order leaks insert history
            idx = np.flatnonzero(sel)
            keys = keys_or_table.numpy()[idx]
            order = np.argsort(keys, kind="stable")
            keys = keys[order]
            results = {n: v.numpy()[idx][order] for n, v in results.items()}
        if len(keys):
            self._emit_rows(p_end, keys, results)
        self._note_latency(t0)

    def _emit_rows(self, p_end: int, keys: np.ndarray,
                   results: dict[str, np.ndarray]) -> None:
        n = len(keys)
        start = (p_end - self._window_panes) * self._pane + self._offset
        end = p_end * self._pane + self._offset
        cols: dict[str, np.ndarray] = {self._key_column: keys}
        fields: list[tuple[str, Any]] = [(self._key_column, np.int64)]
        if self._emit_bounds:
            cols["window_start"] = np.full(n, start, np.int64)
            cols["window_end"] = np.full(n, end, np.int64)
            fields += [("window_start", np.int64), ("window_end", np.int64)]
        # AggSpec declaration order
        for a in self._aggs:
            vals = results[a.out_name]
            cols[a.out_name] = vals
            fields.append((a.out_name, vals.dtype.type))
        self.output.emit(RecordBatch(Schema(fields), cols,
                                     np.full(n, end - 1, np.int64)))

    def finish(self) -> None:
        self._drain(block=True)
        self._refresh_late()

    def _refresh_late(self) -> None:
        """Blocking read of the device late counter (finish and checkpoint
        boundaries only; fires carry it home asynchronously)."""
        if self._late_dev is not None:
            self._late_cached = int(self._late_dev)

    @property
    def late_dropped(self) -> int:
        return self._late_dropped + self._late_cached

    @property
    def backend(self) -> DeviceKeyedStateBackend:
        return self._backend

    # -- checkpointing -----------------------------------------------------
    def snapshot_state(self, checkpoint_id: int) -> dict:
        self._drain(block=True)
        self._refresh_late()
        return {"keyed": {"backend": self._backend.snapshot(checkpoint_id),
                          "meta": self._control_meta()}}
