"""Device slice-window operator (port of
``flink_tpu/runtime/operators/device_window.py``): the Nexmark Q5 path.

* Each micro-batch of device-born columns runs one ingest step on the
  device (``_step``, the reference's ``_step_body``): pane assignment, the
  late mask, the hash-table lookup-or-insert and one in-place fold per
  aggregate into ``[ring, capacity]`` pane planes, all in one launch of
  the hand-written CUDA kernel ``ingest_step``. The step never syncs with
  the host: no ``.item()``, no boolean-mask indexing, no ``nonzero``; its
  only host inputs are the batch's host-int event-time bounds.
* A window ending at pane boundary ``p_end`` fires when the watermark
  passes ``p_end * pane - 1``. The fire (``_fire_outputs``, the
  reference's ``_fire_program`` and ``_fire_inc_program``) takes the
  window's merge of every aggregate, builds the emit mask, optionally
  ranks the top k on the device (radix select on the hand-written
  histogram kernel) and carries the health scalars; its outputs copy to
  the host asynchronously and are emitted when they land. The oldest
  pane's ring row is then retired.
* The merge: a full fire reads the window's W pane rows of every plane.
  With ``window.fire.incremental`` the fire reads a [capacity] view
  instead: a running window accumulator per invertible aggregate and a
  merge tree per min/max, sealed once per fire by one launch of the
  hand-written ``window_seal`` kernel, and rebuilt from the pane rows by
  ``window_rebuild`` when stale (first fire, restore, a jump of the fire
  boundary, a write into a sealed pane). Its cost does not grow with W.
* ``task.coalesce.target-records`` gathers consecutive batches on the host
  and runs one ingest step for them (``CoalescingIngest``).
* In-flight window: after each step a CUDA event is recorded; the host
  waits on the event of the step ``max_inflight`` batches back before it
  admits more work, so the device stays fed while the backlog (and the
  fire latency behind it) stays bounded.

* A certified fused chain (``enable_fused_chain``) hands this operator
  ``LazyDeviceBatch`` handles; each is decoded and folded in one dispatch
  (``_ingest_chain``, ``runtime/compiled.py``: a CUDA graph replay on the
  card).
* Every step marks the slot blocks it writes in the backend's dirty
  bitmap, so a checkpoint copies only what changed (``snapshot_state``).
* HBM budget (``hbm_budget_slots``, or ``state.backend.tpu.hbm-budget-
  slots`` / ``-bytes``): keyed state past it pages to the host tier at
  key-group granularity. Under deferred overflow the split runs inside
  the ingest kernel: rows of spilled groups (and failed inserts) go to
  device staging buffers of ``spill_staging_slots`` rows, drained into
  the host tier at each watermark before any fire
  (``_drain_spill_stage``). A fire takes the host tier's part of the
  window before its pane retires (``_host_fire_part``) and merges it at
  materialization, re-ranking top k across both tiers. A budgeted job
  does not take the fused chain: its lazy batches decode and go through
  the spill step, as the reference does. After the drain, each boundary
  runs the backend's tiering step (``tier_boundary``): the residency
  policy's clock and decay, and at most one promotion of warm key groups
  back into the device table; a promotion makes the incremental fire
  rebuild its window state. The residency registers as
  ``"{task_name}/{subtask_index}"`` (``state/tiering/residency.py``).

Late records (pane already fired) are dropped and counted. Host batches
(the test harness, host sources) take the host late filter and upload
their columns (under a deferred budget they take the device step).
The device guard and the degrade ladder are later slices.
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
from ...metrics.device import DEVICE_STATS
from ...ops.hash_table import EMPTY_KEY
from ...ops.segment_ops import AGG_COMBINE2, AGG_MERGES, INVERTIBLE_KINDS, \
    pow2_ceil
from ...ops.topk import masked_topk
from ...ops.window_seal import rebuild, seal
from ...state.device_backend import DeviceKeyedStateBackend
from ...window.assigners import WindowAssigner
from .base import OneInputOperator, OperatorContext, Output
from .slice_control import AsyncFireQueue, CoalescingIngest, \
    SliceControlPlane

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


def _window_dtype(kind: str, pane_dtype: torch.dtype) -> torch.dtype:
    """dtype of an incremental window plane: an integer sum widens to
    int64 as the full merge's sum does; a count keeps its pane dtype (an
    int32 count plane promises that every window count fits int32)."""
    if kind == "sum" and not pane_dtype.is_floating_point:
        return torch.int64
    return pane_dtype


class DeviceWindowAggOperator(AsyncFireQueue, CoalescingIngest,
                              SliceControlPlane, OneInputOperator):
    def __init__(self, assigner: WindowAssigner, key_column: str,
                 aggs: Sequence[AggSpec],
                 capacity: int = 1 << 16,
                 ring_size: int = 64,
                 emit_window_bounds: bool = True,
                 emit_topk: Optional[int] = None,
                 defer_overflow: bool = False,
                 async_fire: bool = False,
                 hbm_budget_slots: int = 0,
                 spill_staging_slots: int = 1 << 16,
                 fire_incremental: Optional[bool] = None,
                 device=None,
                 name: str = "DeviceWindowAgg"):
        """``emit_topk``: emit only the k keys with the largest value of the
        FIRST aggregate per window (the Q5 hot-items fire).
        ``defer_overflow``: the hot path never syncs with the host; failed
        inserts count on the device and fail loudly at the next fire.
        ``async_fire``: fires emit once their device->host copy lands,
        with watermarks held behind them. ``hbm_budget_slots``: device
        slots of keyed state (0: the configuration's budget, if any);
        ``spill_staging_slots``: rows the deferred step can stage for the
        host tier between two watermarks. ``fire_incremental``: the
        incremental fire engine; None reads ``window.fire.incremental``.
        ``device``: ``cuda`` unless ``"cpu"`` is asked for."""
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
        self._hbm_budget = int(hbm_budget_slots)
        self._stage_slots = int(spill_staging_slots)
        self._stage: Optional[dict] = None   # deferred-spill staging buffers
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
        # incremental fire engine: _inc_next is the fire boundary the sealed
        # state is consistent for; _inc_stale names why the next fire must
        # rebuild it from the pane planes (None: the next fire seals)
        self._inc_flag = fire_incremental
        self._inc_enabled = bool(fire_incremental)
        self._inc_next: Optional[int] = None
        self._inc_stale: Optional[str] = "first fire"
        self._tree_size = pow2_ceil(self._ring)   # merge-tree leaves L
        #: rebuilds by cause, for the run's record
        self.inc_rebuilds: dict[str, int] = {}
        self._init_coalescer()
        # certified fused chain (graph/fusion.py lowered_prefix): armed by
        # the deployer through enable_fused_chain, built at the first batch
        self._fused_spec: Optional[tuple] = None  # (source, subtask, par)
        self.fused_chain = None                   # runtime.compiled.FusedChain
        #: perf_counter of the first batch this operator processed
        self.first_batch_at: Optional[float] = None
        #: seconds of the spill tier's host work: staged-row drains and
        #: host parts of fires; and the rows drained
        self.spill_s = {"drain": 0.0, "host_fire": 0.0}
        self.spill_rows_drained = 0

    # -- lifecycle ---------------------------------------------------------
    def setup(self, ctx: OperatorContext, output: Output) -> None:
        super().setup(ctx, output)
        self._max_inflight = max(1, int(ctx.config.get("task.max-inflight")))
        if self._inc_flag is None:
            self._inc_enabled = bool(ctx.config.get("window.fire.incremental"))
        self._coalesce_target = int(
            ctx.config.get("task.coalesce.target-records"))
        self._coalesce_timeout_s = float(
            ctx.config.get("task.coalesce.timeout-ms")) / 1e3
        budget = self._hbm_budget or int(
            ctx.config.get("state.backend.tpu.hbm-budget-slots"))
        budget_bytes = int(
            ctx.config.get("state.backend.tpu.hbm-budget-bytes"))
        if not budget and budget_bytes:
            # bytes to slots from the per-slot footprint this operator
            # allocates: the 8-byte table key and one [ring] row of 8-byte
            # cells per plane (the count plane and one per non-count
            # aggregate); narrower planes land under the budget
            value_planes = sum(1 for a in self._aggs if a.kind != "count")
            slot_bytes = 8 + self._ring * 8 * (1 + value_planes)
            budget = max(1, budget_bytes // slot_bytes)
        self._backend = DeviceKeyedStateBackend(
            ctx.key_group_range, ctx.max_parallelism,
            capacity=self._capacity, device=self._device,
            defer_overflow=self._defer, hbm_budget_slots=budget,
            config=ctx.config)
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
            # snapshots never carry the derived incremental state: the
            # first fire after a restore rebuilds it
            self._inc_stale = "restore"
            self._inc_next = None

    def open(self) -> None:
        if self._backend.tiering_active:
            from ...state.tiering import register_residency
            register_residency(self._residency_name,
                               self._backend.residency)

    @property
    def _residency_name(self) -> str:
        return f"{self.ctx.task_name}/{self.ctx.subtask_index}"

    def enable_fused_chain(self, source, subtask: int,
                           parallelism: int) -> bool:
        """Arm the certified source -> window lowering (called by the
        deployer before setup): the upstream reader then emits
        ``LazyDeviceBatch`` handles and this operator decodes and folds
        each in one dispatch. Only under deferred overflow, as the fused
        dispatch checks nothing on the host."""
        if not self._defer:
            return False
        self._fused_spec = (source, int(subtask), int(parallelism))
        return True

    def disable_fused_chain(self) -> None:
        self._fused_spec = None

    # -- data path ---------------------------------------------------------
    def process_batch(self, batch: RecordBatch) -> None:
        if batch.n == 0:
            return
        if self._coalesce_target > 1 and not getattr(batch, "lazy", False):
            self._coalesce_admit(batch)
            return
        if self._coalesce_target > 1:
            # a lazy chain batch is already a full micro-batch: flushing the
            # buffered batches first keeps arrival order
            self._coalesce_flush()
        self._process_batch_now(batch)

    def _process_batch_now(self, batch: RecordBatch) -> None:
        if self._pending:
            self._drain(block=False)
        if batch.n == 0:
            return
        if self.first_batch_at is None:
            self.first_batch_at = time.perf_counter()
        if not self._registered:
            key_dtype = np.dtype(batch.schema.field(self._key_column).dtype)
            if not np.issubdtype(key_dtype, np.integer):
                raise TypeError(
                    "device window aggregation needs an integer key column; "
                    f"{self._key_column!r} is {key_dtype}")
            self._register_aggs(batch.schema)
        if (self._fused_spec is not None and getattr(batch, "lazy", False)
                and not batch.realized and not self._spill_deferred):
            self._ingest_chain(batch)
        elif (isinstance(batch, DeviceRecordBatch) and self._defer
                and batch.dtimestamps is not None):
            self._ingest_device(batch)
        elif self._spill_deferred:
            # the spill split needs the device step: upload the columns
            self._ingest_device(self._to_device_batch(batch))
        else:
            keys = np.asarray(batch.column(self._key_column)).astype(
                np.int64, copy=False)
            self._ingest(batch, keys)

    @property
    def _spill_deferred(self) -> bool:
        return (self._defer and self._backend is not None
                and self._backend.hbm_budget > 0)

    def _to_device_batch(self, batch: RecordBatch) -> DeviceRecordBatch:
        ts = np.asarray(batch.timestamps, np.int64)
        cols = {self._key_column: self._upload(np.asarray(
            batch.column(self._key_column)).astype(np.int64, copy=False))}
        for a in self._aggs:
            if a.field is not None and a.field not in cols:
                cols[a.field] = self._upload(batch.column(a.field))
        schema = Schema([(f.name, f.dtype) for f in batch.schema.fields
                         if f.name in cols])
        return DeviceRecordBatch(schema, cols, self._upload(ts),
                                 int(ts.min()), int(ts.max()))

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

    def _device_bookkeeping(self, batch: DeviceRecordBatch
                            ) -> Optional[int]:
        """Pane bookkeeping of a device batch on its event-time BOUNDS
        only; returns the step's first open pane, or None when the batch
        is wholly behind the fired boundary (dropped and counted, with no
        device work)."""
        pane_lo = (batch.ts_min - self._offset) // self._pane
        pane_hi = (batch.ts_max - self._offset) // self._pane
        first_open = (self._fired_boundary - self._window_panes
                      if self._fired_boundary is not None else None)
        if first_open is not None and pane_hi < first_open:
            self._late_dropped += batch.n
            return None
        eff_lo = pane_lo if first_open is None else max(pane_lo, first_open)
        self._max_seen_pane = (pane_hi if self._max_seen_pane is None
                               else max(self._max_seen_pane, pane_hi))
        self._min_seen_pane = (eff_lo if self._min_seen_pane is None
                               else min(self._min_seen_pane, eff_lo))
        self._note_open_ingest(eff_lo)
        self._check_ring(pane_hi)
        if self._late_dev is None:
            self._late_dev = torch.zeros((), dtype=torch.int64,
                                         device=self._device)
        return first_open if first_open is not None else MIN_TIMESTAMP

    def _ingest_device(self, batch: DeviceRecordBatch) -> None:
        """Device-born batch: host bookkeeping on the bounds, then
        ``_step`` on the device."""
        first_open = self._device_bookkeeping(batch)
        if first_open is None:
            return
        self._step(batch, first_open)
        self._admit_token()

    def _ingest_chain(self, batch) -> None:
        """Certified-chain ingest of a ``LazyDeviceBatch``: no columns
        exist yet; one dispatch (runtime/compiled.py) decodes the batch
        from its start index and folds it, with the same bookkeeping as
        ``_ingest_device``."""
        first_open = self._device_bookkeeping(batch)
        if first_open is None:
            batch.realize()   # the reader's contract check sees it too
            return
        if self.fused_chain is None:
            from ..compiled import FusedChain
            source, subtask, parallelism = self._fused_spec
            self.fused_chain = FusedChain(
                source, subtask, parallelism, self._key_column, self._pane,
                self._offset, self._device)
        backend = self._backend
        planes = backend.fold_planes(      # (kind, plane, field name)
            [("__count__", None)]
            + [(name, field) for _kind, name, field in self._fold_sig()])
        self.fused_chain.run(batch, backend.table, planes, self._late_dev,
                             backend.dropped_device, first_open,
                             backend.dirty_buffer, backend.dirty_shift)
        self._admit_token()

    def _step(self, batch: DeviceRecordBatch, first_open: int) -> None:
        """The ingest step on the device: one kernel launch on the card
        (``ops.hash_table.ingest_step``), no host sync anywhere; under a
        deferred budget it stages the host tier's rows."""
        folds = [("__count__", None)] + [
            (name, batch.device_column(field))
            for _kind, name, field in self._fold_sig()]
        self._backend.ingest_deferred(
            batch.dtimestamps, batch.device_column(self._key_column), folds,
            self._pane, self._offset, first_open, self._late_dev,
            self._ensure_stage() if self._spill_deferred else None)

    def _ensure_stage(self) -> dict:
        """The staging buffers of the deferred spill split: keys, ring
        rows and one column per non-count plane, and the row count."""
        if self._stage is None:
            S, dev = self._stage_slots, self._device
            st = {"keys": torch.zeros(S, dtype=torch.int64, device=dev),
                  "ring": torch.zeros(S, dtype=torch.int32, device=dev),
                  "count": torch.zeros((), dtype=torch.int64, device=dev)}
            for _k, name, _f in self._fold_sig():
                st[name] = torch.zeros(
                    S, dtype=self._backend.get_array(name).dtype, device=dev)
            self._stage = st
        return self._stage

    def _drain_spill_stage(self) -> None:
        """Fold the staged rows into the host tier (one scalar read per
        watermark, a copy of the written prefix when rows were staged)."""
        if self._stage is None:
            return
        cnt = int(self._stage["count"])
        if cnt == 0:
            return
        take = min(cnt, self._stage_slots)
        t0 = time.perf_counter()
        keys = self._stage["keys"][:take].cpu().numpy()
        ring = self._stage["ring"][:take].cpu().numpy()
        vals = {"__count__": np.ones(take, np.int64)}
        for _k, name, _f in self._fold_sig():
            vals[name] = self._stage[name][:take].cpu().numpy()
        self._backend.drain_staged(keys, ring, vals)
        self._stage["count"].zero_()
        self.spill_s["drain"] += time.perf_counter() - t0
        self.spill_rows_drained += take

    def _note_open_ingest(self, min_pane: int) -> None:
        """A write into a pane the incremental engine already sealed
        (pane < _inc_next - 1: late-but-open rows, or a lower first pane)
        makes the running window state stale: the next fire rebuilds it."""
        if self._inc_next is not None and min_pane < self._inc_next - 1:
            self._inc_stale = "write into a sealed pane"

    def _pre_fire_flush(self) -> None:
        """Coalesced batches fold before any fire, then the staged host
        tier rows: a fire merges the host tier's part of its window. With
        nothing in flight for any group, the tiering step runs: a
        promotion lands only here, at a batch boundary."""
        self._coalesce_flush()
        self._drain_spill_stage()
        if self._backend is not None and self._backend.tiering_active \
                and self._backend.tier_boundary():
            # promoted keys arrive with identity window-role planes
            self._inc_stale = self._inc_stale or "promotion"

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
        if self._inc_enabled:
            view = self._seal_window(p_end, first)

            def merged(_kind, name, idx=None):
                return view[name] if idx is None else view[name][idx]
        else:
            rows = [p % self._ring for p in range(first, p_end)]
            DEVICE_STATS.note_fire_merge_rows(len(rows))
            backend = self._backend

            def merged(kind, name, idx=None):
                return _merge(kind, backend.get_array(name), rows, idx)
        outs = self._fire_outputs(merged)
        # the host tier's part, taken before the pane below retires
        host_part = (self._host_fire_part([p % self._ring
                                           for p in range(first, p_end)])
                     if self._backend.spill_active else None)
        self._enqueue_fire((p_end, outs, time.perf_counter(), host_part))
        # retire the oldest pane of this window: no later window needs it
        if p_end - W >= self._min_seen_pane:
            self._backend.reset_ring_row((p_end - W) % self._ring)

    # -- incremental fire engine -------------------------------------------
    def _inc_sigs(self) -> tuple[tuple, tuple]:
        """(invertible, merge-tree) signatures over the pane planes: the
        count plane is always invertible; min/max planes take a tree."""
        inv, tree = [("count", "__count__")], []
        for a in self._aggs:
            if a.kind == "count":
                continue
            if a.kind == "avg":
                inv.append(("sum", f"{a.out_name}.sum"))
            elif a.kind in INVERTIBLE_KINDS:
                inv.append((a.kind, a.out_name))
            else:
                tree.append((a.kind, a.out_name))
        return tuple(inv), tuple(tree)

    def _ensure_inc_planes(self, inv_sig: tuple, tree_sig: tuple) -> None:
        """Register the derived window-role planes on the current backend
        (lazily: a restore rebuilds the backend without them)."""
        backend = self._backend
        for kind, name in inv_sig:
            if not backend.has_array(f"{name}.__win__"):
                backend.register_array_state(
                    f"{name}.__win__", kind,
                    _window_dtype(kind, backend.get_array(name).dtype),
                    role="window")
                self._inc_stale = self._inc_stale or "new window planes"
        for kind, name in tree_sig:
            if not backend.has_array(f"{name}.__tree__"):
                backend.register_array_state(
                    f"{name}.__tree__", kind, backend.get_array(name).dtype,
                    ring=2 * self._tree_size, role="window")
                self._inc_stale = self._inc_stale or "new window planes"

    def _seal_window(self, p_end: int, first: int) -> dict:
        """Bring the running window state to this fire, one launch on the
        card: seal the newest pane, or rebuild from the window's pane rows
        when the state is stale. Returns {plane name: [capacity] view}."""
        W, ring, L = self._window_panes, self._ring, self._tree_size
        inv_sig, tree_sig = self._inc_sigs()
        self._ensure_inc_planes(inv_sig, tree_sig)
        backend = self._backend
        planes, view = [], {}
        for kind, name in inv_sig + tree_sig:
            state = backend.get_array(
                f"{name}.__win__" if kind in INVERTIBLE_KINDS
                else f"{name}.__tree__")
            view[name] = torch.empty(state.shape[-1], dtype=state.dtype,
                                     device=self._device)
            planes.append((kind, backend.get_array(name), state,
                           view[name]))
        sub_row = (p_end - W) % ring
        # a retiring pane below the first one seen holds no data, and its
        # ring row may alias a live pane
        sub_valid = p_end - W >= self._min_seen_pane
        cause = self._inc_stale or (None if self._inc_next == p_end
                                    else "fire boundary jump")
        if cause is not None:
            panes = range(first, p_end)
            rebuild(planes, [p % ring for p in panes],
                    [p % L for p in panes], sub_row, sub_valid)
            self.inc_rebuilds[cause] = self.inc_rebuilds.get(cause, 0) + 1
            rows_read = sealed = len(panes)
        else:
            seal(planes, (p_end - 1) % ring, sub_row, sub_valid,
                 (p_end - 1) % L, (p_end - 1 - W) % L)
            rows_read, sealed = (2 if sub_valid else 1), 1
        DEVICE_STATS.note_panes_sealed(sealed)
        DEVICE_STATS.note_fire_merge_rows(rows_read)
        self._inc_stale = None
        self._inc_next = p_end + 1
        return view

    def _fire_outputs(self, merged) -> tuple:
        """The whole fire on the device: the window's merge + emit mask +
        optional top-k + health scalars (dropped inserts, occupancy, late
        rows). ``merged(kind, plane, idx=None)`` is the window's merge of
        a plane, or its values at ``idx`` only (a top-k fire's winners).
        Counts emit as int64 whatever their plane's width, as the full
        merge's sum gives them."""
        backend = self._backend
        table = backend.table
        count = merged("count", "__count__")
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
                s = merged("sum", f"{first.out_name}.sum")
                ranked = s / count.clamp(min=1).to(s.dtype)
            else:
                ranked = merged(first.kind, first.out_name)
            _vals, idx, ok = masked_topk(ranked, emit, self._topk,
                                         value_bits=first.value_bits)
            count_k = count[idx].to(torch.int64)
            out = {}
            for a in self._aggs:
                if a.kind == "count":
                    out[a.out_name] = count_k
                elif a.out_name == first.out_name:
                    out[a.out_name] = ranked[idx]
                elif a.kind == "avg":
                    s = merged("sum", f"{a.out_name}.sum", idx)
                    out[a.out_name] = s / count_k.clamp(min=1).to(s.dtype)
                else:
                    out[a.out_name] = merged(a.kind, a.out_name, idx)
            return table[idx], ok, out, health
        results = {}
        for a in self._aggs:
            if a.kind == "count":
                results[a.out_name] = count.to(torch.int64)
            elif a.kind == "avg":
                s = merged("sum", f"{a.out_name}.sum")
                results[a.out_name] = s / count.clamp(min=1).to(s.dtype)
            else:
                results[a.out_name] = merged(a.kind, a.out_name)
        return table, emit, results, health

    def _host_fire_part(self, rows: list[int]):
        """The window's results for the host tier's keys (numpy merges of
        their ring rows), or None when none has a row in it. Under top k
        only the host's own k best (stable in host order) can place, so
        the other aggregates are merged at those keys alone."""
        t0 = time.perf_counter()
        ht = self._backend.host_tier
        rows = np.asarray(rows, np.int64)
        hcount = ht.fire("__count__", rows)
        pos = np.flatnonzero(hcount > 0)
        if not len(pos):
            self.spill_s["host_fire"] += time.perf_counter() - t0
            return None
        count = hcount[pos]
        if self._topk is not None and len(pos) > self._topk:
            first = self._aggs[0]
            if first.kind == "count":
                ranked = count
            elif first.kind == "avg":
                s = ht.fire(f"{first.out_name}.sum", rows, pos)
                ranked = s / np.maximum(count, 1).astype(s.dtype)
            else:
                ranked = ht.fire(first.out_name, rows, pos)
            k = self._topk
            kth = np.partition(ranked, len(ranked) - k)[len(ranked) - k]
            cand = np.flatnonzero(ranked >= kth)
            keep = np.sort(cand[np.argsort(-ranked[cand],
                                           kind="stable")[:k]])
            pos, count = pos[keep], count[keep]
        res: dict[str, np.ndarray] = {}
        for a in self._aggs:
            if a.kind == "count":
                res[a.out_name] = count
            elif a.kind == "avg":
                s = ht.fire(f"{a.out_name}.sum", rows, pos)
                res[a.out_name] = s / np.maximum(count, 1).astype(s.dtype)
            else:
                res[a.out_name] = ht.fire(a.out_name, rows, pos)
        self.spill_s["host_fire"] += time.perf_counter() - t0
        return ht.keys()[pos], res

    def _materialize(self, item) -> None:
        p_end, host, _event, t0, host_part = item
        keys_or_table, mask, results, (dropped, occ, late) = host
        self._backend.apply_health(int(dropped), int(occ))
        if late is not None:
            self._late_cached = int(late)
        sel = mask.numpy()
        if self._topk is not None:
            keys = keys_or_table.numpy()[sel]
            results = {n: v.numpy()[sel] for n, v in results.items()}
        else:
            idx = np.flatnonzero(sel)
            keys = keys_or_table.numpy()[idx]
            results = {n: v.numpy()[idx] for n, v in results.items()}
        if host_part is not None:
            hkeys, hres = host_part
            keys = np.concatenate([keys, hkeys])
            results = {n: np.concatenate(
                [v, hres[n].astype(v.dtype, copy=False)])
                for n, v in results.items()}
            if self._topk is not None:
                # re-rank across both tiers, ties in (device, host) order;
                # also when both hold k keys or fewer together, so the rows
                # come in rank order as an unbudgeted run's do (the
                # reference re-ranks only past k)
                order = np.argsort(-results[self._aggs[0].out_name],
                                   kind="stable")[:self._topk]
                keys = keys[order]
                results = {n: v[order] for n, v in results.items()}
        if self._topk is None:
            # canonical emission order: raw slot order leaks insert history
            order = np.argsort(keys, kind="stable")
            keys = keys[order]
            results = {n: v[order] for n, v in results.items()}
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
        self._coalesce_flush()
        self._drain(block=True)
        self._refresh_late()

    def close(self) -> None:
        if self._backend is not None and self._backend.tiering_active:
            from ...state.tiering import unregister_residency
            self._backend.prefetch_pipeline.close()
            unregister_residency(self._residency_name)

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
        self._pre_fire_flush()   # buffered batches belong in the snapshot
        self._refresh_late()
        return {"keyed": {"backend": self._backend.snapshot(checkpoint_id),
                          "meta": self._control_meta()}}
