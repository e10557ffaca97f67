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

The device guard and the degrade ladder (``runtime/faults.py``,
``runtime/watchdog.py``):

* Every dispatch runs under a ``DeviceGuard`` (site ``device.execute``)
  on the task's thread: the ingest step, the fused chain's replay, and a
  fire's seal or rebuild with its merge, select and health scalars. Each
  guarded region ends at its launches. The guard retries or degrades
  only faults and hangs of its own visit, which come before the
  dispatch, so a batch never folds twice. The blocking reads are
  ``stall_bounded`` regions of their own on the supervised worker: an
  upload (``transfer.h2d``), a fire's materialization and a staged spill
  drain (``transfer.d2h``); the in-flight wait is bounded by the
  ``device.execute`` deadline. A stall of one of them fails the task.
* ``faults.validate-batches``: rows with NaN or Inf in an aggregated
  float column go to the ``dead-letter`` side output (counted in
  ``dead_letter_records_total``) before they fold, and so do fire rows
  whose results are not finite.
* A poison fault quarantines its batch to ``dead-letter``, unfolded.
* A persistent fault, or retries run out, walks the degrade ladder
  (``device.failover.degradation``, on by default): the state evacuates
  through ``snapshot(-1)`` into an unbudgeted backend on the CPU that
  runs the kernels' plain versions, and the operator stays there: no
  fused chain, device batches copied home, the residency cancelled and
  unregistered, ``DEVICE_STATS`` ``device_degraded_total`` counted and
  ``degrade_s`` timed. Only an injected fault or a stall walks it: a real
  CUDA error, a failed build or a library that does not load propagates
  into task failover untouched.
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
from ..faults import FAULTS, DeviceGuard, DeviceSegmentError
from ..watchdog import WATCHDOG, stall_bounded
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
        # the degrade ladder: once a persistent fault evacuated the state
        # to the CPU, the operator stays on that rung for its lifetime
        self._guard: Optional[DeviceGuard] = None
        self._degraded = False
        self._degrade_enabled = True
        self._validate_batches = False
        #: batches quarantined to the dead-letter output
        self.quarantined_batches = 0
        #: seconds the evacuation to the CPU rung took (None: no degrade)
        self.degrade_s: Optional[float] = None

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
        self._guard = DeviceGuard("device_window", ctx.config)
        self._degrade_enabled = bool(
            ctx.config.get("device.failover.degradation"))
        self._validate_batches = bool(
            ctx.config.get("faults.validate-batches"))
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
        if self._validate_batches:
            batch = self._screen_nonfinite(batch)
            if batch.n == 0:
                return
        if (self._fused_spec is not None and getattr(batch, "lazy", False)
                and not batch.realized and not self._spill_deferred):
            self._ingest_chain(batch)
        elif self._degraded:
            self._ingest_at_home(batch)
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

        def upload():
            cols = {self._key_column: self._upload(np.asarray(
                batch.column(self._key_column)).astype(np.int64,
                                                        copy=False))}
            for a in self._aggs:
                if a.field is not None and a.field not in cols:
                    cols[a.field] = self._upload(batch.column(a.field))
            return cols, self._upload(ts)

        cols, dts = stall_bounded("transfer.h2d", upload,
                                  scope="device_window")
        schema = Schema([(f.name, f.dtype) for f in batch.schema.fields
                         if f.name in cols])
        return DeviceRecordBatch(schema, cols, dts, int(ts.min()),
                                 int(ts.max()))

    # -- the degrade ladder and the dead-letter output ----------------------
    def _host_view(self, batch) -> RecordBatch:
        """A host batch of ``batch`` (a device batch's columns copied
        home; a lazy one is decoded first)."""
        if isinstance(batch, DeviceRecordBatch):
            if getattr(batch, "lazy", False):
                batch.realize()
            return batch._materialize()
        return batch

    def _screen_nonfinite(self, batch: RecordBatch) -> RecordBatch:
        """``faults.validate-batches``: rows with NaN or Inf in an
        aggregated float column go to the dead-letter output before they
        fold; a NaN in a sum plane would spoil every later window of its
        key."""
        bad = None
        for a in self._aggs:
            if a.field is None:
                continue
            col = np.asarray(self._host_view(batch).column(a.field))
            if not np.issubdtype(col.dtype, np.floating):
                continue
            mask = ~np.isfinite(col)
            bad = mask if bad is None else (bad | mask)
        if bad is None or not bad.any():
            return batch
        hb = self._host_view(batch)
        self._dead_letter(hb.filter(bad))
        return hb.filter(~bad)

    def _dead_letter(self, batch: RecordBatch) -> None:
        """Quarantine a host batch: counted, emitted on the ``dead-letter``
        side output where one is wired, never folded."""
        DEVICE_STATS.note_dead_letter(batch.n)
        self.quarantined_batches += 1
        try:
            self.output.emit_side("dead-letter", batch)
        except NotImplementedError:
            pass   # no side output wired: the counter is the record

    def _degrade(self, cause: BaseException) -> None:
        """A persistent fault: evacuate the state through ``snapshot(-1)``
        into an unbudgeted backend on the CPU and stay there. The keyed
        state and the pane and fire metadata carry over, so the results
        are the same; no fault site trips on this rung."""
        if self._degraded:
            raise cause
        t0 = time.perf_counter()
        with FAULTS.suppressed():
            self._drain(block=True)
            while self._inflight:
                self._inflight.popleft().synchronize()
            self._pre_fire_flush()
            snap = self._backend.snapshot(-1)
            if self._late_dev is not None:
                self._late_dropped += int(self._late_dev)
                self._late_dev = None
                self._late_cached = 0
            cpu = torch.device("cpu")
            backend = DeviceKeyedStateBackend(
                self.ctx.key_group_range, self.ctx.max_parallelism,
                capacity=self._capacity, device=cpu, defer_overflow=False,
                hbm_budget_slots=0, config=self.ctx.config)
            backend.restore([snap])
        if self._backend.tiering_active:
            # the CPU backend is unbudgeted: the residency and any queued
            # staging retire with the old one
            from ...state.tiering import unregister_residency
            self._backend.prefetch_pipeline.close()
            unregister_residency(self._residency_name)
        self._backend = backend
        self._device = cpu
        self._defer = False
        self._stage = None
        self._fused_spec = None
        self.fused_chain = None
        self._degraded = True
        self._guard.active = False
        # the evacuated snapshot carries only the pane planes
        self._inc_stale = "degrade"
        self._inc_next = None
        DEVICE_STATS.note_degraded("device_window")
        self.degrade_s = time.perf_counter() - t0

    def _on_segment_failure(self, err: DeviceSegmentError,
                            batch=None) -> bool:
        """Poison quarantines the batch (True: handled, nothing folded);
        anything else degrades when allowed (False: the caller runs the
        work again on the CPU rung) or fails the task."""
        if err.poison and batch is not None:
            self._dead_letter(self._host_view(batch))
            return True
        if self._degrade_enabled and not self._degraded:
            self._degrade(err)
            return False
        raise err

    def _guarded_ingest(self, batch, dispatch) -> None:
        """Run an ingest ``dispatch`` under the guard; after a degrade the
        batch runs through the CPU rung (the guard raises only for its
        own visit, before the dispatch, so nothing of it was folded)."""
        try:
            self._guard.run(dispatch)
        except DeviceSegmentError as e:
            if not self._on_segment_failure(e, batch):
                self._ingest_at_home(batch)
            return
        self._admit_token()

    def _ingest_at_home(self, batch) -> None:
        """The CPU rung's ingest: a device batch comes home and takes the
        plain host path."""
        hb = self._host_view(batch)
        self._ingest(hb, np.asarray(hb.column(self._key_column)).astype(
            np.int64, copy=False))

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
        self._guarded_ingest(batch, lambda: self._step(batch, first_open))

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
        self._guarded_ingest(batch, lambda: self.fused_chain.run(
            batch, backend.table, planes, self._late_dev,
            backend.dropped_device, first_open, backend.dirty_buffer,
            backend.dirty_shift))

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
        stage = self._stage

        host = stall_bounded(
            "transfer.d2h", lambda: {k: v[:take].cpu().numpy()
                                     for k, v in stage.items()
                                     if k != "count"},
            scope="device_window")
        vals = {"__count__": np.ones(take, np.int64)}
        for _k, name, _f in self._fold_sig():
            vals[name] = host[name]
        self._backend.drain_staged(host["keys"], host["ring"], vals)
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
            # bounded: a step that never retires (a wedged card) fails the
            # task into a restart instead of blocking its loop forever; a
            # step already retired cannot block, and goes unsupervised
            event = self._inflight.popleft()
            if not event.query():
                WATCHDOG.run("device.execute", event.synchronize,
                             scope="device_window.inflight")
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

        def dispatch():
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
            return self._fire_outputs(merged)

        try:
            outs = self._guard.run(dispatch)
        except DeviceSegmentError as e:
            # a fire has no batch to quarantine: a persistent fault walks
            # the ladder and the fire runs again on the CPU rung (a seal's
            # window state is stale there: it rebuilds from the panes)
            self._on_segment_failure(e)
            outs = dispatch()
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

    def _await_copy(self, event) -> None:
        """A fire's device->host copy, bounded: site ``transfer.d2h``. A
        copy that has landed cannot block: with no fault armed it goes
        unsupervised. On the CPU rung it is a host view."""
        if (self._guard is not None and self._guard.active
                and (FAULTS.enabled or not (event is None or event.query()))):
            stall_bounded("transfer.d2h", lambda: event is None
                          or event.synchronize(), scope="device_window")
        elif event is not None:
            event.synchronize()

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
        if self._validate_batches and len(keys):
            # a non-finite result, however it got into a plane, goes to
            # the dead-letter count, not down the main stream
            bad = np.zeros(len(keys), bool)
            for v in results.values():
                if np.issubdtype(np.asarray(v).dtype, np.floating):
                    bad |= ~np.isfinite(v)
            if bad.any():
                DEVICE_STATS.note_dead_letter(int(bad.sum()))
                keys = keys[~bad]
                results = {n_: v[~bad] for n_, v in results.items()}
                if not len(keys):
                    return
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
