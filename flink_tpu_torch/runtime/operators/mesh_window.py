"""Mesh slice-window operator: one JobGraph vertex over D shards (port of
``flink_tpu/runtime/operators/mesh_window.py``).

Instead of D parallel subtasks joined by a hash repartition, one vertex
drives a mesh of D shards (``parallel/``): the keyBy edge into the vertex
is the exchange on the device, and upstream vertices hand this operator
their batches as they come.

* Host batches take the host late filter, then gather on the host into
  blocks of D source blocks of ``device_batch`` rows, uploaded a block at a
  time. Device batches (``DeviceRecordBatch``) stay on the card: their
  pane bookkeeping runs on the event-time bounds, their columns gather
  into a block on the device (a batch of exactly one block is used as it
  is), and the step's kernel counts their late rows. A device batch is
  never copied home.
* A block is one step: one ``exchange_bucket`` launch and one counted
  ``ingest_step`` launch per shard (``ShardedWindowAgg.step_block``); the
  host waits on no step, only on the one ``task.max-inflight`` steps back.
* Fires (the shared pane and watermark protocol of ``slice_control.py``)
  merge every shard's window, or seal the incremental planes
  (``window.fire.incremental``), with the emit mask, the health scalars
  and, with ``emit_topk``, the two-phase global top k, on the device; the
  outputs copy home asynchronously (``async_fire`` holds watermarks behind
  them). The oldest pane's ring row then retires.
* Pressure: a probe of (largest shard occupancy, total drops) is
  dispatched at watermark cadence and read when its copy has landed; the
  fires carry the same scalars. A shard past 0.6 of its capacity grows the
  mesh (through a host snapshot); a dropped row fails the task.
* Snapshots are the single-device backend's key-group format
  (``{"kind": "tpu", ...}``, canonical order), so a restore filters keys by
  the new mesh's ranges: a job rescales 8 -> 4 -> 8 shards, or hands its
  state to the single-device operator and back.
* Live rescale (``request_rescale``, applied at the next snapshot, or
  ``rescale_live``): the state moves through the checkpoint's key-group
  pages (``parallel/rescale.py``), digest-verified, onto the new mesh; the
  incremental planes are rebuilt, never shipped. The change is one trace
  tree: a ``rescale.Rescale`` span with ``Migrate`` (the page diff and
  transfer) and ``Rebuild`` (the install on the new mesh) children.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ...core.device_records import DeviceRecordBatch
from ...core.records import RecordBatch, Schema
from ...device import resolve_device, torch_dtype
from ...metrics.device import DEVICE_STATS
from ...ops.segment_ops import identity
from ...parallel.mesh import make_mesh, shard_ranges
from ...parallel.sharded_window import MIN_PANE, AggDef, ShardedWindowAgg
from ...window.assigners import WindowAssigner
from .base import OneInputOperator, OperatorContext, Output
from .device_window import AggSpec
from .slice_control import AsyncFireQueue, SliceControlPlane, _to_host

__all__ = ["MeshWindowAggOperator"]


class MeshWindowAggOperator(AsyncFireQueue, SliceControlPlane,
                            OneInputOperator):
    """Keyed slice-window aggregation over a mesh of shards."""

    def __init__(self, assigner: WindowAssigner, key_column: str,
                 aggs: Sequence[AggSpec],
                 n_devices: Optional[int] = None,
                 capacity: int = 1 << 16,
                 ring_size: int = 64,
                 device_batch: int = 1 << 12,
                 emit_window_bounds: bool = True,
                 emit_topk: Optional[int] = None,
                 async_fire: bool = False,
                 fire_incremental: Optional[bool] = None,
                 device=None, devices: Optional[Sequence] = None,
                 name: str = "MeshWindowAgg"):
        """``n_devices``: shards (None: one for each of ``devices``, else
        one). ``capacity``: slots a shard. ``device_batch``: rows of a
        source block (a step folds ``n_devices`` of them). ``device``: the
        entry point's device, ``cuda`` unless ``"cpu"`` is asked for;
        ``devices``: the shards' devices (default: every shard on
        ``device``)."""
        super().__init__(name)
        pane = assigner.pane_size
        if pane is None:
            raise ValueError(
                "Mesh window operator needs a pane-decomposable assigner "
                "(tumbling, or sliding with size % slide == 0)")
        self._device = resolve_device(device)
        self._devices = list(devices) if devices is not None else None
        self._pane = int(pane)
        self._offset = int(getattr(assigner, "offset", 0))
        size = getattr(assigner, "size", self._pane)
        self._window_panes = int(size) // self._pane
        self._ring = int(ring_size)
        if self._ring < self._window_panes + 1:
            raise ValueError("ring_size must exceed panes per window")
        self._key_column = key_column
        self._aggs = list(aggs)
        self._capacity = int(capacity)
        self._device_batch = int(device_batch)
        self._emit_bounds = emit_window_bounds
        self._topk = emit_topk
        self._async = bool(async_fire)
        self._n_devices = n_devices
        # incremental planes, held outside the state: never snapshotted,
        # rebuilt after a restore, a grow or a rescale
        self._inc_flag = fire_incremental
        self._inc_enabled = bool(fire_incremental)
        self._inc_next: Optional[int] = None
        self._inc_dirty = True
        self._inc_wins: dict = {}
        self._inc_trees: dict = {}
        self._agg: Optional[ShardedWindowAgg] = None
        self._state = None
        # live rescale: a change staged for the next aligned barrier, and
        # the mesh generation it fences
        self._rescale_request: Optional[int] = None
        self._rescale_epoch = 0
        self._last_rescale_stats: Optional[dict] = None
        self._init_control_plane()
        self._init_async_fires()
        if self._async:
            self._record_fire_latency = False
        self._dropped_seen = 0
        self._late_dev_seen = 0
        self.stage_s: dict[str, float] = {}
        self._probe = None
        self._blocks_since_probe = 0
        self._inflight: deque = deque()
        self._max_inflight = 2
        # host staging (panes) and device staging (timestamps) of a block
        self._buf_keys: list[np.ndarray] = []
        self._buf_panes: list[np.ndarray] = []
        self._buf_cols: dict[str, list[np.ndarray]] = {}
        self._buf_n = 0
        self._dstage: Optional[dict] = None
        self._dstage_n = 0
        #: perf_counter of the first batch
        self.first_batch_at: Optional[float] = None
        #: steps run (blocks folded), and blocks that were a batch as is
        self.steps = 0
        self.zero_copy_blocks = 0
        #: times the host waited on the card for the step in flight
        #: ``task.max-inflight`` blocks back
        self.host_waits = 0

    # -- lifecycle ---------------------------------------------------------
    def setup(self, ctx: OperatorContext, output: Output) -> None:
        super().setup(ctx, output)
        self._max_inflight = max(1, int(ctx.config.get("task.max-inflight")))
        P = ctx.parallelism
        n = self._n_devices or (len(self._devices) if self._devices else 1)
        self._n_devices = int(n)
        # key groups live in the job's max-parallelism space, so mesh and
        # host subtasks agree on ownership
        self._max_parallelism = ctx.max_parallelism
        # at vertex parallelism P > 1 this subtask owns its range, and its
        # mesh re-splits it (the two-level split)
        self._base_range = ctx.key_group_range if P > 1 else None
        base_len = (self._max_parallelism if self._base_range is None
                    else self._base_range.end - self._base_range.start + 1)
        if base_len < n:
            raise ValueError(
                f"subtask key-group range ({base_len} groups) must be >= "
                f"mesh size ({n}); raise pipeline.max-parallelism")
        self._parallelism = P
        self._sub_index = ctx.subtask_index
        self._mesh = self._mesh_for(n)
        if self._inc_flag is None:
            self._inc_enabled = bool(ctx.config.get("window.fire.incremental"))

    def _mesh_for(self, n: int) -> list:
        """The shards' devices: a subtask's slice of ``devices`` when they
        hold every subtask's, else the first n; by default all on the
        entry device."""
        if self._devices is None:
            return make_mesh(n, device=self._device)
        sub, P = getattr(self, "_sub_index", 0), getattr(self,
                                                         "_parallelism", 1)
        if P > 1 and len(self._devices) >= (sub + 1) * n:
            return make_mesh(n, self._devices[sub * n:(sub + 1) * n])
        return make_mesh(n, self._devices)

    def initialize_state(self, keyed_snapshots: list,
                         operator_snapshot) -> None:
        if not keyed_snapshots:
            return
        self._restore_control_meta([s["meta"] for s in keyed_snapshots])
        self._restore_backends([s["backend"] for s in keyed_snapshots])
        self._mark_inc_dirty()

    def _mark_inc_dirty(self) -> None:
        self._inc_dirty = True
        self._inc_next = None
        self._inc_wins = {}
        self._inc_trees = {}

    def _note_open_ingest(self, min_pane: int) -> None:
        if self._inc_next is not None and min_pane < self._inc_next - 1:
            self._inc_dirty = True

    # -- the aggregate ------------------------------------------------------
    def _aggdefs(self, schema: Schema) -> list[AggDef]:
        """AggSpec -> planes: a value plane's dtype follows its column (an
        int64 sum stays int64); avg keeps a float32 sum plane and divides
        by the count at emit; a count is int64."""
        defs = []
        for a in self._aggs:
            if a.kind == "count":
                defs.append(AggDef(a.out_name, "count", torch.int64))
            elif a.kind == "avg":
                defs.append(AggDef(f"{a.out_name}.sum", "sum", torch.float32))
            else:
                dt = (torch_dtype(schema.field(a.field).dtype)
                      if a.field in schema else a.dtype)
                defs.append(AggDef(a.out_name, a.kind, dt))
        return defs

    @staticmethod
    def _plane_name(a: AggSpec) -> str:
        return f"{a.out_name}.sum" if a.kind == "avg" else a.out_name

    def _build(self, defs: list[AggDef], capacity: Optional[int] = None
               ) -> None:
        if self._state is not None:
            # the old state's late rows stay counted
            self._refresh_late()
            self._late_dropped += self._late_dev_seen
        self._agg = ShardedWindowAgg(
            self._mesh, defs, capacity=capacity or self._capacity,
            ring=self._ring, max_parallelism=self._max_parallelism,
            base_range=self._base_range)
        self._state = self._agg.init_state()
        self._late_dev_seen = 0

    def _ensure_built(self, schema: Schema) -> None:
        if self._agg is not None:
            return
        key_dtype = schema.field(self._key_column).dtype
        if key_dtype is object or not np.issubdtype(np.dtype(key_dtype),
                                                    np.integer):
            raise TypeError(
                f"mesh window aggregation needs an integer key column; "
                f"{self._key_column!r} is {key_dtype}")
        self._build(self._aggdefs(schema))

    def _column_of(self, plane: str) -> str:
        for a in self._aggs:
            if a.kind != "count" and self._plane_name(a) == plane:
                return a.field
        raise KeyError(f"no input column for plane {plane!r}")

    @property
    def _block_rows(self) -> int:
        return self._n_devices * self._device_batch

    def _first_open(self) -> int:
        return (self._fired_boundary - self._window_panes
                if self._fired_boundary is not None else MIN_PANE)

    # -- data path ----------------------------------------------------------
    def process_batch(self, batch: RecordBatch) -> None:
        if self._pending:
            self._drain(block=False)
        if batch.n == 0:
            return
        if self.first_batch_at is None:
            self.first_batch_at = time.perf_counter()
        self._ensure_built(batch.schema)
        if isinstance(batch, DeviceRecordBatch) \
                and batch.dtimestamps is not None:
            self._ingest_device(batch)
            return
        keys = np.asarray(batch.column(self._key_column)).astype(np.int64)
        self._ingest(batch, keys)

    def _fold(self, batch: RecordBatch, keys: np.ndarray,
              panes: np.ndarray) -> None:
        """Host rows (late ones already dropped): gathered into blocks."""
        self._flush_device(pad=True)
        self._buf_keys.append(keys)
        self._buf_panes.append(panes)
        for a in self._agg.value_aggs:
            self._buf_cols.setdefault(a.name, []).append(
                np.asarray(batch.column(self._column_of(a.name))))
        self._buf_n += batch.n
        if self._buf_n >= self._block_rows:
            self._flush_host(pad=False)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self._mesh[0])

    def _flush_host(self, pad: bool) -> None:
        """Host rows into steps: every full block, and with ``pad`` the
        remainder as a last block of fewer valid rows."""
        if self._agg is None or self._buf_n == 0:
            return
        D, B = self._n_devices, self._device_batch
        full = D * B
        keys = np.concatenate(self._buf_keys)
        panes = np.concatenate(self._buf_panes)
        cols = {n: np.concatenate(vs) for n, vs in self._buf_cols.items()}
        pos, total = 0, len(keys)
        while total - pos >= full or (pad and pos < total):
            n_valid = min(full, total - pos)
            ks = np.zeros(full, np.int64)
            ps = np.zeros(full, np.int64)
            ks[:n_valid] = keys[pos:pos + n_valid]
            ps[:n_valid] = panes[pos:pos + n_valid]
            cs = {}
            for n, c in cols.items():
                buf = np.zeros(full, c.dtype)
                buf[:n_valid] = c[pos:pos + n_valid]
                cs[n] = self._upload(buf).view(D, B)
            self._step(self._upload(ks).view(D, B),
                       self._upload(ps).view(D, B), cs, n_valid, 1, 0)
            pos += n_valid
        self._buf_keys = [keys[pos:]] if pos < total else []
        self._buf_panes = [panes[pos:]] if pos < total else []
        self._buf_cols = ({n: [c[pos:]] for n, c in cols.items()}
                          if pos < total else {})
        self._buf_n = total - pos

    def _device_bookkeeping(self, batch: DeviceRecordBatch) -> bool:
        """Pane bookkeeping of a device batch on its event-time bounds;
        False when the whole batch is behind the fired boundary (dropped
        and counted, no device work)."""
        pane_lo = (batch.ts_min - self._offset) // self._pane
        pane_hi = (batch.ts_max - self._offset) // self._pane
        first_open = (self._fired_boundary - self._window_panes
                      if self._fired_boundary is not None else None)
        if first_open is not None and pane_hi < first_open:
            self._late_dropped += batch.n
            return False
        eff_lo = pane_lo if first_open is None else max(pane_lo, first_open)
        self._max_seen_pane = (pane_hi if self._max_seen_pane is None
                               else max(self._max_seen_pane, pane_hi))
        self._min_seen_pane = (eff_lo if self._min_seen_pane is None
                               else min(self._min_seen_pane, eff_lo))
        self._note_open_ingest(eff_lo)
        self._check_ring(pane_hi)
        return True

    def _ingest_device(self, batch: DeviceRecordBatch) -> None:
        """A device batch: bookkeeping on the bounds, its columns into the
        device block (the kernel drops its late rows)."""
        if not self._device_bookkeeping(batch):
            return
        self._flush_host(pad=True)
        dev = self._mesh[0]
        keys = batch.device_column(self._key_column).to(dev, torch.int64)
        ts = batch.dtimestamps.to(dev, torch.int64)
        cols = {a.name: batch.device_column(self._column_of(a.name)).to(dev)
                for a in self._agg.value_aggs}
        full = self._block_rows
        D, B = self._n_devices, self._device_batch
        if self._dstage_n == 0 and batch.n == full:
            self.zero_copy_blocks += 1
            self._step(keys.view(D, B), ts.view(D, B),
                       {n: c.view(D, B) for n, c in cols.items()}, full,
                       self._pane, self._offset)
            return
        pos = 0
        while pos < batch.n:
            st = self._device_stage(cols)
            take = min(full - self._dstage_n, batch.n - pos)
            at = slice(self._dstage_n, self._dstage_n + take)
            st["keys"][at].copy_(keys[pos:pos + take])
            st["ts"][at].copy_(ts[pos:pos + take])
            for n, c in cols.items():
                st["cols"][n][at].copy_(c[pos:pos + take])
            self._dstage_n += take
            pos += take
            if self._dstage_n == full:
                self._flush_device(pad=False)

    def _device_stage(self, cols: dict) -> dict:
        full = self._block_rows
        if self._dstage is None:
            dev = self._mesh[0]
            self._dstage = {
                "keys": torch.empty(full, dtype=torch.int64, device=dev),
                "ts": torch.empty(full, dtype=torch.int64, device=dev),
                "cols": {n: torch.empty(full, dtype=c.dtype, device=dev)
                         for n, c in cols.items()}}
        return self._dstage

    def _flush_device(self, pad: bool) -> None:
        """The device block into a step: when full, or with ``pad`` when
        it holds any row. A new block buffer follows, so the step's reads
        never race the next batch's copies."""
        n = self._dstage_n
        if n == 0 or (n < self._block_rows and not pad):
            return
        st, self._dstage, self._dstage_n = self._dstage, None, 0
        D, B = self._n_devices, self._device_batch
        self._step(st["keys"].view(D, B), st["ts"].view(D, B),
                   {k: c.view(D, B) for k, c in st["cols"].items()}, n,
                   self._pane, self._offset)

    def _step(self, keys, ts, cols: dict, n_valid: int, pane: int,
              offset: int) -> None:
        self._agg.step_block(self._state, keys, ts, cols, n_valid=n_valid,
                             pane=pane, offset=offset,
                             first_open=self._first_open())
        self.steps += 1
        self._blocks_since_probe += 1
        self._admit_token()

    def _admit_token(self) -> None:
        """Bounded in-flight steps: wait for the step ``max_inflight``
        blocks back, then drain any fires that landed."""
        if self._mesh[0].type != "cuda":
            return
        event = torch.cuda.Event()
        event.record()
        self._inflight.append(event)
        if len(self._inflight) > self._max_inflight:
            event = self._inflight.popleft()
            if not event.query():
                self.host_waits += 1
                event.synchronize()
            if self._pending:
                self._drain(block=False)

    def _flush(self, pad: bool) -> None:
        self._flush_host(pad)
        self._flush_device(pad)

    # -- pressure -------------------------------------------------------------
    def _pre_fire_flush(self) -> None:
        self._flush(pad=True)
        self._pressure_probe()

    def _pressure_probe(self) -> None:
        """Growth without a stall: the pressure scalars are dispatched at
        watermark cadence and read once their copy has landed; the growth
        decision adds a margin for the blocks dispatched since."""
        if self._agg is None:
            return
        if self._probe is not None:
            host, event = self._probe
            if event is None or event.query():
                self._probe = None
                dropped, occ = (int(v) for v in host)
                self._check_dropped(dropped)
                need = occ + self._blocks_since_probe * self._device_batch
                if need > 0.6 * self._agg.capacity:
                    target = self._agg.capacity
                    while need > 0.6 * target:
                        target *= 2
                    self._grow(target)
        if self._probe is None and self._blocks_since_probe:
            host = _to_host(list(self._agg._health(self._state)))
            event = None
            if self._mesh[0].type == "cuda":
                event = torch.cuda.Event()
                event.record()
            self._probe = (host, event)
            self._blocks_since_probe = 0

    def _check_dropped(self, dropped: int) -> None:
        if dropped > self._dropped_seen:
            raise RuntimeError(
                f"mesh hash table overflow: {dropped} records dropped "
                f"(capacity {self._agg.capacity} per shard); raise "
                "state.backend.tpu.slots-per-key-group")

    def _grow(self, new_capacity: int) -> None:
        self._drain(block=True)   # pending fires read the state before
        # rows the old tables dropped since the last check must fail the
        # task here: the new state starts with no drops (the reference
        # grows past them and loses the rows silently)
        self._check_dropped(int(self._agg._health(self._state)[0]))
        snap = self._agg.snapshot(self._state)
        self._build(list(self._agg.aggs), capacity=new_capacity)
        self._load_snapshot_into_state([snap])
        self._probe = None
        self._mark_inc_dirty()

    # -- fires --------------------------------------------------------------
    def _rank(self) -> tuple[Optional[str], int]:
        if self._topk is None:
            return None, 64
        first = self._aggs[0]
        name = (self._agg.count_name if first.kind == "count"
                else self._plane_name(first))
        return name, (first.value_bits if first.kind != "avg" else 64)

    def _fire(self, p_end: int) -> None:
        if self._agg is None:
            return
        t_fire = time.perf_counter()
        W = self._window_panes
        # panes below min_seen hold no data and their ring rows may hold
        # live later panes
        first = max(p_end - W, self._min_seen_pane)
        if first >= p_end:
            return
        rank_name, bits = self._rank()
        if self._inc_enabled:
            outs = self._fire_incremental(p_end, first, rank_name, bits)
        else:
            rows = [p % self._ring for p in range(first, p_end)]
            DEVICE_STATS.note_fire_merge_rows(len(rows))
            outs = self._agg.fire_compact(self._state, rows, None,
                                          rank_name, self._topk, bits)
        self._enqueue_fire((p_end, outs, time.perf_counter()))
        if p_end - W >= self._min_seen_pane:
            self._state = self._agg.retire_row(self._state,
                                               (p_end - W) % self._ring)
        self.stage_s["fire"] = self.stage_s.get("fire", 0.0) + (
            time.perf_counter() - t_fire)

    def _fire_incremental(self, p_end: int, first: int,
                          rank_name: Optional[str], bits: int):
        """Seal the newest pane into the running window planes, or rebuild
        them from the pane rows when stale (restore, grow, a jump of the
        fire boundary, a write into a sealed pane)."""
        W, ring, L = self._window_panes, self._ring, self._agg.tree_size
        panes = range(first, p_end)
        sub_row = (p_end - W) % ring
        sub_valid = p_end - W >= self._min_seen_pane
        if (self._inc_dirty or self._inc_next != p_end
                or not (self._inc_wins or self._inc_trees)):
            view, self._inc_wins, self._inc_trees = self._agg.rebuild_inc(
                self._state, [p % ring for p in panes], None,
                [p % L for p in panes], sub_row, sub_valid)
            rows_read = sealed = len(panes)
        else:
            view, self._inc_wins, self._inc_trees = self._agg.seal_inc(
                self._state, self._inc_wins, self._inc_trees,
                (p_end - 1) % ring, sub_row, sub_valid, (p_end - 1) % L,
                (p_end - 1 - W) % L)
            rows_read, sealed = (2 if sub_valid else 1), 1
        DEVICE_STATS.note_panes_sealed(sealed)
        DEVICE_STATS.note_fire_merge_rows(rows_read)
        self._inc_dirty = False
        self._inc_next = p_end + 1
        return self._agg.fire_inc(self._state, view, rank_name, self._topk,
                                  bits)

    def _materialize(self, item: tuple) -> None:
        """Emit a landed fire, then act on the pressure it carried: a grow
        drains the later fires and the watermarks held behind them, so it
        runs only after this fire's rows are out (the reference grows
        first and emits them behind those watermarks)."""
        p_end, host, _event, t0 = item
        if self._topk is not None:
            keys_k, ok, results, dropped, occ = host
            self._check_dropped(int(dropped))
            sel = ok.numpy()
            keys = keys_k.numpy()[sel]
            res = {n: v.numpy()[sel] for n, v in results.items()}
        else:
            tables, emits, results, dropped, occ = host
            self._check_dropped(int(dropped))
            mask = np.concatenate([e.numpy() for e in emits])
            idx = np.flatnonzero(mask)
            keys = np.concatenate([t.numpy() for t in tables])[idx]
            res = {n: np.concatenate([v.numpy() for v in vs])[idx]
                   for n, vs in results.items()}
            # canonical emission order: slot order leaks insert history
            order = np.argsort(keys, kind="stable")
            keys = keys[order]
            res = {n: v[order] for n, v in res.items()}
        if len(keys):
            self._emit_rows(p_end, keys, res)
        self._note_latency(t0)
        if int(occ) > 0.6 * self._agg.capacity:
            self._grow(self._agg.capacity * 2)

    def _emit_rows(self, p_end: int, keys: np.ndarray, host: dict) -> None:
        count_name = self._agg.count_name
        n = len(keys)
        start = (p_end - self._window_panes) * self._pane + self._offset
        end = p_end * self._pane + self._offset
        cols: dict[str, np.ndarray] = {self._key_column: keys}
        fields: list[tuple[str, Any]] = [(self._key_column, np.int64)]
        if self._emit_bounds:
            cols["window_start"] = np.full(n, start, np.int64)
            cols["window_end"] = np.full(n, end, np.int64)
            fields += [("window_start", np.int64), ("window_end", np.int64)]
        for a in self._aggs:
            if a.kind == "avg":
                s = host[f"{a.out_name}.sum"]
                c = np.maximum(host[count_name], 1).astype(s.dtype)
                vals = s / c
            elif a.kind == "count":
                vals = host[count_name]
            else:
                vals = host[a.out_name]
            cols[a.out_name] = vals
            fields.append((a.out_name, vals.dtype.type))
        self.output.emit(RecordBatch(Schema(fields), cols,
                                     np.full(n, end - 1, np.int64)))

    # -- late rows ------------------------------------------------------------
    def _refresh_late(self) -> None:
        """Blocking read of the device steps' late counters (finish,
        snapshots, grows)."""
        if self._state is not None and self._state.late:
            dev = self._mesh[0]
            # lint: sync-ok the late counters at finish, snapshots and grows
            self._late_dev_seen = int(torch.stack(
                [t.to(dev) for t in self._state.late]).sum())

    @property
    def late_dropped(self) -> int:
        return self._late_dropped + self._late_dev_seen

    # -- checkpoints ----------------------------------------------------------
    def _snapshot_backend(self) -> dict:
        if self._agg is None:
            return {"kind": "tpu", "keys": np.empty(0, np.int64),
                    "key_groups": np.empty(0, np.int32), "states": {}}
        return self._agg.snapshot(self._state)

    def snapshot_state(self, checkpoint_id: int) -> dict:
        self._flush(pad=True)
        self._drain(block=True)
        self._refresh_late()
        snap = {"keyed": {"backend": self._snapshot_backend(),
                          "meta": self._control_meta()}}
        # a staged worker-set change applies at this aligned barrier, with
        # every buffered row folded and every fire drained
        if self._rescale_request is not None:
            req, self._rescale_request = self._rescale_request, None
            self.rescale_live(req)
        return snap

    # -- live rescale ---------------------------------------------------------
    def request_rescale(self, n_devices: int) -> None:
        """Stage a worker-set change for the next aligned barrier
        (``snapshot_state``)."""
        from ...parallel.plan import MESH_RUNTIME
        if not MESH_RUNTIME.rescale_enabled:
            raise RuntimeError(
                "live rescale is disabled (mesh.rescale.enabled=false)")
        self._rescale_request = int(n_devices)

    def rescale_live(self, n_devices: Optional[int] = None,
                     devices: Optional[Sequence] = None) -> dict:
        """Re-shard the keyed state across a new mesh without a restart:
        snapshot at this quiescent point, diff key-group ownership, ship
        the pages whose groups change owner (digest-verified), install on
        the new mesh at the smallest power-of-two capacity that gives every
        shard 2x headroom (never below the old one), and rebuild the
        incremental planes."""
        from ...metrics.tracing import TRACER
        from ...parallel.rescale import plan_migration, reassemble_pages
        t0 = time.perf_counter()
        old_n = self._n_devices
        if devices is not None:
            self._devices = list(devices)
        n = int(n_devices) if n_devices else (
            len(self._devices) if self._devices else old_n)
        base_len = (self._max_parallelism if self._base_range is None
                    else self._base_range.end - self._base_range.start + 1)
        if base_len < n:
            raise ValueError(
                f"subtask key-group range ({base_len} groups) must be >= "
                f"new mesh size ({n}); raise pipeline.max-parallelism")
        if self._agg is None:
            self._n_devices = n
            self._mesh = self._mesh_for(n)
            self._rescale_epoch += 1
            self._last_rescale_stats = {
                "old_devices": old_n, "new_devices": n,
                "keygroups_migrated": 0, "bytes_moved": 0,
                "epoch": self._rescale_epoch, "duration_ms": 0.0}
            return self._last_rescale_stats
        with TRACER.span("rescale", "Rescale") as root:
            root.set_attribute("old_devices", old_n)
            root.set_attribute("new_devices", n)
            self._flush(pad=True)
            self._drain(block=True)
            self._refresh_late()
            old_sig = self._agg.sig
            old_ranges = tuple(self._agg.shard_ranges)
            new_ranges = tuple(shard_ranges(self._max_parallelism, n,
                                            self._base_range))
            snap = self._agg.snapshot(self._state)
            with TRACER.span("rescale", "Migrate") as mig:
                plan = plan_migration(snap, old_ranges, new_ranges)
                verified = reassemble_pages(plan.pages, snap)
                mig.set_attribute("keygroups_migrated",
                                  plan.keygroups_migrated)
                mig.set_attribute("bytes_moved", plan.bytes_moved)
                mig.set_attribute("pages_moved", len(plan.moved_pages))
            with TRACER.span("rescale", "Rebuild") as reb:
                self._n_devices = n
                self._mesh = self._mesh_for(n)
                # per-shard capacity never shrinks; a scale-in that brings
                # a shard more keys than 2x headroom allows doubles it
                # (_restore_backends)
                self._capacity = max(self._capacity, self._agg.capacity)
                if len(verified["keys"]) or verified["states"]:
                    self._restore_backends([verified])
                else:
                    self._build(list(self._agg.aggs),
                                capacity=self._capacity)
                self._dstage = None
                self._probe = None
                self._mark_inc_dirty()
                reb.set_attribute("local_shapes_changed",
                                  self._agg.sig != old_sig)
            self._rescale_epoch += 1
            root.set_attribute("epoch", self._rescale_epoch)
        duration_ms = (time.perf_counter() - t0) * 1e3
        DEVICE_STATS.note_rescale(plan.keygroups_migrated, plan.bytes_moved,
                                  duration_ms)
        self._last_rescale_stats = {
            "old_devices": old_n, "new_devices": n,
            "keygroups_migrated": plan.keygroups_migrated,
            "bytes_moved": plan.bytes_moved,
            "epoch": self._rescale_epoch, "duration_ms": duration_ms,
            "local_shapes_changed": self._agg.sig != old_sig}
        return self._last_rescale_stats

    # -- restore --------------------------------------------------------------
    def _live_pane_span(self) -> range:
        if self._max_seen_pane is None:
            return range(0)
        first = self._min_seen_pane
        if self._fired_boundary is not None:
            first = max(first, self._fired_boundary - self._window_panes)
        return range(first, self._max_seen_pane + 1)

    def _remap_ring_rows(self, vals: np.ndarray, old_ring: int, kind: str,
                         dtype) -> np.ndarray:
        """Re-seat [old_ring, n] rows onto this ring: each live pane's row
        moves from p % old_ring to p % ring; the rest hold the identity."""
        if old_ring == self._ring:
            return vals
        span = self._live_pane_span()
        if len(span) > self._ring:
            raise RuntimeError(
                f"cannot restore onto ring {self._ring}: {len(span)} panes "
                "are live; increase ring_size")
        out = np.full((self._ring, vals.shape[1]),
                      identity(kind, torch_dtype(dtype)), dtype=vals.dtype)
        for p in span:
            out[p % self._ring] = vals[p % old_ring]
        return out

    def _restore_backends(self, snaps: list[dict]) -> None:
        snaps = [s for s in snaps if len(s.get("keys", ()))
                 or s.get("states")]
        if not snaps:
            return
        # the planes come from the snapshot itself (the schema is not seen
        # yet at restore time)
        meta = {}
        for s in snaps:
            meta.update(s["states"])
        defs = [AggDef(n, m["kind"], torch_dtype(m["dtype"]))
                for n, m in meta.items()]
        # the smallest power of two giving every shard 2x headroom
        n_keys = sum(len(s["keys"]) for s in snaps)
        per_shard = max(1, (2 * n_keys) // self._n_devices)
        cap = self._capacity
        while cap < per_shard:
            cap <<= 1
        self._build(defs, capacity=cap)
        self._load_snapshot_into_state(snaps)

    def _load_snapshot_into_state(self, snaps: list[dict]) -> None:
        """Every shard takes the restored keys of its key-group range (the
        StateAssignmentOperation step)."""
        keys = np.concatenate([np.asarray(s["keys"], np.int64)
                               for s in snaps])
        groups = np.concatenate([np.asarray(s["key_groups"], np.int32)
                                 for s in snaps])
        vals = {}
        for a in self._agg.aggs:
            parts = [self._remap_ring_rows(np.asarray(sd["values"]),
                                           int(sd["ring"]), a.kind, a.dtype)
                     for s in snaps
                     if (sd := s.get("states", {}).get(a.name)) is not None]
            if parts:
                vals[a.name] = np.concatenate(parts, axis=-1)
        self._state = self._agg.load(keys, groups, vals)

    # -- teardown -------------------------------------------------------------
    def finish(self) -> None:
        self._flush(pad=True)
        self._drain(block=True)
        self._refresh_late()
