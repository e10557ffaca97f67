"""Streaming joins (port of ``flink_tpu/sql/join.py``): the two-stream
equi-join, the event-time interval join, the temporal (versioned-table)
join and the lookup join.

* ``StreamingJoinOperator`` (``:91``): the unbounded equi-join with
  changelog in and out, inner, left, right and full; each side's rows per
  key with their multiplicity and, on an outer side, their association
  count (the reference's OuterJoinRecordStateView): the null-padded row
  is emitted while a row has no match, retracted when its first match
  arrives and emitted again when its last one leaves.
* ``TemporalJoinOperator`` (``:431``): each left row joins the version of
  the right side's upsert stream valid at its event time, once the
  combined watermark passes it.
* ``LookupJoinOperator`` (``:616``): each row probes a lookup function
  (cached per operator), inner or left.

These three are the reference's host operators, copied with their state
layouts and snapshot formats (``join-left``/``join-right``,
``temporal-versions``/``temporal-left``), so snapshots restore across the
two packages. ``IntervalJoinOperator`` (``:219-429``) is described below.

The interval join:

Emit (l, r) for rows of one key when r.ts lies in [l.ts + lower, l.ts +
upper]; append-only in and out, the output timestamp max(l.ts, r.ts), each
side's rows pruned by the combined watermark. Two planes, routed as the
reference routes them (``_device_eligible``):

* the device plane (``state.backend.type`` = ``tpu``, the default, and a
  schema of numeric columns with an integer key): each side's rows live in
  a ``DeviceListStore`` on the card. A batch probes the other side's lists
  with its interval (``list_probe``: only matches come home, in the
  reference's order; no launch when the batch's ts range cannot reach the
  other side's live rows) and is appended to its own side
  (``list_append``); a watermark prunes both (``list_prune``). A batch of device columns
  (``datagen(device=True)``) is packed and appended on the card with no
  round trip through the host;
* the host plane (``hashmap``, or any other schema): the reference's
  per-row walk over per-key buffers.

Device state followed by an input the device plane cannot take raises;
outer interval joins raise ``NotImplementedError``, as in the reference.
"""

from __future__ import annotations

import time
import bisect
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from ..core.keygroups import assign_to_key_group
from ..core.records import RecordBatch, Schema, scalar as _scalar
from ..device import resolve_device
from ..runtime.operators.base import OneInputOperator, TwoInputOperator
from . import rowkind as rk

__all__ = ["StreamingJoinOperator", "IntervalJoinOperator",
           "TemporalJoinOperator", "LookupJoinOperator"]

#: host seconds of the device plane, by part
STAT_KEYS = ("pack_s", "upload_s", "probe_s", "copy_home_s", "emit_s",
             "append_s", "prune_s")


def _key_of(row: tuple, kidx) -> Any:
    """Join key of a row: single index or composite tuple of indices."""
    if isinstance(kidx, tuple):
        return tuple(row[i] for i in kidx)
    return row[kidx]


class _SideState:
    """One side's keyed state: kg -> key -> {row_tuple: [count, assoc]}.

    ``count`` is the row's multiplicity (duplicates accumulate), ``assoc``
    the number of matching rows currently on the other side (only meaningful
    when this side is outer — reference OuterJoinRecordStateView)."""

    def __init__(self):
        self.state: dict[int, dict[Any, dict[tuple, list]]] = {}

    def rows_for(self, kg: int, key) -> dict[tuple, list]:
        return self.state.get(kg, {}).get(key, {})

    def add(self, kg: int, key, row: tuple, assoc: int) -> list:
        entry = (self.state.setdefault(kg, {}).setdefault(key, {})
                 .setdefault(row, [0, assoc]))
        entry[0] += 1
        return entry

    def retract(self, kg: int, key, row: tuple) -> Optional[list]:
        kmap = self.state.get(kg, {}).get(key)
        if not kmap or row not in kmap:
            return None  # retraction of unknown row: ignore (reference logs)
        entry = kmap[row]
        entry[0] -= 1
        if entry[0] <= 0:
            del kmap[row]
            if not kmap:
                del self.state[kg][key]
        return entry

    def snapshot(self) -> dict:
        return {kg: {k: {r: list(e) for r, e in rows.items()}
                     for k, rows in keys.items()}
                for kg, keys in self.state.items()}

    def restore(self, snap: dict, key_group_range) -> None:
        for kg, keys in snap.items():
            if kg in key_group_range:
                tgt = self.state.setdefault(kg, {})
                for k, rows in keys.items():
                    tgt.setdefault(k, {}).update(
                        {tuple(r): list(e) for r, e in rows.items()})


class StreamingJoinOperator(TwoInputOperator):
    """Unbounded two-stream equi-join with changelog in/out.

    ``join_type`` in inner|left|right|full. Inputs may carry a rowkind
    column (changelog); outputs always carry one. ``key_index{1,2}`` are the
    positions of the join key inside each side's (rowkind-stripped) row;
    ``out_schema`` is left-fields + right-fields + rowkind, with other-side
    numeric fields pre-promoted to float64 by the planner when nullable."""

    def __init__(self, join_type: str, key_index1: int, key_index2: int,
                 out_schema: Schema, n_left: int, n_right: int,
                 name: str = "Join"):
        super().__init__(name)
        if join_type not in ("inner", "left", "right", "full"):
            raise ValueError(f"unknown join type {join_type}")
        self.join_type = join_type
        self.key_idx = (key_index1, key_index2)
        self.out_schema = out_schema
        self.n_fields = (n_left, n_right)
        self.sides = (_SideState(), _SideState())
        self._null_rows = (tuple([None] * n_left), tuple([None] * n_right))

    def _outer(self, side: int) -> bool:
        return (self.join_type == "full"
                or (self.join_type == "left" and side == 0)
                or (self.join_type == "right" and side == 1))

    # -- data path ---------------------------------------------------------
    def process_batch1(self, batch: RecordBatch) -> None:
        self._process(0, batch)

    def process_batch2(self, batch: RecordBatch) -> None:
        self._process(1, batch)

    def _process(self, side: int, batch: RecordBatch) -> None:
        if batch.n == 0:
            return
        has_kind = rk.ROWKIND_COLUMN in batch.schema
        names = [f.name for f in batch.schema.fields
                 if f.name != rk.ROWKIND_COLUMN]
        kinds = (batch.column(rk.ROWKIND_COLUMN).astype(np.int8)
                 if has_kind else np.zeros(batch.n, np.int8))
        cols = [batch.column(n) for n in names]
        ts = batch.timestamps
        out_rows: list[tuple] = []
        out_ts: list[int] = []
        kidx = self.key_idx[side]
        for i in range(batch.n):
            row = tuple(_scalar(c[i]) for c in cols)
            accumulate = kinds[i] in (rk.INSERT, rk.UPDATE_AFTER)
            self._process_row(side, row, _key_of(row, kidx), accumulate,
                              int(ts[i]), out_rows, out_ts)
        if out_rows:
            self.output.emit(RecordBatch.from_rows(
                self.out_schema, out_rows, out_ts))

    def _joined(self, side: int, this_row: tuple, other_row: tuple,
                kind) -> tuple:
        l, r = (this_row, other_row) if side == 0 else (other_row, this_row)
        return l + r + (int(kind),)

    def _process_row(self, side: int, row: tuple, key, accumulate: bool,
                     ts: int, out_rows: list, out_ts: list) -> None:
        kg = assign_to_key_group(key, self.ctx.max_parallelism)
        mine, other = self.sides[side], self.sides[1 - side]
        other_rows = other.rows_for(kg, key)
        other_outer = self._outer(1 - side)
        this_outer = self._outer(side)

        def emit(r: tuple, t: int) -> None:
            out_rows.append(r)
            out_ts.append(t)

        if accumulate:
            total_matches = 0
            for orow, oentry in other_rows.items():
                if other_outer and oentry[1] == 0:
                    # other side's rows lose their null padding (one per
                    # stored duplicate)
                    for _ in range(oentry[0]):
                        emit(self._joined(side, self._null_rows[side], orow,
                                          rk.DELETE), ts)
                oentry[1] += 1
                total_matches += oentry[0]
                for _ in range(oentry[0]):
                    emit(self._joined(side, row, orow, rk.INSERT), ts)
            mine.add(kg, key, row, total_matches)
            if this_outer and total_matches == 0:
                emit(self._joined(side, row, self._null_rows[1 - side],
                                  rk.INSERT), ts)
        else:
            entry = mine.retract(kg, key, row)
            if entry is None:
                return  # retraction of a row we never saw
            for orow, oentry in other_rows.items():
                for _ in range(oentry[0]):
                    emit(self._joined(side, row, orow, rk.DELETE), ts)
                oentry[1] -= 1
                if other_outer and oentry[1] == 0:
                    for _ in range(oentry[0]):
                        emit(self._joined(side, self._null_rows[side], orow,
                                          rk.INSERT), ts)
            if this_outer and not other_rows:
                emit(self._joined(side, row, self._null_rows[1 - side],
                                  rk.DELETE), ts)

    # -- checkpointing -----------------------------------------------------
    def snapshot_state(self, checkpoint_id: int) -> dict:
        return {"keyed": {"backend": {
            "join-left": self.sides[0].snapshot(),
            "join-right": self.sides[1].snapshot()}}}

    def initialize_state(self, keyed_snapshots: list,
                         operator_snapshot) -> None:
        for snap in keyed_snapshots:
            table = snap.get("backend", {})
            self.sides[0].restore(table.get("join-left", {}),
                                  self.ctx.key_group_range)
            self.sides[1].restore(table.get("join-right", {}),
                                  self.ctx.key_group_range)


class IntervalJoinOperator(TwoInputOperator):
    """Event-time interval join: emit (l, r) when r.ts in [l.ts + lower,
    l.ts + upper]; output timestamp max(l.ts, r.ts).

    ``store_capacity``: initial key slots of each side's device list store
    (pre-sizing spares rehashes); ``rows_per_key``: the rows one key may
    hold at once (more fails loudly). ``device``: the card unless the
    caller asks for ``cpu``. ``stats`` holds the device plane's host
    seconds by part (``STAT_KEYS``), its batches and its matches."""

    def __init__(self, key_index1: int, key_index2: int, lower_ms: int,
                 upper_ms: int, out_schema: Schema,
                 join_type: str = "inner", rows_per_key: int = 256,
                 store_capacity: int = 1 << 12,
                 name: str = "IntervalJoin", device=None):
        super().__init__(name)
        if join_type != "inner":
            raise NotImplementedError(
                "outer interval joins need per-row emitted flags; v1 is "
                "inner-only (matches the DataStream API surface)")
        self.key_idx = (key_index1, key_index2)
        self.lower = lower_ms
        self.upper = upper_ms
        self.out_schema = out_schema
        self.rows_per_key = int(rows_per_key)
        self.store_capacity = int(store_capacity)
        self.device = resolve_device(device)
        # host plane: kg -> key -> list[(ts, row)] per side
        self.buffers: tuple[dict, dict] = ({}, {})
        # device plane: one DeviceListStore a side
        self._stores: list = [None, None]
        self._side_ok = [False, False]   # per-side schema validated
        self._device: Optional[bool] = None
        self._restored_device: dict = {}
        self.stats: dict = {k: 0.0 for k in STAT_KEYS}
        self.stats.update(batches=0, matches=0)

    def process_batch1(self, batch: RecordBatch) -> None:
        self._process(0, batch)

    def process_batch2(self, batch: RecordBatch) -> None:
        self._process(1, batch)

    def _bounds(self, side: int, ts: int) -> tuple[int, int]:
        """Other-side timestamp window matching a row with timestamp ts."""
        if side == 0:
            return ts + self.lower, ts + self.upper
        return ts - self.upper, ts - self.lower

    # -- device routing ----------------------------------------------------
    def _device_eligible(self, schema: Schema, side: int) -> bool:
        if self._device is False:
            return False
        if self._device and self._side_ok[side]:
            return True   # established AND validated; skip the scan
        if self.ctx.config.get("state.backend.type") != "tpu":
            self._device = False
            return False
        if self.buffers[0] or self.buffers[1]:
            # host-plane buffers restored from a hashmap checkpoint: keep
            # plane continuity
            self._device = False
            return False
        ok = all(f.dtype is not object and
                 np.dtype(f.dtype).kind in "iufb" for f in schema.fields)
        kf = schema.fields[self.key_idx[side]]
        ok = ok and np.issubdtype(np.dtype(kf.dtype), np.integer)
        if not ok:
            if (self._stores[0] is not None or self._stores[1] is not None
                    or self._restored_device):
                raise TypeError(
                    "interval join: device-plane state exists but this "
                    "input is not device-eligible (non-numeric columns or "
                    "non-integer key); use the hashmap backend")
            self._device = False
            return False
        self._device = True
        self._side_ok[side] = True
        return True

    def _store(self, side: int, schema: Schema):
        # restored stores were built eagerly in initialize_state
        if self._stores[side] is None:
            from ..state.device_lists import DeviceListStore
            self._stores[side] = DeviceListStore(
                self.ctx.key_group_range, self.ctx.max_parallelism,
                [np.dtype(f.dtype) for f in schema.fields],
                capacity=self.store_capacity,
                rows_per_key=self.rows_per_key, device=self.device)
        return self._stores[side]

    def _process(self, side: int, batch: RecordBatch) -> None:
        if batch.n == 0:
            return
        if self._device_eligible(batch.schema, side):
            self._process_device(side, batch)
            return
        names = [f.name for f in batch.schema.fields]
        cols = [batch.column(n) for n in names]
        ts_arr = batch.timestamps
        kidx = self.key_idx[side]
        out_rows, out_ts = [], []
        for i in range(batch.n):
            row = tuple(_scalar(c[i]) for c in cols)
            ts = int(ts_arr[i])
            key = _key_of(row, kidx)
            kg = assign_to_key_group(key, self.ctx.max_parallelism)
            lo, hi = self._bounds(side, ts)
            for ots, orow in self.buffers[1 - side].get(kg, {}).get(key, ()):
                if lo <= ots <= hi:
                    l, r = (row, orow) if side == 0 else (orow, row)
                    out_rows.append(l + r)
                    out_ts.append(max(ts, ots))
            (self.buffers[side].setdefault(kg, {}).setdefault(key, [])
             .append((ts, row)))
        if out_rows:
            self.output.emit(RecordBatch.from_rows(
                self.out_schema, out_rows, out_ts))

    def _process_device(self, side: int, batch: RecordBatch) -> None:
        """Probe the other side's lists with this batch's intervals, emit
        the matches, then append this batch to its own side."""
        from ..state.device_lists import pack_columns

        st = self.stats
        names = [f.name for f in batch.schema.fields]
        store = self._store(side, batch.schema)
        dev = store.device
        on_device = getattr(batch, "is_device", False)
        t0 = time.perf_counter()
        if on_device:
            keys = batch.device_column(names[self.key_idx[side]]).to(
                torch.int64)
            ts = (batch.dtimestamps if batch.dtimestamps is not None else
                  torch.full((batch.n,), batch.ts_min, dtype=torch.int64,
                             device=dev))
            packed = pack_columns(ts, [batch.device_column(n) for n in names],
                                  store.col_dtypes)
            ts_min, ts_max = batch.ts_min, batch.ts_max
            t1 = t0
        else:
            packed = pack_columns(
                torch.from_numpy(batch.timestamps),
                [torch.from_numpy(np.ascontiguousarray(batch.column(n)))
                 for n in names], store.col_dtypes)
            keys = packed[:, 1 + self.key_idx[side]]
            ts_min = int(batch.timestamps.min())
            ts_max = int(batch.timestamps.max())
            t1 = time.perf_counter()
            packed = packed.to(dev)
            keys = keys.contiguous().to(dev)
            ts = packed[:, 0].contiguous()
        t2 = time.perf_counter()
        st["pack_s"] += t1 - t0
        st["upload_s"] += t2 - t1
        st["batches"] += 1
        other = self._stores[1 - side]
        if other is not None:
            lo_off, hi_off = ((self.lower, self.upper) if side == 0
                              else (-self.upper, -self.lower))
            bi, opacked = other.probe_range(keys, ts, lo_off, hi_off, ts_min,
                                            ts_max)
            st["probe_s"] += time.perf_counter() - t2
            if bi.numel():
                self._emit_matches(side, batch, names, on_device, ts, other,
                                   bi, opacked)
        t3 = time.perf_counter()
        store.append_packed(keys, packed, ts_min, ts_max)
        st["append_s"] += time.perf_counter() - t3

    def _emit_matches(self, side: int, batch: RecordBatch, names: list,
                      on_device: bool, ts: torch.Tensor, other, bi, opacked
                      ) -> None:
        st = self.stats
        t0 = time.perf_counter()
        if on_device:
            mine = [batch.device_column(n)[bi].cpu().numpy() for n in names]
            my_ts = ts[bi].cpu().numpy()
        else:
            bi_h = bi.cpu().numpy()
            mine = [batch.column(n)[bi_h] for n in names]
            my_ts = batch.timestamps[bi_h]
        theirs_packed = opacked.cpu().numpy()
        t1 = time.perf_counter()
        theirs = [other._unpack_col(theirs_packed, i)
                  for i in range(len(other.col_dtypes))]
        ordered = mine + theirs if side == 0 else theirs + mine
        out_cols = {f.name: c for f, c in zip(self.out_schema.fields,
                                              ordered)}
        out_ts = np.maximum(my_ts, theirs_packed[:, 0])
        self.output.emit(RecordBatch(self.out_schema, out_cols, out_ts))
        st["copy_home_s"] += t1 - t0
        st["emit_s"] += time.perf_counter() - t1
        st["matches"] += len(out_ts)

    def process_watermark_n(self, input_index: int, watermark) -> None:
        super().process_watermark_n(input_index, watermark)
        wm = self.current_watermark
        # a row on side s can still match other-side rows arriving later
        # iff its matching window's upper bound >= wm; prune the rest
        keep_after = (wm - self.upper, wm + self.lower)
        t0 = time.perf_counter()
        for side in (0, 1):
            horizon = keep_after[side]
            if self._stores[side] is not None:
                self._stores[side].prune(horizon)
                continue
            for kmap in self.buffers[side].values():
                for key in list(kmap):
                    kept = [(t, r) for t, r in kmap[key] if t >= horizon]
                    if kept:
                        kmap[key] = kept
                    else:
                        del kmap[key]
        self.stats["prune_s"] += time.perf_counter() - t0

    def snapshot_state(self, checkpoint_id: int) -> dict:
        if self._device:
            return {"keyed": {"backend": {
                "list-left": (self._stores[0].snapshot()
                              if self._stores[0] is not None else None),
                "list-right": (self._stores[1].snapshot()
                               if self._stores[1] is not None else None)}}}
        return {"keyed": {"backend": {
            "buf-left": {kg: {k: list(v) for k, v in m.items()}
                         for kg, m in self.buffers[0].items()},
            "buf-right": {kg: {k: list(v) for k, v in m.items()}
                          for kg, m in self.buffers[1].items()}}}}

    def initialize_state(self, keyed_snapshots: list,
                         operator_snapshot) -> None:
        for snap in keyed_snapshots:
            table = snap.get("backend", {})
            for name, side in (("list-left", 0), ("list-right", 1)):
                dsnap = table.get(name)
                if dsnap is not None:
                    self._restored_device.setdefault(side, []).append(dsnap)
            for name, side in (("buf-left", 0), ("buf-right", 1)):
                for kg, kmap in table.get(name, {}).items():
                    if kg in self.ctx.key_group_range:
                        tgt = self.buffers[side].setdefault(kg, {})
                        for k, rows in kmap.items():
                            tgt.setdefault(k, []).extend(
                                (int(t), tuple(r)) for t, r in rows)
        if self._restored_device:
            # build the stores eagerly: a checkpoint taken before the
            # first batch must carry this state
            from ..state.device_lists import DeviceListStore
            for side in list(self._restored_device):
                self._stores[side] = DeviceListStore.from_snapshots(
                    self.ctx.key_group_range, self.ctx.max_parallelism,
                    self._restored_device.pop(side),
                    rows_per_key=self.rows_per_key,
                    capacity=self.store_capacity, device=self.device)
            self._device = True


class TemporalJoinOperator(TwoInputOperator):
    """Event-time temporal (versioned-table) join: each left (append)
    row joins the right-side VERSION that was valid at the left row's
    event time (reference StreamExecTemporalJoin.java:77 /
    TemporalRowTimeJoinOperator).

    Input 2 is a changelog/upsert stream building the versioned table:
    INSERT/UPDATE_AFTER rows start a new version at their timestamp,
    DELETE rows a tombstone (no valid version from then on);
    UPDATE_BEFORE rows are ignored (the matching UA carries the state).
    Left rows buffer until the combined watermark passes their timestamp —
    only then are all versions <= t known — and emit as INSERT rows
    (inner drops versionless rows, left pads nulls). Version history at
    or below the watermark compacts to the latest entry per key."""

    def __init__(self, join_type: str, key_index1: int, key_index2: int,
                 out_schema: Schema, n_left: int, n_right: int,
                 name: str = "TemporalJoin"):
        super().__init__(name)
        if join_type not in ("inner", "left"):
            raise ValueError("temporal join supports inner|left")
        self.join_type = join_type
        self.key_idx = (key_index1, key_index2)
        self.out_schema = out_schema
        self.n_fields = (n_left, n_right)
        self._null_right = tuple([None] * n_right)
        # kg -> key -> [ts_list, row_list] parallel sorted arrays
        # (row None = tombstone); parallel lists keep the bisect O(log V)
        # per probe instead of rebuilding a timestamp list per record
        self._versions: dict[int, dict[Any, list]] = {}
        # kg -> [(ts, key, row)] awaiting the watermark
        self._left_buf: dict[int, list] = {}
        # version-table keys touched since the last compaction: the
        # watermark pass prunes only these (untouched keys prune when
        # next touched)
        self._dirty_keys: set = set()

    # -- ingest ------------------------------------------------------------
    def process_batch1(self, batch: RecordBatch) -> None:
        names = [f.name for f in batch.schema.fields
                 if f.name != rk.ROWKIND_COLUMN]
        cols = [batch.column(n) for n in names]
        kinds = (np.asarray(batch.column(rk.ROWKIND_COLUMN))
                 if rk.ROWKIND_COLUMN in batch.schema else None)
        ts_arr = batch.timestamps
        for i in range(batch.n):
            if kinds is not None and kinds[i] != rk.INSERT:
                raise ValueError(
                    "temporal join: the probe side must be append-only "
                    "(reference: updating left inputs need a changelog "
                    "temporal join, not supported)")
            row = tuple(_scalar(c[i]) for c in cols)
            key = _key_of(row, self.key_idx[0])
            kg = assign_to_key_group(key, self.ctx.max_parallelism)
            self._left_buf.setdefault(kg, []).append(
                (int(ts_arr[i]), key, row))

    def process_batch2(self, batch: RecordBatch) -> None:
        names = [f.name for f in batch.schema.fields
                 if f.name != rk.ROWKIND_COLUMN]
        cols = [batch.column(n) for n in names]
        kinds = (np.asarray(batch.column(rk.ROWKIND_COLUMN))
                 if rk.ROWKIND_COLUMN in batch.schema else None)
        ts_arr = batch.timestamps
        for i in range(batch.n):
            kind = int(kinds[i]) if kinds is not None else rk.INSERT
            if kind == rk.UPDATE_BEFORE:
                continue
            key_row = tuple(_scalar(c[i]) for c in cols)
            row = None if kind == rk.DELETE else key_row
            key = _key_of(key_row, self.key_idx[1])
            kg = assign_to_key_group(key, self.ctx.max_parallelism)
            entry = self._versions.setdefault(kg, {}).setdefault(
                key, [[], []])
            ts_list, row_list = entry
            ts = int(ts_arr[i])
            # keep sorted by version time; equal timestamps: last wins
            pos = bisect.bisect_right(ts_list, ts)
            if pos > 0 and ts_list[pos - 1] == ts:
                row_list[pos - 1] = row
            else:
                ts_list.insert(pos, ts)
                row_list.insert(pos, row)
            self._dirty_keys.add((kg, key))

    # -- emission ----------------------------------------------------------
    def process_watermark_n(self, input_index: int, watermark) -> None:
        # release buffered rows BEFORE the base class forwards the
        # watermark: a downstream event-time operator must see the rows
        # (all with ts <= wm) ahead of the watermark that closed them, or
        # every temporal-join result would arrive late by construction
        wms = list(self._input_watermarks)
        wms[input_index] = watermark.timestamp
        wm = min(wms)
        out_rows, out_ts = [], []
        for kg, buf in list(self._left_buf.items()):
            keep = []
            for ts, key, row in buf:
                if ts > wm:
                    keep.append((ts, key, row))
                    continue
                entry = self._versions.get(kg, {}).get(key)
                vrow = None
                if entry is not None:
                    pos = bisect.bisect_right(entry[0], ts)
                    vrow = entry[1][pos - 1] if pos > 0 else None
                if vrow is not None:
                    out_rows.append(row + vrow + (rk.INSERT,))
                    out_ts.append(ts)
                elif self.join_type == "left":
                    out_rows.append(row + self._null_right + (rk.INSERT,))
                    out_ts.append(ts)
            if keep:
                self._left_buf[kg] = keep
            else:
                del self._left_buf[kg]
        # compact TOUCHED keys' version history: keep the newest version
        # at/below the watermark (rows between it and wm still need it)
        # plus everything above. A key stays dirty while it still holds
        # multiple versions (one lagging input can leave wm at -inf, which
        # compacts nothing — dirtiness must survive that watermark).
        still_dirty = set()
        for kg, key in self._dirty_keys:
            keys = self._versions.get(kg, {})
            entry = keys.get(key)
            if entry is None:
                continue
            ts_list, row_list = entry
            pos = bisect.bisect_right(ts_list, wm)
            if pos > 1:
                entry[0] = ts_list = ts_list[pos - 1:]
                entry[1] = row_list = row_list[pos - 1:]
            if (len(ts_list) == 1 and row_list[0] is None
                    and ts_list[0] <= wm):
                del keys[key]   # settled tombstone: key is gone
            elif len(ts_list) > 1 or row_list[-1] is None:
                # still compactable later: multiple versions, or a
                # tombstone the watermark has not settled yet (dropping
                # it here would leak the entry forever)
                still_dirty.add((kg, key))
        self._dirty_keys = still_dirty
        if out_rows:
            self.output.emit(RecordBatch.from_rows(
                self.out_schema, out_rows, out_ts))
        super().process_watermark_n(input_index, watermark)

    # -- checkpointing -----------------------------------------------------
    def snapshot_state(self, checkpoint_id: int) -> dict:
        return {"keyed": {"backend": {
            "temporal-versions": {
                kg: {k: [list(e[0]), list(e[1])]
                     for k, e in keys.items()}
                for kg, keys in self._versions.items()},
            "temporal-left": {kg: list(v)
                              for kg, v in self._left_buf.items()}}}}

    def initialize_state(self, keyed_snapshots: list,
                         operator_snapshot) -> None:
        for snap in keyed_snapshots:
            table = snap.get("backend", {})
            for kg, keys in table.get("temporal-versions", {}).items():
                if kg in self.ctx.key_group_range:
                    tgt = self._versions.setdefault(kg, {})
                    for k, (ts_list, row_list) in keys.items():
                        entry = tgt.setdefault(k, [[], []])
                        pairs = sorted(
                            list(zip(entry[0], entry[1]))
                            + [(int(t), tuple(r) if r is not None else None)
                               for t, r in zip(ts_list, row_list)],
                            key=lambda v: v[0])
                        entry[0] = [p[0] for p in pairs]
                        entry[1] = [p[1] for p in pairs]
            for kg, buf in table.get("temporal-left", {}).items():
                if kg in self.ctx.key_group_range:
                    self._left_buf.setdefault(kg, []).extend(
                        (int(t), k, tuple(r)) for t, k, r in buf)
        # restored version histories must be compactable without waiting
        # for the key to be touched again
        for kg, keys in self._versions.items():
            for key in keys:
                self._dirty_keys.add((kg, key))


class LookupJoinOperator(OneInputOperator):
    """Stream enriched against an external table (reference lookup join,
    StreamExecLookupJoin): per distinct probe key, ``lookup(key)`` returns
    matching rows from the dimension table; results are cached per operator
    instance. inner drops misses, left pads with nulls."""

    def __init__(self, key_index: int, lookup: Callable[[Any], Sequence[tuple]],
                 out_schema: Schema, n_right: int, join_type: str = "inner",
                 cache_size: int = 10000, name: str = "LookupJoin"):
        super().__init__(name)
        if join_type not in ("inner", "left"):
            raise ValueError("lookup join supports inner|left")
        self.key_index = key_index
        self.lookup = lookup
        self.out_schema = out_schema
        self.join_type = join_type
        self._null_right = tuple([None] * n_right)
        self._cache: dict[Any, tuple] = {}
        self._cache_size = cache_size

    def _probe(self, key) -> tuple:
        hit = self._cache.get(key)
        if hit is None:
            hit = tuple(tuple(r) for r in self.lookup(key))
            if len(self._cache) >= self._cache_size:
                self._cache.clear()
            self._cache[key] = hit
        return hit

    def process_batch(self, batch: RecordBatch) -> None:
        if batch.n == 0:
            return
        names = [f.name for f in batch.schema.fields]
        cols = [batch.column(n) for n in names]
        ts_arr = batch.timestamps
        out_rows, out_ts = [], []
        for i in range(batch.n):
            row = tuple(_scalar(c[i]) for c in cols)
            matches = self._probe(row[self.key_index])
            ts = int(ts_arr[i])
            if matches:
                for m in matches:
                    out_rows.append(row + m)
                    out_ts.append(ts)
            elif self.join_type == "left":
                out_rows.append(row + self._null_right)
                out_ts.append(ts)
        if out_rows:
            self.output.emit(RecordBatch.from_rows(
                self.out_schema, out_rows, out_ts))
