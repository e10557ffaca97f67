"""The event-time interval join (port of ``flink_tpu/sql/join.py::
IntervalJoinOperator``, ``:219-429``).

Emit (l, r) for rows of one key when r.ts lies in [l.ts + lower, l.ts +
upper]; append-only in and out, the output timestamp max(l.ts, r.ts), each
side's rows pruned by the combined watermark. Two planes, routed as the
reference routes them (``_device_eligible``):

* the device plane (``state.backend.type`` = ``tpu``, the default, and a
  schema of numeric columns with an integer key): each side's rows live in
  a ``DeviceListStore`` on the card. A batch probes the other side's lists
  with its interval (``list_probe``: only matches come home, in the
  reference's order) and is appended to its own side (``list_append``); a
  watermark prunes both (``list_prune``). A batch of device columns
  (``datagen(device=True)``) is packed and appended on the card with no
  round trip through the host;
* the host plane (``hashmap``, or any other schema): the reference's
  per-row walk over per-key buffers.

Device state followed by an input the device plane cannot take raises;
outer joins raise ``NotImplementedError``. The streaming, temporal and
lookup joins are not ported.
"""

from __future__ import annotations

import time
from typing import Any, Optional

import numpy as np
import torch

from ..core.keygroups import assign_to_key_group
from ..core.records import RecordBatch, Schema, scalar as _scalar
from ..device import resolve_device
from ..runtime.operators.base import TwoInputOperator

__all__ = ["IntervalJoinOperator"]

#: host seconds of the device plane, by part
STAT_KEYS = ("pack_s", "upload_s", "probe_s", "copy_home_s", "emit_s",
             "append_s", "prune_s")


def _key_of(row: tuple, kidx) -> Any:
    """Join key of a row: single index or composite tuple of indices."""
    if isinstance(kidx, tuple):
        return tuple(row[i] for i in kidx)
    return row[kidx]


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
            ts_min = batch.ts_min
            t1 = t0
        else:
            packed = pack_columns(
                torch.from_numpy(batch.timestamps),
                [torch.from_numpy(np.ascontiguousarray(batch.column(n)))
                 for n in names], store.col_dtypes)
            keys = packed[:, 1 + self.key_idx[side]]
            ts_min = int(batch.timestamps.min())
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
            bi, opacked = other.probe_range(keys, ts, lo_off, hi_off)
            st["probe_s"] += time.perf_counter() - t2
            if bi.numel():
                self._emit_matches(side, batch, names, on_device, ts, other,
                                   bi, opacked)
        t3 = time.perf_counter()
        store.append_packed(keys, packed, ts_min)
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
