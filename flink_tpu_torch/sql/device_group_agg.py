"""Device-lowered unbounded GROUP BY: changelog aggregation on device
float64 planes (port of ``flink_tpu/sql/device_group_agg.py``).

The device twin of ``sql/group_agg.GroupAggOperator`` (reference
GroupAggFunction.processElement:125): per group key, maintain accumulators
and emit UPDATE_BEFORE/UPDATE_AFTER (INSERT first, DELETE on full
retraction). Each micro-batch is one lookup-or-insert on the state
backend's hash table (``hash_probe``, growing by rehash as the reference's
synchronous mode does) and one group aggregation step
(``ops/group_agg.py``: four kernels on the card) over dense ``[capacity]``
float64 planes: PREV rows of the touched groups, the folds, drained groups
reset, NEW rows, compacted in first-occurrence order.

Host work per batch: the key combine and the upload of keys, signs and
value columns; one read of the group count; one copy home of the
compacted rows; columnar changelog assembly over the distinct groups.
``stats`` keeps the seconds of each.

Semantics match the host operator:
* SUM/COUNT/AVG retract exactly (additive folds with a sign column).
* MIN/MAX fold append-only (the sign is ignored), the reference's
  documented degradation; a group fully retracted and later re-inserted
  restarts MIN/MAX from identities.
* a group whose signed count drains to <= 0 emits DELETE of its last
  aggregate row and its planes reset.

Keys: integer key columns only (the planner routes others to the host
operator). Composite keys combine with a 64-bit mix (``combine_key_columns``,
bit-exact with the reference); the original key columns are recovered from
the batch at emission, never from the table.

Differences from the reference: batches are not padded to a power of two
(nothing here compiles per shape; the pads changed no result), and only the
blocks of slots that rows fold into are marked dirty (the reference also
marked block 0 for its pad and invalid rows). Snapshots are the backend's,
in the reference's schema.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.records import RecordBatch, Schema
from ..ops.group_agg import group_agg_step, new_rowpos
from ..runtime.watchdog import stall_bounded
from ..runtime.operators.base import OneInputOperator, OperatorContext, Output
from ..state.device_backend import DeviceKeyedStateBackend
from . import rowkind as rk
from .group_agg import SqlAggSpec

__all__ = ["DeviceGroupAggOperator", "combine_key_columns"]

_MIX = np.int64(np.uint64(0x9E3779B97F4A7C15).astype(np.int64))


def combine_key_columns(cols: Sequence[np.ndarray]) -> np.ndarray:
    """Deterministic 64-bit combine of integer key columns (a single
    column passes through untouched: exact, collision-free)."""
    out = cols[0].astype(np.int64, copy=len(cols) > 1)
    with np.errstate(over="ignore"):
        for c in cols[1:]:
            out *= _MIX
            out += c.astype(np.int64)
            out ^= (out >> np.int64(29)) & np.int64(0x5555555555555555)
    return out


class DeviceGroupAggOperator(OneInputOperator):
    """Changelog GROUP BY on device accumulator planes (integer keys)."""

    def __init__(self, key_columns: Sequence[str], aggs: Sequence[SqlAggSpec],
                 capacity: int = 1 << 16, device="cuda",
                 name: str = "DeviceGroupAgg"):
        super().__init__(name)
        self._key_columns = list(key_columns)
        self._aggs = list(aggs)
        for a in self._aggs:
            if a.distinct:
                raise NotImplementedError(
                    "DISTINCT aggregates need per-key value sets")
        self._capacity = capacity
        self._device = torch.device(device)
        self.backend: Optional[DeviceKeyedStateBackend] = None
        self._out_schema: Optional[Schema] = None
        self._key_dtypes: Optional[list] = None
        # the step's persistent scratch (first and last row of a slot)
        self._rowpos: Optional[torch.Tensor] = None
        # plane layout mirrors the host op's slots: __rc__ + per-agg planes
        # (avg = a .sum/.cnt pair); (name, fold kind, value column)
        self._plane_sig: list[tuple[str, str, Optional[str]]] = []
        for a in self._aggs:
            if a.kind == "count":
                # COUNT(col) == COUNT(*) here: the columns are numeric and
                # never null, so the plane folds the SIGN
                self._plane_sig.append((a.out_name, "sum", None))
            elif a.kind in ("sum", "min", "max"):
                self._plane_sig.append((a.out_name, a.kind, a.field))
            else:  # avg
                self._plane_sig.append((f"{a.out_name}.sum", "sum", a.field))
                self._plane_sig.append((f"{a.out_name}.cnt", "sum", None))
        self._val_fields = list(dict.fromkeys(
            f for _n, _k, f in self._plane_sig if f is not None))
        self._names = ["__rc__"] + [n for n, _k, _f in self._plane_sig]
        self._kinds = ["sum"] + [k for _n, k, _f in self._plane_sig]
        self._cols = [-1] + [-1 if f is None else self._val_fields.index(f)
                             for _n, _k, f in self._plane_sig]
        #: seconds by part, summed over batches: the key combine and sign
        #: (prep), the upload, the probe (with any rehash), the step's
        #: enqueue, the wait for the group count, the copy home and the
        #: changelog assembly; batches and groups emitted
        self.stats = {"batches": 0, "rows": 0, "groups": 0, "prep_s": 0.0,
                      "upload_s": 0.0, "probe_s": 0.0, "step_s": 0.0,
                      "sync_s": 0.0, "d2h_s": 0.0, "changelog_s": 0.0}
        #: the capacity after each rehash, in order
        self.rehashes: list[int] = []

    # -- lifecycle ---------------------------------------------------------
    def setup(self, ctx: OperatorContext, output: Output) -> None:
        super().setup(ctx, output)
        self.backend = DeviceKeyedStateBackend(
            ctx.key_group_range, ctx.max_parallelism,
            capacity=self._capacity, device=self._device)
        for name, kind in zip(self._names, self._kinds):
            self.backend.register_array_state(name, kind, np.float64)

    # -- data path ---------------------------------------------------------
    def process_batch(self, batch: RecordBatch) -> None:
        if batch.n == 0:
            return
        t0 = time.perf_counter()
        key_cols = [np.asarray(batch.column(c)) for c in self._key_columns]
        if self._key_dtypes is None:
            self._key_dtypes = [batch.schema.field(c).dtype
                                for c in self._key_columns]
            for c, d in zip(self._key_columns, self._key_dtypes):
                if d is object or not np.issubdtype(np.dtype(d), np.integer):
                    raise TypeError(
                        f"device group aggregation needs integer key "
                        f"columns; {c!r} is {d}: the planner routes such a "
                        "query to the host GroupAggOperator")
        keys = combine_key_columns(key_cols)
        kinds = (np.asarray(batch.column(rk.ROWKIND_COLUMN)).astype(np.int8)
                 if rk.ROWKIND_COLUMN in batch.schema
                 else np.zeros(batch.n, np.int8))
        sign = np.where((kinds == rk.UPDATE_BEFORE) | (kinds == rk.DELETE),
                        -1.0, 1.0)
        vals = np.empty((len(self._val_fields), batch.n), np.float64)
        for j, f in enumerate(self._val_fields):
            vals[j] = batch.column(f)
        t1 = time.perf_counter()
        dev = self._device
        # the reference's three bounded sites: the upload and the read on
        # the supervised worker, and the step on this thread; each site is
        # visited before its region starts
        dkeys, dsign, dvals = stall_bounded(
            "transfer.h2d", lambda: tuple(torch.from_numpy(a).to(dev)
                                          for a in (keys, sign, vals)),
            scope="device_group_agg")
        t2 = time.perf_counter()
        cap = self.backend.capacity
        slots = self.backend.slots_for_batch(dkeys)
        while cap < self.backend.capacity:   # the table doubles per rehash
            cap *= 2
            self.rehashes.append(cap)
        if (self._rowpos is None
                or self._rowpos.shape[0] != self.backend.capacity):
            # a fresh table (first batch, rehash, restore): the scratch
            # holds its sentinels everywhere between steps, so a new one
            # is equal
            self._rowpos = new_rowpos(self.backend.capacity, dev)
        t3 = time.perf_counter()
        st = stall_bounded("device.execute", lambda: group_agg_step(
            [self.backend.get_array(n) for n in self._names], self._kinds,
            self._cols, slots, dsign, dvals, batch.n, self._rowpos,
            self.backend.dirty_buffer, self.backend.dirty_shift),
            scope="device_group_agg")
        t4 = time.perf_counter()
        g = int(st.n_groups[0])
        t5 = time.perf_counter()
        host_rows = host_comp = None
        if g:
            host_rows, host_comp = stall_bounded(
                "transfer.d2h", lambda: (st.row_idx[:g].cpu().numpy(),
                                         st.comp[:g].cpu().numpy()),
                scope="device_group_agg")
        t6 = time.perf_counter()
        if g:
            self._emit_changelog(batch, key_cols, host_rows, host_comp)
        t7 = time.perf_counter()
        s = self.stats
        s["batches"] += 1
        s["rows"] += batch.n
        s["groups"] += g
        for k, a, b in (("prep_s", t0, t1), ("upload_s", t1, t2),
                        ("probe_s", t2, t3), ("step_s", t3, t4),
                        ("sync_s", t4, t5), ("d2h_s", t5, t6),
                        ("changelog_s", t6, t7)):
            s[k] += b - a

    # -- emission ----------------------------------------------------------
    def _results(self, acc: np.ndarray) -> list[np.ndarray]:
        """Aggregate columns from [g, planes] accumulator rows."""
        col = {n: acc[:, q] for q, n in enumerate(self._names)}
        outs = []
        for a in self._aggs:
            if a.kind == "avg":
                s = col[f"{a.out_name}.sum"]
                c = col[f"{a.out_name}.cnt"]
                outs.append(np.where(c != 0, s / np.where(c == 0, 1, c),
                                     0.0))
            else:
                outs.append(col[a.out_name])
        return outs

    def _emit_changelog(self, batch: RecordBatch, key_cols: list,
                        rows: np.ndarray, comp: np.ndarray) -> None:
        g = len(rows)
        P = len(self._names)
        prev, new = comp[:, :P], comp[:, P:]
        was = prev[:, 0] > 0
        now = new[:, 0] > 0
        if not (was.any() or now.any()):
            return
        kind_a = np.where(now, rk.UPDATE_BEFORE, rk.DELETE).astype(np.int8)
        kind_b = np.where(was, rk.UPDATE_AFTER, rk.INSERT).astype(np.int8)
        # prev rows at even, new rows at odd positions, then filter: keeps
        # UB immediately before its UA, like the host op
        n2 = 2 * g
        mask = np.zeros(n2, bool)
        mask[0::2] = was
        mask[1::2] = now
        take = np.flatnonzero(mask)
        cols: dict[str, np.ndarray] = {}
        for i, cname in enumerate(self._key_columns):
            kv = key_cols[i][rows]
            inter = np.empty(n2, kv.dtype)
            inter[0::2] = kv
            inter[1::2] = kv
            cols[cname] = inter[take]
        for a, pv, nv in zip(self._aggs, self._results(prev),
                             self._results(new)):
            inter = np.empty(n2, np.float64)
            inter[0::2] = pv
            inter[1::2] = nv
            cols[a.out_name] = inter[take]
        kinds = np.empty(n2, np.int8)
        kinds[0::2] = kind_a
        kinds[1::2] = kind_b
        cols[rk.ROWKIND_COLUMN] = kinds[take]
        if self._out_schema is None:
            key_fields = [(n, d) for n, d in zip(self._key_columns,
                                                 self._key_dtypes)]
            agg_fields = [(a.out_name, np.float64) for a in self._aggs]
            self._out_schema = Schema(
                key_fields + agg_fields + [(rk.ROWKIND_COLUMN, np.int8)])
        ts = np.full(len(take), int(batch.timestamps.max()), np.int64)
        self.output.emit(RecordBatch(self._out_schema, cols, ts))

    # -- checkpointing -----------------------------------------------------
    def snapshot_state(self, checkpoint_id: int) -> dict:
        return {"keyed": {"backend": self.backend.snapshot(checkpoint_id)}}

    def initialize_state(self, keyed_snapshots: list,
                         operator_snapshot) -> None:
        if keyed_snapshots:
            self.backend.restore([s["backend"] for s in keyed_snapshots])
            self._rowpos = None
