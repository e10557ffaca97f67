"""Unbounded keyed GROUP BY aggregation with changelog output, on the
host (copy of ``flink_tpu/sql/group_agg.py``). The planner routes here
what the device operator (``sql/device_group_agg.py``) does not take:
non-integer keys, DISTINCT, and MIN/MAX over a changelog input.

The analog of the reference table-runtime's GroupAggFunction
(flink-table-runtime operators/aggregate/GroupAggFunction.java:43,
processElement:125): per group key, maintain accumulators; on change emit
UPDATE_BEFORE with the previous aggregate row and UPDATE_AFTER with the new
one (INSERT for a first-seen key, DELETE when the group's count drains to
zero under retraction input).

Batch-first difference: instead of one state read-modify-write per record, each
micro-batch is folded per-key with ``np.add.reduceat``-style grouped
reductions (sort by in-batch group id, reduce each contiguous run), then ONE
state merge per distinct key in the batch — the same two-phase shape as the
reference's MiniBatchGroupAggFunction (local pre-aggregation, then a single
accumulator merge), which is the shape the device operator runs
for integer keys.

State is laid out per key group (``_state[kg][key] -> float64[n_slots]``)
so snapshots re-shard on rescale exactly like the heap backend.

Retraction: SUM/COUNT/AVG retract exactly (additive). MIN/MAX are exact
too when constructed with ``retract_minmax=True`` (a value->multiplicity
map per key per aggregate, the reference's
MinWithRetractAggFunction.java:36 MapView accumulator) — the planner
enables it whenever the input is a changelog; append-only input keeps
the cheap scalar fold (reference planner picks the no-retract variants
the same way).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import numpy as np

from ..core.keygroups import assign_to_key_group
from ..core.records import RecordBatch, Schema, scalar as _scalar
from ..runtime.operators.base import OneInputOperator, OperatorContext, Output
from . import rowkind as rk

__all__ = ["GroupAggOperator", "LocalGroupAggOperator", "SqlAggSpec"]


class SqlAggSpec:
    """One aggregate: kind in count|sum|min|max|avg, over input column
    ``field`` (None for COUNT(*)), emitted as ``out_name``."""

    def __init__(self, kind: str, field: Optional[str], out_name: str,
                 distinct: bool = False):
        if kind not in ("count", "sum", "min", "max", "avg"):
            raise ValueError(f"unsupported aggregate {kind}")
        self.kind = kind
        self.field = field
        self.out_name = out_name
        self.distinct = distinct


# accumulator slots per agg: count->1, sum->1, min->1, max->1, avg->2
_SLOTS = {"count": 1, "sum": 1, "min": 1, "max": 1, "avg": 2}
_INITS = {"count": 0.0, "sum": 0.0, "min": np.inf, "max": -np.inf}


class GroupAggOperator(OneInputOperator):
    """Vectorized unbounded group aggregation emitting a changelog."""

    def __init__(self, key_columns: Sequence[str], aggs: Sequence[SqlAggSpec],
                 count_star_index: Optional[int] = None,
                 partial_input: bool = False,
                 retract_minmax: bool = False,
                 name: str = "GroupAgg"):
        """``retract_minmax``: maintain a per-key value->multiplicity map
        for every MIN/MAX aggregate so retractions are EXACT (reference
        MinWithRetractAggFunction.java:36's MapView accumulator). The
        planner enables it when the input is a changelog; append-only
        input keeps the cheap scalar fold."""
        super().__init__(name)
        self._key_columns = list(key_columns)
        self._aggs = list(aggs)
        self._partial_input = bool(partial_input)
        self._retract_minmax = bool(retract_minmax)
        self._mm_idx = [i for i, a in enumerate(aggs)
                        if a.kind in ("min", "max")]
        if self._partial_input and self._retract_minmax and self._mm_idx:
            raise ValueError(
                "retractable MIN/MAX cannot consume pre-reduced partials "
                "(the local combine folds extrema lossily); the planner "
                "disables the two-phase split in this case")
        # kg -> key -> [value->count dict per min/max agg]
        self._mm_counts: dict[int, dict[Any, list]] = {}
        for a in self._aggs:
            if a.distinct:
                raise NotImplementedError(
                    "DISTINCT aggregates need per-key value sets; not "
                    "supported yet")
        # slot layout: [0]=group row count, then per-agg slots
        self._offsets: list[int] = []
        off = 1
        for a in self._aggs:
            self._offsets.append(off)
            off += _SLOTS[a.kind]
        self._n_slots = off
        self._state: dict[int, dict[Any, np.ndarray]] = {}  # kg -> key -> acc
        self._out_schema: Optional[Schema] = None
        self._key_dtypes: Optional[list] = None

    # -- state layout ------------------------------------------------------
    def _new_acc(self) -> np.ndarray:
        acc = np.zeros(self._n_slots, np.float64)
        for a, off in zip(self._aggs, self._offsets):
            if a.kind in ("min", "max"):
                acc[off] = _INITS[a.kind]
        return acc

    def _results_from_acc(self, acc: np.ndarray) -> list:
        out = []
        for a, off in zip(self._aggs, self._offsets):
            if a.kind == "avg":
                cnt = acc[off + 1]
                out.append(acc[off] / cnt if cnt else 0.0)
            else:
                out.append(acc[off])
        return out

    # -- data path ---------------------------------------------------------
    def _local_partials(self, batch: RecordBatch
                        ) -> tuple[np.ndarray, list, np.ndarray]:
        """The LOCAL phase: fold one batch into per-distinct-key partial
        accumulator rows (uniq keys, key rows, partials [G, n_slots])."""
        keys, single_key = self._group_ids(batch)
        kinds = (batch.column(rk.ROWKIND_COLUMN).astype(np.int8)
                 if rk.ROWKIND_COLUMN in batch.schema
                 else np.zeros(batch.n, np.int8))
        # accumulate (+I/+U) rows add, retract (-U/-D) rows subtract
        sign = np.where((kinds == rk.UPDATE_BEFORE) | (kinds == rk.DELETE),
                        -1.0, 1.0)

        uniq, inverse = _unique_inverse(keys)
        key_rows = [(k,) if single_key else k for k in uniq]
        order = np.argsort(inverse, kind="stable")
        sorted_inv = inverse[order]
        starts = np.searchsorted(sorted_inv, np.arange(len(uniq)))

        partials = np.zeros((len(uniq), self._n_slots), np.float64)
        s = sign[order]
        partials[:, 0] = np.add.reduceat(s, starts)
        for a, off in zip(self._aggs, self._offsets):
            if a.kind == "count":
                vals = (s if a.field is None
                        else s * ~_is_null(batch.column(a.field)[order]))
                partials[:, off] = np.add.reduceat(vals, starts)
            elif a.kind in ("sum", "avg"):
                col = batch.column(a.field)[order].astype(np.float64)
                partials[:, off] = np.add.reduceat(col * s, starts)
                if a.kind == "avg":
                    partials[:, off + 1] = np.add.reduceat(s, starts)
            else:  # min/max
                col = batch.column(a.field)[order].astype(np.float64)
                if self._retract_minmax:
                    # exact under retraction: ship the per-group raw
                    # (value, delta) runs to the count-map merge instead
                    # of a lossy extremum fold
                    continue
                red = np.minimum if a.kind == "min" else np.maximum
                partials[:, off] = red.reduceat(col, starts)
        extras = None
        if self._retract_minmax and self._mm_idx:
            extras = []
            ends = np.append(starts[1:], len(keys))
            cols_sorted = {a.field: batch.column(a.field)[order]
                           .astype(np.float64)
                           for i, a in enumerate(self._aggs)
                           if i in self._mm_idx}
            s_sorted = s
            for gi in range(len(uniq)):
                lo, hi = int(starts[gi]), int(ends[gi])
                extras.append([
                    (cols_sorted[self._aggs[i].field][lo:hi],
                     s_sorted[lo:hi])
                    for i in self._mm_idx])
        return uniq, key_rows, partials, extras

    def _combine_partials(self, batch: RecordBatch
                          ) -> tuple[np.ndarray, list, np.ndarray]:
        """Partial-input mode (downstream of LocalGroupAggOperator): the
        batch's rows ARE partial accumulator rows; combine per distinct
        key (sum for additive slots, min/max-combine for extrema)."""
        keys, single_key = self._group_ids(batch)
        uniq, inverse = _unique_inverse(keys)
        key_rows = [(k,) if single_key else k for k in uniq]
        order = np.argsort(inverse, kind="stable")
        starts = np.searchsorted(inverse[order], np.arange(len(uniq)))
        partials = np.zeros((len(uniq), self._n_slots), np.float64)
        pc = batch.column(_PARTIAL_COUNT)[order].astype(np.float64)
        partials[:, 0] = np.add.reduceat(pc, starts)
        for a, off in zip(self._aggs, self._offsets):
            for j in range(_SLOTS[a.kind]):
                col = batch.column(_partial_col(a.out_name, j))[order] \
                    .astype(np.float64)
                if a.kind == "min" and j == 0:
                    partials[:, off] = np.minimum.reduceat(col, starts)
                elif a.kind == "max" and j == 0:
                    partials[:, off] = np.maximum.reduceat(col, starts)
                else:
                    partials[:, off + j] = np.add.reduceat(col, starts)
        return uniq, key_rows, partials

    def process_batch(self, batch: RecordBatch) -> None:
        if batch.n == 0:
            return
        if self._partial_input:
            uniq, key_rows, partials = self._combine_partials(batch)
            extras = None
        else:
            uniq, key_rows, partials, extras = self._local_partials(batch)

        # global phase: one state merge per distinct key + changelog emit
        out_rows: list[tuple] = []
        out_ts: list[int] = []
        ts_max = int(batch.timestamps.max())
        for gi, key in enumerate(uniq):
            key = key.item() if isinstance(key, np.generic) else key
            key_rows[gi] = tuple(
                v.item() if isinstance(v, np.generic) else v
                for v in key_rows[gi])
            kg = self._key_group_for(key)
            kg_map = self._state.setdefault(kg, {})
            acc = kg_map.get(key)
            first = acc is None
            prev_row = (None if first
                        else self._emit_row(key_rows[gi], acc,
                                            rk.UPDATE_BEFORE))
            if first:
                acc = self._new_acc()
            self._merge(acc, partials[gi])
            if extras is not None:
                self._merge_minmax_counts(kg, key, acc, extras[gi])
            if acc[0] <= 0:
                # group fully retracted: DELETE carries the pre-merge row
                # (reference GroupAggFunction emits -D of the old aggregate)
                if not first:
                    kg_map.pop(key, None)
                    self._mm_counts.get(kg, {}).pop(key, None)
                    out_rows.append(prev_row[:-1] + (int(rk.DELETE),))
                    out_ts.append(ts_max)
                continue
            kg_map[key] = acc
            if not first:
                out_rows.append(prev_row)
                out_ts.append(ts_max)
            out_rows.append(self._emit_row(
                key_rows[gi], acc, rk.INSERT if first else rk.UPDATE_AFTER))
            out_ts.append(ts_max)
        if out_rows:
            self._emit_batch(out_rows, out_ts)

    def _merge(self, acc: np.ndarray, partial: np.ndarray) -> None:
        acc[0] += partial[0]
        for a, off in zip(self._aggs, self._offsets):
            if a.kind in ("count", "sum"):
                acc[off] += partial[off]
            elif a.kind == "avg":
                acc[off] += partial[off]
                acc[off + 1] += partial[off + 1]
            elif self._retract_minmax:
                pass  # extrema maintained by _merge_minmax_counts
            elif a.kind == "min":
                acc[off] = min(acc[off], partial[off])
            else:
                acc[off] = max(acc[off], partial[off])

    def _merge_minmax_counts(self, kg: int, key: Any, acc: np.ndarray,
                             group_extras: list) -> None:
        """Exact MIN/MAX under retraction: per-agg value->multiplicity
        maps (reference MinWithRetractAggFunction.java:36). The extremum
        recomputes over the key's live-value map once per touched group
        per batch — O(distinct live values), the same order the reference
        pays iterating its MapView when the extremum retracts."""
        maps = self._mm_counts.setdefault(kg, {}).setdefault(
            key, [dict() for _ in self._mm_idx])
        for slot, (vals, signs) in zip(range(len(self._mm_idx)),
                                       group_extras):
            agg_i = self._mm_idx[slot]
            a = self._aggs[agg_i]
            off = self._offsets[agg_i]
            m = maps[slot]
            for v, sgn in zip(vals.tolist(), signs.tolist()):
                if sgn > 0:
                    m[v] = m.get(v, 0) + 1
                else:
                    c = m.get(v, 0) - 1
                    if c > 0:
                        m[v] = c
                    else:
                        m.pop(v, None)
            if not m:
                acc[off] = _INITS[a.kind]
            elif a.kind == "min":
                acc[off] = min(m)
            else:
                acc[off] = max(m)

    def _emit_row(self, key_row: tuple, acc: np.ndarray, kind) -> tuple:
        return key_row + tuple(self._results_from_acc(acc)) + (int(kind),)

    def _emit_batch(self, rows: list, ts: list[int]) -> None:
        if self._out_schema is None:
            key_fields = [(n, d) for n, d in zip(self._key_columns,
                                                 self._key_dtypes)]
            agg_fields = [(a.out_name, np.float64) for a in self._aggs]
            self._out_schema = Schema(
                key_fields + agg_fields + [(rk.ROWKIND_COLUMN, np.int8)])
        self.output.emit(RecordBatch.from_rows(self._out_schema, rows, ts))

    # -- keys --------------------------------------------------------------
    def _group_ids(self, batch: RecordBatch) -> tuple[np.ndarray, bool]:
        """Per-row group key array (hashable) + whether it's a single
        column (vs composite tuple keys)."""
        cols = [batch.column(c) for c in self._key_columns]
        if self._key_dtypes is None:
            self._key_dtypes = [batch.schema.field(c).dtype
                                for c in self._key_columns]
        if len(cols) == 1:
            return cols[0], True
        # composite key: build object array of tuples
        keys = np.empty(batch.n, dtype=object)
        for i in range(batch.n):
            keys[i] = tuple(_scalar(c[i]) for c in cols)
        return keys, False

    def _key_group_for(self, key: Any) -> int:
        return assign_to_key_group(key, self.ctx.max_parallelism)

    # -- checkpointing -----------------------------------------------------
    def snapshot_state(self, checkpoint_id: int) -> dict:
        snap = {"group-agg": {kg: dict(m)
                              for kg, m in self._state.items()}}
        if self._mm_counts:
            snap["group-agg-mm"] = {
                kg: {k: [dict(m) for m in maps]
                     for k, maps in keys.items()}
                for kg, keys in self._mm_counts.items()}
        return {"keyed": {"backend": snap}}

    def initialize_state(self, keyed_snapshots: list, operator_snapshot) -> None:
        for snap in keyed_snapshots:
            table = snap["backend"].get("group-agg", {})
            for kg, entries in table.items():
                if kg in self.ctx.key_group_range:
                    self._state.setdefault(kg, {}).update(entries)
            for kg, keys in snap["backend"].get("group-agg-mm", {}).items():
                if kg in self.ctx.key_group_range:
                    tgt = self._mm_counts.setdefault(kg, {})
                    for k, maps in keys.items():
                        tgt[k] = [dict(m) for m in maps]



_PARTIAL_COUNT = "__pc__"


def _partial_col(out_name: str, j: int) -> str:
    return f"{out_name}.__p{j}__"


class LocalGroupAggOperator(OneInputOperator):
    """The LOCAL half of two-phase GROUP BY (reference
    StreamExecLocalGroupAggregate / MiniBatchLocalGroupAggFunction): runs
    BEFORE the keyed exchange on every upstream subtask, folding each
    micro-batch into one partial-accumulator row per distinct key, so the
    exchange ships O(distinct keys) rows instead of O(records). Stateless
    (nothing to checkpoint); the global GroupAggOperator(partial_input=
    True) downstream combines partials and owns the changelog."""

    def __init__(self, key_columns: Sequence[str], aggs: Sequence[SqlAggSpec],
                 name: str = "LocalGroupAgg"):
        super().__init__(name)
        # reuse the partial computation via a throwaway global op core
        self._core = GroupAggOperator(key_columns, aggs, name=name)
        self._key_columns = list(key_columns)
        self._aggs = list(aggs)
        self._out_schema: Optional[Schema] = None

    def setup(self, ctx: OperatorContext, output: Output) -> None:
        super().setup(ctx, output)
        self._core.ctx = ctx

    def _schema_for(self, in_schema: Schema) -> Schema:
        if self._out_schema is None:
            fields = [(n, in_schema.field(n).dtype)
                      for n in self._key_columns]
            fields.append((_PARTIAL_COUNT, np.float64))
            for a in self._aggs:
                for j in range(_SLOTS[a.kind]):
                    fields.append((_partial_col(a.out_name, j), np.float64))
            self._out_schema = Schema(fields)
        return self._out_schema

    def process_batch(self, batch: RecordBatch) -> None:
        if batch.n == 0:
            return
        schema = self._schema_for(batch.schema)
        _uniq, key_rows, partials, _extras = \
            self._core._local_partials(batch)
        g = len(key_rows)
        cols: dict[str, np.ndarray] = {}
        for i, n in enumerate(self._key_columns):
            dtype = schema.field(n).dtype
            if dtype is object:
                arr = np.empty(g, object)
                arr[:] = [kr[i] for kr in key_rows]
            else:
                arr = np.asarray([kr[i] for kr in key_rows], dtype=dtype)
            cols[n] = arr
        cols[_PARTIAL_COUNT] = partials[:, 0]
        for a, off in zip(self._aggs, self._core._offsets):
            for j in range(_SLOTS[a.kind]):
                cols[_partial_col(a.out_name, j)] = partials[:, off + j]
        ts = np.full(g, int(batch.timestamps.max()), np.int64)
        self.output.emit(RecordBatch(schema, cols, ts))


def _unique_inverse(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """np.unique(return_inverse=True) that tolerates None / mixed-type
    object keys (which break numpy's sort): dict-order first-seen unique."""
    if keys.dtype != object:
        return np.unique(keys, return_inverse=True)
    index: dict = {}
    uniq: list = []
    inv = np.empty(len(keys), np.int64)
    for i, k in enumerate(keys):
        j = index.get(k)
        if j is None:
            j = index[k] = len(uniq)
            uniq.append(k)
        inv[i] = j
    out = np.empty(len(uniq), dtype=object)
    out[:] = uniq
    return out, inv


def _is_null(col: np.ndarray) -> np.ndarray:
    if col.dtype == object:
        return np.array([v is None for v in col], dtype=bool)
    return np.zeros(len(col), dtype=bool)
