"""OVER aggregation: per-row running aggregates over a partition (port of
``flink_tpu/sql/over_agg.py``, a host operator).

Analog of the reference's StreamExecOverAggregate + table-runtime
operators/over/ (RowTimeRangeUnboundedPrecedingFunction et al.): every input
row is emitted once, extended with aggregate values computed over the
partition's rows from UNBOUNDED PRECEDING (or a ROWS window of size n) up to
and including the current row, ordered by event time.

TPU-first shape: a batch is sorted by (partition, ts) once, each partition
run's aggregates computed as vectorized prefix scans (np.cumsum / running
min-max), and only one state merge per partition carries the running
accumulator across batches. Append-only input (the reference restricts OVER
to append-only streams too).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np

from ..core.keygroups import assign_to_key_group
from ..core.records import RecordBatch, Schema
from ..runtime.operators.base import OneInputOperator
from .group_agg import SqlAggSpec

__all__ = ["OverAggOperator"]


class OverAggOperator(OneInputOperator):
    """Unbounded-preceding OVER aggregation, one partition key column."""

    def __init__(self, key_column: str, aggs: Sequence[SqlAggSpec],
                 rows_window: Optional[int] = None, name: str = "OverAgg"):
        super().__init__(name)
        self.key_column = key_column
        self.aggs = list(aggs)
        self.rows_window = rows_window  # None = UNBOUNDED PRECEDING
        # kg -> key -> accumulator dict per agg index
        self._state: dict[int, dict[Any, list]] = {}
        # ROWS window needs the trailing rows_window-1 values per agg
        self._tails: dict[int, dict[Any, list]] = {}
        self._out_schema: Optional[Schema] = None

    def _init_acc(self) -> list:
        acc = []
        for a in self.aggs:
            if a.kind == "count":
                acc.append(0.0)
            elif a.kind in ("sum", "avg"):
                acc.append([0.0, 0.0])  # sum, count
            elif a.kind == "min":
                acc.append(np.inf)
            else:
                acc.append(-np.inf)
        return acc

    def process_batch(self, batch: RecordBatch) -> None:
        if batch.n == 0:
            return
        if self._out_schema is None:
            self._out_schema = Schema(
                [(f.name, f.dtype) for f in batch.schema.fields]
                + [(a.out_name, np.float64) for a in self.aggs])
        keys = batch.column(self.key_column)
        ts = batch.timestamps
        # stable sort by (key-run, ts): group rows per key, keep time order
        from .group_agg import _unique_inverse
        uniq, inverse = _unique_inverse(keys)
        order = np.lexsort((ts, inverse))
        n = batch.n
        agg_out = np.zeros((n, len(self.aggs)), np.float64)
        sorted_inv = inverse[order]
        starts = np.searchsorted(sorted_inv, np.arange(len(uniq)))
        ends = np.append(starts[1:], n)
        agg_cols = [None if a.field is None
                    else batch.column(a.field).astype(np.float64)
                    for a in self.aggs]

        for gi in range(len(uniq)):
            key = uniq[gi]
            key = key.item() if isinstance(key, np.generic) else key
            kg = assign_to_key_group(key, self.ctx.max_parallelism)
            idx = order[starts[gi]:ends[gi]]
            m = len(idx)
            if self.rows_window is None:
                acc = self._state.setdefault(kg, {}).get(key)
                if acc is None:
                    acc = self._init_acc()
                self._unbounded_run(acc, idx, m, agg_cols, agg_out)
                self._state[kg][key] = acc
            else:
                # ROWS windows only need the trailing values, no accumulator
                tail = self._tails.setdefault(kg, {}).setdefault(
                    key, [[] for _ in self.aggs])
                self._rows_run(tail, idx, m, agg_cols, agg_out)
        out_cols = {f.name: batch.column(f.name)
                    for f in batch.schema.fields}
        for j, a in enumerate(self.aggs):
            out_cols[a.out_name] = agg_out[:, j]
        self.output.emit(RecordBatch(self._out_schema, out_cols, ts))

    def _unbounded_run(self, acc: list, idx: np.ndarray, m: int,
                       agg_cols: list, agg_out: np.ndarray) -> None:
        for j, a in enumerate(self.aggs):
            if a.kind == "count":
                vals = np.ones(m)
                run = acc[j] + np.cumsum(vals)
                acc[j] = float(run[-1])
                agg_out[idx, j] = run
            elif a.kind in ("sum", "avg"):
                vals = agg_cols[j][idx]
                run_sum = acc[j][0] + np.cumsum(vals)
                run_cnt = acc[j][1] + np.arange(1, m + 1)
                acc[j][0] = float(run_sum[-1])
                acc[j][1] = float(run_cnt[-1])
                agg_out[idx, j] = (run_sum if a.kind == "sum"
                                   else run_sum / run_cnt)
            elif a.kind == "min":
                vals = np.minimum.accumulate(agg_cols[j][idx])
                run = np.minimum(acc[j], vals)
                acc[j] = float(run[-1])
                agg_out[idx, j] = run
            else:
                vals = np.maximum.accumulate(agg_cols[j][idx])
                run = np.maximum(acc[j], vals)
                acc[j] = float(run[-1])
                agg_out[idx, j] = run

    def _rows_run(self, tail: list, idx: np.ndarray, m: int,
                  agg_cols: list, agg_out: np.ndarray) -> None:
        """ROWS BETWEEN n-1 PRECEDING AND CURRENT ROW via a per-key tail of
        the last n-1 values."""
        w = self.rows_window
        for j, a in enumerate(self.aggs):
            vals = (np.ones(m) if a.field is None and a.kind == "count"
                    else agg_cols[j][idx])
            full = np.concatenate([np.asarray(tail[j], np.float64), vals])
            k = len(tail[j])
            for p in range(m):
                lo = max(0, k + p - w + 1)
                window = full[lo:k + p + 1]
                if a.kind == "count":
                    agg_out[idx[p], j] = len(window)
                elif a.kind == "sum":
                    agg_out[idx[p], j] = window.sum()
                elif a.kind == "avg":
                    agg_out[idx[p], j] = window.mean()
                elif a.kind == "min":
                    agg_out[idx[p], j] = window.min()
                else:
                    agg_out[idx[p], j] = window.max()
            tail[j] = list(full[-(w - 1):]) if w > 1 else []

    def snapshot_state(self, checkpoint_id: int) -> dict:
        return {"keyed": {"backend": {
            "over": {kg: {k: _copy_acc(a) for k, a in m.items()}
                     for kg, m in self._state.items()},
            "over-tails": {kg: {k: [list(t) for t in ts]
                                for k, ts in m.items()}
                           for kg, m in self._tails.items()}}}}

    def initialize_state(self, keyed_snapshots: list,
                         operator_snapshot) -> None:
        for snap in keyed_snapshots:
            table = snap.get("backend", {})
            for kg, entries in table.get("over", {}).items():
                if kg in self.ctx.key_group_range:
                    self._state.setdefault(kg, {}).update(
                        {k: _copy_acc(a) for k, a in entries.items()})
            for kg, entries in table.get("over-tails", {}).items():
                if kg in self.ctx.key_group_range:
                    self._tails.setdefault(kg, {}).update(
                        {k: [list(t) for t in ts]
                         for k, ts in entries.items()})


def _copy_acc(acc: list) -> list:
    return [list(a) if isinstance(a, list) else a for a in acc]
