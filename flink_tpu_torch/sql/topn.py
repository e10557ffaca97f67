"""Streaming Top-N over an (optionally changelog) input (copy of
``flink_tpu/sql/topn.py``).

The analog of the reference's rank operators (flink-table-planner
StreamExecRank / flink-table-runtime operators/rank/ — e.g.
AppendOnlyTopNFunction, RetractableTopNFunction): maintains the current
result multiset under +I/+U/-U/-D input and, after every batch, emits the
*delta* of the top-N as a changelog (DELETE rows that left the top-N,
INSERT rows that entered it). Runs at parallelism 1 after a global
exchange, like the reference's singleton rank.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from ..core.records import RecordBatch, Schema, scalar as _scalar
from ..runtime.operators.base import OneInputOperator
from . import rowkind as rk

__all__ = ["TopNOperator"]


class TopNOperator(OneInputOperator):
    def __init__(self, schema: Schema,
                 sort_fns: Sequence[tuple[Callable, bool]], limit: int,
                 name: str = "TopN"):
        super().__init__(name)
        self._schema = schema
        self._data_names = [f.name for f in schema.fields
                            if f.name != rk.ROWKIND_COLUMN]
        self._sort_fns = list(sort_fns)
        self._limit = int(limit)
        self._rows: dict[tuple, int] = {}   # data row -> multiplicity
        self._emitted: list[tuple] = []     # last emitted top-n, in order
        self._out_schema = Schema(
            [(n, schema.field(n).dtype) for n in self._data_names]
            + [(rk.ROWKIND_COLUMN, np.int8)])

    # -- data path ---------------------------------------------------------
    def process_batch(self, batch: RecordBatch) -> None:
        if batch.n == 0:
            return
        kinds = (batch.column(rk.ROWKIND_COLUMN).astype(np.int8)
                 if rk.ROWKIND_COLUMN in batch.schema
                 else np.zeros(batch.n, np.int8))
        cols = [batch.column(n) for n in self._data_names]
        for i in range(batch.n):
            row = tuple(_scalar(c[i]) for c in cols)
            if kinds[i] in (rk.UPDATE_BEFORE, rk.DELETE):
                m = self._rows.get(row, 0) - 1
                if m <= 0:
                    self._rows.pop(row, None)
                else:
                    self._rows[row] = m
            else:
                self._rows[row] = self._rows.get(row, 0) + 1
        self._emit_delta(int(batch.timestamps.max()))

    def _current_topn(self) -> list[tuple]:
        rows = [r for r, m in self._rows.items() for _ in range(m)]
        if not rows:
            return []
        cols = {n: np.array([r[i] for r in rows], dtype=object)
                for i, n in enumerate(self._data_names)}
        n = len(rows)
        # lexicographic sort by the ORDER BY list (last key least significant
        # -> apply in reverse with a stable sort)
        order = np.arange(n)
        for fn, desc in reversed(self._sort_fns):
            vals = np.asarray(fn(cols, n), dtype=np.float64)
            vals = vals[order]
            idx = np.argsort(-vals if desc else vals, kind="stable")
            order = order[idx]
        return [rows[i] for i in order[:self._limit]]

    def _emit_delta(self, ts: int) -> None:
        new = self._current_topn()
        old_set, new_set = set(self._emitted), set(new)
        out_rows: list[tuple] = []
        for r in self._emitted:
            if r not in new_set:
                out_rows.append(r + (int(rk.DELETE),))
        for r in new:
            if r not in old_set:
                out_rows.append(r + (int(rk.INSERT),))
        self._emitted = new
        if out_rows:
            self.output.emit(RecordBatch.from_rows(
                self._out_schema, out_rows, [ts] * len(out_rows)))

    # -- checkpointing -----------------------------------------------------
    def snapshot_state(self, checkpoint_id: int) -> dict:
        return {"operator": {"rows": dict(self._rows),
                             "emitted": list(self._emitted)}}

    def initialize_state(self, keyed_snapshots: list, operator_snapshot) -> None:
        if operator_snapshot:
            self._rows = dict(operator_snapshot["rows"])
            self._emitted = list(operator_snapshot["emitted"])

