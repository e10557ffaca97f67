"""``CepOperator``: keyed NFA pattern matching (port of
``flink_tpu/cep/operator.py``).

Flink's CepOperator: a batch's events are buffered by key group and key,
and each key's events run through the NFA in (ts, seq) order when the
watermark passes them; partial matches stay in the keyed state, and each
match goes to a select function. An event at or behind the watermark is
late: it goes to the ``dead-letter`` side output and is counted in
``DEVICE_STATS``.

A device batch comes home once: each column is copied to the host a
batch and turned into Python values in one call, never an element at a
time. The NFA's state stays on the host. The output is a host
``RecordBatch``; a device window or GROUP BY downstream takes it on its
host-batch route.

The snapshot is the reference's: ``{"keyed": {"backend": {"cep": {kg:
{key: {"buffer": [Event], "partials": [partial]}}}}}, "operator":
{"seq": next sequence number}}``. A restore takes the reference's
events and partials by their fields (``nfa.adopt_partial``).
"""

from __future__ import annotations

import itertools
from typing import Any, Callable

import numpy as np

from ..core.keygroups import assign_to_key_group
from ..core.records import RecordBatch, Schema, scalar
from ..metrics import DEVICE_STATS
from ..runtime.operators.base import OneInputOperator
from .nfa import NFA, Event, Match, adopt_event, adopt_partial

__all__ = ["CepOperator", "DEAD_LETTER_TAG"]

DEAD_LETTER_TAG = "dead-letter"


def _host_values(col: np.ndarray) -> list:
    """A column as Python values, converted in one call."""
    if col.dtype == object:
        return [scalar(v) for v in col]
    return col.tolist()


class CepOperator(OneInputOperator):
    """``select_fn(match) -> row tuple`` (with ``flat_select``: an
    iterable of rows) makes the output rows, of ``out_schema``.
    ``order_column``: MATCH_RECOGNIZE's ORDER BY column, which must be the
    event time (a fire orders only its own rows, so any other column
    would be mis-ordered across fires: the operator raises instead)."""

    def __init__(self, nfa: NFA, key_column: str,
                 select_fn: Callable[[Match], Any], out_schema: Schema,
                 flat_select: bool = False, name: str = "Cep",
                 order_column: str = None):
        super().__init__(name)
        self.nfa = nfa
        self.key_column = key_column
        self.select_fn = select_fn
        self.out_schema = out_schema
        self.flat_select = flat_select
        self.order_column = order_column
        self._seq = itertools.count()
        # kg -> key -> {"buffer": [Event], "partials": [partial]}
        self._state: dict[int, dict[Any, dict]] = {}
        self._late_dropped = 0

    def _key_state(self, key) -> dict:
        kg = assign_to_key_group(key, self.ctx.max_parallelism)
        return (self._state.setdefault(kg, {})
                .setdefault(key, {"buffer": [], "partials": []}))

    @property
    def late_dropped(self) -> int:
        return self._late_dropped

    # -- data path ---------------------------------------------------------
    def process_batch(self, batch: RecordBatch) -> None:
        if batch.n == 0:
            return
        names = list(batch.schema.names)
        ts_arr = np.asarray(batch.timestamps)
        late = ts_arr <= self.current_watermark
        n_late = int(late.sum())
        if n_late:
            self._late_dropped += n_late
            DEVICE_STATS.note_dead_letter(n_late)
            try:
                self.output.emit_side(DEAD_LETTER_TAG, batch.filter(late))
            except NotImplementedError:
                pass  # no dead-letter consumer: counted, then dropped
        cols = [_host_values(np.asarray(batch.column(n))) for n in names]
        keys = cols[names.index(self.key_column)]
        stamps = ts_arr.tolist()
        late_rows = late.tolist()
        for i in range(batch.n):
            if late_rows[i]:
                continue
            data = {n: c[i] for n, c in zip(names, cols)}
            ev = Event(next(self._seq), stamps[i], data)
            self._key_state(keys[i])["buffer"].append(ev)

    def process_watermark(self, watermark) -> None:
        self._fire_up_to(watermark.timestamp)
        super().process_watermark(watermark)

    def finish(self) -> None:
        self._fire_up_to(1 << 62)

    def _check_order(self, ready: list) -> None:
        for e in ready:
            if e.data.get(self.order_column) != e.ts:
                raise ValueError(
                    f"ORDER BY {self.order_column!r} is not the stream's "
                    f"time attribute (row value "
                    f"{e.data.get(self.order_column)!r} != event time "
                    f"{e.ts}); MATCH_RECOGNIZE requires ordering by the "
                    "time attribute")

    def _fire_up_to(self, wm_ts: int) -> None:
        out_rows: list = []
        out_ts: list = []
        for kg_map in self._state.values():
            for key in list(kg_map):
                st = kg_map[key]
                ready = [e for e in st["buffer"] if e.ts <= wm_ts]
                if not ready and not st["partials"]:
                    if not st["buffer"]:
                        del kg_map[key]   # drained: free the key
                    continue
                st["buffer"] = [e for e in st["buffer"] if e.ts > wm_ts]
                if self.order_column is not None:
                    self._check_order(ready)
                ready.sort(key=lambda e: (e.ts, e.seq))
                partials = st["partials"]
                for ev in ready:
                    partials, matches = self.nfa.advance(partials, ev)
                    self._collect(matches, out_rows, out_ts)
                partials, timed_out = self.nfa.prune(partials, wm_ts)
                self._collect(timed_out, out_rows, out_ts)
                st["partials"] = partials
                if not partials and not st["buffer"]:
                    del kg_map[key]
        if out_rows:
            self.output.emit(RecordBatch.from_rows(self.out_schema,
                                                   out_rows, out_ts))

    def _collect(self, matches: list, out_rows: list, out_ts: list) -> None:
        for m in matches:
            if self.flat_select:
                for row in self.select_fn(m):
                    out_rows.append(tuple(row))
                    out_ts.append(m.end_ts)
            else:
                out_rows.append(tuple(self.select_fn(m)))
                out_ts.append(m.end_ts)

    # -- checkpointing -----------------------------------------------------
    def snapshot_state(self, checkpoint_id: int) -> dict:
        return {"keyed": {"backend": {"cep": {
            kg: {k: {"buffer": list(st["buffer"]),
                     "partials": list(st["partials"])}
                 for k, st in m.items()}
            for kg, m in self._state.items()}}},
            "operator": {"seq": next(self._seq)}}

    def initialize_state(self, keyed_snapshots: list,
                         operator_snapshot) -> None:
        for snap in keyed_snapshots:
            for kg, entries in snap.get("backend", {}).get("cep",
                                                           {}).items():
                if kg not in self.ctx.key_group_range:
                    continue
                target = self._state.setdefault(kg, {})
                for k, st in entries.items():
                    cur = target.setdefault(k, {"buffer": [],
                                                "partials": []})
                    cur["buffer"].extend(adopt_event(e)
                                         for e in st["buffer"])
                    cur["partials"].extend(adopt_partial(p)
                                           for p in st["partials"])
        if operator_snapshot and "seq" in operator_snapshot:
            self._seq = itertools.count(operator_snapshot["seq"])
