"""Device session windows on per-key lanes (port of
``flink_tpu/runtime/operators/device_session.py``).

The host runs the watermark protocol; the gap and merge logic and the
per-session accumulators live on the device in dense planes. Every key
slot owns L session lanes (``[L, capacity]`` planes ``__start__``,
``__end__``, ``__open__``, ``__count__`` and one per aggregate) and an
int32 ``__cur_lane__``; a key's live sessions rotate through its lanes.

* Each batch is sorted by (key, ts) on the device, two stable
  ``torch.sort`` passes (the reference's host ``lexsort``; ties keep their
  batch order), then runs one ``session_step`` (``ops/session.py``, a
  launch of ``csrc/session_window.cu`` on the card): lookup-or-insert,
  the merge check against all lanes, lateness, segments, lane allocation
  and the folds. A device batch stays on the device; a host batch is
  uploaded. The one host read per batch is the count of settled segments
  the step emitted (the reference's too); those rows come home into a
  host pending buffer and are emitted once the watermark passes their
  end.
* A session [start, last + gap) fires when the watermark passes its end:
  ``session_fire`` rounds compact the due lanes into ``[capacity]``
  buffers and reset them, the host looping while a round overflows. The
  dropped and late counters are read at a fire only: a dropped record
  (table full, or no free lane) raises there.

Semantics are the reference's (allowed lateness 0; an event bridging two
open sessions of one key joins one of them; more than L concurrently open
sessions of a key raise at the next fire), with one repair: a fire marks
the dirty blocks of the lanes it resets, so an incremental snapshot after
a fire holds them closed (the reference's ``set_array`` marks nothing, and
a restore from such a snapshot fires those sessions again).

The reference's five bounded sites (``runtime/watchdog.py``
``stall_bounded``): each batch's upload (``transfer.h2d``, a device batch
too, as the reference uploads every batch), its step (``device.execute``,
on the task's thread: it ends at its launches) and the read of its
emitted segments (``transfer.d2h``), and each fire round
(``device.execute``) with its read (``transfer.d2h``). Each site is
visited before its region starts.

Left out: an HBM budget, processing-time sessions.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from ...core.device_records import DeviceRecordBatch
from ...core.elements import Watermark
from ...core.keygroups import hash_batch, key_groups_for_hash_batch
from ...core.records import RecordBatch, Schema
from ...device import resolve_device, torch_dtype
from ...metrics.device import DEVICE_STATS
from ...metrics.profiler import DEVICE_LEDGER
from ...ops.session import session_fire, session_step
from ...state.device_backend import DeviceKeyedStateBackend
from ..watchdog import stall_bounded
from .base import OneInputOperator, OperatorContext, Output
from .device_window import AggSpec

__all__ = ["DeviceSessionWindowOperator"]


def session_step_cost(n: int, capacity: int, lanes: int, col_sizes: tuple,
                      plane_sizes: tuple) -> tuple[int, int]:
    """(flops, bytes) of one session step over ``n`` rows from its shapes:
    keys, timestamps and the value columns read once; the two stable
    sorts read their keys and write an int64 order once each; each row's
    table slot read once and its element of every lane plane read and
    written once; operations: the two sorts' n log2 n comparisons and one
    fold a plane per row. The emitted segments depend on the data and are
    not counted."""
    log_n = max(1, (n - 1).bit_length())
    return (2 * n * log_n + n * (1 + len(plane_sizes)),
            n * (16 + sum(col_sizes)) + 2 * n * 16
            + n * (8 + 2 * sum(plane_sizes)))


def session_fire_cost(capacity: int, lanes: int,
                      plane_sizes: tuple) -> tuple[int, int]:
    """(flops, bytes) of one session fire round from its shapes: the
    table (8 bytes a slot) and every lane of every plane read once; one
    operation a lane a slot. The fired rows depend on the data and are
    not counted."""
    return capacity * lanes, capacity * (8 + lanes * sum(plane_sizes))

_NEG = -(1 << 62)


class DeviceSessionWindowOperator(OneInputOperator):
    def __init__(self, gap_ms: int, key_column: str,
                 aggs: Sequence[AggSpec],
                 capacity: int = 1 << 16,
                 lanes: int = 4,
                 emit_window_bounds: bool = True,
                 device=None,
                 name: str = "DeviceSessionWindowAgg"):
        """``lanes``: sessions a key may hold open at once; ``device``:
        ``cuda`` unless ``"cpu"`` is asked for."""
        super().__init__(name)
        self._device = resolve_device(device)
        self._gap = int(gap_ms)
        self._lanes = int(lanes)
        self._key_column = key_column
        self._aggs = list(aggs)
        self._capacity = capacity
        self._emit_bounds = emit_window_bounds
        self._backend: Optional[DeviceKeyedStateBackend] = None
        self._registered = False
        self._late_cached = 0
        self._late_dev: Optional[torch.Tensor] = None
        self._fired_boundary = _NEG
        self.fire_latencies_ms: list[float] = []
        #: perf_counter of the first batch this operator processed
        self.first_batch_at: Optional[float] = None
        # settled sessions awaiting their watermark, as columnar numpy
        # chunks {"k", "s", "e", "c", plane name: values}
        self._pending: list[dict] = []

    # -- lifecycle ---------------------------------------------------------
    def setup(self, ctx: OperatorContext, output: Output) -> None:
        super().setup(ctx, output)
        # the session step inserts into the table itself: the backend's
        # own slot resolution and growth are never used
        self._backend = DeviceKeyedStateBackend(
            ctx.key_group_range, ctx.max_parallelism,
            capacity=self._capacity, device=self._device)
        L = self._lanes
        self._backend.register_array_state("__start__", "min", torch.int64,
                                           ring=L)
        self._backend.register_array_state("__end__", "max", torch.int64,
                                           ring=L)
        self._backend.register_array_state("__open__", "max", torch.int8,
                                           ring=L)
        self._backend.register_array_state("__count__", "count", torch.int64,
                                           ring=L)
        self._backend.register_array_state("__cur_lane__", "sum",
                                           torch.int32)
        self._late_dev = torch.zeros((), dtype=torch.int64,
                                     device=self._device)

    def _register_aggs(self, schema: Schema) -> None:
        for a in self._aggs:
            if a.field is not None and a.field in schema:
                a.dtype = (torch.float32 if a.kind == "avg"
                           else torch_dtype(schema.field(a.field).dtype))
            if a.kind == "avg":
                self._backend.register_array_state(
                    f"{a.out_name}.sum", "sum", a.dtype, ring=self._lanes)
            elif a.kind != "count":
                self._backend.register_array_state(
                    a.out_name, a.kind, a.dtype, ring=self._lanes)
        self._registered = True

    def _fold_sig(self) -> list[tuple[str, str, str]]:
        """(fold kind, plane name, field) per non-count aggregate."""
        sig = []
        for a in self._aggs:
            if a.kind == "count":
                continue
            name = f"{a.out_name}.sum" if a.kind == "avg" else a.out_name
            sig.append(("sum" if a.kind == "avg" else a.kind, name, a.field))
        return sig

    def _agg_sig(self) -> list[tuple[str, str, str]]:
        """(kind, output name, plane name) per aggregate."""
        sig = []
        for a in self._aggs:
            plane = (f"{a.out_name}.sum" if a.kind == "avg"
                     else "__count__" if a.kind == "count" else a.out_name)
            sig.append((a.kind, a.out_name, plane))
        return sig

    def _lanes_planes(self) -> list[torch.Tensor]:
        get = self._backend.get_array
        return [get("__start__"), get("__end__"), get("__open__"),
                get("__count__")]

    # -- data path ---------------------------------------------------------
    def process_batch(self, batch: RecordBatch) -> None:
        if batch.n == 0:
            return
        if self.first_batch_at is None:
            self.first_batch_at = time.perf_counter()
        if not self._registered:
            key_dtype = np.dtype(batch.schema.field(self._key_column).dtype)
            if not np.issubdtype(key_dtype, np.integer):
                raise TypeError(
                    "device session windows need an integer key column; "
                    f"{self._key_column!r} is {key_dtype}")
            self._register_aggs(batch.schema)
        # bounded sites, as the reference's: the upload and the reads on
        # the supervised worker, the step on this thread; each site is
        # visited before its region starts
        keys, ts, cols = stall_bounded(
            "transfer.h2d", lambda: self._device_columns(batch),
            scope="device_session")
        if not isinstance(batch, DeviceRecordBatch):
            DEVICE_STATS.note_h2d(keys.nbytes + ts.nbytes + sum(
                c.nbytes for c in cols.values()), batch.n)

        def step():
            # sort by (key, ts): ts first, then key, both stable, so ties
            # keep their batch order (np.lexsort's order)
            order = torch.sort(ts, stable=True).indices
            order = order[torch.sort(keys[order], stable=True).indices]
            backend = self._backend
            folds = [(kind, backend.get_array(name),
                      cols[field][order].to(backend.get_array(name).dtype))
                     for kind, name, field in self._fold_sig()]
            return session_step(
                backend.table, *self._lanes_planes(), folds,
                backend.get_array("__cur_lane__"), keys[order], ts[order],
                self._gap, self._fired_boundary,
                backend.dropped_device, self._late_dev, backend.dirty_buffer,
                backend.dirty_shift)

        tok = DEVICE_LEDGER.begin("device_session.step", self._device) \
            if DEVICE_LEDGER.enabled else None
        rows = stall_bounded("device.execute", step, scope="device_session")
        if tok is not None:
            DEVICE_LEDGER.end(tok, (
                batch.n, self._backend.capacity, self._lanes,
                tuple(c.element_size() for c in cols.values()),
                tuple(self._backend.get_array(n).element_size()
                      for _k, n, _f in self._fold_sig())),
                session_step_cost)
        # lint: sync-ok the one host read per batch: emitted segments
        g = int(rows.n)
        if g:
            def read() -> dict:
                # lint: sync-ok the emitted segments, one bounded read a batch
                chunk = {"k": rows.key[:g].cpu().numpy(),
                         "s": rows.start[:g].cpu().numpy(),
                         "e": rows.end[:g].cpu().numpy(),
                         "c": rows.count[:g].cpu().numpy()}
                for (_k, name, _f), v in zip(self._fold_sig(), rows.values):
                    chunk[name] = v[:g].cpu().numpy()
                return chunk

            chunk = stall_bounded("transfer.d2h", read,
                                  scope="device_session")
            DEVICE_STATS.note_d2h(sum(v.nbytes for v in chunk.values()), g)
            self._pending.append(chunk)

    def _device_columns(self, batch: RecordBatch):
        """(keys int64, ts int64, {field: values}) on the device: a device
        batch's own columns, or a host batch's uploaded."""
        fields = {f for _k, _n, f in self._fold_sig()}
        if isinstance(batch, DeviceRecordBatch):
            ts = batch.dtimestamps
            if ts is None:
                ts = torch.full((batch.n,), batch.ts_min, dtype=torch.int64,
                                device=self._device)
            return (batch.device_column(self._key_column).to(torch.int64),
                    ts.to(torch.int64),
                    {f: batch.device_column(f) for f in fields})

        def up(a) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(self._device)

        return (up(np.asarray(batch.column(self._key_column)).astype(
                    np.int64, copy=False)),
                up(np.asarray(batch.timestamps, np.int64)),
                {f: up(np.asarray(batch.column(f))) for f in fields})

    def process_watermark(self, watermark: Watermark) -> None:
        self.current_watermark = watermark.timestamp
        boundary = watermark.timestamp + 1
        if boundary > self._fired_boundary:
            self._fired_boundary = boundary
            self._fire(boundary)
            self._flush_pending(boundary)
        self.output.emit_watermark(watermark)

    def _flush_pending(self, boundary: int) -> None:
        """Emit the settled sessions whose window end passed the
        watermark; keep the rest."""
        if not self._pending:
            return
        merged = {key: np.concatenate([c[key] for c in self._pending])
                  for key in self._pending[0]}
        ripe = merged["e"] + self._gap <= boundary
        if ripe.any():
            sel = {k: v[ripe] for k, v in merged.items()}
            outs = {}
            for a in self._aggs:
                if a.kind == "count":
                    outs[a.out_name] = sel["c"]
                elif a.kind == "avg":
                    s = sel[f"{a.out_name}.sum"]
                    outs[a.out_name] = s / np.maximum(
                        sel["c"], 1).astype(s.dtype)
                else:
                    outs[a.out_name] = sel[a.out_name]
            self._emit(sel["k"], sel["s"], sel["e"], outs)
        rest = ~ripe
        self._pending = ([{k: v[rest] for k, v in merged.items()}]
                         if rest.any() else [])

    def _fire(self, boundary: int) -> None:
        if not self._registered:
            return
        t0 = time.perf_counter()
        backend = self._backend
        resets = [(kind, backend.get_array(name))
                  for kind, name, _f in self._fold_sig()]
        outs = [(kind, backend.get_array(plane))
                for kind, _o, plane in self._agg_sig()]
        while True:
            # each round a bounded device.execute visit, its reads a
            # bounded transfer.d2h
            tok = DEVICE_LEDGER.begin("device_session.fire", self._device) \
                if DEVICE_LEDGER.enabled else None
            rows = stall_bounded("device.execute", lambda: session_fire(
                backend.table, *self._lanes_planes(), resets, outs,
                self._gap, boundary, backend.dirty_buffer,
                backend.dirty_shift), scope="device_session")
            if tok is not None:
                DEVICE_LEDGER.end(tok, (
                    backend.capacity, self._lanes,
                    tuple(p.element_size() for _k, p in resets)),
                    session_fire_cost)
            # lint: sync-ok fire loop control: fired and overflow counts
            fired, overflow = rows.counts.tolist()
            if fired == 0:
                break
            host = stall_bounded("transfer.d2h", lambda: (
                rows.key[:fired].cpu().numpy(),
                rows.start[:fired].cpu().numpy(),
                rows.end[:fired].cpu().numpy(),
                {o: v[:fired].cpu().numpy()
                 for (_k, o, _p), v in zip(self._agg_sig(), rows.values)}),
                scope="device_session")
            DEVICE_STATS.note_d2h(sum(a.nbytes for a in host[:3]) + sum(
                v.nbytes for v in host[3].values()), fired)
            self._emit(*host)
            if overflow == 0:
                break
        # deferred health: table overflow and lane collisions raise here
        health = torch.stack([backend.dropped_device, self._late_dev])
        # lint: sync-ok deferred health, once a fire
        dropped, late = health.tolist()
        self._late_cached = late
        if dropped:
            raise RuntimeError(
                f"device session state overflow: {dropped} records hit "
                f"hash-table or session-lane limits; raise capacity/"
                f"lanes (lanes={self._lanes})")
        if len(self.fire_latencies_ms) < 65536:
            self.fire_latencies_ms.append((time.perf_counter() - t0) * 1e3)

    def _emit(self, keys: np.ndarray, start: np.ndarray, end: np.ndarray,
              outs: dict) -> None:
        """Rows (key, [window_start, window_end], aggregates in AggSpec
        order), timestamped window_end - 1."""
        end = end + self._gap
        cols: dict[str, np.ndarray] = {self._key_column: keys}
        fields: list = [(self._key_column, np.int64)]
        if self._emit_bounds:
            cols["window_start"] = start
            cols["window_end"] = end
            fields += [("window_start", np.int64), ("window_end", np.int64)]
        for a in self._aggs:
            v = np.asarray(outs[a.out_name])
            cols[a.out_name] = v
            fields.append((a.out_name, v.dtype.type))
        self.output.emit(RecordBatch(Schema(fields), cols, end - 1))

    def _refresh_late(self) -> None:
        """Blocking read of the device late counter (fires and
        checkpoints only)."""
        # lint: sync-ok the late counter at fires and checkpoints only
        self._late_cached = int(self._late_dev)

    @property
    def late_dropped(self) -> int:
        return self._late_cached

    @property
    def backend(self) -> DeviceKeyedStateBackend:
        return self._backend

    # -- checkpointing -----------------------------------------------------
    def snapshot_state(self, checkpoint_id: int) -> dict:
        self._refresh_late()
        return {"keyed": {
            "backend": self._backend.snapshot(checkpoint_id),
            "pending": [dict(c) for c in self._pending],
            "meta": {"fired_boundary": int(self._fired_boundary),
                     "watermark": self.current_watermark}}}

    def initialize_state(self, keyed_snapshots: list,
                         operator_snapshot) -> None:
        if not keyed_snapshots:
            return
        backend = self._backend
        backend.restore([s["backend"] for s in keyed_snapshots])
        # pending sessions re-filter by key group on rescale
        kgr = backend.key_group_range
        for s in keyed_snapshots:
            for chunk in s.get("pending", []):
                kg = key_groups_for_hash_batch(hash_batch(chunk["k"]),
                                               backend.max_parallelism)
                mine = (kg >= kgr.start) & (kg <= kgr.end)
                if mine.any():
                    self._pending.append({k: np.asarray(v)[mine]
                                          for k, v in chunk.items()})
        self._fired_boundary = max(int(s["meta"]["fired_boundary"])
                                   for s in keyed_snapshots)
        self.current_watermark = max(s["meta"]["watermark"]
                                     for s in keyed_snapshots)
        self._registered = False   # re-register agg planes lazily
