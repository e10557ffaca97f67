"""Streaming deduplication (port of ``flink_tpu/sql/dedup.py``; reference
table-runtime operators/deduplicate/{ProcTimeDeduplicateKeepFirstRowFunction,
RowTimeDeduplicateFunction} behind StreamExecDeduplicate).

keep="first": emit only the first row per key (append-only output).
keep="last": emit a changelog: +I for a key's first row, then -U(prev)/+U
(new) as later rows replace it (the reference's keep-last with
generateUpdateBefore=true).

``ttl_ms`` bounds how long a key stays deduplicated (the reference's
table.exec.state.ttl): a key re-admits after the TTL passes.

With ``state.backend.type`` = ``tpu`` (the default) and an integer key
column, keep-first runs on the device: each batch is one keep-first
admission (``DeviceKeyedStateBackend.dedup_first_device``: the
``dedup_first`` kernel's lookup-or-insert, presence and TTL check and
first-in-batch resolution, then one host read of its status), so the
state lives on the card and scales with the hash table. A batch of device
columns (``datagen(device=True)``) stays on the card: its fresh rows are
compacted there, with the count that the status read brought home. Device
TTL is batch-granular: duplicates within one micro-batch always
deduplicate, even across a TTL boundary. keep="last" needs the previous
rows' values for its retractions and stays on the host plane, as do
``hashmap`` and non-integer keys. Retractions (UPDATE_BEFORE and DELETE
rows) reach keep-first as invalid rows: they claim no slot and emit
nothing.

Snapshots: the backend's ``{"kind": "tpu", ...}`` on the device plane,
``{"dedup2": {group: {key: (admit_ts, row)}}}`` on the host plane; the
legacy ``"dedup"`` format (no admit ts) restores too. Host state restored
into a device run migrates onto the card; device state refuses a run
that cannot use the device plane. ``stats`` holds the device plane's
host seconds a batch by part.
"""

from __future__ import annotations

import time
from typing import Any, Optional

import numpy as np
import torch

from ..core.device_records import DeviceRecordBatch
from ..core.keygroups import assign_to_key_group
from ..core.records import RecordBatch, Schema, scalar as _scalar
from ..device import resolve_device
from ..runtime.operators.base import OneInputOperator
from ..state.device_backend import DeviceKeyedStateBackend
from . import rowkind as rk

__all__ = ["DeduplicateOperator"]

#: host seconds of the device plane, by part
STAT_KEYS = ("prep_s", "admit_s", "compact_s", "emit_s")


def _integer(dtype) -> bool:
    return dtype is not object and np.issubdtype(np.dtype(dtype), np.integer)


class DeduplicateOperator(OneInputOperator):
    """``capacity``: the device table's first capacity (it grows by
    rehash); ``device``: the card unless the caller asks for ``cpu``."""

    def __init__(self, key_index: int, keep: str = "first",
                 ttl_ms: Optional[int] = None, name: str = "Deduplicate",
                 capacity: int = 1 << 16, device=None):
        super().__init__(name)
        if keep not in ("first", "last"):
            raise ValueError("keep must be 'first' or 'last'")
        self.key_index = key_index
        self.keep = keep
        self.ttl_ms = int(ttl_ms) if ttl_ms else 0
        self.capacity = int(capacity)
        self.device = resolve_device(device)
        # host plane: kg -> key -> (admit_ts, row-or-True)
        self._state: dict[int, dict[Any, Any]] = {}
        self._out_schema: Optional[Schema] = None
        self._backend: Optional[DeviceKeyedStateBackend] = None
        self._device_checked = False
        self._key_checked = False
        self._restored_device: list = []
        self.stats: dict = {k: 0.0 for k in STAT_KEYS}
        self.stats.update(batches=0, rows=0, fresh=0)

    @property
    def backend(self) -> Optional[DeviceKeyedStateBackend]:
        return self._backend

    # -- device routing ----------------------------------------------------
    def _build_backend(self) -> DeviceKeyedStateBackend:
        b = DeviceKeyedStateBackend(self.ctx.key_group_range,
                                    self.ctx.max_parallelism,
                                    capacity=self.capacity,
                                    device=self.device)
        b.register_row_state("__seen__", np.int8, self.ttl_ms or None)
        if self._restored_device:
            b.restore(self._restored_device)
            self._restored_device = []
        if self._state:
            # host-plane entries restored from a hashmap checkpoint migrate
            # into the device presence plane
            keys, admit_ts = [], []
            for kmap in self._state.values():
                for k, entry in kmap.items():
                    keys.append(int(k))
                    admit_ts.append(int(entry[0]))
            b.rows_upsert("__seen__", np.asarray(keys, np.int64),
                          np.ones(len(keys), np.int8),
                          now_ms=np.asarray(admit_ts, np.int64))
            self._state = {}
        return b

    def _device_backend(self, schema: Schema
                        ) -> Optional[DeviceKeyedStateBackend]:
        """The device backend when this operator runs its admission on the
        card (keep-first, the tpu backend, an integer key column)."""
        if self._device_checked:
            return self._backend
        self._device_checked = True
        eligible = (self.keep == "first"
                    and self.ctx.config.get("state.backend.type") == "tpu"
                    and _integer(schema.fields[self.key_index].dtype))
        if not eligible:
            if self._restored_device:
                raise RuntimeError(
                    "dedup state was checkpointed on the tpu backend but "
                    "this run cannot use the device path (backend/keep/"
                    "key-dtype changed); restore with the original config")
            return None
        self._backend = self._build_backend()
        return self._backend

    def _ensure_schema(self, in_schema: Schema) -> Schema:
        if self._out_schema is None:
            fields = [(f.name, f.dtype) for f in in_schema.fields
                      if f.name != rk.ROWKIND_COLUMN]
            if self.keep == "last":
                fields.append((rk.ROWKIND_COLUMN, np.int8))
            self._out_schema = Schema(fields)
        return self._out_schema

    def process_batch(self, batch: RecordBatch) -> None:
        if batch.n == 0:
            return
        schema = self._ensure_schema(batch.schema)
        names = [f.name for f in batch.schema.fields
                 if f.name != rk.ROWKIND_COLUMN]
        backend = self._device_backend(batch.schema)
        if backend is None:
            kinds = (batch.column(rk.ROWKIND_COLUMN).astype(np.int8)
                     if rk.ROWKIND_COLUMN in batch.schema
                     else np.zeros(batch.n, np.int8))
            self._process_host(batch, schema, names, kinds)
            return
        if not self._key_checked:
            # the eager restore skipped the schema check: a key column
            # that stopped being integer must fail loudly, not truncate
            kf = batch.schema.fields[self.key_index]
            if not _integer(kf.dtype):
                raise RuntimeError(
                    "dedup device state restored but the key column "
                    f"is {kf.dtype} (not integer); restore with the "
                    "original schema or the hashmap backend")
            self._key_checked = True
        if getattr(batch, "is_device", False):
            self._process_device_columns(batch, backend, schema, names)
        else:
            self._process_host_columns(batch, backend, schema, names)

    def _process_host_columns(self, batch: RecordBatch,
                              backend: DeviceKeyedStateBackend,
                              schema: Schema, names: list) -> None:
        """Device keep-first of a host batch: the keys, timestamps and
        validity go up, the fresh mask comes home."""
        t0 = time.perf_counter()
        kinds = (batch.column(rk.ROWKIND_COLUMN).astype(np.int8)
                 if rk.ROWKIND_COLUMN in batch.schema
                 else np.zeros(batch.n, np.int8))
        retract = np.isin(kinds, (rk.UPDATE_BEFORE, rk.DELETE))
        keys = batch.column(names[self.key_index]).astype(np.int64)
        t1 = time.perf_counter()
        fresh = backend.dedup_first_batch("__seen__", keys, batch.timestamps,
                                          valid=~retract)
        t2 = time.perf_counter()
        if fresh.any():
            self.output.emit(RecordBatch(
                schema, {n: batch.column(n)[fresh] for n in names},
                batch.timestamps[fresh]))
        t3 = time.perf_counter()
        self._count(batch.n, int(fresh.sum()), t0, t1, t2, t2, t3)

    def _process_device_columns(self, batch, backend, schema: Schema,
                                names: list) -> None:
        """Device keep-first of a batch of device columns: the fresh rows
        are compacted on the card with the count the status read brought
        home, and leave as a device batch."""
        t0 = time.perf_counter()
        dev = backend.device
        keys = batch.device_column(names[self.key_index])
        ts = (batch.dtimestamps if batch.dtimestamps is not None else
              torch.full((batch.n,), batch.ts_min, dtype=torch.int64,
                         device=dev))
        valid = None
        if rk.ROWKIND_COLUMN in batch.schema:
            kinds = batch.device_column(rk.ROWKIND_COLUMN)
            valid = (kinds != rk.UPDATE_BEFORE) & (kinds != rk.DELETE)
        t1 = time.perf_counter()
        fresh, n_fresh = backend.dedup_first_device("__seen__", keys, ts,
                                                    valid)
        t2 = time.perf_counter()
        t3 = t2
        if n_fresh:
            idx = _compact(fresh, n_fresh)
            cols = {n: batch.device_column(n).index_select(0, idx)
                    for n in names}
            out_ts = ts.index_select(0, idx)
            t3 = time.perf_counter()
            self.output.emit(DeviceRecordBatch(schema, cols, out_ts,
                                               batch.ts_min, batch.ts_max))
        self._count(batch.n, n_fresh, t0, t1, t2, t3, time.perf_counter())

    def _count(self, n: int, n_fresh: int, t0, t1, t2, t3, t4) -> None:
        st = self.stats
        st["batches"] += 1
        st["rows"] += n
        st["fresh"] += n_fresh
        for k, a, b in (("prep_s", t0, t1), ("admit_s", t1, t2),
                        ("compact_s", t2, t3), ("emit_s", t3, t4)):
            st[k] += b - a

    def _process_host(self, batch: RecordBatch, schema: Schema,
                      names: list, kinds: np.ndarray) -> None:
        cols = [batch.column(n) for n in names]
        ts_arr = batch.timestamps
        ttl = self.ttl_ms
        out_rows, out_ts = [], []
        for i in range(batch.n):
            row = tuple(_scalar(c[i]) for c in cols)
            key = row[self.key_index]
            kg = assign_to_key_group(key, self.ctx.max_parallelism)
            kmap = self._state.setdefault(kg, {})
            ts = int(ts_arr[i])
            retract = kinds[i] in (rk.UPDATE_BEFORE, rk.DELETE)
            if self.keep == "first":
                # keep-first assumes append-only input (like the reference's
                # KeepFirstRowFunction); retractions are ignored
                if retract:
                    continue
                entry = kmap.get(key)
                expired = (entry is not None and ttl
                           and ts - entry[0] > ttl)
                if entry is None or expired:
                    kmap[key] = (ts, True)
                    out_rows.append(row)
                    out_ts.append(ts)
            elif retract:
                # retraction of the current row deletes the key's entry
                entry = kmap.get(key)
                if entry is not None and entry[1] == row:
                    del kmap[key]
                    out_rows.append(row + (int(rk.DELETE),))
                    out_ts.append(ts)
            else:
                entry = kmap.get(key)
                prev = entry[1] if entry is not None else None
                if entry is not None and ttl and ts - entry[0] > ttl:
                    prev = None
                kmap[key] = (ts, row)
                if prev is None:
                    out_rows.append(row + (int(rk.INSERT),))
                    out_ts.append(ts)
                elif prev != row:
                    out_rows.append(prev + (int(rk.UPDATE_BEFORE),))
                    out_ts.append(ts)
                    out_rows.append(row + (int(rk.UPDATE_AFTER),))
                    out_ts.append(ts)
        if out_rows:
            self.output.emit(RecordBatch.from_rows(schema, out_rows, out_ts))

    # -- checkpointing -----------------------------------------------------
    def snapshot_state(self, checkpoint_id: int) -> dict:
        if self._backend is not None:
            return {"keyed": {"backend": self._backend.snapshot(
                checkpoint_id)}}
        return {"keyed": {"backend": {"dedup2": {
            kg: dict(m) for kg, m in self._state.items()}}}}

    def initialize_state(self, keyed_snapshots: list,
                         operator_snapshot) -> None:
        device_snaps = []
        kgr = self.ctx.key_group_range
        for snap in keyed_snapshots:
            table = snap.get("backend", {})
            if table.get("kind") == "tpu":
                device_snaps.append(table)
                continue
            for kg, entries in table.get("dedup2", {}).items():
                if kg in kgr:
                    self._state.setdefault(kg, {}).update(entries)
            for kg, entries in table.get("dedup", {}).items():
                # the pre-TTL format: entries lack the admit ts
                if kg in kgr:
                    self._state.setdefault(kg, {}).update(
                        {k: (0, v) for k, v in entries.items()})
        if device_snaps:
            # build and restore eagerly: a checkpoint taken before the
            # first batch must carry this state, not an empty host plane.
            # Validate the configuration first: a keep or backend change
            # cannot reinterpret device keep-first state
            if (self.keep != "first"
                    or self.ctx.config.get("state.backend.type") != "tpu"):
                raise RuntimeError(
                    "dedup state was checkpointed on the tpu backend but "
                    "this run cannot use the device path (backend or keep "
                    "changed); restore with the original config")
            self._restored_device = device_snaps
            self._backend = self._build_backend()
            self._device_checked = True


def _compact(mask: torch.Tensor, count: int) -> torch.Tensor:
    """Positions of the set entries of ``mask``, ``count`` of them known on
    the host: no second read of the count."""
    return torch.nonzero_static(mask, size=count).flatten()
