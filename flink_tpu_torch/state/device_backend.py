"""DeviceKeyedStateBackend: device-resident keyed state (port of the core
of ``flink_tpu/state/tpu_backend.py``).

Keyed state for one subtask's key-group range lives on the device as a
hash table (``ops/hash_table.py``: int64 key -> dense slot) next to named
accumulator planes, ``[capacity]`` or ``[ring, capacity]``, updated by
whole-batch scatter folds (a device batch's step is one fused kernel,
``ingest_deferred``). Planes are updated in place.

Growth: when occupancy passes 0.6 * capacity (or an insert exhausts its
probes) the table doubles and every plane is re-keyed on the device.

Window-role planes (``role="window"``) hold the incremental fire
engine's derived state; snapshots, pane retirement and ring conforming
leave them out.

Snapshots are the reference's schema, ``{"kind": "tpu", keys,
key_groups, max_parallelism, states}``, as numpy in canonical (group,
key) order, so a snapshot of either package restores into the other.

Left out of this slice: the HBM budget, spill and tiering, the dirty-block
snapshot mirror, the native host index and the row planes.
"""

from __future__ import annotations

import time
from typing import Iterable, Optional

import numpy as np
import torch

from ..core.keygroups import KeyGroupRange, hash_batch, \
    key_groups_for_hash_batch
from ..device import numpy_dtype, torch_dtype
from ..ops.hash_table import EMPTY_KEY, ingest_step, lookup, \
    lookup_or_insert, make_table, sanitize_keys_device
from ..ops.segment_ops import identity, make_accumulator, scatter_fold

__all__ = ["DeviceKeyedStateBackend"]

_GROW_AT = 0.6  # occupancy share that triggers a doubling rehash


class _ArrayState:
    __slots__ = ("name", "kind", "dtype", "ring", "array", "role")

    def __init__(self, name: str, kind: str, dtype: torch.dtype,
                 ring: Optional[int], capacity: int, device,
                 role: str = "pane"):
        self.name = name
        self.kind = kind
        self.dtype = dtype
        self.ring = ring
        # role "pane": the source-of-truth pane planes, which snapshot,
        # retire and conform. role "window": DERIVED incremental-fire state
        # (running window accumulators, merge trees); it follows slot
        # remaps on a rehash but is left out of snapshots, ring-row
        # retirement and conform_ring: a restore rebuilds it from the panes
        self.role = role
        shape = (ring, capacity) if ring else (capacity,)
        self.array = make_accumulator(kind, shape, dtype, device)


class DeviceKeyedStateBackend:
    def __init__(self, key_group_range: KeyGroupRange, max_parallelism: int,
                 capacity: int = 1 << 16, device="cuda",
                 defer_overflow: bool = False):
        self.key_group_range = key_group_range
        self.max_parallelism = max_parallelism
        self.device = torch.device(device)
        cap = 1
        while cap < capacity:
            cap <<= 1
        self.capacity = cap
        self.table = make_table(cap, self.device)
        self._array_states: dict[str, _ArrayState] = {}
        self._num_keys = 0
        # deferred mode: the hot path never syncs with the host; failed
        # inserts accumulate in a device counter read at fire boundaries
        self._defer = bool(defer_overflow)
        self._dropped = torch.zeros((), dtype=torch.int64, device=self.device)
        #: seconds of the last snapshot's phases: the copy to the host, and
        #: the hash, sort and gather there
        self.last_snapshot_s: dict[str, float] = {}

    # -- array states ---------------------------------------------------
    def register_array_state(self, name: str, kind: str, dtype,
                             ring: Optional[int] = None,
                             role: str = "pane") -> None:
        if name not in self._array_states:
            self._array_states[name] = _ArrayState(
                name, kind, torch_dtype(dtype), ring, self.capacity,
                self.device, role)

    def has_array(self, name: str) -> bool:
        return name in self._array_states

    def get_array(self, name: str) -> torch.Tensor:
        return self._array_states[name].array

    def _pane_states(self) -> list[_ArrayState]:
        """The states that snapshot, retire and conform: every one but the
        derived window-role planes."""
        return [st for st in self._array_states.values()
                if st.role != "window"]

    @property
    def state_nbytes(self) -> int:
        """Device bytes of the table and every plane."""
        return self.table.nbytes + sum(st.array.nbytes
                                       for st in self._array_states.values())

    @property
    def dropped_device(self) -> torch.Tensor:
        return self._dropped

    # -- hot path --------------------------------------------------------
    def slots_for_batch(self, keys: torch.Tensor) -> torch.Tensor:
        """Lookup-or-insert a batch of device int64 keys; returns int32
        slots. Deferred mode: no host sync, failed inserts get slot -1 and
        count into ``dropped_device``. Otherwise the table grows inline
        (one host sync per batch), so every slot is valid on return."""
        keys = sanitize_keys_device(keys)
        if self._defer:
            return self.insert_deferred(keys)
        while True:
            _, slots, ok = lookup_or_insert(self.table, keys)
            all_ok = bool(ok.all())
            self._num_keys = int((self.table != EMPTY_KEY).sum())
            if all_ok:
                if self._num_keys > _GROW_AT * self.capacity:
                    self._rehash(self.capacity * 2)
                    slots = lookup(self.table, keys)
                return slots
            self._rehash(self.capacity * 2)

    def insert_deferred(self, keys: torch.Tensor) -> torch.Tensor:
        """Sync-free insert of sanitized keys: rows out of probes get slot
        -1 and count into ``dropped_device``."""
        _, slots, ok = lookup_or_insert(self.table, keys)
        self._dropped += (~ok).sum()
        return slots

    def ingest_deferred(self, ts: torch.Tensor, keys: torch.Tensor,
                        folds: list[tuple[str, Optional[torch.Tensor]]],
                        pane: int, offset: int, first_open: int,
                        late: torch.Tensor) -> None:
        """A device batch's whole ingest step, sync-free
        (``ops.hash_table.ingest_step``): rows in panes below
        ``first_open`` count into ``late``, the others find-or-claim their
        key and fold into each named ring plane, ``(name, values)`` with
        values None for +1; failed inserts count into ``dropped_device``."""
        ingest_step(self.table, self.fold_planes(folds), ts, keys, pane,
                    offset, first_open, late, self._dropped)

    def fold_planes(self, folds: list[tuple[str, object]]) -> list[tuple]:
        """(name, values) -> (kind, plane array, values) for the step."""
        return [(self._array_states[name].kind,
                 self._array_states[name].array, values)
                for name, values in folds]

    def fold_batch(self, name: str, slots: torch.Tensor,
                   values: torch.Tensor, valid: torch.Tensor,
                   ring_idx: Optional[torch.Tensor] = None) -> None:
        """acc[(ring_idx,) slot] op= values, one in-place scatter."""
        st = self._array_states[name]
        slots = slots.to(torch.int64).clamp(min=0)
        flat = ring_idx.to(torch.int64) * st.array.shape[-1] + slots \
            if st.ring else slots
        scatter_fold(st.kind, st.array.view(-1), flat, values, valid)

    def reset_ring_row(self, row: int) -> None:
        """Pane retirement: ring row ``row`` of every ring pane plane back
        to its aggregate identity."""
        for st in self._pane_states():
            if st.ring:
                st.array[row].fill_(identity(st.kind, st.dtype))

    # -- health (fire boundaries) -----------------------------------------
    def apply_health(self, dropped: int, occupancy: int) -> None:
        """Consume host copies of the health scalars that ride with a
        fire: fail loudly on any dropped insert, grow before the load
        factor bites."""
        if int(dropped) > 0:
            raise RuntimeError(
                f"device hash table overflow: {int(dropped)} records "
                f"dropped (capacity {self.capacity}); raise the operator's "
                "capacity or disable deferred overflow checking")
        self._num_keys = int(occupancy)
        if self._num_keys > _GROW_AT * self.capacity:
            self._rehash(self.capacity * 2)

    # -- growth ------------------------------------------------------------
    def _rehash(self, new_capacity: int) -> None:
        """Grow the table and re-key every plane on the device."""
        occupied = self.table != EMPTY_KEY
        old_slots = torch.nonzero(occupied).flatten()
        self._rebuild(self.table[old_slots], old_slots, new_capacity)

    def _rebuild(self, keys: torch.Tensor, old_slots: torch.Tensor,
                 new_capacity: int) -> None:
        """Re-key every plane, window-role planes included, onto a fresh
        table of ``new_capacity``."""
        new_table = make_table(new_capacity, self.device)
        if keys.numel():
            _, new_slots, ok = lookup_or_insert(new_table, keys.contiguous())
            if not bool(ok.all()):
                raise RuntimeError(
                    "rebuild failed: pathological key distribution")
            new_slots = new_slots.to(torch.int64)
        for st in self._array_states.values():
            shape = (st.ring, new_capacity) if st.ring else (new_capacity,)
            new_arr = make_accumulator(st.kind, shape, st.dtype, self.device)
            if keys.numel():
                new_arr[..., new_slots] = st.array[..., old_slots]
            st.array = new_arr
        self.table = new_table
        self.capacity = new_capacity
        self._num_keys = int(keys.numel())

    def conform_ring(self, ring: int, live_panes: Iterable[int]) -> None:
        """Re-seat ring planes restored under another ring size: each live
        pane's row moves from p % old_ring to p % ring."""
        live = list(live_panes)
        for st in self._pane_states():
            if not st.ring or st.ring == ring:
                continue
            if len(live) > ring:
                raise RuntimeError(
                    f"cannot conform ring {st.ring} -> {ring}: "
                    f"{len(live)} panes are live; increase ring_size")
            new = make_accumulator(st.kind, (ring, self.capacity), st.dtype,
                                   self.device)
            for p in live:
                new[p % ring] = st.array[p % st.ring]
            st.array = new
            st.ring = ring

    # -- checkpointing -----------------------------------------------------
    def snapshot(self, checkpoint_id: int) -> dict:
        """Host numpy snapshot in the reference's schema, canonical
        (group, key) order: the table and every pane plane copied whole to
        the host, then the occupied keys hashed, sorted and gathered there.
        ``last_snapshot_s`` keeps the seconds of the two phases."""
        t0 = time.perf_counter()
        table = self.table.cpu().numpy()
        planes = {st.name: st.array.cpu().numpy()
                  for st in self._pane_states()}
        t1 = time.perf_counter()
        occupied = table != EMPTY_KEY
        keys = table[occupied]
        slots = np.flatnonzero(occupied)
        groups = key_groups_for_hash_batch(hash_batch(keys),
                                           self.max_parallelism)
        order = np.lexsort((keys, groups))
        states = {}
        for st in self._pane_states():
            arr = planes.pop(st.name)
            vals = arr[:, slots] if st.ring else arr[slots]
            states[st.name] = {"kind": st.kind,
                               "dtype": str(numpy_dtype(st.dtype)),
                               "ring": st.ring,
                               "values": np.ascontiguousarray(
                                   vals[..., order])}
        self.last_snapshot_s = {"copy": t1 - t0,
                                "sort_gather": time.perf_counter() - t1}
        return {"kind": "tpu", "keys": np.ascontiguousarray(keys[order]),
                "key_groups": np.ascontiguousarray(groups[order]),
                "max_parallelism": self.max_parallelism, "states": states}

    def restore(self, snapshots: Iterable[dict]) -> None:
        """Rebuild from snapshots of either package, keeping the keys of
        this backend's key-group range."""
        all_keys, per_state, meta = [], {}, {}
        for snap in snapshots:
            groups = np.asarray(snap["key_groups"])
            sel = (groups >= self.key_group_range.start) & \
                (groups <= self.key_group_range.end)
            all_keys.append(np.asarray(snap["keys"])[sel])
            for name, sdata in snap["states"].items():
                meta[name] = sdata
                vals = np.asarray(sdata["values"])
                per_state.setdefault(name, []).append(
                    vals[:, sel] if sdata["ring"] else vals[sel])
        keys = (np.concatenate(all_keys) if all_keys
                else np.empty(0, np.int64)).astype(np.int64)
        while self.capacity < 2 * max(len(keys), 1):
            self.capacity *= 2
        self.table = make_table(self.capacity, self.device)
        self._num_keys = len(keys)
        slots = None
        if len(keys):
            dkeys = torch.from_numpy(keys).to(self.device)
            _, slots, ok = lookup_or_insert(self.table, dkeys)
            if not bool(ok.all()):
                raise RuntimeError("restore failed: table overflow")
            slots = slots.to(torch.int64)
        self._array_states.clear()
        for name, sdata in meta.items():
            st = _ArrayState(name, sdata["kind"], torch_dtype(sdata["dtype"]),
                             sdata["ring"], self.capacity, self.device)
            if slots is not None:
                vals = np.concatenate(per_state[name], axis=-1)
                st.array[..., slots] = torch.from_numpy(
                    np.ascontiguousarray(vals)).to(self.device)
            self._array_states[name] = st
