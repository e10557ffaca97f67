"""DeviceKeyedStateBackend: device-resident keyed state (port of
``flink_tpu/state/tpu_backend.py``).

Keyed state for one subtask's key-group range lives on the device as a
hash table (``ops/hash_table.py``: int64 key -> dense slot) next to named
accumulator planes, ``[capacity]`` or ``[ring, capacity]``, updated by
whole-batch scatter folds (a device batch's step is one fused kernel,
``ingest_deferred``). Planes are updated in place.

Growth: when occupancy passes 0.6 * capacity (or an insert exhausts its
probes) the table doubles and every plane is re-keyed on the device.

Window-role planes (``role="window"``) hold the incremental fire
engine's derived state; snapshots, the host tier, pane retirement and
ring conforming leave them out.

Snapshots are the reference's schema, ``{"kind": "tpu", keys,
key_groups, max_parallelism, states}``, as numpy in canonical (group,
key) order, so a snapshot of either package restores into the other, and
a snapshot does not depend on where a key lives (device or host tier).

* Incremental capture: a ``[n_blocks]`` uint8 dirty bitmap over blocks of
  512 slots, set by the ingest kernel, the session step and fire kernels
  (through ``dirty_buffer`` and ``dirty_shift``) and the host-batch fold,
  and a host mirror of the table and every pane plane in pinned memory
  (allocated once per shape). A snapshot gathers only the dirty blocks on the device
  and brings them home in one copy (or copies everything when more than
  half are dirty); ring-row retirements are replayed on the host. A
  rehash, an eviction, a restore or a ring conform invalidates the mirror
  and the next snapshot captures it whole.
* The canonical order is computed on the device: the key groups of the
  occupied keys (``key_groups_device``), then two stable sorts (key, then
  group). One composed permutation comes home and each plane is gathered
  from the mirror once with it, by a pool of threads. ``snapshot_plain`` is the whole-copy form
  (everything to the host, numpy hash, ``lexsort`` and gathers), kept as
  the plain version of the capture.
* HBM budget (``hbm_budget_slots``): the capacity is capped at the largest
  power of two under it. When the table would pass 0.6 of the cap, the
  coldest resident key groups (least recently touched, by a per-group
  batch clock) move to the host tier (``state/spill.py``) and the table is
  rebuilt without them. In deferred mode the split of each batch between
  the tiers runs inside the ingest kernel (``StepSpill``): rows of spilled
  groups and failed inserts are staged on the device and folded into the
  host tier at the next watermark (``drain_staged``).
* Row plane (the reference's typed row states, ``tpu_backend.py:1119-
  1258``): per-key values of any numeric dtype as three array states of
  kind ``sum``, ``name`` (values), ``name.__set__`` (int8 presence) and,
  under a TTL, ``name.__ts__`` (int64 clock of the last write), so they
  snapshot, mirror and restore with the rest. ``rows_upsert``,
  ``rows_lookup``, ``rows_clear`` and keep-first ``dedup_first_batch``
  run the kernels of ``ops/row_state.py`` (one batch a call, a
  ``[capacity]`` int32 scratch kept across calls); ``get_partitioned_state``
  hands out ``ValueState`` handles over them. The row plane refuses an
  HBM budget, as the reference's does.
"""

from __future__ import annotations

import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Optional

import numpy as np
import torch

from ..core.keygroups import KeyGroupRange, hash_batch, \
    key_groups_device, key_groups_for_hash_batch
from ..device import numpy_dtype, torch_dtype
from ..ops.hash_table import EMPTY_KEY, StepSpill, ingest_step, lookup, \
    lookup_or_insert, make_table, sanitize_keys_device
from ..ops.row_state import dedup_first, new_row_scratch, row_get, row_set, \
    row_unset
from ..ops.segment_ops import identity, make_accumulator, scatter_fold
from .backend import State, ValueState
from .descriptors import StateDescriptor
from .spill import HostTier

__all__ = ["DeviceKeyedStateBackend"]

_GROW_AT = 0.6   # occupancy share that triggers a doubling rehash
_BLOCK = 512     # slots per dirty block
_INT64_MAX = int(np.iinfo(np.int64).max)


def _gather(src: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``src[..., perm]`` for a CPU tensor. One ``index_select`` of a row
    runs on one thread, so the rows, cut into pieces of the permutation,
    are gathered by a pool of threads."""
    rows = src.reshape(-1, src.shape[-1])
    n = perm.numel()
    out = torch.empty((rows.shape[0], n), dtype=src.dtype)
    threads = torch.get_num_threads()
    cuts = np.linspace(0, n, min(2 * threads, n // (1 << 16) + 1) + 1)
    cuts = cuts.astype(np.int64)
    jobs = [(r, int(lo), int(hi)) for r in range(rows.shape[0])
            for lo, hi in zip(cuts[:-1], cuts[1:]) if lo < hi]

    def run(job) -> None:
        r, lo, hi = job
        torch.index_select(rows[r], 0, perm[lo:hi], out=out[r, lo:hi])

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(run, jobs))
    return out.view(*src.shape[:-1], n)


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
        # spill, retire and conform. role "window": DERIVED incremental-fire
        # state (running window accumulators, merge trees); it follows slot
        # remaps on a rehash but is left out of snapshots, the host tier,
        # ring-row retirement and conform_ring: a restore rebuilds it
        self.role = role
        shape = (ring, capacity) if ring else (capacity,)
        self.array = make_accumulator(kind, shape, dtype, device)


class DeviceKeyedStateBackend:
    def __init__(self, key_group_range: KeyGroupRange, max_parallelism: int,
                 capacity: int = 1 << 16, device="cuda",
                 defer_overflow: bool = False, hbm_budget_slots: int = 0):
        self.key_group_range = key_group_range
        self.max_parallelism = max_parallelism
        self.device = torch.device(device)
        cap = 1
        while cap < capacity:
            cap <<= 1
        budget = 0
        if hbm_budget_slots:
            budget = 1
            while budget * 2 <= hbm_budget_slots:
                budget <<= 1
            cap = min(cap, budget)
        self._budget = budget
        self.capacity = cap
        self.table = make_table(cap, self.device)
        self._array_states: dict[str, _ArrayState] = {}
        self._num_keys = 0
        # deferred mode: the hot path never syncs with the host; failed
        # inserts (or stage overflow, under a budget) accumulate in a
        # device counter read at fire boundaries
        self._defer = bool(defer_overflow)
        self._dropped = torch.zeros((), dtype=torch.int64, device=self.device)
        # -- spill tier (HBM budget) --------------------------------------
        self._host: Optional[HostTier] = None
        self._batch_no = 0
        # per-group batch clock of the last touch (eviction is coldest
        # first); the deferred step keeps a device twin (_touch_dev)
        self._last_touch = np.zeros(max_parallelism, np.int64)
        self._spilled_dev: Optional[torch.Tensor] = None
        self._touch_dev: Optional[torch.Tensor] = None
        # host positions and host slots of the last sync-path batch's
        # spilled rows, folded by fold_batch
        self._pending_host: Optional[tuple[np.ndarray, np.ndarray]] = None
        #: evictions: calls, key groups and keys moved to the host
        self.evictions = {"calls": 0, "groups": 0, "keys": 0}
        #: seconds of the spill tier's work: host folds of staged rows,
        #: and evictions (gather, host absorb, table rebuild)
        self.spill_s = {"host_fold": 0.0, "evict": 0.0}
        # -- incremental capture --------------------------------------------
        self._mirror_bufs: dict[str, torch.Tensor] = {}
        self._mirror_valid = False
        self._staging: Optional[torch.Tensor] = None
        self._retired_rows: set[int] = set()
        self._reset_dirty()
        #: device->host bytes of the last snapshot's capture
        self.last_snapshot_dma_bytes = 0
        #: seconds of the last snapshot's phases: capture (the mirror
        #: update), order (on the device), gather (from the mirror) and
        #: host_tier (the spilled keys merged in)
        self.last_snapshot_s: dict[str, float] = {}
        #: one record per snapshot: id, phases, DMA bytes, dirty share
        self.snapshot_log: deque = deque(maxlen=64)
        # -- row plane ------------------------------------------------------
        self._row_meta: dict[str, tuple[int, np.dtype]] = {}  # name -> ttl
        self._row_states: dict[str, State] = {}
        self._row_scratch_buf: Optional[torch.Tensor] = None
        self._current_key = None
        #: keep-first batches run again after a row found no slot
        self.row_overflows = 0

    # -- array states ---------------------------------------------------
    def register_array_state(self, name: str, kind: str, dtype,
                             ring: Optional[int] = None,
                             role: str = "pane") -> None:
        if name not in self._array_states:
            self._array_states[name] = _ArrayState(
                name, kind, torch_dtype(dtype), ring, self.capacity,
                self.device, role)
            if self._host is not None and role != "window":
                self._host.register(name, kind, numpy_dtype(dtype), ring)

    def has_array(self, name: str) -> bool:
        return name in self._array_states

    def get_array(self, name: str) -> torch.Tensor:
        return self._array_states[name].array

    def _pane_states(self) -> list[_ArrayState]:
        """The states that snapshot, spill, retire and conform: every one
        but the derived window-role planes."""
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

    @property
    def num_keys(self) -> int:
        return self._num_keys

    # -- hot path --------------------------------------------------------
    def slots_for_batch(self, keys: torch.Tensor) -> torch.Tensor:
        """Lookup-or-insert a batch of device int64 keys; returns int32
        slots. Deferred mode: no host sync, failed inserts get slot -1 and
        count into ``dropped_device``. Otherwise the table grows inline
        (one host sync per batch), so every slot is valid on return, but
        for the rows of spilled key groups under a budget: those get -1
        and ``fold_batch`` folds them into the host tier."""
        keys = sanitize_keys_device(keys)
        if self._defer:
            return self.insert_deferred(keys)
        self._pending_host = None
        groups = keys_np = None
        if self._budget:
            self._batch_no += 1
            keys_np = keys.cpu().numpy()
            groups = key_groups_for_hash_batch(hash_batch(keys_np),
                                               self.max_parallelism)
            self._last_touch[groups] = self._batch_no
        while True:
            sp = None
            if self.spill_active and groups is not None:
                sp = self._host.spilled_mask[groups]
                if not sp.any():
                    sp = None
            valid = (None if sp is None
                     else torch.from_numpy(~sp).to(self.device))
            _, slots, ok = lookup_or_insert(self.table, keys, valid)
            all_ok = bool((ok if valid is None else ok | ~valid).all())
            self._num_keys = int((self.table != EMPTY_KEY).sum())
            if all_ok:
                if self._num_keys <= _GROW_AT * self.capacity:
                    break
                if self._may_grow():
                    self._rehash(self.capacity * 2)
                    slots = lookup(self.table, keys)
                    break
                self._evict_cold_groups(batch_groups=groups)
                continue   # the spilled set changed: split the batch again
            if self._may_grow():
                self._rehash(self.capacity * 2)
            else:
                self._evict_cold_groups(batch_groups=groups)
        if sp is not None:
            host_pos = np.flatnonzero(sp)
            self._pending_host = (host_pos,
                                  self._host.slots_for(keys_np[host_pos]))
        self.mark_dirty(slots)
        return slots

    def _may_grow(self) -> bool:
        return not self._budget or 2 * self.capacity <= self._budget

    def insert_deferred(self, keys: torch.Tensor) -> torch.Tensor:
        """Sync-free insert of sanitized keys: rows out of probes get slot
        -1 and count into ``dropped_device``."""
        _, slots, ok = lookup_or_insert(self.table, keys)
        self._dropped += (~ok).sum()
        self.mark_dirty(slots)
        return slots

    def ingest_deferred(self, ts: torch.Tensor, keys: torch.Tensor,
                        folds: list[tuple[str, Optional[torch.Tensor]]],
                        pane: int, offset: int, first_open: int,
                        late: torch.Tensor,
                        stage: Optional[dict] = None) -> None:
        """A device batch's whole ingest step, sync-free
        (``ops.hash_table.ingest_step``): rows in panes below
        ``first_open`` count into ``late``, the others find-or-claim their
        key and fold into each named ring plane, ``(name, values)`` with
        values None for +1, marking their dirty blocks; failed inserts
        count into ``dropped_device``. ``stage`` (the operator's staging
        buffers, under a budget): the spill split, with this batch's
        clock tick."""
        planes = self.fold_planes(folds)
        spill = None
        if stage is not None:
            spill = StepSpill(
                self.spilled_mask_device, self.touch_device,
                self.note_batch(), stage["count"], stage["keys"],
                stage["ring"], [stage.get(name) for name, _v in folds])
        ingest_step(self.table, planes, ts, keys, pane, offset, first_open,
                    late, self._dropped, self._dirty_buf, self.dirty_shift,
                    spill)

    def fold_planes(self, folds: list[tuple[str, object]]) -> list[tuple]:
        """(name, values) -> (kind, plane array, values) for the step."""
        return [(self._array_states[name].kind,
                 self._array_states[name].array, values)
                for name, values in folds]

    def fold_batch(self, name: str, slots: torch.Tensor,
                   values: torch.Tensor, valid: torch.Tensor,
                   ring_idx: Optional[torch.Tensor] = None) -> None:
        """acc[(ring_idx,) slot] op= values, one in-place scatter; under a
        budget the batch's spilled rows fold into the host tier."""
        st = self._array_states[name]
        dslots = slots.to(torch.int64).clamp(min=0)
        flat = ring_idx.to(torch.int64) * st.array.shape[-1] + dslots \
            if st.ring else dslots
        scatter_fold(st.kind, st.array.view(-1), flat, values, valid)
        if self._pending_host is not None:
            pos, hslots = self._pending_host
            ring_np = (ring_idx.cpu().numpy()[pos]
                       if st.ring and ring_idx is not None else None)
            self._host.fold(name, hslots, values.cpu().numpy()[pos], ring_np)

    def reset_ring_row(self, row: int) -> None:
        """Pane retirement: ring row ``row`` of every ring pane plane back
        to its aggregate identity. The host knows the row, so the mirror
        replays it without marking anything dirty."""
        for st in self._pane_states():
            if st.ring:
                st.array[row].fill_(identity(st.kind, st.dtype))
        self._retired_rows.add(int(row))
        if self._host is not None:
            self._host.reset_ring_row(row)

    # -- health (fire boundaries) -----------------------------------------
    def apply_health(self, dropped: int, occupancy: int) -> None:
        """Consume host copies of the health scalars that ride with a
        fire: fail loudly on any dropped record, grow before the load
        factor bites, or, under a budget, page cold key groups out."""
        if int(dropped) > 0:
            if self._budget:
                raise RuntimeError(
                    f"spill staging overflow: {int(dropped)} records could "
                    "not be staged for the host tier in one watermark "
                    "interval; raise spill_staging_slots or the HBM budget")
            raise RuntimeError(
                f"device hash table overflow: {int(dropped)} records "
                f"dropped (capacity {self.capacity}); raise the operator's "
                "capacity or disable deferred overflow checking")
        self._num_keys = int(occupancy)
        if self._num_keys > _GROW_AT * self.capacity:
            if self._may_grow():
                self._rehash(self.capacity * 2)
            else:
                self._sync_touch_from_device()
                self._evict_cold_groups()

    # -- growth ------------------------------------------------------------
    def _rehash(self, new_capacity: int) -> None:
        """Grow the table and re-key every plane on the device."""
        occupied = self.table != EMPTY_KEY
        old_slots = torch.nonzero(occupied).flatten()
        self._rebuild(self.table[old_slots], old_slots, new_capacity)

    def _rebuild(self, keys: torch.Tensor, old_slots: torch.Tensor,
                 new_capacity: int) -> None:
        """Re-key every plane, window-role planes included, onto a fresh
        table of ``new_capacity`` holding ``keys`` only."""
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
        self._invalidate_mirror()

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
            self._invalidate_mirror()

    # -- spill tier (HBM budget) -------------------------------------------
    @property
    def hbm_budget(self) -> int:
        return self._budget

    @property
    def spill_active(self) -> bool:
        return self._host is not None and self._host.active

    @property
    def host_tier(self) -> Optional[HostTier]:
        return self._host

    @property
    def spilled_mask_device(self) -> torch.Tensor:
        """[max_parallelism] bool on the device: the groups on the host,
        read by the ingest kernel's spill split."""
        if self._spilled_dev is None:
            self._spilled_dev = torch.zeros(self.max_parallelism,
                                            dtype=torch.bool,
                                            device=self.device)
        return self._spilled_dev

    @property
    def touch_device(self) -> torch.Tensor:
        """[max_parallelism] int64 on the device: each group's last batch
        clock, maxed by the ingest kernel."""
        if self._touch_dev is None:
            self._touch_dev = torch.zeros(self.max_parallelism,
                                          dtype=torch.int64,
                                          device=self.device)
        return self._touch_dev

    def note_batch(self) -> int:
        """Tick the monotone batch clock of the eviction order."""
        self._batch_no += 1
        return self._batch_no

    def _sync_spilled_dev(self) -> None:
        if self._host is not None:
            self.spilled_mask_device.copy_(
                torch.from_numpy(self._host.spilled_mask))

    def _sync_touch_from_device(self) -> None:
        """Adopt the device clock of the deferred step (at evictions)."""
        if self._touch_dev is not None:
            np.maximum(self._last_touch, self._touch_dev.cpu().numpy(),
                       out=self._last_touch)

    def _ensure_host_tier(self) -> HostTier:
        if self._host is None:
            self._host = HostTier(self.max_parallelism)
        for st in self._pane_states():
            self._host.register(st.name, st.kind, numpy_dtype(st.dtype),
                                st.ring)
        return self._host

    def _device_resident(self) -> tuple[torch.Tensor, torch.Tensor,
                                        np.ndarray]:
        """(keys, slots) on the device and the key groups (numpy) of every
        device-resident entry."""
        slots = torch.nonzero(self.table != EMPTY_KEY).flatten()
        keys = self.table[slots]
        groups = key_groups_device(keys, self.max_parallelism)
        return keys, slots, groups.cpu().numpy()

    def _evict_cold_groups(self, rebuild_capacity: Optional[int] = None,
                           batch_groups: Optional[np.ndarray] = None
                           ) -> None:
        """Page the coldest resident key groups to the host tier, least
        recently touched first (group id breaks ties), until the resident
        keys fall to 0.4 of the capacity (a quarter of them at least).
        When the resident set alone cannot make room, half of the
        incoming batch's groups are spilled too, so every call spills at
        least one group."""
        t0 = time.perf_counter()
        self._ensure_host_tier()
        cap = rebuild_capacity or self.capacity
        keys, slots, groups = self._device_resident()
        counts = np.bincount(groups, minlength=self.max_parallelism)
        resident = np.flatnonzero(counts > 0)
        order = resident[np.lexsort((resident, self._last_touch[resident]))]
        target = int(0.4 * cap)
        need = max(len(groups) - target, max(1, len(groups) // 4))
        evict, acc = [], 0
        for g in order:
            evict.append(int(g))
            acc += int(counts[g])
            if acc >= need:
                break
        if acc < need and batch_groups is not None:
            fresh = np.unique(batch_groups)
            fresh = [int(g) for g in fresh[~self._host.spilled_mask[fresh]]
                     if g not in set(evict)]
            evict.extend(fresh[:max(1, len(fresh) // 2)])
        if not evict:
            raise RuntimeError("spill eviction made no progress; raise the "
                               "HBM budget")
        gmask = np.zeros(self.max_parallelism, bool)
        gmask[evict] = True
        sel = gmask[groups]
        self._absorb_and_rebuild(keys, slots, sel, evict, cap)
        self.evictions["calls"] += 1
        self.evictions["groups"] += len(evict)
        self.evictions["keys"] += int(sel.sum())
        self.spill_s["evict"] += time.perf_counter() - t0

    def _absorb_and_rebuild(self, keys: torch.Tensor, slots: torch.Tensor,
                            sel: np.ndarray, groups, cap: int) -> None:
        """Move the selected device entries (their rows gathered on the
        device, one copy home) into the host tier, mark their groups
        spilled, and rebuild the table without them."""
        host = self._ensure_host_tier()
        dsel = torch.from_numpy(sel).to(self.device)
        if sel.any():
            out = slots[dsel]
            host.absorb(keys[dsel].cpu().numpy(),
                        {st.name: st.array.index_select(-1, out).cpu().numpy()
                         for st in self._pane_states()})
        host.spilled_mask[np.asarray(groups, np.int64)] = True
        if sel.any() or cap != self.capacity:
            keep = ~dsel
            self._rebuild(keys[keep], slots[keep], cap)
        self._sync_spilled_dev()

    def _force_spill_groups(self, groups: np.ndarray) -> None:
        """Page the given key groups to the host tier now (the staged
        rows of a group seen for the first time there), so no key is ever
        split across the tiers."""
        t0 = time.perf_counter()
        keys, slots, g = self._device_resident()
        gmask = np.zeros(self.max_parallelism, bool)
        gmask[np.asarray(groups, np.int64)] = True
        sel = gmask[g]
        self._absorb_and_rebuild(keys, slots, sel, groups, self.capacity)
        self.evictions["calls"] += 1
        self.evictions["groups"] += len(groups)
        self.evictions["keys"] += int(sel.sum())
        self.spill_s["evict"] += time.perf_counter() - t0

    def drain_staged(self, keys: np.ndarray, ring_idx: np.ndarray,
                     values: dict[str, np.ndarray]) -> None:
        """Fold rows the step staged for the host (spilled-group rows and
        failed inserts) into the host tier. Groups staged for the first
        time are force-spilled first, so their device rows merge before
        the fold and their later rows stage on the device."""
        if len(keys) == 0:
            return
        host = self._ensure_host_tier()
        groups = key_groups_for_hash_batch(hash_batch(keys),
                                           self.max_parallelism)
        fresh = np.unique(groups[~host.spilled_mask[groups]])
        if len(fresh):
            self._force_spill_groups(fresh)
        t0 = time.perf_counter()
        hslots = host.slots_for(keys)
        for name, vals in values.items():
            st = self._array_states[name]
            host.fold(name, hslots, vals, ring_idx if st.ring else None)
        self.spill_s["host_fold"] += time.perf_counter() - t0

    # -- incremental capture -----------------------------------------------
    @property
    def dirty_shift(self) -> int:
        return self._block.bit_length() - 1

    @property
    def dirty_buffer(self) -> torch.Tensor:
        """The bitmap a kernel marks: one byte per block, and one more."""
        return self._dirty_buf

    @property
    def dirty_mask(self) -> torch.Tensor:
        """[n_blocks] uint8: 1 where a block was written since the last
        capture."""
        return self._dirty_buf[:self._n_blocks]

    def _reset_dirty(self) -> None:
        self._block = min(_BLOCK, self.capacity)
        self._n_blocks = self.capacity // self._block
        # one byte more than the blocks: mark_dirty's sink for invalid slots
        self._dirty_buf = torch.zeros(self._n_blocks + 1, dtype=torch.uint8,
                                      device=self.device)

    def mark_dirty(self, slots: torch.Tensor) -> None:
        """Mark the blocks of ``slots`` (slot -1 marks nothing), sync-free."""
        s = slots.to(torch.int64)
        self._dirty_buf[torch.where(s >= 0, s >> self.dirty_shift,
                                    self._n_blocks)] = 1

    def _invalidate_mirror(self) -> None:
        """Structural change (rehash, eviction, restore, ring conform): the
        next snapshot captures everything. The pinned buffers stay while
        their shapes do."""
        self._mirror_valid = False
        self._reset_dirty()
        self._retired_rows.clear()

    def _mirror_buf(self, name: str, like: torch.Tensor) -> torch.Tensor:
        buf = self._mirror_bufs.get(name)
        if buf is None or buf.shape != like.shape or buf.dtype != like.dtype:
            self._mirror_bufs.pop(name, None)
            buf = torch.empty(like.shape, dtype=like.dtype,
                              pin_memory=self.device.type == "cuda")
            self._mirror_bufs[name] = buf
        return buf

    def _mirror_sources(self) -> dict[str, torch.Tensor]:
        return {"__table__": self.table,
                **{st.name: st.array for st in self._pane_states()}}

    def _copy_whole(self, sources: dict) -> int:
        for name, arr in sources.items():
            self._mirror_buf(name, arr).copy_(arr, non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return sum(a.nbytes for a in sources.values())

    def _sync_mirror(self) -> float:
        """Bring the host mirror up to date with the device: the blocks
        written since the last capture (plus planes new since then), or
        everything after a structural change. Returns the dirty share."""
        sources = self._mirror_sources()
        for name in list(self._mirror_bufs):
            if name not in sources:
                del self._mirror_bufs[name]
        nb = self._n_blocks
        if not self._mirror_valid:
            self.last_snapshot_dma_bytes = self._copy_whole(sources)
            share = 1.0
        else:
            dma = 0
            fresh = {n: a for n, a in sources.items()
                     if n not in self._mirror_bufs}
            if fresh:
                dma += self._copy_whole(fresh)
            for row in self._retired_rows:
                for st in self._pane_states():
                    if st.ring and st.name not in fresh:
                        self._mirror_bufs[st.name][row].fill_(
                            identity(st.kind, st.dtype))
            old = {n: a for n, a in sources.items() if n not in fresh}
            blocks = torch.nonzero(self.dirty_mask).flatten()
            k = int(blocks.numel())
            dma += nb
            share = k / nb
            if 2 * k > nb:
                dma += self._copy_whole(old)
            elif k:
                dma += self._copy_blocks(old, blocks, k)
            self.last_snapshot_dma_bytes = dma
        self._dirty_buf.zero_()
        self._retired_rows.clear()
        self._mirror_valid = True
        return share

    def _copy_blocks(self, sources: dict, blocks: torch.Tensor,
                     k: int) -> int:
        """Gather the dirty blocks of every source into one device buffer,
        bring it home in one copy, and scatter it into the mirror."""
        nb, bs = self._n_blocks, self._block
        layout, total = [], 0
        for name, arr in sources.items():
            lead = arr.shape[:-1]
            shape = (*lead, k, bs)
            nbytes = int(np.prod(shape)) * arr.element_size()
            layout.append((name, arr, shape, total, nbytes))
            total += (nbytes + 7) // 8 * 8
        flat = torch.empty(total, dtype=torch.uint8, device=self.device)
        for name, arr, shape, off, nbytes in layout:
            out = flat[off:off + nbytes].view(arr.dtype).view(shape)
            torch.index_select(arr.view(*arr.shape[:-1], nb, bs),
                               len(shape) - 2, blocks, out=out)
        if self._staging is None or self._staging.numel() < total:
            self._staging = torch.empty(
                total, dtype=torch.uint8,
                pin_memory=self.device.type == "cuda")
        staged = self._staging[:total]
        staged.copy_(flat, non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        bcpu = blocks.cpu()
        for name, arr, shape, off, nbytes in layout:
            part = staged[off:off + nbytes].view(arr.dtype).view(shape)
            mirror = self._mirror_bufs[name]
            mirror.view(*arr.shape[:-1], nb, bs).index_copy_(
                len(shape) - 2, bcpu, part)
        return total

    # -- row plane ---------------------------------------------------------
    def register_row_state(self, name: str, dtype,
                           ttl_ms: Optional[int] = None) -> None:
        """Value plane [capacity] of ``dtype``, presence int8 and, with a
        TTL, the int64 clock of each key's last write: an entry expires
        ``ttl_ms`` after it, checked when read (the reference's relaxed
        StateTtlConfig)."""
        if self._budget:
            raise NotImplementedError(
                "the typed row plane does not page to the host tier; "
                "configure this backend without hbm_budget_slots (the "
                "budget applies to the array/window plane)")
        if name in self._row_meta:
            return
        self._row_meta[name] = (int(ttl_ms or 0), np.dtype(dtype))
        self._ensure_row_planes(name)

    def _ensure_row_planes(self, name: str) -> None:
        """(Re-)register a row state's planes: a restore rebuilds the array
        states from the snapshot alone, so a plane it lacked (the TTL clock
        of a job that had none) comes back here. A fresh clock next to
        restored presence holds int64 max: those entries never expire,
        rather than all at once."""
        ttl, dtype = self._row_meta[name]
        restored_presence = f"{name}.__set__" in self._array_states
        self.register_array_state(name, "sum", dtype)
        self.register_array_state(f"{name}.__set__", "sum", np.int8)
        if ttl and f"{name}.__ts__" not in self._array_states:
            self.register_array_state(f"{name}.__ts__", "sum", np.int64)
            if restored_presence:
                self.get_array(f"{name}.__ts__").fill_(_INT64_MAX)

    def _row_planes(self, name: str):
        ttl, _dtype = self._row_meta[name]
        self._ensure_row_planes(name)
        last = self.get_array(f"{name}.__ts__") if ttl else None
        return (self.get_array(name), self.get_array(f"{name}.__set__"),
                last, ttl)

    def _row_scratch(self) -> torch.Tensor:
        """The row programs' [capacity] int32 scratch, ``ROW_NONE``
        between calls; a fresh one after the capacity changes."""
        buf = self._row_scratch_buf
        if buf is None or buf.numel() != self.capacity:
            buf = self._row_scratch_buf = new_row_scratch(self.capacity,
                                                          self.device)
        return buf

    def _device_keys(self, keys) -> torch.Tensor:
        if isinstance(keys, torch.Tensor):
            return keys.to(self.device, torch.int64).contiguous()
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(keys, np.int64))).to(self.device)

    def _device_rows(self, values, dtype) -> torch.Tensor:
        if isinstance(values, torch.Tensor):
            return values.to(self.device, dtype).contiguous()
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(values).astype(numpy_dtype(dtype)))).to(self.device)

    def rows_upsert(self, name: str, keys, values, now_ms) -> None:
        """Set values for a batch of keys (numpy or tensors): the last
        occurrence of a key wins. One slot resolution (``slots_for_batch``,
        which grows the table and marks the dirty blocks) and one
        ``row_set``. ``now_ms``: a scalar or an array a row (the clock)."""
        slots = self.slots_for_batch(self._device_keys(keys))
        vals, present, last, _ttl = self._row_planes(name)
        now = (int(now_ms) if np.ndim(now_ms) == 0
               else self._device_rows(now_ms, torch.int64))
        row_set(vals, present, last, slots, self._device_rows(values,
                                                             vals.dtype),
                now, self._row_scratch())

    def rows_lookup(self, name: str, keys, now_ms: int
                    ) -> tuple[np.ndarray, np.ndarray]:
        """(values, present) on the host for a batch of keys: absent,
        cleared or expired keys report present False. One ``row_get`` and
        one copy home of each."""
        vals, present, last, ttl = self._row_planes(name)
        v, p = row_get(self.table, vals, present, last,
                       self._device_keys(keys), int(now_ms), ttl)
        return v.cpu().numpy(), p.cpu().numpy()

    def rows_clear(self, name: str, keys) -> None:
        _vals, present, _last, _ttl = self._row_planes(name)
        self.mark_dirty(row_unset(self.table, present,
                                  self._device_keys(keys)))

    def dedup_first_device(self, name: str, keys: torch.Tensor,
                           ts: torch.Tensor,
                           valid: Optional[torch.Tensor] = None
                           ) -> tuple[torch.Tensor, int]:
        """Keep-first admission of a batch of device keys: (fresh bool [n]
        on the device, the number of fresh rows). One ``dedup_first`` and
        one host read of its status a try; a batch a row of which found no
        slot grows the table and runs again (presence and the clock are
        left as they were), and the table doubles past 0.6 occupancy, as
        the reference's synchronous mode."""
        if name not in self._row_meta:
            raise RuntimeError(f"row state {name!r} not registered")
        keys = keys.to(self.device, torch.int64).contiguous()
        ts = ts.to(self.device, torch.int64).contiguous()
        if valid is not None:
            valid = valid.to(self.device, torch.bool).contiguous()
        while True:
            _vals, present, last, ttl = self._row_planes(name)
            fresh, _slots, status = dedup_first(
                self.table, present, last, keys, valid, ts, ttl,
                self._row_scratch(), self._dirty_buf, self.dirty_shift)
            failed, claims, n_fresh = status.tolist()
            if failed:
                self.row_overflows += 1
                self._rehash(self.capacity * 2)
                continue
            self._num_keys += claims
            if self._num_keys > _GROW_AT * self.capacity:
                self._rehash(self.capacity * 2)
            return fresh, n_fresh

    def dedup_first_batch(self, name: str, keys, ts,
                          valid: Optional[np.ndarray] = None) -> np.ndarray:
        """``dedup_first_device`` on host arrays: the fresh mask as numpy
        (the reference's signature)."""
        fresh, _n = self.dedup_first_device(
            name, self._device_keys(keys), self._device_rows(ts, torch.int64),
            None if valid is None else self._device_rows(valid, torch.bool))
        return fresh.cpu().numpy()

    # -- keyed state handles (the row plane's per-key API) ---------------------
    def set_current_key(self, key) -> None:
        self._current_key = key

    @property
    def current_key(self):
        return self._current_key

    def get_partitioned_state(self, descriptor: StateDescriptor) -> State:
        """A ``ValueState`` over the row plane; each call of the handle is
        one program and a host round trip. float64 unless the default is a
        numpy integer (a Python int default must not truncate later float
        updates)."""
        if descriptor.kind != "value":
            raise NotImplementedError(
                "the device backend's row plane holds ValueState only; use "
                "array states or the device list plane "
                "(state/device_lists.py)")
        handle = self._row_states.get(descriptor.name)
        if handle is None:
            default = descriptor.default
            if isinstance(default, (np.integer, np.ndarray)) and \
                    np.asarray(default).dtype.kind in "iu":
                dtype = np.asarray(default).dtype
            else:
                dtype = np.float64
            ttl_ms = (int(descriptor.ttl.ttl * 1000)
                      if descriptor.ttl is not None else None)
            self.register_row_state(descriptor.name, dtype, ttl_ms)
            handle = _DeviceValueState(self, descriptor)
            self._row_states[descriptor.name] = handle
        return handle

    # -- checkpointing -----------------------------------------------------
    def snapshot(self, checkpoint_id: int) -> dict:
        """Host numpy snapshot in the reference's schema, canonical (group,
        key) order, through the mirror: capture the dirty blocks, order
        the keys on the device, gather every plane from the mirror with one
        composed permutation, and merge in the host tier's keys."""
        t0 = time.perf_counter()
        share = self._sync_mirror()
        t1 = time.perf_counter()
        slots = torch.nonzero(self.table != EMPTY_KEY).flatten()
        dev_keys = self.table[slots]
        host_keys = host_vals = None
        t_host = 0.0
        if self._host is not None and len(self._host.index):
            th = time.perf_counter()
            host_keys, parts = self._host.snapshot_parts()
            host_vals = {st.name: torch.from_numpy(np.ascontiguousarray(
                parts[st.name].astype(numpy_dtype(st.dtype), copy=False)))
                for st in self._pane_states()}
            t_host = time.perf_counter() - th
            all_keys = torch.cat([dev_keys,
                                  torch.from_numpy(host_keys).to(self.device)])
        else:
            all_keys = dev_keys
        groups = key_groups_device(all_keys, self.max_parallelism)
        o1 = torch.argsort(all_keys, stable=True)
        order = o1[torch.argsort(groups[o1], stable=True)]
        groups = groups[order].cpu()
        if host_keys is None:
            perm = slots[order].cpu()
            t2 = time.perf_counter()
            keys = _gather(self._mirror_bufs["__table__"], perm)
            vals = {st.name: _gather(self._mirror_bufs[st.name], perm)
                    for st in self._pane_states()}
        else:
            order = order.cpu()
            dslots = slots.cpu()
            t2 = time.perf_counter()
            keys = _gather(torch.cat([_gather(
                self._mirror_bufs["__table__"], dslots),
                torch.from_numpy(host_keys)]), order)
            vals = {st.name: _gather(torch.cat(
                [_gather(self._mirror_bufs[st.name], dslots),
                 host_vals[st.name]], -1), order)
                for st in self._pane_states()}
        states = {st.name: {"kind": st.kind,
                            "dtype": str(numpy_dtype(st.dtype)),
                            "ring": st.ring, "values": vals[st.name].numpy()}
                  for st in self._pane_states()}
        t3 = time.perf_counter()
        self.last_snapshot_s = {"capture": t1 - t0,
                                "order": t2 - t1 - t_host,
                                "gather": t3 - t2, "host_tier": t_host}
        self.snapshot_log.append({
            "checkpoint_id": checkpoint_id, **self.last_snapshot_s,
            "dma_bytes": self.last_snapshot_dma_bytes, "dirty_share": share,
            "keys": int(keys.numel()),
            "host_keys": 0 if host_keys is None else len(host_keys)})
        return {"kind": "tpu", "keys": keys.numpy(),
                "key_groups": groups.numpy(),
                "max_parallelism": self.max_parallelism, "states": states}

    def snapshot_plain(self, checkpoint_id: int) -> dict:
        """Plain version of ``snapshot``: the table and every pane plane
        copied whole to the host, the occupied keys hashed, sorted
        (``lexsort``) and gathered there, the host tier merged in. Touches
        neither the mirror nor the dirty blocks."""
        table = self.table.cpu().numpy()
        occupied = table != EMPTY_KEY
        keys = table[occupied]
        slots = np.flatnonzero(occupied)
        groups = key_groups_for_hash_batch(hash_batch(keys),
                                           self.max_parallelism)
        host_vals = None
        if self._host is not None and len(self._host.index):
            host_keys, host_vals = self._host.snapshot_parts()
            keys = np.concatenate([keys, host_keys])
            groups = np.concatenate([groups, key_groups_for_hash_batch(
                hash_batch(host_keys), self.max_parallelism)])
        order = np.lexsort((keys, groups))
        states = {}
        for st in self._pane_states():
            arr = st.array.cpu().numpy()
            vals = arr[:, slots] if st.ring else arr[slots]
            if host_vals is not None:
                vals = np.concatenate(
                    [vals, host_vals[st.name].astype(vals.dtype)], axis=-1)
            states[st.name] = {"kind": st.kind,
                               "dtype": str(numpy_dtype(st.dtype)),
                               "ring": st.ring,
                               "values": np.ascontiguousarray(
                                   vals[..., order])}
        return {"kind": "tpu", "keys": np.ascontiguousarray(keys[order]),
                "key_groups": np.ascontiguousarray(groups[order]),
                "max_parallelism": self.max_parallelism, "states": states}

    def restore(self, snapshots: Iterable[dict]) -> None:
        """Rebuild from snapshots of either package, keeping the keys of
        this backend's key-group range; under a budget, state above it is
        paged out to the host tier at once."""
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
            self.capacity *= 2   # may pass the budget: evicted back below
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
        self._host = None
        self._spilled_dev = None
        self._touch_dev = None
        self._last_touch[:] = 0
        self._pending_host = None
        self._invalidate_mirror()
        if self._budget and self.capacity > self._budget:
            self._evict_cold_groups(rebuild_capacity=self._budget)


class _DeviceValueState(ValueState):
    """A ``ValueState`` over the row plane for the backend's current key
    (the reference's ``_TpuValueState``): each call is one program and a
    host round trip; the clock is the wall clock in ms."""

    def __init__(self, backend: DeviceKeyedStateBackend,
                 desc: StateDescriptor):
        self._b, self._d = backend, desc

    def _key(self) -> np.ndarray:
        return np.asarray([self._b.current_key], np.int64)

    def value(self):
        vals, present = self._b.rows_lookup(
            self._d.name, self._key(), now_ms=int(time.time() * 1000))
        if not present[0]:
            return self._d.default
        v = vals[0]
        return v.item() if isinstance(v, np.generic) else v

    def update(self, value) -> None:
        self._b.rows_upsert(self._d.name, self._key(), np.asarray([value]),
                            now_ms=int(time.time() * 1000))

    def clear(self) -> None:
        self._b.rows_clear(self._d.name, self._key())
