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
  coldest resident key groups move to the host tier (``state/spill.py``)
  and the table is rebuilt without them. Coldest is the residency
  manager's decayed 2Q order (``state/tiering/``: probationary groups by
  recency, then protected ones by heat and recency, a seeded permutation
  breaking ties), fed each host batch's key groups or, in deferred mode,
  the ingest kernel's per-group batch clock, read once a boundary. In
  deferred mode the split of each batch between the tiers runs inside the
  ingest kernel (``StepSpill``): rows of spilled groups and failed
  inserts are staged on the device and folded into the host tier at the
  next watermark (``drain_staged``).
* Promotion (``tier_boundary``, at each batch boundary after the drain):
  warm groups with heat enough are staged by the prefetch pipeline (their
  rows gathered from the host tier into pinned memory and copied to the
  device on a stream of its own, off the task's thread when
  ``state.tiering.async-prefetch`` is true and the batches are host
  batches; the deferred step's drains race every such payload, so it
  stages inline), and at most one staged
  payload lands a boundary (``apply_promotion``): its keys go into the
  table at fixed capacity through the probe kernel, all or none, its rows
  into every pane plane in place, and only then do the groups leave the
  host tier, so a key is never split between the tiers or lost.
* Row plane (the reference's typed row states, ``tpu_backend.py:1119-
  1258``): per-key values of any numeric dtype as three array states of
  kind ``sum``, ``name`` (values), ``name.__set__`` (int8 presence) and,
  under a TTL, ``name.__ts__`` (int64 clock of the last write), so they
  snapshot, mirror and restore with the rest. ``rows_upsert``,
  ``rows_lookup``, ``rows_clear`` and keep-first ``dedup_first_batch``
  run the kernels of ``ops/row_state.py`` (one batch a call, one batch
  map that grows with the largest batch); ``get_partitioned_state``
  hands out ``ValueState`` handles over them. The row plane refuses an
  HBM budget, as the reference's does.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Optional

import numpy as np
import torch

from ..core.config import DEFAULTS
from ..core.keygroups import KeyGroupRange, hash_batch, \
    key_groups_device, key_groups_for_hash_batch
from ..device import numpy_dtype, resolve_device, torch_dtype
from ..metrics.device import DEVICE_STATS
from ..ops.hash_table import EMPTY_KEY, StepSpill, ingest_step, lookup, \
    lookup_or_insert, make_table, ordered_table, sanitize_keys_device
from ..ops.row_state import MAP_HEAD, batch_map_entries, dedup_first, \
    new_batch_map, row_get, row_set, row_unset
from ..ops.segment_ops import identity, make_accumulator, scatter_fold
from .backend import State, ValueState, register_backend
from .descriptors import StateDescriptor
from .spill import HostTier
from .tiering import PrefetchPipeline, ResidencyManager

__all__ = ["DeviceKeyedStateBackend"]

_GROW_AT = 0.6   # occupancy share that triggers a doubling rehash
_BLOCK = 512     # slots per dirty block
_INT64_MAX = int(np.iinfo(np.int64).max)


def _tiering_params(config) -> dict:
    """The ``state.tiering.*`` keys (their defaults without a config)."""
    get = DEFAULTS.get if config is None else config.get
    return {"seed": int(get("state.tiering.seed")),
            "decay_interval": int(get("state.tiering.decay-interval")),
            "decay_factor": float(get("state.tiering.decay-factor")),
            "promote_headroom": float(get("state.tiering.promote-headroom")),
            "promote_min_heat": float(get("state.tiering.promote-min-heat")),
            "async_prefetch": bool(get("state.tiering.async-prefetch"))}


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
    # the row plane holds value state only: an operator that needs
    # namespaced list, aggregating or map state pins ``hashmap``
    SUPPORTS_GENERAL_STATE = False

    def __init__(self, key_group_range: KeyGroupRange, max_parallelism: int,
                 capacity: int = 1 << 16, device=None,
                 defer_overflow: bool = False, hbm_budget_slots: int = 0,
                 config=None):
        self.key_group_range = key_group_range
        self.max_parallelism = max_parallelism
        # the card unless a caller asks for the CPU (the registry's ``tpu``
        # factory passes the operator's device, or nothing)
        self.device = resolve_device(device)
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
        # tiered residency (state/tiering/), under a budget only: the
        # manager's heat policy decides which groups evict and promote; the
        # pipeline stages promotions, applied at batch boundaries
        self._residency: Optional[ResidencyManager] = None
        self._prefetch: Optional[PrefetchPipeline] = None
        if budget:
            params = _tiering_params(config)
            self._residency = ResidencyManager(
                max_parallelism, budget, seed=params["seed"],
                decay_interval=params["decay_interval"],
                decay_factor=params["decay_factor"],
                promote_headroom=params["promote_headroom"],
                promote_min_heat=params["promote_min_heat"])
            # the deferred step's drain folds the hot spilled groups' rows
            # into the host tier at every boundary, so a payload staged off
            # the task's thread is always stale when it would apply and is
            # gathered again: deferred staging runs inline
            self._prefetch = PrefetchPipeline(
                self._stage_promotion,
                asynchronous=params["async_prefetch"] and not self._defer)
        # the staging copies' stream (the card only)
        self._stage_stream = (torch.cuda.Stream(self.device)
                              if budget and self.device.type == "cuda"
                              else None)
        self._tier_lock = threading.Lock()
        #: promotions applied, refused (headroom gone, or an insert that
        #: did not fit) and gathered again (raced by a host tier mutation);
        #: seconds of tier_boundary on the task's thread, of staging (off
        #: it when staging is asynchronous) and of apply_promotion
        self.promotions = {"applied": 0, "refused": 0, "regathered": 0}
        self.tier_s = {"boundary": 0.0, "stage": 0.0, "apply": 0.0}
        #: (start, end) CUDA events around the latest applied promotions'
        #: device work (insert and plane scatters), for their device ms
        self.promotion_events: deque = deque(maxlen=1024)
        # the deferred step's spilled-group mask and per-group batch clock,
        # on the device
        self._spilled_dev: Optional[torch.Tensor] = None
        self._touch_dev: Optional[torch.Tensor] = None
        # host positions and host slots of the last sync-path batch's
        # spilled rows, folded by fold_batch
        self._pending_host: Optional[tuple[np.ndarray, np.ndarray]] = None
        #: evictions: calls, key groups and keys moved to the host;
        #: ``ordered_rebuilds``: rebuilds the probe could not place and the
        #: home-slot layout did (``_fresh_table``); ``forced_fallback``:
        #: groups a forced spill took beyond those it was asked for because
        #: no layout held the rest at the same capacity, a guard that a
        #: table's own keys never reach (``_force_spill_groups``)
        self.evictions = {"calls": 0, "groups": 0, "keys": 0,
                          "ordered_rebuilds": 0, "forced_fallback": 0}
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
        #: one record per snapshot: id, phases, DMA bytes, dirty share,
        #: keys (on the host tier too) and the promotions applied so far
        self.snapshot_log: deque = deque(maxlen=64)
        # -- row plane ------------------------------------------------------
        self._row_meta: dict[str, tuple[int, np.dtype]] = {}  # name -> ttl
        self._row_states: dict[str, State] = {}
        self._batch_map_buf: Optional[torch.Tensor] = None
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
            self._residency.observe(
                groups, self._batch_no,
                self._host.spilled_mask if self._host is not None else None)
        while True:
            sp = None
            if self.spill_active and groups is not None:
                sp = self._host.spilled_mask[groups]
                if not sp.any():
                    sp = None
            valid = (None if sp is None
                     else torch.from_numpy(~sp).to(self.device))
            # under a budget a batch that does not fit leaves the table as
            # it was (the eviction that follows sees the reference's
            # resident set); without one the claims carry into the rehash
            work = self.table.clone() if self._budget else self.table
            _, slots, ok = lookup_or_insert(work, keys, valid)
            # lint: sync-ok the probe's all-found flag, one a host batch
            all_ok = bool((ok if valid is None else ok | ~valid).all())
            if all_ok and work is not self.table:
                self.table.copy_(work)
            # lint: sync-ok the key count of the growth check, one a host batch
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
        from ..metrics.profiler import DEVICE_LEDGER
        tok = DEVICE_LEDGER.begin("state.reset_row", self.table.device) \
            if DEVICE_LEDGER.enabled else None
        for st in self._pane_states():
            if st.ring:
                st.array[row].fill_(identity(st.kind, st.dtype))
        if tok is not None:
            DEVICE_LEDGER.end(tok, (self.capacity, tuple(
                st.array.element_size() for st in self._pane_states()
                if st.ring)), reset_row_cost)
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
        # lint: sync-ok the occupied slots, once a rehash
        old_slots = torch.nonzero(occupied).flatten()
        self._rebuild(self.table[old_slots], old_slots, new_capacity)

    def _fresh_table(self, keys: torch.Tensor, capacity: int
                     ) -> Optional[tuple[torch.Tensor, torch.Tensor]]:
        """A table of ``capacity`` holding ``keys`` and their int64 slots,
        or None when no layout within the probe window holds them.

        The probe places them first. On the card it claims slots in thread
        order, and at a high load (the deferred step fills the table past
        0.6 between two fires) that order can strand a key past the
        probe's window although the keys fit: they are then laid out in
        home-slot order (``ordered_table``), which fits every key set one
        table already held at this capacity. So which keys a rebuild keeps
        never depends on the card's thread order."""
        table = make_table(capacity, self.device)
        _, slots, ok = lookup_or_insert(table, keys.contiguous())
        # lint: sync-ok the probe's all-placed flag, once a rebuild
        if bool(ok.all()):
            return table, slots.to(torch.int64)
        self.evictions["ordered_rebuilds"] += 1
        return ordered_table(keys.contiguous(), capacity)

    def _rebuild(self, keys: torch.Tensor, old_slots: torch.Tensor,
                 new_capacity: int, fresh: Optional[tuple] = None) -> None:
        """Re-key every plane, window-role planes included, onto a fresh
        table of ``new_capacity`` holding ``keys`` only (``fresh``: that
        table and the keys' slots, already built)."""
        if fresh is None:
            fresh = self._fresh_table(keys, new_capacity)
            if fresh is None:
                raise RuntimeError(
                    "rebuild failed: pathological key distribution")
        new_table, new_slots = fresh
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
        """Tick the monotone batch clock of the residency policy."""
        self._batch_no += 1
        return self._batch_no

    def _sync_spilled_dev(self) -> None:
        if self._host is not None:
            self.spilled_mask_device.copy_(
                torch.from_numpy(self._host.spilled_mask))

    def _sync_touch_from_device(self) -> None:
        """Hand the deferred step's device clock to the residency policy
        (at boundaries and evictions): one copy home of [max_parallelism]
        int64."""
        if self._touch_dev is not None and self._residency is not None:
            self._residency.adopt_clock(
                self._touch_dev.cpu().numpy(),
                self._host.spilled_mask if self._host is not None else None)

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
        """``_evict_cold_groups_inner`` under the ``tier.evict`` site,
        visited before anything moves (a transient trip retries with
        nothing mutated, a persistent one fails the batch), and under the
        watchdog's ``watchdog.tier-timeout``."""
        from ..runtime.faults import fire_with_retries
        from ..runtime.watchdog import WATCHDOG
        fire_with_retries("tier.evict", scope="device_backend.tier")
        WATCHDOG.run("tier.evict",
                     lambda: self._evict_cold_groups_inner(rebuild_capacity,
                                                           batch_groups),
                     scope="device_backend.tier")

    def _evict_cold_groups_inner(self,
                                 rebuild_capacity: Optional[int] = None,
                                 batch_groups: Optional[np.ndarray] = None
                                 ) -> None:
        """Page the coldest resident key groups to the host tier, in the
        residency policy's order, until the resident keys fall to 0.4 of
        the capacity (a quarter of them at least). When the resident set
        alone cannot make room, half of the incoming batch's groups are
        spilled too, so every call spills at least one group."""
        t0 = time.perf_counter()
        self._ensure_host_tier()
        cap = rebuild_capacity or self.capacity
        keys, slots, groups = self._device_resident()
        counts = np.bincount(groups, minlength=self.max_parallelism)
        resident = np.flatnonzero(counts > 0)
        order = self._residency.eviction_order(resident)
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
        self._note_demoted(np.asarray(evict, np.int64), int(sel.sum()))
        self.spill_s["evict"] += time.perf_counter() - t0

    def _note_demoted(self, groups: np.ndarray, keys: int) -> None:
        self._residency.note_demoted(groups)
        DEVICE_STATS.note_tier_eviction(len(groups), keys)
        self.evictions["calls"] += 1
        self.evictions["groups"] += len(groups)
        self.evictions["keys"] += keys

    def _absorb_and_rebuild(self, keys: torch.Tensor, slots: torch.Tensor,
                            sel: np.ndarray, groups, cap: int,
                            fresh: Optional[tuple] = None) -> None:
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
            self._rebuild(keys[keep], slots[keep], cap, fresh)
        self._sync_spilled_dev()

    def _force_spill_groups(self, groups: np.ndarray) -> None:
        """``_force_spill_groups_inner`` under the ``tier.evict`` site and
        the watchdog, as ``_evict_cold_groups``."""
        from ..runtime.faults import fire_with_retries
        from ..runtime.watchdog import WATCHDOG
        fire_with_retries("tier.evict", scope="device_backend.tier")
        WATCHDOG.run("tier.evict",
                     lambda: self._force_spill_groups_inner(groups),
                     scope="device_backend.tier")

    def _force_spill_groups_inner(self, groups: np.ndarray) -> None:
        """Page the given key groups to the host tier now (the staged
        rows of a group seen for the first time there), so no key is ever
        split across the tiers: exactly those groups, rebuilt at the same
        capacity, as the reference evicts them. The rebuild cannot fail on
        keys the table held (``_fresh_table``); were no layout to hold
        them, the coldest resident groups would go too, in the residency
        policy's order, down to 0.4 of the capacity, counted in
        ``evictions["forced_fallback"]``."""
        t0 = time.perf_counter()
        keys, slots, g = self._device_resident()
        groups = [int(x) for x in np.asarray(groups, np.int64)]
        gmask = np.zeros(self.max_parallelism, bool)
        gmask[groups] = True
        sel = gmask[g]
        fresh = self._fresh_table(keys[torch.from_numpy(~sel).to(
            self.device)], self.capacity) if sel.any() else None
        if sel.any() and fresh is None:
            counts = np.bincount(g[~sel], minlength=self.max_parallelism)
            kept = int((~sel).sum())
            asked = len(groups)
            for grp in self._residency.eviction_order(
                    np.flatnonzero(counts > 0)):
                if kept <= int(0.4 * self.capacity):
                    break
                groups.append(int(grp))
                kept -= int(counts[grp])
            self.evictions["forced_fallback"] += len(groups) - asked
            gmask[groups] = True
            sel = gmask[g]
        self._absorb_and_rebuild(keys, slots, sel, groups, self.capacity,
                                 fresh)
        self._note_demoted(np.asarray(groups, np.int64), int(sel.sum()))
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

    # -- tiered residency: the boundary hook and promotion ------------------
    @property
    def tiering_active(self) -> bool:
        return self._residency is not None

    @property
    def residency(self) -> Optional[ResidencyManager]:
        return self._residency

    @property
    def prefetch_pipeline(self) -> Optional[PrefetchPipeline]:
        return self._prefetch

    def tier_boundary(self) -> bool:
        """The batch-boundary step of tiered residency, called by the
        operator after the staged rows' drain (nothing is in flight for
        any group): adopt the device clock, advance the decay cadence,
        request promotion candidates from the prefetch pipeline and apply
        at most one staged payload. Raises a staging failure. Returns True
        when a promotion landed, so the operator can rebuild derived
        window planes."""
        if self._residency is None:
            return False
        t0 = time.perf_counter()
        self._sync_touch_from_device()
        self._residency.on_boundary()
        changed = False
        host = self._host
        if host is not None and host.active:
            counts = host.group_counts()
            cands = self._residency.promotion_candidates(
                host.spilled_mask, counts, self._num_keys, self.capacity)
            if len(cands):
                self._prefetch.request(cands)
            payload = self._prefetch.poll()
            if payload is not None:
                changed = self.apply_promotion(payload)
                counts = host.group_counts()
            self._residency.update_view(host.spilled_mask, counts)
        DEVICE_STATS.set_tier_hbm_bytes(self.state_nbytes)
        with self._tier_lock:
            self.tier_s["boundary"] += time.perf_counter() - t0
        return changed

    def _stage_promotion(self, groups: np.ndarray) -> Optional[dict]:
        """Gather ``groups``' warm rows and copy them to the device (on the
        prefetch thread, unless staging is synchronous). The gather runs
        under the host tier's lock, into pinned memory on the card, and is
        stamped with the tier's version; the copies run on a stream of
        their own and record an event that ``apply_promotion`` waits on.
        Exactly the groups' n rows are staged."""
        t0 = time.perf_counter()
        host = self._host
        if host is None:
            return None
        cuda = self.device.type == "cuda"
        bufs: list[torch.Tensor] = []

        def alloc(shape, dtype) -> np.ndarray:
            t = torch.empty(shape, dtype=torch_dtype(dtype), pin_memory=cuda)
            bufs.append(t)
            return t.numpy()

        with host._mtx:
            version = host.version
            groups = np.asarray(groups, np.int64)
            groups = groups[host.spilled_mask[groups]]
            if len(groups) == 0:
                return None
            keys, vals = host.peek_groups(groups, alloc)
        n = len(keys)
        if n == 0:
            return None
        staged = dict(zip(["__keys__", *vals], bufs))
        event = None
        if cuda:
            with torch.cuda.stream(self._stage_stream):
                staged = {k: v.to(self.device, non_blocking=True)
                          for k, v in staged.items()}
                event = torch.cuda.Event()
                event.record(self._stage_stream)
        with self._tier_lock:
            self.tier_s["stage"] += time.perf_counter() - t0
        return {"groups": groups, "version": version, "n": n,
                "keys": staged.pop("__keys__"), "values": staged,
                "event": event, "pinned": bufs}

    def apply_promotion(self, payload: dict) -> bool:
        """Install a staged promotion at a batch boundary (task thread):
        insert its keys into the table at fixed capacity (one probe
        launch on a copy of the table, its ``ok`` read once, the copy
        written back only if every key found a slot), scatter its rows
        into every pane plane in place, then drop the groups from the
        host tier and clear their spilled flags. A payload raced by a host
        tier mutation since staging is gathered again first. Refused, with
        nothing moved and the groups left warm, when the promoted and
        resident keys would pass 0.6 of the capacity or the insert does
        not fit."""
        t0 = time.perf_counter()
        host = self._host
        groups = np.asarray(payload["groups"], np.int64)
        if host is None:
            return False
        if payload["version"] != host.version:
            self.promotions["regathered"] += 1
            payload = self._stage_promotion(groups)
            if payload is None:
                return False
            groups = payload["groups"]
        n = int(payload["n"])
        if self._num_keys + n > int(_GROW_AT * self.capacity):
            self._refuse(groups)
            return False
        cuda = self.device.type == "cuda"
        if cuda:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(payload["event"])
            # made on the staging stream, used on this one: the caching
            # allocator must not hand their memory out before this use
            payload["keys"].record_stream(stream)
            for v in payload["values"].values():
                v.record_stream(stream)
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
        work = self.table.clone()
        _, slots, ok = lookup_or_insert(work, payload["keys"])
        if not bool(ok.all()):
            self._refuse(groups)
            return False
        self.table.copy_(work)
        self._num_keys += n
        slots = slots.to(torch.int64)
        for st in self._pane_states():
            st.array.index_copy_(st.array.dim() - 1, slots,
                                 payload["values"][st.name])
        if cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
            self.promotion_events.append((start, end))
        host.drop_groups(groups)
        self._sync_spilled_dev()
        self.mark_dirty(slots)
        self._residency.note_promoted(groups)
        DEVICE_STATS.note_tier_prefetch(len(groups), n)
        self.promotions["applied"] += 1
        with self._tier_lock:
            self.tier_s["apply"] += time.perf_counter() - t0
        return True

    def _refuse(self, groups: np.ndarray) -> None:
        """A staged promotion that does not land: discarded, its groups
        stay warm and may be requested again."""
        self._prefetch.forget(groups)
        self.promotions["refused"] += 1

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
        # a scalar fill: index assignment would copy its value from the host
        self._dirty_buf.index_fill_(0, torch.where(
            s >= 0, s >> self.dirty_shift, self._n_blocks), 1)

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

    def _batch_map(self, n: int) -> Optional[torch.Tensor]:
        """The row kernels' batch map for n rows (``ops/row_state.py``),
        grown with the largest batch; None on the CPU, whose plain
        versions need none."""
        if self.device.type == "cpu":
            return None
        buf = self._batch_map_buf
        if buf is None or buf.numel() < MAP_HEAD + batch_map_entries(n):
            buf = self._batch_map_buf = new_batch_map(n, self.device)
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
                now, self._batch_map(slots.numel()))

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
                self._dirty_buf, self.dirty_shift,
                self._batch_map(keys.numel()))
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
                "TPU backend row plane supports ValueState only; use array "
                "states (device operators), the device list plane "
                "(state/device_lists.py), or the hashmap backend")
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

    def keys(self, state_name: str, namespace=None) -> list:
        """Every key of the table (the reference's ``keys``: the table's
        keys, whatever their planes hold); one copy home."""
        t = self.table.cpu().numpy()
        return t[t != EMPTY_KEY].tolist()

    # -- checkpointing -----------------------------------------------------
    def snapshot(self, checkpoint_id: int) -> dict:
        """Host numpy snapshot in the reference's schema, canonical (group,
        key) order, through the mirror: capture the dirty blocks, order
        the keys on the device, gather every plane from the mirror with one
        composed permutation, and merge in the host tier's keys."""
        from ..runtime.faults import fire_with_retries
        from ..runtime.watchdog import WATCHDOG
        t0 = time.perf_counter()

        # site transfer.d2h under the checkpoint deadline; no retry in
        # place: the mirror update mutates the backend, so a stall (an
        # injected hang too) fails the checkpoint or the evacuation, and
        # with it the task
        deadline = WATCHDOG.deadline_for("checkpoint.write")
        fire_with_retries("transfer.d2h", scope="device_backend.snapshot",
                          bound=("transfer.d2h", WATCHDOG.deadline_in_force(
                              "transfer.d2h", deadline),
                              "device_backend.snapshot"))
        share = WATCHDOG.run("transfer.d2h", self._sync_mirror,
                             scope="device_backend.snapshot",
                             deadline=deadline)
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
            "host_keys": 0 if host_keys is None else len(host_keys),
            "promotions": self.promotions["applied"]})
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
        if self._prefetch is not None:
            # stagings gathered against the state before the restore must
            # never apply
            self._prefetch.cancel()
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
        # site transfer.h2d, before anything of this backend changes
        from ..runtime.faults import fire_with_retries
        fire_with_retries("transfer.h2d", scope="device_backend.restore")
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


def reset_row_cost(capacity: int, plane_sizes: tuple) -> tuple[int, int]:
    """(flops, bytes) of a pane retirement from its shapes: one ring row
    of every ring plane written once ([capacity] elements each), nothing
    read."""
    return 0, capacity * sum(plane_sizes)


register_backend("tpu", DeviceKeyedStateBackend)
