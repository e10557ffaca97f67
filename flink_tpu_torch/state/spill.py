"""Host-RAM spill tier for device keyed state (port of
``flink_tpu/state/spill.py``).

Keyed state larger than the HBM budget pages out of the device at
key-group granularity: the device table and its planes stay the HOT set,
and whole cold key groups move to host RAM. Here a key index maps each
spilled key to a dense slot (first-seen order) of numpy accumulator
arrays, and every operation is batched: folds are ``np.add.at`` /
``np.minimum.at`` / ``np.maximum.at`` over a whole batch's host rows, and a
fire merges the window's ring rows of every host key at once.

The key index is the port's own hash table (``ops/hash_table.py``) on a
CPU tensor, which runs its plain version there, next to a
``[table capacity]`` array of dense slots; it doubles when it passes the
backend's 0.6 load factor. Keys arrive sanitized (never ``EMPTY_KEY``).

The prefetch pipeline (``state/tiering/prefetch.py``) reads the tier from
a thread of its own: every mutation bumps ``version`` and runs under an
``RLock``, as does ``peek_groups``, so a staged gather is never torn and
one raced by a later mutation is known stale.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from ..core.keygroups import hash_batch, key_groups_for_hash_batch
from ..ops.hash_table import lookup_or_insert, lookup_plain, make_table

__all__ = ["HostTier"]

_GROW_AT = 0.6


def _ident(kind: str, dtype: np.dtype):
    dtype = np.dtype(dtype)
    if kind in ("sum", "count"):
        return dtype.type(0)
    if kind == "min":
        return (np.finfo(dtype).max if np.issubdtype(dtype, np.floating)
                else np.iinfo(dtype).max)
    return (np.finfo(dtype).min if np.issubdtype(dtype, np.floating)
            else np.iinfo(dtype).min)


_FOLDS = {"sum": np.add.at, "count": np.add.at, "min": np.minimum.at,
          "max": np.maximum.at}

#: elementwise combine of each kind, for folds of distinct keys and merges
_COMBINE = {"sum": np.add, "count": np.add, "min": np.minimum,
            "max": np.maximum}


class _KeyIndex:
    """int64 key -> dense slot in first-seen order."""

    def __init__(self, capacity: int = 1 << 12):
        self._table = make_table(capacity, "cpu")
        self._dense = np.full(capacity, -1, np.int64)
        self.n = 0

    def __len__(self) -> int:
        return self.n

    def _rebuild(self, capacity: int, keys: np.ndarray) -> None:
        """A fresh table of ``capacity`` holding ``keys`` at dense slots
        0..len-1, in that order."""
        self._table = make_table(capacity, "cpu")
        self._dense = np.full(capacity, -1, np.int64)
        if len(keys):
            _, slots, ok = lookup_or_insert(self._table,
                                            torch.from_numpy(keys))
            if not bool(ok.all()):
                raise RuntimeError("host key index rebuild failed")
            self._dense[slots.numpy()] = np.arange(len(keys))
        self.n = len(keys)

    def upsert(self, keys: np.ndarray, all_keys) -> np.ndarray:
        """Dense slots of ``keys``, new keys appended in first-seen order;
        ``all_keys()`` gives the keys in dense order for a growth. Each
        distinct key is looked up once; only the absent ones insert."""
        uniq, first, inverse = np.unique(keys, return_index=True,
                                         return_inverse=True)
        s = lookup_plain(self._table, torch.from_numpy(uniq)).numpy()
        dense = np.where(s >= 0, self._dense[np.maximum(s, 0)], -1)
        absent = np.flatnonzero(dense < 0)
        if len(absent):
            absent = absent[np.argsort(first[absent], kind="stable")]
            new = uniq[absent]
            cap = self._table.numel()
            while self.n + len(new) > _GROW_AT * cap:
                cap *= 2
            if cap != self._table.numel():
                self._rebuild(cap, all_keys())
            while True:
                _, slots, ok = lookup_or_insert(self._table,
                                                torch.from_numpy(new))
                if bool(ok.all()):
                    break
                self._rebuild(self._table.numel() * 2, all_keys())
            ids = self.n + np.arange(len(new))
            self._dense[slots.numpy()] = ids
            dense[absent] = ids
            self.n += len(new)
        return dense[inverse.reshape(-1)]


class _HostArray:
    __slots__ = ("kind", "dtype", "ring", "array")

    def __init__(self, kind: str, dtype, ring: Optional[int], cap: int):
        self.kind = kind
        self.dtype = np.dtype(dtype)
        self.ring = ring
        shape = (ring, cap) if ring else (cap,)
        self.array = np.full(shape, _ident(kind, self.dtype), self.dtype)

    def grow(self, cap: int) -> None:
        old = self.array
        shape = (self.ring, cap) if self.ring else (cap,)
        self.array = np.full(shape, _ident(self.kind, self.dtype), self.dtype)
        self.array[..., :old.shape[-1]] = old


class HostTier:
    """Spilled key groups: key index + accumulator arrays + counters."""

    def __init__(self, max_parallelism: int):
        self.max_parallelism = max_parallelism
        self.index = _KeyIndex()
        self.cap = 1 << 12
        self.arrays: dict[str, _HostArray] = {}
        # True where the key group lives on the host
        self.spilled_mask = np.zeros(max_parallelism, bool)
        self.evicted_keys = 0      # keys moved device -> host
        self.promoted_keys = 0     # keys moved host -> device
        # monotone mutation counter: a promotion staged off the task's
        # thread is applied only while it still matches
        self.version = 0
        # mutations and the staging thread's multi-read gather; reentrant
        # because absorb nests slots_for
        self._mtx = threading.RLock()
        self._keys = np.empty(self.cap, np.int64)     # dense-slot order
        self._groups = np.empty(self.cap, np.int32)

    @property
    def active(self) -> bool:
        return bool(self.spilled_mask.any())

    def register(self, name: str, kind: str, dtype,
                 ring: Optional[int]) -> None:
        if name not in self.arrays:
            self.arrays[name] = _HostArray(kind, dtype, ring, self.cap)

    def _ensure(self, n: int) -> None:
        cap = self.cap
        while cap < n:
            cap *= 2
        if cap == self.cap:
            return
        self.cap = cap
        for a in self.arrays.values():
            a.grow(cap)
        for attr in ("_keys", "_groups"):
            old = getattr(self, attr)
            new = np.empty(cap, old.dtype)
            new[:len(old)] = old
            setattr(self, attr, new)

    def slots_for(self, keys: np.ndarray) -> np.ndarray:
        """Upsert host-side keys -> dense host slots."""
        keys = np.ascontiguousarray(keys, np.int64)
        with self._mtx:
            self.version += 1
            n0 = len(self.index)
            slots = self.index.upsert(keys, self.keys)
            self._ensure(len(self.index) + 1)
            self.record_new_keys(keys, slots, n0)
            return slots

    def record_new_keys(self, keys: np.ndarray, slots: np.ndarray,
                        n0: int) -> None:
        """Track the keys that took dense slots from ``n0`` on, for the
        slot -> key reverse lookup (and their groups)."""
        fresh = slots >= n0
        if fresh.any():
            self._keys[slots[fresh]] = keys[fresh]
            n = len(self.index)
            self._groups[n0:n] = key_groups_for_hash_batch(
                hash_batch(self._keys[n0:n]), self.max_parallelism)

    def absorb(self, keys: np.ndarray,
               values: dict[str, np.ndarray]) -> None:
        """Fold evicted device rows into the tier (values[name]: [ring?,
        n] rows aligned with keys). The keys are distinct (a device
        table's), so one gather-combine-scatter per plane does the fold."""
        if len(keys) == 0:
            return
        with self._mtx:
            n0 = len(self.index)
            slots = self.slots_for(keys)
            # every key new: their slots are n0, n0 + 1, ... in order, and
            # the fold into identities is a copy into that slice
            fresh = len(self.index) == n0 + len(keys)
            for name, vals in values.items():
                a = self.arrays[name]
                vals = vals.astype(a.dtype, copy=False)
                if fresh:
                    a.array[..., n0:n0 + len(keys)] = vals
                else:
                    a.array[..., slots] = _COMBINE[a.kind](
                        a.array[..., slots], vals)
            self.evicted_keys += len(keys)

    def fold(self, name: str, slots: np.ndarray, values: np.ndarray,
             ring_idx: Optional[np.ndarray]) -> None:
        with self._mtx:
            self.version += 1
            a = self.arrays[name]
            idx = (ring_idx, slots) if a.ring else slots
            _FOLDS[a.kind](a.array, idx, values.astype(a.dtype, copy=False))

    def keys(self) -> np.ndarray:
        """All host keys, in dense-slot order."""
        return self._keys[:len(self.index)]

    def fire(self, name: str, pane_rows: np.ndarray,
             slots: Optional[np.ndarray] = None) -> np.ndarray:
        """Merge the given ring rows -> per-key window results [n keys],
        or at the dense ``slots`` only."""
        a = self.arrays[name]
        cols = slice(0, len(self.index)) if slots is None else slots
        if a.ring is None:
            return a.array[cols].copy()
        # row by row, in numpy's accumulator dtype for a sum (an int32
        # count sums in int64), with no [rows, keys] temporary
        rows = np.asarray(pane_rows)
        dtype = (np.zeros(0, a.dtype).sum().dtype
                 if a.kind in ("sum", "count") else a.dtype)
        out = a.array[rows[0], cols].astype(dtype)
        for r in rows[1:]:
            _COMBINE[a.kind](out, a.array[r, cols], out=out)
        return out

    def reset_ring_row(self, row: int) -> None:
        with self._mtx:
            self.version += 1
            for a in self.arrays.values():
                if a.ring:
                    a.array[row] = _ident(a.kind, a.dtype)

    def key_groups(self) -> np.ndarray:
        """Key group of every host key, in dense-slot order."""
        return self._groups[:len(self.index)]

    def group_counts(self) -> np.ndarray:
        """Host-key histogram over key groups [max_parallelism]."""
        return np.bincount(self.key_groups(),
                           minlength=self.max_parallelism)

    def peek_groups(self, groups: np.ndarray, alloc=np.empty
                    ) -> tuple[np.ndarray, dict[str, np.ndarray]]:
        """Read-only copy of ``groups``' keys and accumulator rows, into
        arrays from ``alloc(shape, dtype)`` (called for the keys first,
        then for each plane in order); safe from the staging thread.
        Removes nothing: a promotion inserts on the device first and only
        then calls ``drop_groups``."""
        sel = np.zeros(self.max_parallelism, bool)
        sel[np.asarray(groups, np.int64)] = True
        with self._mtx:
            pick = np.flatnonzero(sel[self.key_groups()])
            keys = np.take(self.keys(), pick,
                           out=alloc((len(pick),), np.int64))
            vals = {}
            for name, a in self.arrays.items():
                vals[name] = np.take(a.array, pick, axis=-1, out=alloc(
                    a.array.shape[:-1] + (len(pick),), a.dtype))
            return keys, vals

    def drop_groups(self, groups: np.ndarray) -> int:
        """Remove ``groups`` from the tier and compact the rest (a new
        index over the survivors, dense in their order). Returns the keys
        dropped."""
        groups = np.asarray(groups, np.int64)
        sel = np.zeros(self.max_parallelism, bool)
        sel[groups] = True
        with self._mtx:
            self.version += 1
            pick = sel[self.key_groups()]
            dropped = int(pick.sum())
            if dropped:
                n = len(self.index)
                keep_keys = self.keys()[~pick].copy()
                keep_groups = self.key_groups()[~pick].copy()
                for a in self.arrays.values():
                    kept = a.array[..., :n][..., ~pick]
                    a.array[..., :len(keep_keys)] = kept
                    a.array[..., len(keep_keys):] = _ident(a.kind, a.dtype)
                # the survivors are distinct: one insert rebuilds the index
                self.index._rebuild(self.index._table.numel(), keep_keys)
                self._keys[:len(keep_keys)] = keep_keys
                self._groups[:len(keep_keys)] = keep_groups
                self.promoted_keys += dropped
            self.spilled_mask[groups] = False
            return dropped

    def snapshot_parts(self) -> tuple[np.ndarray, dict[str, np.ndarray]]:
        """(keys, {name: [ring?, n] values}) for checkpointing."""
        with self._mtx:
            n = len(self.index)
            return (self.keys().copy(),
                    {name: a.array[..., :n].copy()
                     for name, a in self.arrays.items()})
