"""Device list plane: per-key bounded row lists on the card (port of
``flink_tpu/state/device_lists.py``).

Every key owns L fixed slots in a dense ``[capacity, L, C]`` int64 block
(column 0 the row's event time; numeric columns bit-packed, floats as
their int64 bits), addressed by the device hash table of
``ops/hash_table.py``. The three operations are the kernels of
``ops/device_lists.py``:

* ``append_batch`` / ``append_packed``: slot resolution, the in-batch rank
  (duplicate keys take consecutive positions in batch order) and the
  write; one host read of three flags a batch;
* ``probe_range``: the other side's rows of each key whose ts lies in the
  row's interval, compacted on the card, so only matches come home;
  ``probe_batch`` keeps the reference's ``[B, L_eff, C]`` contract. A
  probe that cannot match is not launched: the store has no live row, or
  the batch's interval ``[ts_min + lo_off, ts_max + hi_off]`` lies wholly
  outside host bounds that hold for every live row's ts;
* ``prune``: per-key compaction keeping rows with ts >= horizon (the
  watermark cleanup of the interval join). A tile summary (``tiles``:
  per 128 slots bounds on the live rows' ts and the live slots; derived,
  never snapshotted; rebuilt by every load with the widest bounds) lets
  it skip the tiles it cannot change and empty the tiles it drops whole
  without reading a ts. A store with no live key skips the prune.

The reference's rules hold: the 0.6 load pre-grow, list overflow failing
loudly with the same message, the dead-key rebuild when emptied keys
dominate, and snapshots ``{"kind": "tpu-list", keys, key_groups, rows,
counts, L, C, dtypes}`` that restore across both packages, widening to a
larger ``rows_per_key``. A rehash or rebuild runs on the card and never
holds two blocks at once: the kept keys' lists are gathered, the old
block is freed, then they are reinserted.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core.keygroups import KeyGroupRange, hash_batch, \
    key_groups_for_hash_batch
from ..device import resolve_device
from ..ops.device_lists import check_list_shape, list_append, list_probe, \
    list_prune, make_tiles, tiles_from_counts
from ..ops.hash_table import EMPTY_KEY, lookup_or_insert, make_table

__all__ = ["DeviceListStore", "pack_columns"]

#: ``_min_ts`` of a store with no live row: every prune and every probe is
#: skipped until an append lowers it
_NO_ROWS = 1 << 63
_INT64_MAX, _INT64_MIN = (1 << 63) - 1, -(1 << 63)
#: live lists whose ts one step of ``_live_ts_bounds`` reads
_BOUNDS_CHUNK = 1 << 20
_OVERFLOW = ("device list overflow: a key exceeded {L} live rows; raise "
             "rows_per_key or tighten the retention window")


def pack_columns(ts: torch.Tensor, cols: Sequence[torch.Tensor],
                 dtypes: Sequence[np.dtype]) -> torch.Tensor:
    """[B, 1 + len(cols)] int64 rows on the columns' device: ts, then each
    column as int64 (floats as their float64 bits)."""
    out = [ts.to(torch.int64)]
    for c, d in zip(cols, dtypes):
        if d.kind == "f":
            out.append(c.to(torch.float64).view(torch.int64))
        else:
            out.append(c.to(torch.int64))
    return torch.stack(out, dim=1).contiguous()


class DeviceListStore:
    """Bounded per-key row lists on the device (see module docstring).

    ``col_dtypes``: numpy dtypes of the payload columns. Column 0 of the
    packed block is always the row's event timestamp (int64). ``device``:
    ``cuda`` unless the caller asks for the CPU."""

    def __init__(self, key_group_range: KeyGroupRange, max_parallelism: int,
                 col_dtypes: Sequence[np.dtype], capacity: int = 1 << 12,
                 rows_per_key: int = 256, device=None):
        cap = 1
        while cap < capacity:
            cap <<= 1
        self.key_group_range = key_group_range
        self.max_parallelism = max_parallelism
        self.device = resolve_device(device)
        self.capacity = cap
        self.L = int(rows_per_key)
        self.col_dtypes = [np.dtype(d) for d in col_dtypes]
        for d in self.col_dtypes:
            if d.kind not in "iufb":
                raise TypeError(
                    f"device list columns must be numeric/bool; got {d}")
        self.C = 1 + len(self.col_dtypes)    # ts + payload columns
        check_list_shape(self.L, self.C)
        self._occ = 0   # occupied slots (insert-only table)
        # lower bound on the oldest live row's ts, as the reference keeps
        # it (None after a restore until an append); _NO_ROWS: no live
        # row. prune() is skipped when it provably cannot drop a row
        self._min_ts: Optional[int] = _NO_ROWS
        # bounds that hold for every live row's ts, for the probe to skip
        # on (None: unknown; after a restore until the next append, which
        # reads them from the whole store). _min_ts need not hold: after a
        # restore an append sets it to the batch's least ts, as the
        # reference's does, and the prune skips by it as the reference's
        self._probe_min_ts: Optional[int] = None
        self._max_ts: Optional[int] = None
        # the largest probe output so far: the room the next one starts with
        self._probe_hint = 0
        #: prunes and probes run and skipped, dead-key rebuilds, rehashes
        self.stats = {"prunes": 0, "prunes_skipped": 0, "probes": 0,
                      "probes_skipped": 0, "rebuilds": 0, "rehashes": 0}
        self._alloc(cap)

    def _alloc(self, cap: int) -> None:
        """A fresh state of ``cap`` slots. The block is not cleared: a
        slot's list is written whole when an insert claims it, or by a
        reload. The tile summary starts empty."""
        dev = self.device
        self.capacity = cap
        # the block first: it takes the freed block of a reload whole
        self.rows = torch.empty((cap, self.L, self.C), dtype=torch.int64,
                                device=dev)
        self.table = make_table(cap, dev)
        self.counts = torch.zeros(cap, dtype=torch.int32, device=dev)
        self.hits = torch.zeros(cap, dtype=torch.int64, device=dev)
        self.tiles = make_tiles(cap, dev)

    # -- packing -------------------------------------------------------
    def _pack(self, ts, cols) -> torch.Tensor:
        ts = torch.as_tensor(np.asarray(ts, np.int64)) \
            if not isinstance(ts, torch.Tensor) else ts
        cols = [c if isinstance(c, torch.Tensor)
                else torch.as_tensor(np.ascontiguousarray(c)) for c in cols]
        return pack_columns(ts, cols, self.col_dtypes).to(self.device)

    def _unpack_col(self, packed: np.ndarray, i: int) -> np.ndarray:
        """packed[..., 1 + i] back to the column's dtype."""
        raw = packed[..., 1 + i]
        d = self.col_dtypes[i]
        if d.kind == "f":
            return raw.view(np.float64).astype(d)
        if d.kind == "b":
            return raw.astype(bool)
        return raw.astype(d)

    # -- operations ----------------------------------------------------
    def append_batch(self, keys, ts, cols) -> None:
        """Append one row per key: numpy or torch columns (moved to the
        store's device)."""
        if len(keys) == 0:
            return
        keys_t = keys if isinstance(keys, torch.Tensor) else \
            torch.as_tensor(np.asarray(keys, np.int64))
        self.append_packed(keys_t.to(self.device, torch.int64),
                           self._pack(ts, cols))

    def append_packed(self, keys: torch.Tensor, packed: torch.Tensor,
                      ts_min: Optional[int] = None,
                      ts_max: Optional[int] = None) -> None:
        """Append packed rows [n, C] under keys [n], both on the store's
        device; ``ts_min`` and ``ts_max`` (bounds on the batch's ts) spare
        a device read."""
        n = keys.numel()
        if n == 0:
            return
        if ts_min is None or ts_max is None:
            lo, hi = torch.stack(torch.aminmax(packed[:, 0])).tolist()
            ts_min = lo if ts_min is None else ts_min
            ts_max = hi if ts_max is None else ts_max
        if self._min_ts == _NO_ROWS:
            self._probe_min_ts, self._max_ts = ts_min, ts_max
        elif self._max_ts is None:
            lo, hi = self._live_ts_bounds()
            self._probe_min_ts, self._max_ts = min(lo, ts_min), max(hi,
                                                                    ts_max)
        else:
            self._probe_min_ts = min(self._probe_min_ts, ts_min)
            self._max_ts = max(self._max_ts, ts_max)
        self._min_ts = (ts_min if self._min_ts is None
                        else min(self._min_ts, ts_min))
        # pre-grow while the worst case (every key new) would pass the
        # load threshold, so inserts stay infallible
        while self._occ + n > 0.6 * self.capacity:
            self._rehash(self.capacity * 2)
        keys = keys.contiguous()
        flags, failed = list_append(self.table, self.rows, self.counts,
                                    self.tiles, self.hits, keys,
                                    packed.contiguous())
        full, insert_failed, inserted = flags.tolist()
        self._occ += int(inserted)
        if full:
            raise RuntimeError(_OVERFLOW.format(L=self.L))
        if insert_failed:
            # a probe cluster longer than the bounded walk: the rows that
            # did insert are applied; grow and retry only the failed ones
            sel = torch.nonzero(failed).flatten()
            self._rehash(self.capacity * 2)
            self.append_packed(keys[sel], packed[sel], ts_min, ts_max)

    def _live_ts_bounds(self) -> tuple[int, int]:
        """The least and largest ts of the live rows, read from the rows
        (int64 max and min when there is none)."""
        pos = torch.arange(self.L, device=self.device)[None, :]
        lo, hi = [], []
        for live in torch.nonzero(self.counts > 0).flatten().split(
                _BOUNDS_CHUNK):
            ts = self.rows[live, :, 0]
            on = pos < self.counts[live][:, None].to(torch.int64)
            lo.append(torch.where(on, ts, _INT64_MAX).amin())
            hi.append(torch.where(on, ts, _INT64_MIN).amax())
        if not lo:
            return _INT64_MAX, _INT64_MIN
        return tuple(torch.stack([torch.stack(lo).amin(),
                                  torch.stack(hi).amax()]).tolist())

    def _probe_skips(self, lo: Optional[int], hi: Optional[int]) -> bool:
        """True, and counted, when no live row can match a probe whose
        rows' intervals lie inside [lo, hi] (None: not known): the store
        has no live row, or [lo, hi] misses bounds that hold for every
        live row. An unknown bound never skips; touching a bound runs."""
        skip = self._min_ts == _NO_ROWS or (
            lo is not None and hi is not None and self._max_ts is not None
            and (hi < self._probe_min_ts or lo > self._max_ts))
        self.stats["probes_skipped" if skip else "probes"] += 1
        return skip

    def _probe(self, keys: torch.Tensor, ts: Optional[torch.Tensor],
               lo_off: int = 0, hi_off: int = 0):
        out = list_probe(self.table, self.rows, self.counts,
                         keys.contiguous(),
                         None if ts is None else ts.contiguous(), lo_off,
                         hi_off, hint=self._probe_hint)
        self._probe_hint = max(self._probe_hint, out[0].numel())
        return out

    def probe_range(self, keys: torch.Tensor, ts: torch.Tensor,
                    lo_off: int, hi_off: int, ts_min: Optional[int] = None,
                    ts_max: Optional[int] = None):
        """For each key, its rows with ts in [ts + lo_off, ts + hi_off]:
        (batch row int64 [M], packed rows int64 [M, C]) on the device, in
        (batch row, list position) order. ``ts_min`` and ``ts_max``, bounds
        on the batch's ts, let a probe that cannot match skip its launch
        (with neither, only an empty store skips)."""
        if self._probe_skips(None if ts_min is None else ts_min + lo_off,
                             None if ts_max is None else ts_max + hi_off):
            return (torch.empty(0, dtype=torch.int64, device=self.device),
                    torch.empty((0, self.C), dtype=torch.int64,
                                device=self.device))
        bi, packed, _m = self._probe(keys, ts, lo_off, hi_off)
        return bi, packed

    def probe_batch(self, keys) -> tuple[np.ndarray, np.ndarray]:
        """(packed rows [B, L_eff, C], counts [B]) for a batch of keys, as
        the reference returns them: L_eff is the batch's longest list
        rounded up to a power of two, at most L. Positions at or past a
        key's count hold zeros here; mask them."""
        n = len(keys)
        if n == 0:
            return np.zeros((0, 0, self.C), np.int64), np.zeros(0, np.int32)
        if self._probe_skips(None, None):
            return np.zeros((n, 0, self.C), np.int64), np.zeros(n, np.int32)
        keys_t = (keys if isinstance(keys, torch.Tensor) else
                  torch.as_tensor(np.asarray(keys, np.int64))).to(
            self.device, torch.int64)
        bi, packed, m = self._probe(keys_t, None)
        counts = m.cpu().numpy()
        mx = int(counts.max())
        if mx == 0:
            return np.zeros((n, 0, self.C), np.int64), counts
        l_eff = min(1 << (mx - 1).bit_length(), self.L)
        out = np.zeros((n, l_eff, self.C), np.int64)
        bi_h = bi.cpu().numpy()
        start = np.cumsum(counts) - counts
        out[bi_h, np.arange(len(bi_h)) - start[bi_h]] = packed.cpu().numpy()
        return out, counts

    def prune(self, horizon: int) -> None:
        """Drop every row with ts < horizon (watermark cleanup). When dead
        keys (occupied slots whose lists emptied) dominate, the table is
        rebuilt without them, so an unbounded key domain cannot grow the
        device state without bound. Skipped when no row can drop: every
        live row is at the horizon or above, or there is none (the
        reference's prune then changes nothing and rebuilds nothing)."""
        if self._min_ts is not None and self._min_ts >= horizon:
            self.stats["prunes_skipped"] += 1
            return
        live = int(list_prune(self.rows, self.counts, self.tiles, self.hits,
                              int(horizon)))
        self.stats["prunes"] += 1
        if live:    # every live row is at the horizon or above
            self._min_ts = int(horizon)
            self._probe_min_ts = (int(horizon) if self._probe_min_ts is None
                                  else max(self._probe_min_ts, int(horizon)))
        else:
            self._min_ts = _NO_ROWS
            self._probe_min_ts = self._max_ts = None
        dead = self._occ - live
        if dead > 64 and dead * 2 > self._occ:
            self.stats["rebuilds"] += 1
            self._reload(self.capacity, live_only=True)

    def _rehash(self, new_capacity: int) -> None:
        self.stats["rehashes"] += 1
        self._reload(new_capacity, live_only=False)

    def _reload(self, capacity: int, live_only: bool) -> None:
        """Reinsert the occupied keys (``live_only``: those with a live
        row) into a fresh state of ``capacity`` slots. Their whole lists
        are gathered first and the old block is freed before the new one
        is made, so two blocks never coexist."""
        keep = self.table != EMPTY_KEY
        if live_only:
            keep &= self.counts > 0
        slots = torch.nonzero(keep).flatten()
        keys, rows, counts = self.table[slots], self.rows[slots], \
            self.counts[slots]
        self.table = self.rows = self.counts = self.hits = self.tiles = None
        del slots, keep
        self._load(capacity, keys, rows, counts)

    def _load(self, capacity: int, keys: torch.Tensor, rows: torch.Tensor,
              counts: torch.Tensor) -> None:
        self._alloc(capacity)
        self._occ = int(keys.numel())
        if not self._occ:
            return
        self.table, slots, ok = lookup_or_insert(self.table,
                                                 keys.contiguous())
        if not bool(ok.all()):  # pragma: no cover
            raise RuntimeError("device list rehash overflow")
        slots = slots.to(torch.int64)
        self.rows[slots] = rows
        self.counts[slots] = counts.to(torch.int32)
        self.tiles = tiles_from_counts(self.counts)

    # -- checkpointing -------------------------------------------------
    def snapshot(self) -> dict:
        slots = torch.nonzero(self.table != EMPTY_KEY).flatten()
        keys = self.table[slots].cpu().numpy()
        groups = key_groups_for_hash_batch(hash_batch(keys),
                                           self.max_parallelism)
        return {"kind": "tpu-list", "keys": keys, "key_groups": groups,
                "rows": self.rows[slots].cpu().numpy(),
                "counts": self.counts[slots].cpu().numpy(),
                "L": self.L, "C": self.C,
                "dtypes": [str(d) for d in self.col_dtypes]}

    @classmethod
    def from_snapshots(cls, key_group_range: KeyGroupRange,
                       max_parallelism: int, snapshots: list[dict],
                       rows_per_key: Optional[int] = None,
                       capacity: int = 1 << 12,
                       device=None) -> "DeviceListStore":
        """Rebuild a store purely from its snapshots; ``capacity`` honours
        the operator's pre-sizing."""
        dtypes = [np.dtype(d) for d in snapshots[0]["dtypes"]]
        L = rows_per_key or max(int(s["L"]) for s in snapshots)
        store = cls(key_group_range, max_parallelism, dtypes,
                    capacity=capacity,
                    rows_per_key=max(L, max(int(s["L"])
                                            for s in snapshots)),
                    device=device)
        store.restore(snapshots)
        return store

    def restore(self, snapshots: list[dict]) -> None:
        keys_parts, rows_parts, counts_parts = [], [], []
        for snap in snapshots:
            groups = np.asarray(snap["key_groups"])
            sel = np.array([g in self.key_group_range for g in groups],
                           bool)
            if snap["L"] > self.L or snap["C"] != self.C:
                raise RuntimeError(
                    "list-state snapshot shape mismatch: restore with "
                    f"rows_per_key >= {snap['L']} and the same columns")
            keys_parts.append(np.asarray(snap["keys"], np.int64)[sel])
            r = np.asarray(snap["rows"], np.int64)[sel]
            if snap["L"] < self.L:   # widen onto this store's row budget
                pad = np.zeros((len(r), self.L - snap["L"], self.C),
                               np.int64)
                r = np.concatenate([r, pad], axis=1)
            rows_parts.append(r)
            counts_parts.append(np.asarray(snap["counts"])[sel])
        keys = (np.concatenate(keys_parts) if keys_parts
                else np.empty(0, np.int64))
        cap = self.capacity
        while cap < 2 * max(len(keys), 1):
            cap *= 2
        rows = (np.concatenate(rows_parts) if rows_parts
                else np.empty((0, self.L, self.C), np.int64))
        counts = (np.concatenate(counts_parts) if counts_parts
                  else np.empty(0, np.int32))
        self.table = self.rows = self.counts = self.hits = self.tiles = None
        dev = self.device
        self._load(cap, torch.as_tensor(keys).to(dev),
                   torch.as_tensor(rows).to(dev),
                   torch.as_tensor(counts.astype(np.int32)).to(dev))
        self._min_ts = None if (counts > 0).any() else _NO_ROWS
        self._probe_min_ts = self._max_ts = None
