"""Live key-group rescale: migration planning and the page transfer
format (a copy of ``flink_tpu/parallel/rescale.py``, numpy on the host).

When the worker set of a mesh changes, its keyed window state is
re-sharded across the new mesh without a job restart. The transfer unit is
the checkpoint's key-group page: the keyed snapshot in (key group, key)
order cut into fixed spans of the max-parallelism key-group space, each
page verified by its digest (blake2b-128) before it is applied, so a page
that fails verification aborts the rescale instead of installing torn
state. Only pages whose key groups change owner count as moved. The
derived incremental fire planes are never shipped: the operator rebuilds
them from the pane planes after the switch, as after a restore.

The operator (``runtime/operators/mesh_window.py``) drives this over
snapshot dicts of its own ``snapshot`` format and owns the device state.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ..core.keygroups import KeyGroupRange

__all__ = ["KeyGroupPage", "MigrationPlan", "paginate_snapshot",
           "plan_migration", "reassemble_pages", "owners_of_groups"]


def owners_of_groups(groups: np.ndarray,
                     ranges: Sequence[KeyGroupRange]) -> np.ndarray:
    """Owning position index per key group under contiguous ``ranges``
    (the inverse of shard_ranges, vectorized; -1 = unowned)."""
    starts = np.array([r.start for r in ranges], np.int64)
    ends = np.array([r.end for r in ranges], np.int64)
    idx = np.searchsorted(starts, np.asarray(groups, np.int64),
                          side="right") - 1
    ok = (idx >= 0) & (np.asarray(groups, np.int64) <= ends[
        np.clip(idx, 0, len(ends) - 1)])
    return np.where(ok, idx, -1).astype(np.int32)


@dataclass(frozen=True)
class KeyGroupPage:
    """One fixed key-group span of a keyed snapshot: the rescale transfer
    unit, laid out exactly like a checkpoint key-group page so the two
    formats stay interchangeable (a rescale could stream pages straight
    out of the last retained checkpoint)."""
    index: int
    group_lo: int               # first key group of the span (inclusive)
    group_hi: int               # last key group of the span (inclusive)
    keys: np.ndarray            # [n] int64, sorted by (group, key)
    key_groups: np.ndarray      # [n] int32
    values: dict                # plane name -> [..., n] (last axis = key)
    digest: str                 # blake2b-128 over keys+groups+values

    @property
    def nbytes(self) -> int:
        return (self.keys.nbytes + self.key_groups.nbytes
                + sum(int(v.nbytes) for v in self.values.values()))


def _page_digest(keys: np.ndarray, groups: np.ndarray,
                 values: dict) -> str:
    h = hashlib.blake2b(digest_size=16)
    h.update(np.ascontiguousarray(keys).tobytes())
    h.update(np.ascontiguousarray(groups).tobytes())
    for name in sorted(values):
        h.update(name.encode())
        h.update(np.ascontiguousarray(values[name]).tobytes())
    return h.hexdigest()


def paginate_snapshot(snap: dict, n_pages: Optional[int] = None
                      ) -> list[KeyGroupPage]:
    """Cut a ``_snapshot_backend``-format dict into key-group pages:
    (key group, key) lexsort + equal spans of the max-parallelism space,
    byte-for-byte the checkpoint page layout (storage._page_tpu_snapshot),
    with the page content digest computed up front."""
    if n_pages is None:
        from ..checkpoint.storage import N_PAGES
        n_pages = N_PAGES
    keys = np.asarray(snap["keys"], np.int64)
    groups = np.asarray(snap["key_groups"], np.int32)
    mp = int(snap.get("max_parallelism") or
             (int(groups.max()) + 1 if len(groups) else 1))
    order = np.lexsort((keys, groups))
    keys, groups = keys[order], groups[order]
    span = (mp + n_pages - 1) // n_pages
    bounds = np.searchsorted(groups, np.arange(1, n_pages) * span)
    key_pages = np.split(keys, bounds)
    group_pages = np.split(groups, bounds)
    value_pages = {
        name: np.split(np.asarray(sd["values"])[..., order], bounds,
                       axis=-1)
        for name, sd in snap.get("states", {}).items()}
    pages = []
    for i in range(n_pages):
        vals = {name: np.ascontiguousarray(parts[i])
                for name, parts in value_pages.items()}
        pages.append(KeyGroupPage(
            index=i, group_lo=i * span,
            group_hi=min((i + 1) * span, mp) - 1,
            keys=key_pages[i], key_groups=group_pages[i], values=vals,
            digest=_page_digest(key_pages[i], group_pages[i], vals)))
    return pages


@dataclass(frozen=True)
class MigrationPlan:
    """What a rescale moves: per-page ownership diff of old vs new shard
    ranges. Pages not in ``moved_pages`` stay resident (every key group
    they hold keeps its owner); the metrics feed
    keygroups_migrated_total / rescale_bytes_moved_total."""
    old_ranges: tuple
    new_ranges: tuple
    pages: tuple                # all KeyGroupPages of the snapshot
    moved_pages: tuple          # indices of pages with >= 1 moved group
    keygroups_migrated: int     # distinct populated groups changing owner
    bytes_moved: int            # row bytes of the moved groups

    @property
    def moved(self) -> tuple:
        return tuple(self.pages[i] for i in self.moved_pages)


def plan_migration(snap: dict, old_ranges: Sequence[KeyGroupRange],
                   new_ranges: Sequence[KeyGroupRange],
                   n_pages: Optional[int] = None) -> MigrationPlan:
    """Diff key-group ownership between two shard layouts over the actual
    snapshot contents. Ownership is compared positionally when the device
    count is unchanged and by range membership otherwise — a group whose
    old owner index has no counterpart in the new layout always moves."""
    pages = paginate_snapshot(snap, n_pages)
    moved_idx, migrated, bytes_moved = [], set(), 0
    for page in pages:
        if len(page.key_groups) == 0:
            continue
        old_own = owners_of_groups(page.key_groups, old_ranges)
        new_own = owners_of_groups(page.key_groups, new_ranges)
        moved = old_own != new_own
        if not moved.any():
            continue
        moved_idx.append(page.index)
        migrated.update(int(g) for g in np.unique(
            page.key_groups[moved]))
        frac = int(moved.sum())
        n = len(page.key_groups)
        # row-exact bytes: keys/groups per moved row + the [..., n] value
        # planes' per-row slice
        bytes_moved += frac * (page.keys.itemsize
                               + page.key_groups.itemsize)
        for v in page.values.values():
            bytes_moved += int(v.nbytes // max(n, 1)) * frac
    return MigrationPlan(
        old_ranges=tuple(old_ranges), new_ranges=tuple(new_ranges),
        pages=tuple(pages), moved_pages=tuple(moved_idx),
        keygroups_migrated=len(migrated), bytes_moved=int(bytes_moved))


def reassemble_pages(pages: Sequence[KeyGroupPage], snap: dict) -> dict:
    """Rebuild a ``_snapshot_backend``-format dict from pages, verifying
    every page digest first (the checkpoint restore contract: corrupt
    transfer bytes abort the rescale before any state is installed)."""
    for page in pages:
        got = _page_digest(page.keys, page.key_groups, page.values)
        if got != page.digest:
            raise RuntimeError(
                f"rescale page {page.index} (key groups "
                f"[{page.group_lo}, {page.group_hi}]) failed digest "
                f"verification: {got} != {page.digest}")
    keys = np.concatenate([p.keys for p in pages]) if pages else \
        np.empty(0, np.int64)
    groups = np.concatenate([p.key_groups for p in pages]) if pages else \
        np.empty(0, np.int32)
    states = {}
    for name, sd in snap.get("states", {}).items():
        vals = (np.concatenate([p.values[name] for p in pages], axis=-1)
                if pages else np.asarray(sd["values"]))
        out = dict(sd)
        out["values"] = vals
        states[name] = out
    return {"kind": snap.get("kind", "tpu"), "keys": keys,
            "key_groups": groups,
            "max_parallelism": snap.get("max_parallelism"),
            "states": states}
