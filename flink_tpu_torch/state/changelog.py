"""The changelog state backend, ``changelog`` (port of
``flink_tpu/state/changelog.py``): checkpoints whose bytes follow the
change rate, through the durable log of ``state/dstl.py``.

It is the heap backend (``state/heap.py``) with every mutation also
appended to a ``ChangelogWriter``: a put as ``("put", state, key group,
pickle((key, namespace, value)), expiry)``, a removal as ``("rm", ...)``.
A change is pickled when it is appended, so the log never shares a live
value. A checkpoint writes the buffered changes as a segment and ships
``{"kind": "changelog-dstl", driver, base, base_seq, mat_id, segments}``:
a handle to the materialized base and the handles of the segments past
it.

* Materialization: the first checkpoint, and every
  ``state.backend.changelog.materialization-interval`` checkpoints after
  it, write the heap snapshot (``super().snapshot``, list and map values
  copied) once as the new base; later checkpoints share it by handle.
* Truncation follows subsumption, never a snapshot attempt: a superseded
  generation's base and segments retire, and are deleted only when a
  completed checkpoint shows that every checkpoint the coordinator may
  still serve (``execution.checkpointing.num-retained``) and every
  snapshot still in flight references a newer generation. Each snapshot
  pins its generation until its completion or abort is notified; a
  completed savepoint pins nothing (the coordinator inlines it).
* Restore reads the base, replays the segments' records past
  ``base_seq`` in seq order, and keeps the key groups of its own range,
  so a rescale restores as a full snapshot does. The inline
  ``{"kind": "changelog", mat, log}`` form (a savepoint's, and older
  snapshots') and any other backend's snapshot restore too.
"""

from __future__ import annotations

import pickle
import time
import uuid
from typing import Any, Iterable, Optional

from ..core.keygroups import KeyGroupRange
from .backend import register_backend
from .descriptors import StateDescriptor
from .dstl import ChangelogWriter, changelog_storage_for, read_any_base, \
    read_any_segment
from .heap import HeapKeyedStateBackend, _Entry

__all__ = ["ChangelogKeyedStateBackend"]


class ChangelogKeyedStateBackend(HeapKeyedStateBackend):
    def __init__(self, key_group_range: KeyGroupRange, max_parallelism: int,
                 config=None, materialization_interval: Optional[int] = None,
                 flush_bytes: int = 1 << 20, **kwargs):
        super().__init__(key_group_range, max_parallelism, **kwargs)
        if materialization_interval is None:
            materialization_interval = 10 if config is None else config.get(
                "state.backend.changelog.materialization-interval")
        self._mat_interval = max(1, int(materialization_interval))
        self._store = changelog_storage_for(config)
        self._writer = ChangelogWriter(self._store, flush_bytes=flush_bytes)
        self._base_location: Optional[str] = None   # the live base
        self._base_seq = 0                          # log seq it covers
        self._mat_id = 0
        self._checkpoints_since_mat = 0
        #: materializations written (bases)
        self.materializations = 0
        retained = 1 if config is None else config.get(
            "execution.checkpointing.num-retained")
        self._retained = max(1, int(retained))
        self._retired: list[tuple[int, str, list]] = []  # (gen, base, segs)
        self._ckpt_gen: dict[int, int] = {}     # snapshot cid -> generation
        self._completed_gens: list[tuple[int, int]] = []  # (cid, gen)

    # -- logged mutations --------------------------------------------------
    def _put(self, desc: StateDescriptor, value: Any) -> None:
        super()._put(desc, value)
        payload = pickle.dumps(
            (self._current_key, self._current_namespace, value),
            protocol=pickle.HIGHEST_PROTOCOL)
        self._writer.append(
            ("put", desc.name, self._current_key_group, payload,
             time.time() + desc.ttl.ttl if desc.ttl else None),
            len(payload))

    def _remove(self, desc: StateDescriptor) -> None:
        super()._remove(desc)
        payload = pickle.dumps((self._current_key, self._current_namespace),
                               protocol=pickle.HIGHEST_PROTOCOL)
        self._writer.append(
            ("rm", desc.name, self._current_key_group, payload, None),
            len(payload))

    @property
    def bytes_uploaded(self) -> int:
        return self._writer.bytes_uploaded

    # -- checkpointing -----------------------------------------------------
    def materialize(self, checkpoint_id: int) -> None:
        """Write the heap snapshot once as the new base. The previous
        generation's base and covered segments retire; they are deleted
        once no servable checkpoint references them."""
        prev_gen = self._mat_id
        self._mat_id += 1
        self.materializations += 1
        base = super().snapshot(checkpoint_id)
        prev_base = self._base_location
        # the key-group range and a nonce: subtasks share one store
        base_id = (f"kg{self.key_group_range.start}-"
                   f"{self.key_group_range.end}-m{self._mat_id}-"
                   f"c{checkpoint_id}-{uuid.uuid4().hex[:8]}")
        self._base_location = self._store.write_base(
            base_id, pickle.dumps(base, protocol=pickle.HIGHEST_PROTOCOL))
        self._base_seq = self._writer.last_seq
        self._writer.drop_buffered()   # the base covers them
        covered = self._writer.detach(self._base_seq)
        if prev_base is not None:
            self._retired.append((prev_gen, prev_base, covered))
        else:
            # no checkpoint referenced segments from before the first base
            for h in covered:
                self._store.delete_segment(h)
        self._checkpoints_since_mat = 0

    def snapshot(self, checkpoint_id: int) -> dict:
        if self._base_location is None \
                or self._checkpoints_since_mat >= self._mat_interval:
            self.materialize(checkpoint_id)
        self._checkpoints_since_mat += 1
        segments = self._writer.persist(self._base_seq)
        # the pin is released only by a completion or abort notice
        self._ckpt_gen[checkpoint_id] = self._mat_id
        return {"kind": "changelog-dstl",
                "driver": self._store.driver,
                "base": self._base_location,
                "base_seq": self._base_seq,
                "mat_id": self._mat_id,
                "segments": [dict(h.__dict__) for h in segments]}

    def notify_checkpoint_complete(self, checkpoint_id: int,
                                   is_savepoint: bool = False) -> None:
        gen = self._ckpt_gen.pop(checkpoint_id, None)
        if gen is None or is_savepoint:
            # a completed savepoint is self-contained and out of the
            # regular retention: it pins nothing and evicts no pin
            return
        self._completed_gens.append((checkpoint_id, gen))
        self._completed_gens = self._completed_gens[-self._retained:]
        min_live = min(g for _cid, g in self._completed_gens)
        if self._ckpt_gen:
            # snapshots in flight pin their generation too
            min_live = min(min_live, min(self._ckpt_gen.values()))
        keep = []
        for gen_, loc, segments in self._retired:
            if gen_ < min_live:
                self._store.delete_base(loc)
                for h in segments:
                    self._store.delete_segment(h)
            else:
                keep.append((gen_, loc, segments))
        self._retired = keep

    def notify_checkpoint_aborted(self, checkpoint_id: int) -> None:
        self._ckpt_gen.pop(checkpoint_id, None)

    def restore(self, snapshots: Iterable[dict]) -> None:
        bases, replogs, plain = [], [], []
        root = getattr(self._store, "dir", None)
        for snap in snapshots:
            kind = snap.get("kind")
            if kind == "changelog-dstl":
                sers = None
                if snap.get("base") is not None:
                    base = pickle.loads(read_any_base(
                        snap["driver"], snap["base"], root))
                    sers = base.get("serializers")
                    bases.append(base)
                records: list = []
                for h in snap.get("segments", []):
                    records.extend(read_any_segment(h, root))
                replogs.append((snap.get("base_seq", 0), records, sers))
            elif kind == "changelog":   # the inline form
                mat = snap.get("mat")
                if mat is not None:
                    bases.append(mat)
                replogs.append((0, list(enumerate(snap.get("log", []), 1)),
                                (mat or {}).get("serializers")))
            else:
                plain.append(snap)      # another backend's snapshot
        super().restore(bases + plain)
        for base_seq, records, sers in replogs:
            # a segment may start before the base (flushed early): replay
            # the records past it, in seq order, migrated as the base's
            migrations: dict = {}
            for seq, rec in sorted(records, key=lambda r: r[0]):
                if seq > base_seq:
                    self._apply(rec, sers, migrations)
        # the restored state is the new base: materialize at first snapshot
        self._base_location = None
        self._base_seq = self._writer.last_seq
        self._checkpoints_since_mat = 0

    def _apply(self, rec: tuple, snap_sers: Optional[dict],
               migrations: dict) -> None:
        op, name, kg, payload, expiry = rec
        if int(kg) not in self.key_group_range:
            return
        table = self._table(name).setdefault(int(kg), {})
        if op == "put":
            key, ns, value = pickle.loads(payload)
            if name not in migrations:
                migrations[name] = self._value_migration(name, snap_sers)
            if migrations[name] is not None:
                value = migrations[name](value)
            table[(key, ns)] = _Entry(value, expiry)
        else:
            key, ns = pickle.loads(payload)
            table.pop((key, ns), None)


register_backend("changelog", ChangelogKeyedStateBackend)
