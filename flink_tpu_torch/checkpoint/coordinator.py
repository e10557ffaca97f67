"""Checkpoint coordinator: master-side snapshot orchestration (trimmed
port of ``flink_tpu/checkpoint/coordinator.py``).

* Every ``execution.checkpointing.interval`` seconds it injects a barrier
  at each source (through the source task's mailbox); barriers flow with
  the data, tasks align, snapshot and acknowledge here.
* A pending checkpoint completes when every task acknowledged; it is
  stored, and the one before it discarded (savepoints are kept). A
  failed store aborts it; so does the timeout.
* ``build_restore_map`` maps a completed checkpoint onto a (possibly
  rescaled) topology: every new subtask gets the keyed snapshots of all
  old subtasks of its vertex (backends keep their key-group range), and
  reader state maps 1:1 when the parallelism is unchanged.

One checkpoint is in flight at a time. Verification, quarantine and the
changelog store of the reference are not ported.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from ..core.config import Configuration
from ..core.elements import CheckpointBarrier
from .storage import CheckpointStorage, CompletedCheckpoint, \
    FsCheckpointStorage, MemoryCheckpointStorage, snapshot_nbytes

__all__ = ["CheckpointCoordinator", "build_restore_map"]

RETAINED = 1   # completed checkpoints kept (savepoints are not counted)


@dataclass
class _Pending:
    checkpoint_id: int
    started: float
    is_savepoint: bool
    # the task set at trigger time: completion never shrinks with it
    expected: frozenset = frozenset()
    acks: dict[str, dict] = field(default_factory=dict)
    ack_at: dict[str, float] = field(default_factory=dict)
    completed: Optional[CompletedCheckpoint] = None
    done: threading.Event = field(default_factory=threading.Event)


class CheckpointCoordinator:
    def __init__(self, job, config: Configuration,
                 storage: Optional[CheckpointStorage] = None):
        """``job`` exposes ``tasks``, ``source_tasks``, ``job_graph`` and
        a ``checkpoint_listener`` hook (a ``LocalJob``)."""
        self.job = job
        self.config = config
        directory = config.get("execution.checkpointing.dir")
        self.storage = storage or (FsCheckpointStorage(directory)
                                   if directory
                                   else MemoryCheckpointStorage())
        self.timeout = config.get("execution.checkpointing.timeout")
        self.interval = config.get("execution.checkpointing.interval")
        self._next_id = 1
        self._pending: dict[int, _Pending] = {}
        self._completed: list[CompletedCheckpoint] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: one record per finished checkpoint: duration, per-task
        #: barrier-to-ack seconds, store seconds, snapshot bytes
        self.stats: list[dict] = []
        job.checkpoint_listener = self._on_ack

    # -- trigger -----------------------------------------------------------
    def trigger_checkpoint(self, is_savepoint: bool = False) -> _Pending:
        """Inject a barrier at every source."""
        with self._lock:
            cid = self._next_id
            self._next_id += 1
            pending = _Pending(cid, time.time(), is_savepoint,
                               expected=frozenset(self.job.tasks))
            self._pending[cid] = pending
        barrier = CheckpointBarrier(cid, timestamp=pending.started,
                                    is_savepoint=is_savepoint)
        for st in self.job.source_tasks.values():
            st.trigger_checkpoint(barrier)
        return pending

    def trigger_savepoint(self, timeout: float = 60.0) -> CompletedCheckpoint:
        p = self.trigger_checkpoint(is_savepoint=True)
        if not p.done.wait(timeout):
            raise TimeoutError(f"savepoint {p.checkpoint_id} timed out")
        if p.completed is None:
            raise RuntimeError(f"savepoint {p.checkpoint_id} failed")
        return p.completed

    # -- acks --------------------------------------------------------------
    def _on_ack(self, task_id: str, checkpoint_id: int,
                snapshot: dict) -> None:
        complete = None
        with self._lock:
            p = self._pending.get(checkpoint_id)
            if p is None:
                return
            p.acks[task_id] = snapshot
            p.ack_at[task_id] = time.time()
            if set(p.acks) >= set(p.expected):
                del self._pending[checkpoint_id]
                complete = p
        if complete is not None:
            self._complete(complete)

    def _complete(self, p: _Pending) -> None:
        vertices = self.job.job_graph.vertices
        cp = CompletedCheckpoint(
            checkpoint_id=p.checkpoint_id, timestamp=p.started,
            task_snapshots=dict(p.acks), is_savepoint=p.is_savepoint,
            vertex_parallelism={vid: v.parallelism
                                for vid, v in vertices.items()},
            vertex_uids={vid: v.uid for vid, v in vertices.items()
                         if v.uid})
        t0 = time.time()
        try:
            cp = self.storage.store(cp)
        except Exception as e:  # noqa: BLE001 - a failed write aborts it
            with self._lock:
                self.stats.append({"id": p.checkpoint_id, "failed": True,
                                   "error": f"{type(e).__name__}: {e}"})
            p.done.set()
            return
        now = time.time()
        with self._lock:
            self._completed.append(cp)
            self._completed.sort(key=lambda c: c.checkpoint_id)
            self.stats.append({
                "id": p.checkpoint_id, "savepoint": p.is_savepoint,
                "duration_s": now - p.started,
                "barrier_to_ack_s": {t: at - p.started
                                     for t, at in p.ack_at.items()},
                "store_s": now - t0,
                "bytes": snapshot_nbytes(cp.task_snapshots),
                "tasks": len(p.acks)})
            regulars = [c for c in self._completed if not c.is_savepoint]
            while len(regulars) > RETAINED:
                old = regulars.pop(0)
                self._completed.remove(old)
                self.storage.discard(old)
        p.completed = cp
        p.done.set()

    def latest_checkpoint(self) -> Optional[CompletedCheckpoint]:
        with self._lock:
            return self._completed[-1] if self._completed else None

    # -- periodic loop -----------------------------------------------------
    def start_periodic(self) -> None:
        if self.interval <= 0 or self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop,
                                        name="checkpoint-coordinator",
                                        daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            now = time.time()
            with self._lock:
                for cid, p in list(self._pending.items()):
                    if now - p.started > self.timeout:
                        del self._pending[cid]
                        p.done.set()
                in_flight = len(self._pending)
            if in_flight:
                continue
            # a finished source cannot inject a barrier any more
            if not all(t.is_alive for t in self.job.source_tasks.values()):
                return
            self.trigger_checkpoint()

    def stop(self) -> None:
        self._stop.set()
        if (self._thread is not None
                and self._thread is not threading.current_thread()):
            self._thread.join(timeout=2.0)


def build_restore_map(checkpoint: CompletedCheckpoint,
                      job_graph) -> dict[str, dict]:
    """task id (``{vid}#{sub}``) -> {"reader": ..., "chain": {op key:
    {"keyed_list": [...], "operator": ...}}} for ``job_graph``. Vertices
    map by uid where the checkpoint recorded uids."""
    by_vertex: dict[str, dict[int, dict]] = {}
    for task_id, snap in checkpoint.task_snapshots.items():
        vid, sub = task_id.rsplit("#", 1)
        by_vertex.setdefault(vid, {})[int(sub)] = snap
    uid_to_old = {uid: vid
                  for vid, uid in (checkpoint.vertex_uids or {}).items()
                  if vid in by_vertex}

    restore: dict[str, dict] = {}
    for vid, vertex in job_graph.vertices.items():
        uid = getattr(vertex, "uid", "")
        if uid and uid in uid_to_old:
            old_vid = uid_to_old[uid]
        elif uid and checkpoint.vertex_uids:
            continue   # a raw id match would be another operator
        else:
            old_vid = vid
        old = by_vertex.get(old_vid)
        if not old:
            continue
        same_par = checkpoint.vertex_parallelism.get(
            old_vid, len(old)) == vertex.parallelism
        op_keys: set[str] = set()
        for snap in old.values():
            op_keys.update((snap.get("chain") or {}).keys())
        for sub in range(vertex.parallelism):
            task_snap: dict[str, Any] = {}
            if same_par and sub in old:
                task_snap["reader"] = old[sub].get("reader")
            chain_map: dict[str, dict] = {}
            for op_key in op_keys:
                keyed_list, operator_state = [], None
                for osub in sorted(old):
                    op_snap = (old[osub].get("chain") or {}).get(op_key) or {}
                    if op_snap.get("keyed") is not None:
                        keyed_list.append(op_snap["keyed"])
                    if same_par and osub == sub:
                        operator_state = op_snap.get("operator")
                chain_map[op_key] = {"keyed_list": keyed_list,
                                     "operator": operator_state}
            if chain_map:
                task_snap["chain"] = chain_map
            restore[f"{vid}#{sub}"] = task_snap
    return restore
