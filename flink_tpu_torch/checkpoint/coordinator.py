"""Checkpoint coordinator: master-side snapshot orchestration (trimmed
port of ``flink_tpu/checkpoint/coordinator.py``).

* Every ``execution.checkpointing.interval`` seconds it injects a barrier
  at each source (through the source task's mailbox); barriers flow with
  the data, tasks align, snapshot and acknowledge here.
* A pending checkpoint completes when every task acknowledged; it is
  stored, and those before the last ``execution.checkpointing.
  num-retained`` discarded (savepoints are kept). A task's decline (an
  unaligned checkpoint overtaken before its capture finished) aborts it
  at once; so do a failed store and the timeout. Every abort reaches the
  tasks' operators (``notify_checkpoint_aborted``), whose changelog
  backends drop the generation they pinned for it. A savepoint's
  changelog handles are rewritten into self-contained snapshots
  (``savepoint_self_contained``), so no truncation can reach it.
* A job with an iteration (feedback edges) takes no checkpoint.
* ``build_restore_map`` maps a completed checkpoint onto a (possibly
  rescaled) topology: every new subtask gets the keyed snapshots of all
  old subtasks of its vertex (backends keep their key-group range), and
  reader and operator state map 1:1 when the parallelism is unchanged;
  on a rescale the broadcast maps go to every new subtask
  (``redistribute_operator_state``). An unaligned checkpoint's in-flight
  batches (``inflight``, ``inflight1``, ``inflight2``) go to the same
  subtask; a rescale of a vertex that has some is refused, as in the
  reference.

* ``latest_verified_checkpoint`` is what a restart restores from: the
  newest retained checkpoint whose files pass their digests (on disk;
  in-memory storage has nothing to verify). One that fails is recorded
  on the job's failure history, moved aside and dropped, and the walk
  goes on to the next; when none verifies it raises. Each failure counts
  in ``DEVICE_STATS`` (``verify_failures_total``, which dumps the flight
  recorder as ``corrupt-artifact``), and a restore that skipped one in
  ``restore_fallbacks_total``.

With a ``tracer``, a checkpoint is one trace tree: its root
``checkpoint.Checkpoint`` span (trigger to completion) rides the barrier
as a wire context; the tasks' Align and Snapshot spans and the
coordinator's ``Store`` and ``Notify`` parent on it. A restore candidate's
selection is a ``restore.Restore`` span, with a ``restore.Fallback`` child
when it skipped a corrupt checkpoint.

One checkpoint is in flight at a time.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from ..core.config import Configuration
from ..core.elements import CheckpointBarrier
from ..metrics.device import DEVICE_STATS
from .storage import CheckpointStorage, CompletedCheckpoint, \
    CorruptArtifactError, FsCheckpointStorage, MemoryCheckpointStorage, \
    snapshot_nbytes, verify_checkpoint

__all__ = ["CheckpointCoordinator", "build_restore_map",
           "redistribute_operator_state", "savepoint_self_contained"]


def savepoint_self_contained(snapshots: dict, config: Configuration) -> dict:
    """Every ``changelog-dstl`` snapshot in ``snapshots`` rewritten into
    the inline ``changelog`` form (its base and the log past it embedded),
    so a savepoint outlives the changelog store's truncation."""
    import os
    import pickle

    from ..state.dstl import read_any_base, read_any_segment

    directory = config.get("execution.checkpointing.dir")
    root = os.path.join(directory, "changelog") if directory else None

    def rewrite(node):
        if isinstance(node, dict):
            if node.get("kind") == "changelog-dstl":
                base = None
                if node.get("base") is not None:
                    base = pickle.loads(read_any_base(
                        node["driver"], node["base"], root))
                base_seq = node.get("base_seq", 0)
                records: list = []
                for h in node.get("segments", []):
                    records.extend(read_any_segment(h, root))
                return {"kind": "changelog", "mat": base,
                        "log": [rec for seq, rec in sorted(records)
                                if seq > base_seq]}
            return {k: rewrite(v) for k, v in node.items()}
        if isinstance(node, list):
            return [rewrite(v) for v in node]
        return node

    return rewrite(snapshots)


@dataclass
class _Pending:
    checkpoint_id: int
    started: float
    is_savepoint: bool
    # the task set at trigger time: completion never shrinks with it
    expected: frozenset = frozenset()
    acks: dict[str, dict] = field(default_factory=dict)
    ack_at: dict[str, float] = field(default_factory=dict)
    declined: bool = False
    completed: Optional[CompletedCheckpoint] = None
    done: threading.Event = field(default_factory=threading.Event)
    # the open root span (metrics/tracing.SpanBuilder), with a tracer
    span: Any = None


class CheckpointCoordinator:
    def __init__(self, job, config: Configuration,
                 storage: Optional[CheckpointStorage] = None, tracer=None):
        """``job`` exposes ``tasks``, ``source_tasks``, ``job_graph`` and
        a ``checkpoint_listener`` hook (a ``LocalJob``); ``tracer`` (a
        ``metrics/tracing.Tracer``) receives each checkpoint's spans."""
        self.job = job
        self.config = config
        self.tracer = tracer
        directory = config.get("execution.checkpointing.dir")
        self.storage = storage or (FsCheckpointStorage(directory)
                                   if directory
                                   else MemoryCheckpointStorage())
        self.timeout = config.get("execution.checkpointing.timeout")
        self.interval = config.get("execution.checkpointing.interval")
        self.retained = max(1, config.get(
            "execution.checkpointing.num-retained"))
        self._next_id = 1
        self._pending: dict[int, _Pending] = {}
        self._completed: list[CompletedCheckpoint] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._paused = False
        self._thread: Optional[threading.Thread] = None
        #: checkpoints that failed verification before a restore
        self.verify_failures: list[dict] = []
        #: one record per finished checkpoint: duration, per-task
        #: barrier-to-ack seconds, store seconds, snapshot bytes
        self.stats: list[dict] = []
        job.checkpoint_listener = self._on_ack
        job.decline_listener = self._on_decline

    # -- trigger -----------------------------------------------------------
    def trigger_checkpoint(self, is_savepoint: bool = False) -> _Pending:
        """Inject a barrier at every source."""
        if any(e.feedback for e in self.job.job_graph.edges):
            # the back edge drops barriers: the head would align forever
            raise ValueError("iteration jobs (feedback edges) cannot be "
                             "checkpointed or savepointed")
        with self._lock:
            cid = self._next_id
            self._next_id += 1
            span = None
            if self.tracer is not None:
                span = (self.tracer.span("checkpoint", "Checkpoint")
                        .set_attribute("checkpointId", cid)
                        .set_attribute("savepoint", is_savepoint))
            pending = _Pending(cid, time.time(), is_savepoint,
                               expected=frozenset(self.job.tasks),
                               span=span)
            self._pending[cid] = pending
        barrier = CheckpointBarrier(
            cid, timestamp=pending.started, is_savepoint=is_savepoint,
            unaligned=bool(self.config.get(
                "execution.checkpointing.unaligned")),
            trace=span.context.to_wire() if span is not None else None)
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
        stale = False
        with self._lock:
            p = self._pending.get(checkpoint_id)
            if p is None:
                # a snapshot of an abandoned checkpoint landed after the
                # abort went out: abort again, so its pins are dropped
                stale = not any(c.checkpoint_id == checkpoint_id
                                for c in self._completed)
            else:
                p.acks[task_id] = snapshot
                p.ack_at[task_id] = time.time()
                if set(p.acks) >= set(p.expected):
                    del self._pending[checkpoint_id]
                    complete = p
        if stale:
            self._notify_aborted(checkpoint_id)
        elif complete is not None:
            self._complete(complete)

    def _on_decline(self, task_id: str, checkpoint_id: int,
                    reason: str) -> None:
        """A task cannot complete ``checkpoint_id``: abort it now."""
        with self._lock:
            p = self._pending.pop(checkpoint_id, None)
            if p is not None:
                self.stats.append({"id": checkpoint_id, "declined": True,
                                   "task": task_id, "reason": reason})
        if p is not None:
            p.declined = True
            p.done.set()
            if p.span is not None:
                p.span.set_attribute("aborted", True).set_attribute(
                    "declined_by", task_id).finish()
            self._notify_aborted(checkpoint_id)

    def _notify_aborted(self, checkpoint_id: int) -> None:
        """Tell every task's operators ``checkpoint_id`` will not
        complete."""
        for t in list(self.job.tasks.values()):
            t.execute_in_mailbox(
                lambda t=t, c=checkpoint_id: t.chain.notify_checkpoint_aborted(
                    c) if t.chain is not None else None)

    def _complete(self, p: _Pending) -> None:
        if p.is_savepoint:
            p.acks = savepoint_self_contained(p.acks, self.config)
        vertices = self.job.job_graph.vertices
        cp = CompletedCheckpoint(
            checkpoint_id=p.checkpoint_id, timestamp=p.started,
            task_snapshots=dict(p.acks), is_savepoint=p.is_savepoint,
            vertex_parallelism={vid: v.parallelism
                                for vid, v in vertices.items()},
            vertex_uids={vid: v.uid for vid, v in vertices.items()
                         if v.uid})
        store_sb = None
        if p.span is not None:
            store_sb = (self.tracer.span("checkpoint", "Store",
                                         parent=p.span.context)
                        .set_attribute("checkpointId", p.checkpoint_id))
        t0 = time.time()
        try:
            cp = self.storage.store(cp)
        except Exception as e:  # noqa: BLE001 - a failed write aborts it
            if store_sb is not None:
                store_sb.set_attribute("error", True).finish()
                p.span.set_attribute("error", True).set_attribute(
                    "aborted", True).finish()
            with self._lock:
                self.stats.append({"id": p.checkpoint_id, "failed": True,
                                   "error": f"{type(e).__name__}: {e}"})
            p.done.set()
            self._notify_aborted(p.checkpoint_id)
            return
        if store_sb is not None:
            store_sb.finish()
        now = time.time()
        with self._lock:
            self._completed.append(cp)
            self._completed.sort(key=lambda c: c.checkpoint_id)
            self.stats.append({
                "id": p.checkpoint_id, "savepoint": p.is_savepoint,
                "started": p.started,
                "duration_s": now - p.started,
                "barrier_to_ack_s": {t: at - p.started
                                     for t, at in p.ack_at.items()},
                "store_s": now - t0,
                "bytes": snapshot_nbytes(cp.task_snapshots),
                "bytes_written": getattr(self.storage, "last_bytes_written",
                                         None),
                "tasks": len(p.acks)})
            regulars = [c for c in self._completed if not c.is_savepoint]
            while len(regulars) > self.retained:
                old = regulars.pop(0)
                self._completed.remove(old)
                self.storage.discard(old)
        # tell every task (a two-phase sink commits on this)
        notify_sb = None
        if p.span is not None:
            notify_sb = (self.tracer.span("checkpoint", "Notify",
                                          parent=p.span.context)
                         .set_attribute("checkpointId", p.checkpoint_id)
                         .set_attribute("tasks", len(self.job.tasks)))
        for t in list(self.job.tasks.values()):
            t.execute_in_mailbox(
                lambda t=t: t.chain.notify_checkpoint_complete(
                    p.checkpoint_id, is_savepoint=p.is_savepoint)
                if t.chain is not None else None)
        if notify_sb is not None:
            notify_sb.finish()
        if p.span is not None:
            (p.span.set_attribute("tasks", len(p.acks))
             .set_start_ts(int(p.started * 1000))
             .set_attribute("duration_s", round(now - p.started, 6))
             .finish())
        p.completed = cp
        p.done.set()

    def latest_checkpoint(self) -> Optional[CompletedCheckpoint]:
        with self._lock:
            return self._completed[-1] if self._completed else None

    def latest_verified_checkpoint(self) -> Optional[CompletedCheckpoint]:
        """The newest retained checkpoint whose files pass their digests.
        Raises CorruptArtifactError when checkpoints were retained and
        none verifies: starting over would replay the stream past output
        already committed."""
        restore_sb = (self.tracer.span("restore", "Restore")
                      if self.tracer is not None else None)
        try:
            cand, skipped = self._verified_candidate()
        except BaseException:
            if restore_sb is not None:
                restore_sb.set_attribute("error", True).finish()
            raise
        if skipped:
            DEVICE_STATS.note_restore_fallback("checkpoint.restore")
            if restore_sb is not None:
                (self.tracer.span("restore", "Fallback",
                                  parent=restore_sb.context)
                 .set_attribute("checkpointId", cand.checkpoint_id)
                 .set_attribute("skipped", skipped)
                 .finish())
        if restore_sb is not None:
            if cand is not None:
                restore_sb.set_attribute("checkpointId", cand.checkpoint_id)
            restore_sb.set_attribute("skipped", skipped).finish()
        return cand

    def _verified_candidate(self) -> tuple:
        """(the newest verifying candidate or None, candidates skipped)."""
        skipped = 0
        while True:
            with self._lock:
                cand = self._completed[-1] if self._completed else None
            if cand is None:
                if skipped:
                    raise CorruptArtifactError(
                        f"all {skipped} retained checkpoints failed "
                        "verification; refusing to restore")
                return None, 0
            if (not isinstance(self.storage, FsCheckpointStorage)
                    or not cand.external_path):
                return cand, skipped
            try:
                verify_checkpoint(cand.external_path)
                return cand, skipped
            except CorruptArtifactError as e:
                skipped += 1
                DEVICE_STATS.note_verify_failure("checkpoint.restore")
                event = {"timestamp": time.time(),
                         "kind": "corrupt-artifact",
                         "checkpoint": cand.checkpoint_id,
                         "path": cand.external_path,
                         "error": f"{type(e).__name__}: {e}"}
                self.verify_failures.append(event)
                hist = getattr(self.job, "failure_history", None)
                if hist is not None:
                    hist.append(event)
                with self._lock:
                    if cand in self._completed:
                        self._completed.remove(cand)
                self.storage.quarantine(cand)

    def pause(self) -> None:
        """Trigger no periodic checkpoint until ``resume``, and abort the
        checkpoints in flight: a region restart removes tasks whose
        barriers can then never be acknowledged."""
        with self._lock:
            self._paused = True
            aborted = list(self._pending)
            for cid, p in list(self._pending.items()):
                del self._pending[cid]
                p.declined = True
                p.done.set()
                if p.span is not None:
                    p.span.set_attribute("aborted", True).finish()
        for cid in aborted:
            self._notify_aborted(cid)

    def resume(self) -> None:
        with self._lock:
            self._paused = False

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
            if self._paused:
                continue
            now = time.time()
            timed_out = []
            with self._lock:
                for cid, p in list(self._pending.items()):
                    if now - p.started > self.timeout:
                        del self._pending[cid]
                        p.done.set()
                        timed_out.append(cid)
                in_flight = len(self._pending)
            for cid in timed_out:
                self._notify_aborted(cid)
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


#: a task snapshot's in-flight batches of an unaligned checkpoint
_INFLIGHT = ("inflight", "inflight1", "inflight2")


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
        if not same_par and any(s.get(k) for s in old.values()
                                for k in _INFLIGHT):
            # channel state cannot be redistributed across parallelisms
            raise ValueError(
                f"cannot rescale vertex {vid} from an unaligned checkpoint "
                "with in-flight data; take an aligned checkpoint/savepoint "
                "first")
        op_keys: set[str] = set()
        for snap in old.values():
            op_keys.update((snap.get("chain") or {}).keys())
        # a rescale: the operator state that survives it, redistributed
        redistributed: dict[str, list] = {}
        if not same_par:
            for op_key in op_keys:
                redistributed[op_key] = redistribute_operator_state(
                    [op_snap for osub in sorted(old)
                     if (op_snap := ((old[osub].get("chain") or {})
                                     .get(op_key) or {}).get("operator"))
                     is not None], vertex.parallelism)
        for sub in range(vertex.parallelism):
            task_snap: dict[str, Any] = {}
            if same_par and sub in old:
                task_snap["reader"] = old[sub].get("reader")
                for k in _INFLIGHT:
                    if old[sub].get(k):
                        task_snap[k] = old[sub][k]
            chain_map: dict[str, dict] = {}
            for op_key in op_keys:
                keyed_list = []
                operator_state = (None if same_par
                                  else redistributed[op_key][sub])
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


def redistribute_operator_state(snapshots: list,
                                new_parallelism: int) -> list:
    """One operator's non-keyed snapshots, of the old subtasks, for each
    of ``new_parallelism`` new ones. Only the broadcast maps
    (``CoBroadcastWithKeyedOperator``) cross a rescale: every old subtask
    wrote an equal replica, so each new subtask takes the first (the
    reference's ``OperatorStateBackend.redistribute``, which ships
    broadcast state whole). Other operator state starts empty, as in the
    reference, whose split and union lists the port does not keep."""
    first = next((s["broadcast"] for s in snapshots if s.get("broadcast")),
                 None)
    if first is None:
        return [None] * new_parallelism
    return [{"broadcast": {n: dict(m) for n, m in first.items()}}
            for _ in range(new_parallelism)]
