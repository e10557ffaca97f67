"""Job supervisor: deploy, watch, checkpoint and restart on failure
(trimmed port of ``flink_tpu/cluster/scheduler.py``).

Flink's scheduler for a local job: a failed task cancels the attempt, the
restart strategy (``cluster/failover.py``) decides, and the job deploys
anew with every task restored from the latest verified checkpoint
(``CheckpointCoordinator.latest_verified_checkpoint``). When the failed
tasks' pipelined regions (``cluster/regions.py``) do not span the whole
job, only those regions restart, inside the running job, and the others
keep their state. Each attempt runs a ``TaskStallDetector``, so a task
that stalls with queued input takes the same path. Checkpoint ids keep
rising across attempts.

A restarted attempt never holds the old attempt's state: the old job's
tasks are joined and their chains dropped (``LocalJob.release``) and the
cyclic collector runs before the new attempt deploys.

``rescale`` takes a savepoint, rewrites the parallelism of some vertices
and deploys again from it: ``build_restore_map`` gives every new subtask
all old keyed snapshots of its vertex, and each backend keeps the key
groups of its own range, so keyed state re-splits across the new
parallelism. Reader positions map only where a vertex keeps its
parallelism (rescale a keyed vertex, not a source), and a device batch
cannot be split by key group across subtasks yet: rescale the parallelism
of jobs of host batches. ``mesh_devices`` re-splits a mesh job's device
state too: each mesh operator restores from the savepoint and re-shards
it across its new shard count before the job starts.

A restart of the whole job is a ``restart.JobRestart`` span (cancel,
release, backoff) and a flight-recorder dump (``job-restart``) written
once the span has ended.
"""

from __future__ import annotations

import gc
import time
from collections import deque
from typing import Optional

import torch

from ..checkpoint.coordinator import build_restore_map
from ..checkpoint.storage import CompletedCheckpoint
from ..core.config import Configuration
from ..graph.stream_graph import JobGraph
from .failover import restart_strategy_from_config
from .local import LocalJob, deploy_local

__all__ = ["JobSupervisor"]


class JobSupervisor:
    """Runs a JobGraph to its end across failures."""

    def __init__(self, job_graph: JobGraph, config: Configuration,
                 device: torch.device):
        self.job_graph = job_graph
        self.config = config
        self.device = torch.device(device)
        self.restart_strategy = restart_strategy_from_config(config)
        self.attempt = 0
        self.current_job: Optional[LocalJob] = None
        self._rescaling = False   # a rescale swaps the job in run()'s hands
        self._detector = None
        self._latest: Optional[CompletedCheckpoint] = None
        #: (attempt, error message) per failure
        self.failures: list[tuple[int, str]] = []
        #: one history across every attempt: task failures, restarts
        self.failure_history: deque = deque(maxlen=64)
        #: seconds from each failure to the next attempt's start
        self.restart_s: list[float] = []

    @property
    def coordinator(self):
        return self.current_job.coordinator if self.current_job else None

    # -- lifecycle ---------------------------------------------------------
    def _deploy(self, restore: Optional[CompletedCheckpoint]) -> LocalJob:
        from ..runtime.watchdog import TaskStallDetector

        restored_state = (build_restore_map(restore, self.job_graph)
                          if restore else None)
        job = deploy_local(self.job_graph, self.config, self.device,
                           restored_state=restored_state)
        job.failure_history = self.failure_history
        if job.coordinator is not None and self._latest is not None:
            # checkpoint ids keep rising across attempts
            job.coordinator._next_id = self._latest.checkpoint_id + 1
        if self._detector is not None:
            self._detector.stop()
        self._detector = TaskStallDetector(
            job, float(self.config.get("task.stall-timeout")))
        self.current_job = job
        return job

    def _stop_supervision(self, job: LocalJob) -> None:
        if self._detector is not None:
            self._detector.stop()
        if job.coordinator is not None:
            job.coordinator.stop()

    def _latest_verified(self, job: LocalJob
                         ) -> Optional[CompletedCheckpoint]:
        if job.coordinator is None:
            return None
        return job.coordinator.latest_verified_checkpoint()

    def run(self, timeout: Optional[float] = None,
            initial_restore: Optional[CompletedCheckpoint] = None
            ) -> LocalJob:
        """Run to the end of input, restarting on failures; raises when
        the restart strategy gives up or ``timeout`` passes.
        ``initial_restore`` starts the first attempt from a checkpoint."""
        deadline = None if timeout is None else time.time() + timeout
        restore = initial_restore
        if initial_restore is not None:
            self._latest = initial_restore
        while True:
            self.attempt += 1
            job = self._deploy(restore)
            job.start()
            self._detector.start()
            try:
                while True:
                    remaining = (None if deadline is None
                                 else max(deadline - time.time(), 0.1))
                    if deadline is not None and time.time() >= deadline:
                        job.cancel()
                        raise TimeoutError(
                            f"job did not finish within {timeout}s")
                    if not job.wait_event(remaining):
                        continue
                    if job.current_failures() and \
                            self._try_region_restart(job):
                        continue
                    job.wait(0.1)  # raises on a failure
                    if self.current_job is job and not self._rescaling:
                        break
                    if self.current_job is not job:
                        # rescale() swapped in a new deployment
                        job = self.current_job
                    else:
                        time.sleep(0.05)   # the swap is under way
                self._stop_supervision(job)
                return job
            except TimeoutError:
                self._stop_supervision(job)
                raise
            except RuntimeError as e:
                t_fail = time.perf_counter()
                self._stop_supervision(job)
                latest = self._latest_verified(job)
                if latest is not None:
                    self._latest = latest
                self.failures.append((self.attempt, str(e)))
                self.restart_strategy.notify_failure()
                if not self.restart_strategy.can_restart():
                    self.failure_history.append({
                        "timestamp": time.time(), "attempt": self.attempt,
                        "kind": "terminal-failure", "error": str(e)})
                    raise RuntimeError(
                        f"job failed terminally after {self.attempt} "
                        f"attempts: {e}") from e
                self.failure_history.append({
                    "timestamp": time.time(), "attempt": self.attempt,
                    "kind": "restart", "error": str(e),
                    "restored_checkpoint": (self._latest.checkpoint_id
                                            if self._latest else None)})
                from ..metrics.tracing import TRACER, dump_flight_recorder
                restart_sb = (TRACER.span("restart", "JobRestart")
                              .set_attribute("job", self.job_graph.name)
                              .set_attribute("attempt", self.attempt)
                              .set_attribute("restored",
                                             self._latest.checkpoint_id
                                             if self._latest else None))
                job.cancel()
                # the old attempt's device state goes before the new one
                # deploys
                job.release()
                gc.collect()
                time.sleep(self.restart_strategy.backoff_seconds())
                restore = self._latest
                # the span ends before the dump reads the ring, so the
                # dump's tail holds it (the reference dumps first)
                restart_sb.finish()
                dump_flight_recorder(
                    "job-restart", job=self.job_graph.name,
                    attempt=self.attempt, error=str(e))
                self.restart_s.append(time.perf_counter() - t_fail)

    def _try_region_restart(self, job: LocalJob) -> bool:
        """Restart only the failed tasks' regions, from the latest
        verified checkpoint, when they do not span the whole job; True
        when handled."""
        from .local import restart_region
        from .regions import affected_vertices, compute_regions

        failed = job.current_failures()
        if not failed:
            return False
        regions = compute_regions(self.job_graph)
        if len(regions) <= 1:
            return False
        vids = affected_vertices(regions, [tid for tid, _e in failed])
        if vids >= set(self.job_graph.vertices):
            return False
        t_fail = time.perf_counter()
        self.restart_strategy.notify_failure()
        if not self.restart_strategy.can_restart():
            return False
        self.failures.append((self.attempt, str(failed[0][1])))
        self.failure_history.append({
            "timestamp": time.time(), "attempt": self.attempt,
            "kind": "region-restart", "error": str(failed[0][1]),
            "vertices": sorted(vids)})
        latest = self._latest_verified(job)
        restored = {}
        if latest is not None:
            self._latest = latest
            restored = {tid: snap for tid, snap in build_restore_map(
                latest, self.job_graph).items()
                if tid.rsplit("#", 1)[0] in vids}
        if job.coordinator is not None:
            job.coordinator.pause()
        try:
            time.sleep(self.restart_strategy.backoff_seconds())
            # the restarted region's libraries come from the build cache
            # when it is on (a no-op for libraries already open)
            from ..runtime.aot import AOT
            if AOT.enabled:
                AOT.warmup()
            restart_region(job, self.job_graph, self.config, vids, restored)
        finally:
            if job.coordinator is not None:
                job.coordinator.resume()
        self.restart_s.append(time.perf_counter() - t_fail)
        return True

    # -- rescaling ---------------------------------------------------------
    def rescale(self, vertex_parallelism: dict[str, int],
                timeout: float = 60.0,
                mesh_devices: Optional[int] = None) -> None:
        """Stop with a savepoint, set the vertices' parallelism, and
        deploy again from the savepoint; with ``mesh_devices``, every mesh
        operator re-shards its restored state across that many shards
        before the new attempt starts. Call it from a thread other than
        the job's and ``run``'s."""
        job = self.current_job
        sp = job.coordinator.trigger_savepoint(timeout)
        self._rescaling = True
        try:
            self._stop_supervision(job)
            job.cancel()
            for vid, par in vertex_parallelism.items():
                self.job_graph.vertices[vid].parallelism = par
            self._latest = sp
            new = self._deploy(sp)
            if mesh_devices is not None:
                for op in new.operators:
                    if hasattr(op, "rescale_live"):
                        op.rescale_live(mesh_devices)
            new.start()
            self._detector.start()
        finally:
            self._rescaling = False
