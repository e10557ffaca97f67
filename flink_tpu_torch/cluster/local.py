"""Local deployment: run a JobGraph as threads in one process (trimmed
port of ``flink_tpu/cluster/local.py``).

Real channels, real barrier alignment, real keyed state: every (vertex,
subtask) becomes a task on a thread of its own, joined to its neighbours
by bounded channels. A two-input vertex gets one gate per logical input
(its in-edges' ``target_input``). ``run_job`` deploys, attaches the checkpoint
coordinator when ``execution.checkpointing.interval`` > 0, and runs to
the end of input.

A vertex whose fusion certificate (graph/fusion.py) carries a
``lowered_prefix`` arms the fused chain at both ends: the device reader
emits lazy batches and the window operator folds each with one dispatch
(runtime/compiled.py). The operator may decline for the reference's own
gates (deferred overflow off) and the reader for its own (no timestamp
column); ``LocalJob.fusion_declined`` records why.

The job's wall time runs from its first read to the end of input, with
the device drained, so events/s of a job is records / ``wall_s``.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import torch

from ..core.config import Configuration
from ..graph.stream_graph import JobGraph
from ..runtime.channels import InputGate, LocalChannel
from ..runtime.operators.base import OperatorChain, OperatorContext
from ..runtime.stream_task import OneInputStreamTask, SourceStreamTask, \
    StreamTask, TaskReporter, TwoInputStreamTask
from ..runtime.writer import RecordWriter

__all__ = ["LocalJob", "deploy_local", "run_job"]


class LocalJob(TaskReporter):
    """One running local job: its tasks, the reporter the tasks call, and
    the checkpoint coordinator's hook."""

    def __init__(self, job_graph: JobGraph, config: Configuration,
                 device: torch.device):
        self.job_graph = job_graph
        self.config = config
        self.device = torch.device(device)
        self.tasks: dict[str, StreamTask] = {}
        self.source_tasks: dict[str, SourceStreamTask] = {}
        self._finished: set[str] = set()
        self._failed: list[tuple[str, BaseException]] = []
        # a cancelled job's tasks unwind through task_finished; this flag
        # tells cancellation from completion
        self.cancelled = False
        self._lock = threading.Lock()
        self._done = threading.Event()
        self.checkpoint_listener: Optional[Callable] = None
        self.coordinator = None
        #: vertex id -> why the fused chain was not armed there
        self.fusion_declined: dict[str, str] = {}
        self._ended_at: Optional[float] = None

    # -- TaskReporter ------------------------------------------------------
    def acknowledge_checkpoint(self, task_id: str, checkpoint_id: int,
                               snapshot: dict) -> None:
        if self.checkpoint_listener is not None:
            self.checkpoint_listener(task_id, checkpoint_id, snapshot)

    def task_finished(self, task_id: str) -> None:
        with self._lock:
            self._finished.add(task_id)
            if len(self._finished) == len(self.tasks):
                self._done.set()

    def task_failed(self, task_id: str, error: BaseException) -> None:
        with self._lock:
            self._failed.append((task_id, error))
            self._done.set()

    # -- control -----------------------------------------------------------
    def start(self) -> None:
        for t in self.tasks.values():
            t.start()
        if self.coordinator is not None:
            self.coordinator.start_periodic()

    def cancel(self) -> None:
        self.cancelled = True
        if self.coordinator is not None:
            self.coordinator.stop()
        for t in self.tasks.values():
            t.cancel()
        for t in self.tasks.values():
            t.join(30)
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until every task finished (or one failed); raises on a
        task failure or the timeout."""
        try:
            if not self._done.wait(timeout):
                self.cancel()
                raise TimeoutError(f"job did not finish within {timeout}s")
            if self._failed:
                task_id, err = self._failed[0]
                self.cancel()
                raise RuntimeError(f"task {task_id} failed: {err!r}") from err
            for t in self.tasks.values():
                t.join()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._ended_at = time.perf_counter()
        finally:
            if self.coordinator is not None:
                self.coordinator.stop()

    @property
    def failed(self) -> bool:
        return bool(self._failed)

    # -- what a caller reads after the run ---------------------------------
    @property
    def operators(self) -> list:
        """Every task's chained operators, vertices in topological order."""
        out = []
        for v in self.job_graph.topological_order():
            for sub in range(v.parallelism):
                chain = self.tasks[f"{v.id}#{sub}"].chain
                out.extend(chain.operators if chain is not None else ())
        return out

    @property
    def first_read_at(self) -> Optional[float]:
        starts = [t.first_read_at for t in self.source_tasks.values()
                  if t.first_read_at is not None]
        return min(starts) if starts else None

    @property
    def wall_s(self) -> float:
        """Seconds from the first read to the end of input (device
        drained)."""
        if self._ended_at is None or self.first_read_at is None:
            return 0.0
        return self._ended_at - self.first_read_at

    @property
    def records_in(self) -> int:
        return sum(t.records_in for t in self.source_tasks.values())


def deploy_local(job_graph: JobGraph, config: Configuration,
                 device: torch.device,
                 restored_state: Optional[dict] = None) -> LocalJob:
    """Channels, gates, writers, chains and tasks for every (vertex,
    subtask); a checkpoint coordinator when checkpointing is on. Nothing
    runs until ``job.start()``."""
    job = LocalJob(job_graph, config, device)
    # channels[edge index][src sub][dst sub]
    channels: dict[int, list[list[LocalChannel]]] = {}
    for ei, e in enumerate(job_graph.edges):
        src = job_graph.vertices[e.source_vertex]
        dst = job_graph.vertices[e.target_vertex]
        channels[ei] = [[LocalChannel() for _ in range(dst.parallelism)]
                        for _ in range(src.parallelism)]
    _deploy_vertices(job, job_graph, config, channels, restored_state)
    if config.get("execution.checkpointing.interval") > 0:
        from ..checkpoint.coordinator import CheckpointCoordinator
        job.coordinator = CheckpointCoordinator(job, config)
    return job


def _deploy_vertices(job: LocalJob, job_graph: JobGraph,
                     config: Configuration, channels: dict,
                     restored_state: Optional[dict]) -> None:
    aligned = config.get("execution.checkpointing.mode") == "exactly-once"
    cert = job_graph.certificate
    for vid, vertex in job_graph.vertices.items():
        out_edges = [(ei, e) for ei, e in enumerate(job_graph.edges)
                     if e.source_vertex == vid]
        in_edges = [(ei, e) for ei, e in enumerate(job_graph.edges)
                    if e.target_vertex == vid]
        for sub in range(vertex.parallelism):
            task_id = f"{vid}#{sub}"
            ctx = OperatorContext(
                task_name=vertex.name, subtask_index=sub,
                parallelism=vertex.parallelism,
                max_parallelism=vertex.max_parallelism, config=config)
            if any(e.side_tag is not None for _ei, e in out_edges):
                raise NotImplementedError("the port has no side outputs")
            writers = [RecordWriter(channels[ei][sub],
                                    e.partitioner_factory(), sub)
                       for ei, e in out_edges]
            snapshot = (restored_state or {}).get(task_id)
            if vertex.kind == "source":
                src_node = vertex.chained_nodes[0]
                ops = [n.operator_factory() for n in vertex.chained_nodes[1:]]
                reader = _make_reader(src_node, sub, vertex.parallelism,
                                      job.device)
                rep = cert.chain_for_vertex(vid) if cert is not None else None
                if rep is not None and rep.lowered_prefix and ops:
                    why = _arm_fused_chain(ops[0], reader, src_node.source,
                                           sub, vertex.parallelism)
                    if why:
                        job.fusion_declined[vid] = why
                task = SourceStreamTask(task_id, ctx, reader,
                                        src_node.watermark_strategy, writers,
                                        job, config)
                if ops:
                    task.chain = OperatorChain(ops, ctx,
                                               task.make_tail_output())
                job.source_tasks[task_id] = task
            elif vertex.kind == "two_input":
                per_input: list[list] = [[], []]
                for ei, e in in_edges:
                    per_input[e.target_input].extend(
                        channels[ei][s][sub] for s in range(len(channels[ei])))
                task = TwoInputStreamTask(
                    task_id, ctx, InputGate(per_input[0], aligned=aligned),
                    InputGate(per_input[1], aligned=aligned), writers, job,
                    config)
                task.chain = OperatorChain(
                    [n.operator_factory() for n in vertex.chained_nodes],
                    ctx, task.make_tail_output())
            else:
                in_channels = [channels[ei][s][sub] for ei, _e in in_edges
                               for s in range(len(channels[ei]))]
                task = OneInputStreamTask(
                    task_id, ctx, InputGate(in_channels, aligned=aligned),
                    writers, job, config)
                task.chain = OperatorChain(
                    [n.operator_factory() for n in vertex.chained_nodes],
                    ctx, task.make_tail_output())
            if snapshot:
                task.restore_state(snapshot)
            job.tasks[task_id] = task


def _arm_fused_chain(op, reader, source, subtask: int,
                     parallelism: int) -> Optional[str]:
    """Arm a certified source -> window prefix at both ends; returns why
    it was declined (None: armed). No fallback is chosen here: an armed
    chain captures and replays on the card, or raises."""
    if not hasattr(op, "enable_fused_chain"):
        return f"the chain's head {type(op).__name__} has no fused step"
    if not op.enable_fused_chain(source, subtask, parallelism):
        return "deferred overflow is off on the window operator"
    if not (hasattr(reader, "enable_fused") and reader.enable_fused()):
        op.disable_fused_chain()
        return "the source has no device reader with a timestamp column"
    return None


def _make_reader(src_node, subtask: int, parallelism: int,
                 device: torch.device):
    source = src_node.source
    splits = source.create_splits(parallelism)
    reader = source.create_reader(splits[subtask], device)
    reader._parallelism = parallelism
    return reader


def run_job(job_graph: JobGraph, config: Configuration, device: torch.device,
            timeout: Optional[float] = None,
            restored_state: Optional[dict] = None) -> LocalJob:
    """Deploy, start (with periodic checkpoints when configured), and run
    to the end of input."""
    job = deploy_local(job_graph, config, device, restored_state)
    job.start()
    job.wait(timeout)
    return job
