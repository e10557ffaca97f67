"""Stream tasks: the per-subtask execution loop (port of
``flink_tpu/runtime/stream_task.py``).

One thread per subtask alternates between its default action (read a
batch, or process one input event) and mails (checkpoint triggers from
the coordinator), so operators never see concurrency.

* ``SourceStreamTask`` reads its source, assigns timestamps, runs its
  chained operators (or writes downstream), and emits the watermark every
  ``pipeline.auto-watermark-interval`` seconds of wall time (0: after
  every batch) and a latency marker every ``metrics.latency.interval``
  seconds (0: none). A checkpoint barrier is injected here: broadcast
  downstream first, then the reader's position and the chain are
  snapshotted and acknowledged.
  - Watermark alignment: a source whose strategy names an alignment group
    registers with the job's ``WatermarkAlignmentCoordinator`` at deploy
    time (at the minimum, so no group mate runs ahead before its first
    report), reports its watermark every turn, pauses reading 1 ms at a
    time while it is past the group's minimum plus the drift (counted in
    ``alignment_pauses``, the largest overshoot in
    ``alignment_max_overshoot_ms``; its chain's processing time still
    advances), and unregisters when it ends.
  - Adaptive batch sizes (``pipeline.adaptive-batch-size``): the next
    batch's size moves halfway toward throughput x target latency,
    clamped to [min, max]; ``batch_size_history`` keeps the sizes.
* ``OneInputStreamTask`` polls its input gate. An aligned barrier is
  broadcast downstream, then the chain is snapshotted and acknowledged.
  An unaligned one (the gate fired it ahead of other channels' queued
  batches) is broadcast and snapshotted at once, and acknowledged when
  the gate's capture completed, with the captured batches under
  ``"inflight"``; a newer barrier arriving before that declines the older
  checkpoint.
* ``TwoInputStreamTask`` polls two gates, one per logical input, in
  turns. Aligned, each gate aligns over its own channels and the snapshot
  waits for both gates' barriers of one checkpoint (a gate whose input
  ended holds none back). Unaligned, the first barrier on either gate
  snapshots at once and starts a capture on the other gate; the ack
  waits for both captures (``"inflight1"``, ``"inflight2"``).
* A restored task replays its in-flight batches before any new input.
* At the end of a bounded input the MAX watermark flushes event time, the
  chain finishes, and ``EndOfInput`` closes every output channel.
* Every loop turn, and every idle wait, advances the chain's processing
  time to the task's clock, which fires processing-time timers.
* A side output's writers (``get_side_output(tag)``) get the chain's
  tagged batches; watermarks, latency markers, barriers and end of input
  go to them too.
* ``TaskIOTimers`` keeps the loop's busy, idle and backpressured seconds
  (the reference's busy/idle/backPressuredTimeMsPerSecond, cumulative
  over the run).
* Spans (``metrics/tracing.py``): a source's read-and-emit cycle is a
  ``task.SourceBatch`` span; a barrier's alignment at a task is a
  ``checkpoint.Align`` span and its snapshot up to the acknowledgement a
  ``checkpoint.Snapshot`` span, both parented on the coordinator's
  context the barrier carries (an unaligned snapshot's span ends when the
  state is taken, marked ``unaligned``). The two-input task's unaligned
  path has both spans too, which the reference's lacks.

Every task of one job runs on the device's default stream, so a device
batch made on a source thread is consumed in order on the window thread.
Each loop bumps the task's progress epoch once per event it handled
(``runtime/watchdog.py``): a task whose epoch stalls while its input
holds queued data is failed by the job's stall detector. Admission under
multi-tenant isolation waits for ``cluster/isolation.py`` (item 10,
group 8).
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Callable, Optional

from ..core.config import Configuration
from ..core.elements import MAX_WATERMARK, CheckpointBarrier, EndOfInput, \
    LatencyMarker, Watermark
from ..core.records import MIN_TIMESTAMP, RecordBatch, Schema
from ..core.watermarks import WatermarkStrategy
from ..metrics.tracing import TRACER, TraceContext, now_ms
from .channels import InputGate
from .operators.base import OperatorChain, OperatorContext, Output
from .watchdog import PROGRESS, TaskProgress
from .writer import RecordWriter

__all__ = ["StreamTask", "SourceStreamTask", "OneInputStreamTask",
           "TwoInputStreamTask", "TaskReporter", "TaskIOTimers"]

IDLE_POLL_S = 0.0005  # a task whose gate is empty sleeps this long
PAUSE_S = 0.001       # an aligned source past its group's bound waits this
OVERTAKEN = "overtaken by a newer unaligned checkpoint"


class TaskIOTimers:
    """Cumulative busy, idle and backpressured wall seconds of one task's
    loop. ``busy_s`` includes time blocked in emits, which the writers
    also add to ``backpressured_s``; the ratios subtract it, so busy means
    making progress."""

    __slots__ = ("busy_s", "idle_s", "backpressured_s", "_started_at",
                 "_ended_at")

    def __init__(self):
        self.busy_s = 0.0
        self.idle_s = 0.0
        self.backpressured_s = 0.0
        self._started_at: Optional[float] = None
        self._ended_at: Optional[float] = None

    def start(self) -> None:
        if self._started_at is None:
            self._started_at = time.time()

    def stop(self) -> None:
        # elapsed freezes at the task's end: later reads stay stable
        if self._ended_at is None:
            self._ended_at = time.time()

    @property
    def elapsed_s(self) -> float:
        if self._started_at is None:
            return 0.0
        return max((self._ended_at or time.time()) - self._started_at,
                   1e-9)

    @property
    def busy_ratio(self) -> float:
        return min(1.0, max(0.0, self.busy_s - self.backpressured_s)
                   / self.elapsed_s)

    @property
    def busy_ms_per_s(self) -> float:
        return self.busy_ratio * 1000.0

    @property
    def idle_ms_per_s(self) -> float:
        return min(1.0, self.idle_s / self.elapsed_s) * 1000.0

    @property
    def backpressured_ms_per_s(self) -> float:
        return min(1.0, self.backpressured_s / self.elapsed_s) * 1000.0


class TaskReporter:
    """Callbacks from tasks to the control plane."""

    def acknowledge_checkpoint(self, task_id: str, checkpoint_id: int,
                               snapshot: dict) -> None:
        pass

    def declined_checkpoint(self, task_id: str, checkpoint_id: int,
                            reason: str) -> None:
        pass

    def task_finished(self, task_id: str) -> None:
        pass

    def task_failed(self, task_id: str, error: BaseException) -> None:
        pass


def own_batch(batch: RecordBatch) -> RecordBatch:
    """A restored in-flight batch as this package's host batch: a
    checkpoint restored across the packages holds the other package's
    record batches."""
    if isinstance(batch, RecordBatch):
        return batch
    schema = Schema([(f.name, f.dtype) for f in batch.schema.fields])
    return RecordBatch(schema, dict(batch.columns), batch.timestamps)


def _barrier_spans(task_id: str, barrier: CheckpointBarrier,
                   align: bool = True):
    """The task's checkpoint spans, parented on the coordinator's context
    the barrier carries: the Align span (trigger to aligned here) is
    reported now; the Snapshot builder is returned open, for the caller
    to finish at the acknowledgement."""
    parent = TraceContext.from_wire(barrier.trace)
    if align:
        (TRACER.span("checkpoint", "Align", parent=parent)
         .set_attribute("task", task_id)
         .set_attribute("checkpointId", barrier.checkpoint_id)
         .set_start_ts(int(barrier.timestamp * 1000))
         .finish())
    return (TRACER.span("checkpoint", "Snapshot", parent=parent)
            .set_attribute("task", task_id)
            .set_attribute("checkpointId", barrier.checkpoint_id))


class _WriterFanout(Output):
    """Chain tail output -> this task's record writers; watermarks and
    latency markers go to the side writers too."""

    def __init__(self, writers: list[RecordWriter],
                 side_writers: Optional[dict] = None, metrics=None):
        self._writers = writers
        self._side = side_writers or {}
        self._metrics = metrics

    def _all_writers(self):
        yield from self._writers
        for ws in self._side.values():
            yield from ws

    def emit(self, batch: RecordBatch) -> None:
        if self._metrics is not None:
            self._metrics.records_out.inc(batch.n)
        for w in self._writers:
            w.emit(batch)

    def emit_watermark(self, watermark: Watermark) -> None:
        for w in self._all_writers():
            w.emit_watermark(watermark)

    def emit_latency_marker(self, marker: LatencyMarker) -> None:
        for w in self._all_writers():
            w.broadcast(marker)

    def emit_side(self, tag: str, batch: RecordBatch) -> None:
        for w in self._side.get(tag, ()):
            w.emit(batch)


class StreamTask:
    """Base: mailbox + lifecycle + checkpoint plumbing."""

    def __init__(self, task_id: str, ctx: OperatorContext,
                 writers: list[RecordWriter], reporter: TaskReporter,
                 config: Optional[Configuration] = None,
                 side_writers: Optional[dict] = None):
        self.task_id = task_id
        self.ctx = ctx
        self.writers = writers
        #: tag -> the writers of the side edges leaving this task
        self.side_writers: dict = side_writers or {}
        self._last_proc_time = 0
        self.reporter = reporter
        self.config = config or ctx.config
        self.chain: Optional[OperatorChain] = None
        self._mailbox: queue.Queue = queue.Queue()
        self._cancelled = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: wall seconds the loop slept with nothing to do
        self.idle_s = 0.0
        #: CPU seconds of the task's thread over its run
        self.cpu_s = 0.0
        self.io_timers = TaskIOTimers()
        #: progress epoch, bumped once per handled event (stall detection)
        self.progress = TaskProgress()
        #: the owning job (the ledger's attribution)
        self.job_name = str(self.config.get("pipeline.name") or "")
        if ctx.metrics is not None:
            ctx.metrics.bind_io_timers(self.io_timers)
            ctx.metrics.bind_progress(self.progress)

    def all_writers(self):
        yield from self.writers
        for ws in self.side_writers.values():
            yield from ws

    def broadcast_all(self, element) -> None:
        for w in self.all_writers():
            w.broadcast(element)

    def make_tail_output(self) -> _WriterFanout:
        return _WriterFanout(self.writers, self.side_writers,
                             self.ctx.metrics)

    def side_outputs(self) -> Optional[dict]:
        """tag -> output of the side writers, for the chain's inner
        operators."""
        if not self.side_writers:
            return None
        return {tag: _WriterFanout(ws)
                for tag, ws in self.side_writers.items()}

    def _advance_processing_time(self) -> None:
        now = self.ctx.processing_time()
        if now > self._last_proc_time:
            self._last_proc_time = now
            if self.chain is not None:
                self.chain.advance_processing_time(now)

    def _idle(self, seconds: float) -> None:
        time.sleep(seconds)
        self.idle_s += seconds
        self.io_timers.idle_s += seconds

    # -- mailbox -----------------------------------------------------------
    def execute_in_mailbox(self, fn: Callable[[], None]) -> None:
        self._mailbox.put(fn)

    def _drain_mailbox(self) -> None:
        while True:
            try:
                self._mailbox.get_nowait()()
            except queue.Empty:
                return

    # -- control -----------------------------------------------------------
    def start(self) -> threading.Thread:
        for w in self.all_writers():
            w.cancel_event = self._cancelled
            w.io_timers = self.io_timers
        self._thread = threading.Thread(target=self._run_safely,
                                        name=self.task_id, daemon=True)
        self._thread.start()
        return self._thread

    def cancel(self) -> None:
        self._cancelled.set()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread:
            self._thread.join(timeout)

    @property
    def is_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _run_safely(self) -> None:
        from ..metrics.profiler import set_dispatch_context
        # pin the owning job for the whole task thread; the operator chain
        # narrows the operator part at each batch and watermark
        set_dispatch_context(self.job_name, self.task_id)
        t0 = time.thread_time()
        self.io_timers.start()
        self.progress.bump()  # deploy-to-start time never reads as a stall
        PROGRESS.register(self.task_id, self.progress)
        try:
            self.invoke()
            self.cpu_s = time.thread_time() - t0
            self.reporter.task_finished(self.task_id)
        except BaseException as e:  # noqa: BLE001 - report everything
            self.cpu_s = time.thread_time() - t0
            if self._cancelled.is_set():
                self.reporter.task_finished(self.task_id)
            else:
                self.reporter.task_failed(self.task_id, e)
        finally:
            self.io_timers.stop()
            PROGRESS.unregister(self.task_id)

    def invoke(self) -> None:
        raise NotImplementedError

    def input_pending(self) -> bool:
        """Queued input this task could be handling now: what tells a
        stalled task from an idle one. A source has no gate and is never
        flagged."""
        return False

    def _decline(self, barrier: CheckpointBarrier) -> None:
        self.reporter.declined_checkpoint(self.task_id,
                                          barrier.checkpoint_id, OVERTAKEN)


class SourceStreamTask(StreamTask):
    """Runs one source reader; checkpoints are injected here by the
    coordinator through the mailbox."""

    def __init__(self, task_id: str, ctx: OperatorContext, reader,
                 watermark_strategy: WatermarkStrategy,
                 writers: list[RecordWriter], reporter: TaskReporter,
                 config: Optional[Configuration] = None,
                 side_writers: Optional[dict] = None):
        super().__init__(task_id, ctx, writers, reporter, config,
                         side_writers)
        self.reader = reader
        self.ws = watermark_strategy
        self._restored_reader_state = None
        #: perf_counter at the first read (the job's wall clock starts)
        self.first_read_at: Optional[float] = None
        self.records_in = 0
        self.batches_in = 0
        self.watermarks_out = 0
        self.latency_markers_out = 0
        self.alignment_pauses = 0
        self.alignment_max_overshoot_ms = 0
        self.current_batch_size = 0
        self.batch_size_history: deque = deque(maxlen=1024)
        # join the alignment group at deploy time at the minimum, so no
        # group mate runs ahead before this source's first report (every
        # task is built before any starts)
        align = getattr(reporter, "watermark_alignment", None)
        if align is not None and watermark_strategy.alignment_group:
            align.report(watermark_strategy.alignment_group, task_id,
                         MIN_TIMESTAMP,
                         watermark_strategy.alignment_max_drift_ms)

    def restore_state(self, snapshot: Optional[dict]) -> None:
        if not snapshot:
            return
        if snapshot.get("reader") is not None:
            self._restored_reader_state = snapshot["reader"]
        if self.chain is not None and snapshot.get("chain"):
            self.chain.initialize_state(snapshot["chain"])

    def _snapshot(self, barrier: CheckpointBarrier) -> None:
        # the source is the barrier's origin (nothing to align): downstream
        # first, then the reader's position and the chained operators
        sb = _barrier_spans(self.task_id, barrier, align=False)
        self.broadcast_all(barrier)
        snap = {"reader": self.reader.snapshot(),
                "chain": (self.chain.snapshot_state(barrier.checkpoint_id)
                          if self.chain else None)}
        self.reporter.acknowledge_checkpoint(
            self.task_id, barrier.checkpoint_id, snap)
        sb.finish()

    def trigger_checkpoint(self, barrier: CheckpointBarrier) -> None:
        self.execute_in_mailbox(lambda: self._snapshot(barrier))

    def _aligned_pause(self, align, group: str, drift: int, gen) -> bool:
        """Report this source's watermark to its group; True (after one
        pause) when it is past the group's bound."""
        cur = gen.current_watermark()
        allowed = align.report(group, self.task_id, cur, drift)
        if cur <= allowed:
            return False
        self.alignment_pauses += 1
        if allowed - drift > MIN_TIMESTAMP:
            # an overshoot means something once the group's minimum is a
            # real report, not a deploy-time registration
            self.alignment_max_overshoot_ms = max(
                self.alignment_max_overshoot_ms, cur - allowed)
        time.sleep(PAUSE_S)
        # held by the group: backpressured, not idle
        self.io_timers.backpressured_s += PAUSE_S
        # a pause stops reading only: processing-time timers still fire
        self._advance_processing_time()
        return True

    def invoke(self) -> None:
        cfg = self.config
        batch_size = cfg.get("pipeline.micro-batch-size")
        wm_interval = cfg.get("pipeline.auto-watermark-interval")
        latency_interval = cfg.get("metrics.latency.interval")
        adaptive = cfg.get("pipeline.adaptive-batch-size")
        target_s = cfg.get("pipeline.adaptive-batch-size.target-latency")
        min_batch = cfg.get("pipeline.adaptive-batch-size.min")
        max_batch = cfg.get("pipeline.adaptive-batch-size.max")
        align = getattr(self.reporter, "watermark_alignment", None)
        group = self.ws.alignment_group if align is not None else None
        drift = self.ws.alignment_max_drift_ms
        if self._restored_reader_state is not None:
            self.reader.restore(self._restored_reader_state)
        gen = self.ws.create_generator()
        out: Output = self.make_tail_output()
        if self.chain is not None:
            self.chain.open()
        last_wm_emit = last_marker_emit = 0.0
        last_wm = MIN_TIMESTAMP
        self.current_batch_size = batch_size
        metrics = self.ctx.metrics
        while not self._cancelled.is_set():
            self._drain_mailbox()
            if group is not None and self._aligned_pause(align, group,
                                                         drift, gen):
                continue
            if self.first_read_at is None:
                self.first_read_at = time.perf_counter()
            t0 = time.perf_counter()
            batch = self.reader.read_batch(self.current_batch_size)
            read_dt = time.perf_counter() - t0
            self.io_timers.busy_s += read_dt
            if batch is None:  # exhausted (bounded)
                break
            if batch.n:
                self.records_in += batch.n
                self.batches_in += 1
                if metrics is not None:
                    metrics.records_in.inc(batch.n)
                batch = self.ws.assign_timestamps(batch)
                gen.on_batch(batch)
                t0 = time.perf_counter()
                if self.chain is not None:
                    self.chain.process_batch(batch)
                else:
                    out.emit(batch)
                emit_dt = time.perf_counter() - t0
                self.io_timers.busy_s += emit_dt
                self.progress.bump()
                if TRACER.enabled:
                    # one read + chain/emit cycle of the loop
                    end = now_ms()
                    (TRACER.span("task", "SourceBatch")
                     .set_attribute("task", self.task_id)
                     .set_attribute("records", batch.n)
                     .set_attribute("read_ms", round(read_dt * 1e3, 3))
                     .set_attribute("emit_ms", round(emit_dt * 1e3, 3))
                     .set_start_ts(end - int((read_dt + emit_dt) * 1e3))
                     .finish(end))
                if adaptive:
                    # halfway toward throughput x target: at the fixpoint
                    # one batch takes the target
                    desired = batch.n / max(read_dt + emit_dt, 1e-9) \
                        * target_s
                    self.current_batch_size = int(min(max(
                        0.5 * self.current_batch_size + 0.5 * desired,
                        min_batch), max_batch))
                    self.batch_size_history.append(self.current_batch_size)
            else:
                self._idle(0.001)  # nothing due yet (rate limit)
            now = time.time()
            if now - last_wm_emit >= wm_interval:
                last_wm_emit = now
                wm = gen.current_watermark()
                if wm > last_wm:
                    last_wm = wm
                    self.watermarks_out += 1
                    if self.chain is not None:
                        self.chain.process_watermark(Watermark(wm))
                    else:
                        out.emit_watermark(Watermark(wm))
            if latency_interval > 0 \
                    and now - last_marker_emit >= latency_interval:
                # the probe rides the chain: every operator records its
                # source-to-here latency before forwarding it
                last_marker_emit = now
                self.latency_markers_out += 1
                marker = LatencyMarker(now, self.task_id,
                                       self.ctx.subtask_index)
                if self.chain is not None:
                    self.chain.process_latency_marker(marker)
                else:
                    out.emit_latency_marker(marker)
            self._advance_processing_time()
        if group is not None:
            # a finished or cancelled source must not hold its group back
            align.unregister(group, self.task_id)
        if not self._cancelled.is_set():
            self._drain_mailbox()
            # bounded source done: flush event time, finish the chain,
            # close the edges
            if self.chain is not None:
                self.chain.process_watermark(MAX_WATERMARK)
                self.chain.finish()
                self.chain.close()
            else:
                out.emit_watermark(MAX_WATERMARK)
            self.broadcast_all(EndOfInput())
            self.reader.close()


class OneInputStreamTask(StreamTask):
    """Gate -> operator chain -> writers."""

    def __init__(self, task_id: str, ctx: OperatorContext, gate: InputGate,
                 writers: list[RecordWriter], reporter: TaskReporter,
                 config: Optional[Configuration] = None,
                 side_writers: Optional[dict] = None):
        super().__init__(task_id, ctx, writers, reporter, config,
                         side_writers)
        self.gate = gate
        self._restored_inflight: list = []
        #: (barrier, snapshot) of an unaligned checkpoint awaiting capture
        self._unaligned_pending = None

    def restore_state(self, snapshot: Optional[dict]) -> None:
        if not snapshot:
            return
        if snapshot.get("chain"):
            self.chain.initialize_state(snapshot["chain"])
        # an unaligned checkpoint: its in-flight batches replay first
        self._restored_inflight = [own_batch(b)
                                   for b in snapshot.get("inflight", ())]

    def _on_barrier(self, barrier: CheckpointBarrier) -> None:
        """Broadcast downstream first, then snapshot. Aligned: acknowledge
        now. Unaligned: the snapshot is taken now and acknowledged once
        the other channels' batches ahead of their barrier are captured."""
        if self._unaligned_pending is not None:
            # a newer checkpoint overtook before the capture finished
            self._decline(self._unaligned_pending[0])
            self._unaligned_pending = None
        sb = _barrier_spans(self.task_id, barrier)
        self.broadcast_all(barrier)
        snap = {"chain": self.chain.snapshot_state(barrier.checkpoint_id)}
        if self.gate.capture_active and not self.gate.capture_complete:
            self._unaligned_pending = (barrier, snap)
            sb.set_attribute("unaligned", True).finish()
            return
        if self.gate.capture_active:  # complete already (one channel)
            snap["inflight"] = self.gate.take_captured()
        self.reporter.acknowledge_checkpoint(
            self.task_id, barrier.checkpoint_id, snap)
        sb.finish()

    def _maybe_finish_unaligned(self) -> None:
        if self._unaligned_pending is None or \
                not self.gate.capture_complete:
            return
        barrier, snap = self._unaligned_pending
        self._unaligned_pending = None
        snap["inflight"] = self.gate.take_captured()
        self.reporter.acknowledge_checkpoint(
            self.task_id, barrier.checkpoint_id, snap)

    def invoke(self) -> None:
        self.chain.open()
        for batch in self._restored_inflight:
            # replayed in-flight data precedes any new input
            self.chain.process_batch(batch)
        self._restored_inflight = []
        metrics = self.ctx.metrics
        while not self._cancelled.is_set():
            self._drain_mailbox()
            ev = self.gate.poll()
            if ev is None:
                self._maybe_finish_unaligned()
                if self.gate.all_ended():
                    break
                self._advance_processing_time()
                self._idle(IDLE_POLL_S)
                continue
            t0 = time.perf_counter()
            if ev.kind == "batch":
                if metrics is not None:
                    metrics.records_in.inc(ev.value.n)
                self.chain.process_batch(ev.value)
            elif ev.kind == "watermark":
                self.chain.process_watermark(ev.value)
            elif ev.kind == "barrier":
                self._on_barrier(ev.value)
            elif ev.kind == "latency":
                # through the chain: each operator records its latency
                self.chain.process_latency_marker(ev.value)
            elif ev.kind == "idle":
                self.broadcast_all(ev.value)
            self.io_timers.busy_s += time.perf_counter() - t0
            self.progress.bump()
            self._maybe_finish_unaligned()
            self._advance_processing_time()
        if not self._cancelled.is_set():
            self._maybe_finish_unaligned()
            self.chain.finish()
            self.chain.close()
            self.broadcast_all(EndOfInput())

    def input_pending(self) -> bool:
        return any(ch.size() > 0 for ch in self.gate.channels)


class TwoInputStreamTask(StreamTask):
    """Two gates -> a chain headed by a two-input operator -> writers."""

    def __init__(self, task_id: str, ctx: OperatorContext, gate1: InputGate,
                 gate2: InputGate, writers: list[RecordWriter],
                 reporter: TaskReporter,
                 config: Optional[Configuration] = None,
                 side_writers: Optional[dict] = None):
        super().__init__(task_id, ctx, writers, reporter, config,
                         side_writers)
        self.gates = [gate1, gate2]
        # the barrier each gate delivered and the task holds
        self._gate_barrier: list = [None, None]
        self._unaligned_pending = None
        self._restored_inflight: list = [[], []]

    def restore_state(self, snapshot: Optional[dict]) -> None:
        if not snapshot:
            return
        if snapshot.get("chain"):
            self.chain.initialize_state(snapshot["chain"])
        self._restored_inflight = [
            [own_batch(b) for b in snapshot.get(key, ())]
            for key in ("inflight1", "inflight2")]

    def _on_barrier(self, gi: int, barrier: CheckpointBarrier) -> None:
        if self.gates[gi].capture_active:
            # unaligned: the barrier overtook on gate gi. Snapshot now,
            # capture the other gate too, acknowledge when both drained
            if self._unaligned_pending is not None:
                self._decline(self._unaligned_pending[0])
                self._unaligned_pending = None
            sb = _barrier_spans(self.task_id, barrier)
            self.broadcast_all(barrier)
            snap = {"chain": self.chain.snapshot_state(barrier.checkpoint_id)}
            sb.set_attribute("unaligned", True).finish()
            self.gates[1 - gi].begin_capture(barrier)
            self._unaligned_pending = (barrier, snap)
            self._maybe_finish_unaligned()
            return
        self._gate_barrier[gi] = barrier
        self._maybe_complete_barrier()

    def _maybe_finish_unaligned(self) -> None:
        if self._unaligned_pending is None or \
                not all(g.capture_complete for g in self.gates):
            return
        barrier, snap = self._unaligned_pending
        self._unaligned_pending = None
        snap["inflight1"] = self.gates[0].take_captured()
        snap["inflight2"] = self.gates[1].take_captured()
        self.reporter.acknowledge_checkpoint(
            self.task_id, barrier.checkpoint_id, snap)

    def _maybe_complete_barrier(self) -> None:
        b0, b1 = self._gate_barrier
        # an ended input never delivers barriers: do not wait on it
        if b0 is not None and b1 is None and self.gates[1].all_ended():
            b1 = b0
        if b1 is not None and b0 is None and self.gates[0].all_ended():
            b0 = b1
        if b0 is None or b1 is None:
            return  # hold the aligned gate
        if b0.checkpoint_id != b1.checkpoint_id:
            # a newer checkpoint overtook on one side: adopt it
            newer = max(b0, b1, key=lambda b: b.checkpoint_id)
            self._gate_barrier = [b if b is newer else None
                                  for b in self._gate_barrier]
            return
        sb = _barrier_spans(self.task_id, b0)
        self._gate_barrier = [None, None]
        self.broadcast_all(b0)
        snap = {"chain": self.chain.snapshot_state(b0.checkpoint_id)}
        self.reporter.acknowledge_checkpoint(self.task_id, b0.checkpoint_id,
                                             snap)
        sb.finish()

    def invoke(self) -> None:
        self.chain.open()
        for gi in (0, 1):
            for b in self._restored_inflight[gi]:
                self.chain.process_batch_n(gi, b)
        self._restored_inflight = [[], []]
        metrics = self.ctx.metrics
        rr = 0
        while not self._cancelled.is_set():
            self._drain_mailbox()
            self._maybe_finish_unaligned()
            if any(b is not None for b in self._gate_barrier):
                # the other input may have ended while a barrier was held
                self._maybe_complete_barrier()
            ev = gi = None
            for off in range(2):
                g = (rr + off) % 2
                if self._gate_barrier[g] is not None:
                    continue  # aligned, waiting for the other gate
                ev = self.gates[g].poll()
                if ev is not None:
                    gi, rr = g, 1 - g
                    break
            if ev is None:
                if all(g.all_ended() for g in self.gates):
                    break
                self._advance_processing_time()
                self._idle(IDLE_POLL_S)
                continue
            t0 = time.perf_counter()
            if ev.kind == "batch":
                if metrics is not None:
                    metrics.records_in.inc(ev.value.n)
                self.chain.process_batch_n(gi, ev.value)
            elif ev.kind == "watermark":
                self.chain.process_watermark_n(gi, ev.value)
            elif ev.kind == "barrier":
                self._on_barrier(gi, ev.value)
            elif ev.kind == "latency":
                self.chain.process_latency_marker(ev.value)
            elif ev.kind == "idle":
                self.broadcast_all(ev.value)
            self.io_timers.busy_s += time.perf_counter() - t0
            self.progress.bump()
            self._advance_processing_time()
        if not self._cancelled.is_set():
            self._maybe_finish_unaligned()
            self.chain.finish()
            self.chain.close()
            self.broadcast_all(EndOfInput())

    def input_pending(self) -> bool:
        return any(ch.size() > 0 for g in self.gates for ch in g.channels)
