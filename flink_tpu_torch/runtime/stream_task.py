"""Stream tasks: the per-subtask execution loop (trimmed port of
``flink_tpu/runtime/stream_task.py``).

One thread per subtask alternates between its default action (read a
batch, or process one input event) and mails (checkpoint triggers from
the coordinator), so operators never see concurrency.

* ``SourceStreamTask`` reads its source, assigns timestamps, runs its
  chained operators (or writes downstream), and emits the watermark every
  ``pipeline.auto-watermark-interval`` seconds of wall time (0: after
  every batch). A checkpoint barrier is injected here: broadcast
  downstream first, then the reader's position and the chain are
  snapshotted and acknowledged.
* ``OneInputStreamTask`` polls its input gate; a fully aligned barrier is
  broadcast downstream, then the chain is snapshotted and acknowledged.
* ``TwoInputStreamTask`` polls two gates, one per logical input, in
  turns. Each gate aligns barriers over its own channels; the snapshot is
  taken only once both gates delivered the barrier of the same
  checkpoint, and the gate that aligned first is not polled meanwhile. A
  held barrier completes when the other gate's input ends.
* At the end of a bounded input the MAX watermark flushes event time, the
  chain finishes, and ``EndOfInput`` closes every output channel.
* Every loop turn, and every idle wait, advances the chain's processing
  time to the task's clock, which fires processing-time timers.
* A side output's writers (``get_side_output(tag)``) get the chain's
  tagged batches; watermarks, barriers and end of input go to them too,
  since the stream behind a side edge needs event time as well.

Every task of one job runs on the device's default stream, so a device
batch made on a source thread is consumed in order on the window thread.
Each loop bumps the task's progress epoch once per event it handled
(``runtime/watchdog.py``): a task whose epoch stalls while its input
holds queued data is failed by the job's stall detector. Alignment
groups, admission control, adaptive batch sizes, latency markers,
tracing and unaligned checkpoints are not ported.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

from ..core.config import Configuration
from ..core.elements import MAX_WATERMARK, CheckpointBarrier, EndOfInput, \
    Watermark
from ..core.records import MIN_TIMESTAMP, RecordBatch
from ..core.watermarks import WatermarkStrategy
from .channels import InputGate
from .operators.base import OperatorChain, OperatorContext, Output
from .watchdog import PROGRESS, TaskProgress
from .writer import RecordWriter

__all__ = ["StreamTask", "SourceStreamTask", "OneInputStreamTask",
           "TwoInputStreamTask", "TaskReporter"]

IDLE_POLL_S = 0.0005  # a task whose gate is empty sleeps this long


class TaskReporter:
    """Callbacks from tasks to the control plane."""

    def acknowledge_checkpoint(self, task_id: str, checkpoint_id: int,
                               snapshot: dict) -> None:
        pass

    def task_finished(self, task_id: str) -> None:
        pass

    def task_failed(self, task_id: str, error: BaseException) -> None:
        pass


class _WriterFanout(Output):
    """Chain tail output -> this task's record writers; watermarks go to
    the side writers too."""

    def __init__(self, writers: list[RecordWriter],
                 side_writers: Optional[dict] = None):
        self._writers = writers
        self._side = side_writers or {}

    def emit(self, batch: RecordBatch) -> None:
        for w in self._writers:
            w.emit(batch)

    def emit_watermark(self, watermark: Watermark) -> None:
        for w in self._writers:
            w.emit_watermark(watermark)
        for ws in self._side.values():
            for w in ws:
                w.emit_watermark(watermark)

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
        #: progress epoch, bumped once per handled event (stall detection)
        self.progress = TaskProgress()
        #: the owning job (the ledger's attribution)
        self.job_name = str(self.config.get("pipeline.name") or "")

    def all_writers(self):
        yield from self.writers
        for ws in self.side_writers.values():
            yield from ws

    def broadcast_all(self, element) -> None:
        for w in self.all_writers():
            w.broadcast(element)

    def make_tail_output(self) -> _WriterFanout:
        return _WriterFanout(self.writers, self.side_writers)

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
            PROGRESS.unregister(self.task_id)

    def invoke(self) -> None:
        raise NotImplementedError

    def input_pending(self) -> bool:
        """Queued input this task could be handling now: what tells a
        stalled task from an idle one. A source has no gate and is never
        flagged."""
        return False


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

    def restore_state(self, snapshot: Optional[dict]) -> None:
        if not snapshot:
            return
        if snapshot.get("reader") is not None:
            self._restored_reader_state = snapshot["reader"]
        if self.chain is not None and snapshot.get("chain"):
            self.chain.initialize_state(snapshot["chain"])

    def _snapshot(self, barrier: CheckpointBarrier) -> None:
        # the source is the barrier's origin: downstream first, then the
        # reader's position and the chained operators
        self.broadcast_all(barrier)
        snap = {"reader": self.reader.snapshot(),
                "chain": (self.chain.snapshot_state(barrier.checkpoint_id)
                          if self.chain else None)}
        self.reporter.acknowledge_checkpoint(
            self.task_id, barrier.checkpoint_id, snap)

    def trigger_checkpoint(self, barrier: CheckpointBarrier) -> None:
        self.execute_in_mailbox(lambda: self._snapshot(barrier))

    def invoke(self) -> None:
        batch_size = self.config.get("pipeline.micro-batch-size")
        wm_interval = self.config.get("pipeline.auto-watermark-interval")
        if self._restored_reader_state is not None:
            self.reader.restore(self._restored_reader_state)
        gen = self.ws.create_generator()
        out: Output = self.make_tail_output()
        if self.chain is not None:
            self.chain.open()
        last_wm_emit = 0.0
        last_wm = MIN_TIMESTAMP
        while not self._cancelled.is_set():
            self._drain_mailbox()
            if self.first_read_at is None:
                self.first_read_at = time.perf_counter()
            batch = self.reader.read_batch(batch_size)
            if batch is None:  # exhausted (bounded)
                break
            if batch.n:
                self.records_in += batch.n
                self.batches_in += 1
                batch = self.ws.assign_timestamps(batch)
                gen.on_batch(batch)
                if self.chain is not None:
                    self.chain.process_batch(batch)
                else:
                    out.emit(batch)
                self.progress.bump()
            else:
                time.sleep(0.001)  # nothing due yet (rate limit)
                self.idle_s += 0.001
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
            self._advance_processing_time()
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

    def restore_state(self, snapshot: Optional[dict]) -> None:
        if snapshot and snapshot.get("chain"):
            self.chain.initialize_state(snapshot["chain"])

    def _on_barrier(self, barrier: CheckpointBarrier) -> None:
        """Broadcast downstream first, then snapshot and acknowledge."""
        self.broadcast_all(barrier)
        snap = {"chain": self.chain.snapshot_state(barrier.checkpoint_id)}
        self.reporter.acknowledge_checkpoint(
            self.task_id, barrier.checkpoint_id, snap)

    def invoke(self) -> None:
        self.chain.open()
        while not self._cancelled.is_set():
            self._drain_mailbox()
            ev = self.gate.poll()
            if ev is None:
                if self.gate.all_ended():
                    break
                self._advance_processing_time()
                time.sleep(IDLE_POLL_S)
                self.idle_s += IDLE_POLL_S
                continue
            if ev.kind == "batch":
                self.chain.process_batch(ev.value)
            elif ev.kind == "watermark":
                self.chain.process_watermark(ev.value)
            elif ev.kind == "barrier":
                self._on_barrier(ev.value)
            elif ev.kind == "idle":
                self.broadcast_all(ev.value)
            self.progress.bump()
            self._advance_processing_time()
        if not self._cancelled.is_set():
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

    def restore_state(self, snapshot: Optional[dict]) -> None:
        if snapshot and snapshot.get("chain"):
            self.chain.initialize_state(snapshot["chain"])

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
        self._gate_barrier = [None, None]
        self.broadcast_all(b0)
        snap = {"chain": self.chain.snapshot_state(b0.checkpoint_id)}
        self.reporter.acknowledge_checkpoint(self.task_id, b0.checkpoint_id,
                                             snap)

    def invoke(self) -> None:
        self.chain.open()
        rr = 0
        while not self._cancelled.is_set():
            self._drain_mailbox()
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
                time.sleep(IDLE_POLL_S)
                self.idle_s += IDLE_POLL_S
                continue
            if ev.kind == "batch":
                self.chain.process_batch_n(gi, ev.value)
            elif ev.kind == "watermark":
                self.chain.process_watermark_n(gi, ev.value)
            elif ev.kind == "barrier":
                self._gate_barrier[gi] = ev.value
                self._maybe_complete_barrier()
            elif ev.kind == "idle":
                self.broadcast_all(ev.value)
            self.progress.bump()
            self._advance_processing_time()
        if not self._cancelled.is_set():
            self.chain.finish()
            self.chain.close()
            self.broadcast_all(EndOfInput())

    def input_pending(self) -> bool:
        return any(ch.size() > 0 for g in self.gates for ch in g.channels)
