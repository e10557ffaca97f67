"""In-process channels, input gates, barrier alignment and the watermark
valve (port of ``flink_tpu/runtime/channels.py``).

Bounded queues stand in for credit-based network channels: a full queue
is backpressure. ``InputGate`` merges a task's input channels; watermarks
min-combine over the active channels. Barrier modes:

* aligned (exactly-once, the default): a channel that delivered its
  barrier is not polled again until every live channel's barrier
  arrived;
* at least once (``aligned=False``): barriers are counted, nothing
  blocks;
* unaligned (``unaligned=True``): the first barrier fires at once, and
  the batches still queued ahead of the other channels' barriers are
  captured as in-flight data (``captured``) while they are processed as
  usual; a channel's own barrier ends its capture;
* alignment timeout (``alignment_timeout_s`` > 0): an aligned checkpoint
  whose alignment stalls longer turns unaligned.

A captured device batch is kept by reference, so it holds its card
memory for as long as its checkpoint is kept; the fs storage pickles it
as its host batch (``DeviceRecordBatch.__reduce__``).

``ReplayableChannel`` is a blocking partition a reader can re-read
(``clone_reader``) or replace with another attempt's output
(``adopt_items``). ``IterationGate`` heads an iteration: its feedback
channels start idle, and it ends once its regular channels ended and the
loop stayed quiet for ``max_wait_s``.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Optional

from ..core.elements import CheckpointBarrier, EndOfInput, LatencyMarker, \
    Watermark, WatermarkStatus
from ..core.records import MIN_TIMESTAMP, RecordBatch
from .faults import FAULTS

__all__ = ["Channel", "LocalChannel", "ReplayableChannel", "InputGate",
           "IterationGate", "GateEvent", "DEFAULT_CAPACITY"]

DEFAULT_CAPACITY = 64  # queued elements per channel before backpressure


class Channel:
    """One logical edge subtask -> subtask."""

    def put(self, element: Any, timeout: Optional[float] = None) -> bool:
        raise NotImplementedError

    def poll(self) -> Optional[Any]:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError


class LocalChannel(Channel):
    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._q: queue.Queue = queue.Queue(maxsize=capacity)

    def put(self, element: Any, timeout: Optional[float] = None) -> bool:
        if FAULTS.enabled and FAULTS.check("channel.backpressure"):
            # drop-style site: report "queue full" once; the writer's wait
            # treats it as a full queue and puts again, so nothing is lost
            return False
        try:
            self._q.put(element, timeout=timeout)
            return True
        except queue.Full:
            return False

    def poll(self) -> Optional[Any]:
        try:
            return self._q.get_nowait()
        except queue.Empty:
            return None

    def size(self) -> int:
        return self._q.qsize()


class ReplayableChannel(Channel):
    """A blocking partition: writes append to a list, and a reader's
    cursor advances without consuming, so another reader can re-read it
    from the start (``clone_reader``). Unbounded: the producer's whole
    output is kept."""

    def __init__(self, items: Optional[list] = None,
                 lock: Optional[threading.Lock] = None):
        self._items: list = items if items is not None else []
        self._lock = lock or threading.Lock()
        self._cursor = 0
        self._sealed = False

    def put(self, element: Any, timeout: Optional[float] = None) -> bool:
        with self._lock:
            if not self._sealed:
                # a sealed partition was adopted from another attempt:
                # the losing attempt's late writes are dropped
                self._items.append(element)
        return True

    def poll(self) -> Optional[Any]:
        with self._lock:
            if self._cursor >= len(self._items):
                return None
            e = self._items[self._cursor]
            self._cursor += 1
            return e

    def size(self) -> int:
        with self._lock:
            return len(self._items) - self._cursor

    def clone_reader(self) -> "ReplayableChannel":
        """A fresh cursor over the same partition."""
        return ReplayableChannel(self._items, self._lock)

    def adopt_items(self, other: "ReplayableChannel") -> None:
        """Take another attempt's output as this partition's, and seal it
        against the late writes of the attempt that lost."""
        with self._lock:
            self._sealed = True
            self._items[:] = list(other._items)
            self._cursor = 0


@dataclass
class GateEvent:
    """What the gate hands the task: data or a watermark to process, a
    barrier (snapshot now), a latency marker, or a channel's idleness."""

    kind: str  # "batch" | "watermark" | "barrier" | "latency" | "idle"
    value: Any = None
    channel: int = -1


class InputGate:
    """Merges N input channels with barrier alignment and the watermark
    valve."""

    def __init__(self, channels: list[Channel], aligned: bool = True,
                 unaligned: bool = False, alignment_timeout_s: float = 0.0):
        self.channels = channels
        self.aligned = aligned
        self.unaligned = unaligned
        self.alignment_timeout_s = alignment_timeout_s
        n = len(channels)
        self._blocked = [False] * n          # barrier-aligned channels
        self._ended = [False] * n
        self._wm = [MIN_TIMESTAMP] * n       # per-channel watermark
        self._active = [True] * n            # idleness per channel
        self._pending_barrier: Optional[CheckpointBarrier] = None
        self._barrier_seen: set[int] = set()
        self._combined_wm = MIN_TIMESTAMP
        self._rr = 0                         # fair round-robin pointer
        self.alignment_start = 0.0
        # unaligned capture: the channels still ahead of their barrier,
        # the barrier that overtook them, and what they delivered since
        self._capturing: set[int] = set()
        self._capture_barrier: Optional[CheckpointBarrier] = None
        self.captured: list = []

    # -- unaligned capture -------------------------------------------------
    @property
    def capture_active(self) -> bool:
        return self._capture_barrier is not None

    @property
    def capture_complete(self) -> bool:
        return self._capture_barrier is not None and not self._capturing

    def take_captured(self) -> list:
        out = self.captured
        self.captured = []
        self._capture_barrier = None
        self._capturing = set()
        return out

    def _begin(self, b: CheckpointBarrier, capturing: set) -> None:
        self.captured = []   # an overtaken capture's data is dropped
        self._capture_barrier = b
        self._capturing = capturing
        self._pending_barrier = None
        self._barrier_seen.clear()
        self._blocked = [False] * len(self.channels)

    def _start_capture(self, b: CheckpointBarrier) -> GateEvent:
        """The barrier overtakes: fire now, and capture the other live
        channels' batches until their own barrier arrives."""
        self._begin(b, {i for i in range(len(self.channels))
                        if i not in self._barrier_seen
                        and not self._ended[i]})
        return GateEvent("barrier", b)

    def begin_capture(self, b: CheckpointBarrier) -> None:
        """Start a capture for a barrier that arrived on a sibling gate (a
        two-input task's unaligned checkpoint): every live channel here is
        ahead of its barrier."""
        if self._capture_barrier is not None \
                and self._capture_barrier.checkpoint_id >= b.checkpoint_id:
            return
        self._begin(b, {i for i in range(len(self.channels))
                        if not self._ended[i]})

    def convert_to_unaligned(self) -> Optional[GateEvent]:
        """Turn a stalled aligned checkpoint unaligned (the timeout)."""
        if self._pending_barrier is None or self.capture_active:
            return None
        return self._start_capture(self._pending_barrier)

    # -- watermark valve ---------------------------------------------------
    def _recompute_watermark(self) -> Optional[Watermark]:
        live = [self._wm[i] for i in range(len(self.channels))
                if self._active[i] and not self._ended[i]]
        if not live:
            # all idle or ended: the ended channels' final marks drive it
            live = list(self._wm)
        combined = min(live) if live else MIN_TIMESTAMP
        if combined > self._combined_wm:
            self._combined_wm = combined
            return Watermark(combined)
        return None

    def all_ended(self) -> bool:
        return all(self._ended)

    def unblock_all(self) -> None:
        self._blocked = [False] * len(self.channels)
        self._pending_barrier = None
        self._barrier_seen.clear()

    def poll(self) -> Optional[GateEvent]:
        """One event, fair round-robin over non-blocked channels; None when
        nothing is available right now."""
        if (self.alignment_timeout_s > 0 and not self.unaligned
                and self._pending_barrier is not None
                and not self.capture_active
                and time.time() - self.alignment_start
                > self.alignment_timeout_s):
            ev = self.convert_to_unaligned()
            if ev is not None:
                return ev
        n = len(self.channels)
        for off in range(n):
            i = (self._rr + off) % n
            if self._blocked[i] or self._ended[i]:
                continue
            e = self.channels[i].poll()
            if e is None:
                continue
            self._rr = (i + 1) % n
            return self._classify(i, e)
        return None

    def _classify(self, i: int, e: Any) -> Optional[GateEvent]:
        if isinstance(e, RecordBatch):
            if self._capture_barrier is not None and i in self._capturing:
                # ahead of this channel's barrier: it rides with the
                # checkpoint and is processed as usual
                self.captured.append(e)
            return GateEvent("batch", e, i)
        if isinstance(e, Watermark):
            self._wm[i] = max(self._wm[i], e.timestamp)
            self._active[i] = True
            wm = self._recompute_watermark()
            return GateEvent("watermark", wm, i) if wm else None
        if isinstance(e, WatermarkStatus):
            self._active[i] = e.active
            wm = self._recompute_watermark()
            return GateEvent("watermark", wm, i) if wm else \
                GateEvent("idle", e, i)
        if isinstance(e, CheckpointBarrier):
            return self._on_barrier(i, e)
        if isinstance(e, LatencyMarker):
            return GateEvent("latency", e, i)
        if isinstance(e, EndOfInput):
            self._ended[i] = True
            self._capturing.discard(i)   # nothing more to capture from it
            # an ended channel no longer holds back alignment
            if self._pending_barrier is not None:
                return self._check_alignment_complete()
            wm = self._recompute_watermark()
            return GateEvent("watermark", wm, i) if wm else None
        raise TypeError(f"unknown stream element {type(e)}")

    def _on_barrier(self, i: int, b: CheckpointBarrier) -> Optional[GateEvent]:
        if self._capture_barrier is not None:
            if b.checkpoint_id <= self._capture_barrier.checkpoint_id:
                # this channel caught up with the overtaking barrier
                self._capturing.discard(i)
                return None
            # a newer checkpoint while capturing: drop the old capture and
            # overtake again
            self._capturing.clear()
            self._barrier_seen = {i}
            return self._start_capture(b)
        if self.unaligned:
            self._barrier_seen.add(i)
            return self._start_capture(b)
        if not self.aligned:
            # at-least-once: count barriers, never block
            self._barrier_seen.add(i)
            if self._pending_barrier is None:
                self._pending_barrier = b
                self.alignment_start = time.time()
            return self._check_alignment_complete()
        if self._pending_barrier is None:
            self._pending_barrier = b
            self.alignment_start = time.time()
        elif b.checkpoint_id != self._pending_barrier.checkpoint_id:
            # a newer checkpoint overtakes: adopt the newer barrier
            self.unblock_all()
            self._pending_barrier = b
            self.alignment_start = time.time()
        self._blocked[i] = True
        self._barrier_seen.add(i)
        return self._check_alignment_complete()

    def _check_alignment_complete(self) -> Optional[GateEvent]:
        needed = {i for i in range(len(self.channels)) if not self._ended[i]}
        if self._pending_barrier is not None and needed <= self._barrier_seen:
            b = self._pending_barrier
            self.unblock_all()
            return GateEvent("barrier", b)
        return None


class IterationGate(InputGate):
    """The gate of an iteration head: some channels are feedback edges
    from the loop body. The body ends only after the head does, so the
    head cannot wait for their end of input: it ends once every regular
    channel ended and the loop stayed quiet (no event polled, no feedback
    queued) for ``max_wait_s``. Feedback channels start idle, so the
    loop's watermarks never hold event time back."""

    def __init__(self, channels: list[Channel], feedback: set[int],
                 max_wait_s: float, **kwargs):
        super().__init__(channels, **kwargs)
        self.feedback = set(feedback)
        self.max_wait_s = max_wait_s
        self._quiet_since: Optional[float] = None
        self._regular = [i for i in range(len(channels))
                         if i not in self.feedback]
        for i in self.feedback:
            self._active[i] = False

    def poll(self) -> Optional[GateEvent]:
        ev = super().poll()
        if ev is not None:
            self._quiet_since = None     # any activity resets quiescence
        return ev

    def all_ended(self) -> bool:
        if not all(self._ended[i] for i in self._regular):
            self._quiet_since = None
            return False
        if all(self._ended):
            return True
        if any(self.channels[i].size() > 0 for i in self.feedback
               if not self._ended[i]):
            self._quiet_since = None     # queued feedback: not quiet
            return False
        now = time.time()
        if self._quiet_since is None:
            self._quiet_since = now
            return False
        return now - self._quiet_since >= self.max_wait_s
