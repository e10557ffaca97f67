"""In-process channels, the input gate, barrier alignment and the watermark
valve (trimmed port of ``flink_tpu/runtime/channels.py``).

Bounded queues stand in for credit-based network channels: a full queue
is backpressure. ``InputGate`` merges a task's input channels: with
aligned (exactly-once) barriers a channel that delivered its barrier is
not polled again until every live channel's barrier arrived; at least
once counts barriers and blocks nothing. Watermarks min-combine over the
active channels. The unaligned mode, replayable channels and iteration
gates of the reference are not ported.
"""

from __future__ import annotations

import queue
from dataclasses import dataclass
from typing import Any, Optional

from ..core.elements import CheckpointBarrier, EndOfInput, Watermark, \
    WatermarkStatus
from ..core.records import MIN_TIMESTAMP, RecordBatch

__all__ = ["Channel", "LocalChannel", "InputGate", "GateEvent",
           "DEFAULT_CAPACITY"]

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


@dataclass
class GateEvent:
    """What the gate hands the task: data or a watermark to process, a
    fully aligned barrier (snapshot now), or a channel's idleness."""

    kind: str  # "batch" | "watermark" | "barrier" | "idle"
    value: Any = None
    channel: int = -1


class InputGate:
    """Merges N input channels with barrier alignment and the watermark
    valve."""

    def __init__(self, channels: list[Channel], aligned: bool = True):
        self.channels = channels
        self.aligned = aligned
        n = len(channels)
        self._blocked = [False] * n          # barrier-aligned channels
        self._ended = [False] * n
        self._wm = [MIN_TIMESTAMP] * n       # per-channel watermark
        self._active = [True] * n            # idleness per channel
        self._pending_barrier: Optional[CheckpointBarrier] = None
        self._barrier_seen: set[int] = set()
        self._combined_wm = MIN_TIMESTAMP
        self._rr = 0                         # fair round-robin pointer

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
        if isinstance(e, EndOfInput):
            self._ended[i] = True
            # an ended channel no longer holds back alignment
            if self._pending_barrier is not None:
                return self._check_alignment_complete()
            wm = self._recompute_watermark()
            return GateEvent("watermark", wm, i) if wm else None
        raise TypeError(f"unknown stream element {type(e)}")

    def _on_barrier(self, i: int, b: CheckpointBarrier) -> Optional[GateEvent]:
        if not self.aligned:
            # at-least-once: count barriers, never block
            self._barrier_seen.add(i)
            if self._pending_barrier is None:
                self._pending_barrier = b
            return self._check_alignment_complete()
        if self._pending_barrier is None:
            self._pending_barrier = b
        elif b.checkpoint_id != self._pending_barrier.checkpoint_id:
            # a newer checkpoint overtakes: adopt the newer barrier
            self.unblock_all()
            self._pending_barrier = b
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
