"""Stream elements besides record batches (trimmed copy of
``flink_tpu/core/elements.py``): watermarks, channel idleness, checkpoint
barriers, latency markers and the end of a bounded input. They are
interleaved with batches in channel order, which is what gives barriers
and watermarks their alignment semantics."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

from .records import MAX_TIMESTAMP

__all__ = ["Watermark", "MAX_WATERMARK", "WatermarkStatus",
           "CheckpointBarrier", "LatencyMarker", "EndOfInput"]


@dataclass(frozen=True)
class Watermark:
    """Event-time watermark: no further records with ts <= this will arrive."""

    timestamp: int


MAX_WATERMARK = Watermark(MAX_TIMESTAMP)


@dataclass(frozen=True)
class WatermarkStatus:
    """Channel idleness marker."""

    active: bool


@dataclass(frozen=True)
class CheckpointBarrier:
    """All state mutations from batches before the barrier belong to
    checkpoint ``checkpoint_id``."""

    checkpoint_id: int
    timestamp: float = field(default_factory=time.time)
    is_savepoint: bool = False
    # an unaligned checkpoint's barrier (the gate may let it overtake)
    unaligned: bool = False
    # the wire form of the coordinator's trace context
    # (metrics/tracing.py): tasks parent their Align and Snapshot spans on
    # it, so one checkpoint's spans form one tree
    trace: Optional[dict] = None


@dataclass(frozen=True)
class LatencyMarker:
    """An end-to-end latency probe a source injects every
    ``metrics.latency.interval`` seconds: ``marked_time`` is its wall
    clock (``time.time()``) at the source."""

    marked_time: float
    source_id: str
    subtask: int


@dataclass(frozen=True)
class EndOfInput:
    """Graceful end of a bounded stream."""
