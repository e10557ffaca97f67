"""Stream elements besides record batches (trimmed copy of
``flink_tpu/core/elements.py``): watermarks, channel idleness, checkpoint
barriers and the end of a bounded input. They are interleaved with
batches in channel order, which is what gives barriers and watermarks
their alignment semantics."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from .records import MAX_TIMESTAMP

__all__ = ["Watermark", "MAX_WATERMARK", "WatermarkStatus",
           "CheckpointBarrier", "EndOfInput"]


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


@dataclass(frozen=True)
class EndOfInput:
    """Graceful end of a bounded stream."""
