"""Event-time window assigners (trimmed copy of
``flink_tpu/window/assigners.py``).

A sliding window of ``size`` that slides by ``slide`` decomposes into
non-overlapping panes of ``slide`` ms (size % slide == 0), so each record
folds into exactly one pane and a fire merges size/slide panes. Session
windows (``EventTimeSessionWindows``) merge instead: a record opens the
window [ts, ts + gap), and windows that intersect become one; the device
session operator keeps them on per-key lanes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

__all__ = ["WindowAssigner", "TumblingEventTimeWindows",
           "SlidingEventTimeWindows", "EventTimeSessionWindows",
           "TimeWindow"]


@dataclass(frozen=True)
class TimeWindow:
    """[start, end) window; max_timestamp is end-1 (reference TimeWindow)."""

    start: int
    end: int

    @property
    def max_timestamp(self) -> int:
        return self.end - 1

    def intersects(self, other: "TimeWindow") -> bool:
        return (self.start <= other.max_timestamp
                and other.start <= self.max_timestamp)

    def cover(self, other: "TimeWindow") -> "TimeWindow":
        return TimeWindow(min(self.start, other.start),
                          max(self.end, other.end))


class WindowAssigner:
    offset: int = 0

    @property
    def pane_size(self) -> Optional[int]:
        """Pane width in ms when the assigner decomposes into panes."""
        return None


@dataclass(frozen=True)
class TumblingEventTimeWindows(WindowAssigner):
    size: int
    offset: int = 0

    @staticmethod
    def of(size_ms: int, offset_ms: int = 0) -> "TumblingEventTimeWindows":
        return TumblingEventTimeWindows(size_ms, offset_ms)

    @property
    def pane_size(self) -> int:
        return self.size


@dataclass(frozen=True)
class SlidingEventTimeWindows(WindowAssigner):
    size: int
    slide: int
    offset: int = 0

    @staticmethod
    def of(size_ms: int, slide_ms: int,
           offset_ms: int = 0) -> "SlidingEventTimeWindows":
        return SlidingEventTimeWindows(size_ms, slide_ms, offset_ms)

    @property
    def pane_size(self) -> Optional[int]:
        return self.slide if self.size % self.slide == 0 else None


@dataclass(frozen=True)
class EventTimeSessionWindows(WindowAssigner):
    """Merging session windows of inactivity ``gap`` ms."""

    gap: int
    is_merging = True

    @staticmethod
    def with_gap(gap_ms: int) -> "EventTimeSessionWindows":
        return EventTimeSessionWindows(gap_ms)

    def assign_windows(self, timestamp: int) -> list[TimeWindow]:
        return [TimeWindow(timestamp, timestamp + self.gap)]
