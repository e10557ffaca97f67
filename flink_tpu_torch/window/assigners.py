"""Pane-decomposable event-time window assigners (trimmed copy of
``flink_tpu/window/assigners.py``).

A sliding window of ``size`` that slides by ``slide`` decomposes into
non-overlapping panes of ``slide`` ms (size % slide == 0), so each record
folds into exactly one pane and a fire merges size/slide panes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

__all__ = ["WindowAssigner", "TumblingEventTimeWindows",
           "SlidingEventTimeWindows"]


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
