"""Window assigners (port of ``flink_tpu/window/assigners.py``).

Every non-merging assigner can assign a timestamp column at once
(``assign_batch``): for a sliding window this gives the *pane* of each
record, one non-overlapping slice per slide period, so the device
operators fold each record once and merge panes at a fire. A sliding
window of ``size`` that slides by ``slide`` decomposes into panes of
``slide`` ms when size % slide == 0. CUMULATE windows have panes too, but
a window spans a variable number of them, so they run on the host
WindowOperator. Session windows merge instead: a record opens [ts, ts +
gap), and windows that intersect become one. Processing-time assigners
take the task's clock; ``GlobalWindows`` puts every record of a key in
one window that only a custom trigger fires.

A ``TimeWindow`` or ``GlobalWindow`` equals the reference's of the same
bounds, with the same hash, so window namespaces in keyed state and
timers cross the two packages in snapshots unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np

from ..core.records import MAX_TIMESTAMP

__all__ = ["TimeWindow", "GlobalWindow", "WindowAssigner",
           "TumblingEventTimeWindows", "TumblingProcessingTimeWindows",
           "SlidingEventTimeWindows", "SlidingProcessingTimeWindows",
           "CumulateWindows", "reject_variable_pane_assigner",
           "EventTimeSessionWindows", "ProcessingTimeSessionWindows",
           "GlobalWindows"]


@dataclass(frozen=True, eq=False)
class TimeWindow:
    """[start, end) window; max_timestamp is end-1."""

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

    def _bounds(self, other) -> Optional[tuple]:
        if type(other).__name__ != "TimeWindow":
            return None
        return (other.start, other.end)

    def __eq__(self, other) -> bool:
        b = self._bounds(other)
        return NotImplemented if b is None else (self.start, self.end) == b

    def __hash__(self) -> int:
        return hash((self.start, self.end))

    def __lt__(self, other) -> bool:
        b = self._bounds(other)
        return NotImplemented if b is None else (self.start, self.end) < b

    def __le__(self, other) -> bool:
        b = self._bounds(other)
        return NotImplemented if b is None else (self.start, self.end) <= b

    def __gt__(self, other) -> bool:
        b = self._bounds(other)
        return NotImplemented if b is None else (self.start, self.end) > b

    def __ge__(self, other) -> bool:
        b = self._bounds(other)
        return NotImplemented if b is None else (self.start, self.end) >= b


@dataclass(frozen=True, eq=False)
class GlobalWindow:
    @property
    def max_timestamp(self) -> int:
        return MAX_TIMESTAMP

    def __eq__(self, other) -> bool:
        return (type(other).__name__ == "GlobalWindow"
                or NotImplemented)

    def __hash__(self) -> int:
        return hash(())


def _window_start(ts, size: int, offset: int):
    """ts - (ts - offset) mod size (floor mod: right for negative ts)."""
    return ts - np.mod(ts - offset, size)


class WindowAssigner:
    is_event_time: bool = True
    is_merging: bool = False
    offset: int = 0

    def assign_windows(self, timestamp: int) -> Iterable:
        raise NotImplementedError

    def assign_batch(self, timestamps: np.ndarray) -> Optional[np.ndarray]:
        """The pane start of every record, or None if not paneable."""
        return None

    @property
    def pane_size(self) -> Optional[int]:
        """Pane width in ms when the assigner decomposes into panes."""
        return None

    def windows_for_pane(self, pane_start: int) -> Iterable[TimeWindow]:
        """Every window a pane contributes to."""
        raise NotImplementedError

    def default_trigger(self):
        from .triggers import EventTimeTrigger, ProcessingTimeTrigger
        return EventTimeTrigger() if self.is_event_time \
            else ProcessingTimeTrigger()


@dataclass(frozen=True)
class TumblingEventTimeWindows(WindowAssigner):
    size: int
    offset: int = 0

    @staticmethod
    def of(size_ms: int, offset_ms: int = 0) -> "TumblingEventTimeWindows":
        return TumblingEventTimeWindows(size_ms, offset_ms)

    def assign_windows(self, timestamp: int):
        start = int(_window_start(np.int64(timestamp), self.size,
                                  self.offset))
        return [TimeWindow(start, start + self.size)]

    def assign_batch(self, timestamps: np.ndarray) -> np.ndarray:
        return _window_start(timestamps, self.size, self.offset)

    @property
    def pane_size(self) -> int:
        return self.size

    def windows_for_pane(self, pane_start: int):
        return [TimeWindow(pane_start, pane_start + self.size)]


class TumblingProcessingTimeWindows(TumblingEventTimeWindows):
    is_event_time = False

    @staticmethod
    def of(size_ms: int, offset_ms: int = 0
           ) -> "TumblingProcessingTimeWindows":
        return TumblingProcessingTimeWindows(size_ms, offset_ms)


@dataclass(frozen=True)
class SlidingEventTimeWindows(WindowAssigner):
    size: int
    slide: int
    offset: int = 0

    @staticmethod
    def of(size_ms: int, slide_ms: int,
           offset_ms: int = 0) -> "SlidingEventTimeWindows":
        return SlidingEventTimeWindows(size_ms, slide_ms, offset_ms)

    def assign_windows(self, timestamp: int):
        start = int(_window_start(np.int64(timestamp), self.slide,
                                  self.offset))
        out = []
        while start > timestamp - self.size:
            out.append(TimeWindow(start, start + self.size))
            start -= self.slide
        return out

    def assign_batch(self, timestamps: np.ndarray) -> Optional[np.ndarray]:
        if self.size % self.slide != 0:
            return None
        return _window_start(timestamps, self.slide, self.offset)

    @property
    def pane_size(self) -> Optional[int]:
        return self.slide if self.size % self.slide == 0 else None

    def windows_for_pane(self, pane_start: int):
        n = self.size // self.slide
        return [TimeWindow(pane_start - i * self.slide,
                           pane_start - i * self.slide + self.size)
                for i in range(n)]


class SlidingProcessingTimeWindows(SlidingEventTimeWindows):
    is_event_time = False

    @staticmethod
    def of(size_ms: int, slide_ms: int,
           offset_ms: int = 0) -> "SlidingProcessingTimeWindows":
        return SlidingProcessingTimeWindows(size_ms, slide_ms, offset_ms)


def reject_variable_pane_assigner(assigner, where: str) -> None:
    """The guard of every fixed-panes-per-window fire (device, mesh):
    cumulate windows span a variable pane count."""
    if isinstance(assigner, CumulateWindows):
        raise ValueError(
            f"cumulate windows cannot run on the {where} window operator "
            "(variable panes per window); use the host WindowOperator "
            "(.aggregate/.sum) or the SQL CUMULATE TVF")


@dataclass(frozen=True)
class CumulateWindows(WindowAssigner):
    """Cumulative (expanding) windows (the CUMULATE TVF): within each
    ``size`` base window, windows [base, base + k*step) fire at every step
    until the base window closes. Panes of ``step``; a window spans 1 to
    size/step of them."""

    size: int
    step: int
    offset: int = 0

    def __post_init__(self):
        if self.size % self.step != 0:
            raise ValueError(
                f"CUMULATE size ({self.size}) must be a multiple of the "
                f"step ({self.step})")

    @staticmethod
    def of(size_ms: int, step_ms: int,
           offset_ms: int = 0) -> "CumulateWindows":
        return CumulateWindows(size_ms, step_ms, offset_ms)

    def _base(self, timestamp) -> int:
        return int(_window_start(np.int64(timestamp), self.size,
                                 self.offset))

    def assign_windows(self, timestamp: int):
        return self.windows_for_pane(timestamp)

    def assign_batch(self, timestamps: np.ndarray) -> np.ndarray:
        return _window_start(timestamps, self.step, self.offset)

    @property
    def pane_size(self) -> int:
        return self.step

    def windows_for_pane(self, pane_start: int):
        base = self._base(pane_start)
        n = self.size // self.step
        k_from = (pane_start - base) // self.step + 1
        return [TimeWindow(base, base + k * self.step)
                for k in range(k_from, n + 1)]


@dataclass(frozen=True)
class EventTimeSessionWindows(WindowAssigner):
    """Merging session windows of inactivity ``gap`` ms."""

    gap: int
    is_merging = True

    @staticmethod
    def with_gap(gap_ms: int) -> "EventTimeSessionWindows":
        return EventTimeSessionWindows(gap_ms)

    def assign_windows(self, timestamp: int):
        return [TimeWindow(timestamp, timestamp + self.gap)]


class ProcessingTimeSessionWindows(EventTimeSessionWindows):
    """Session windows on processing time."""

    is_event_time = False

    @staticmethod
    def with_gap(gap_ms: int) -> "ProcessingTimeSessionWindows":
        return ProcessingTimeSessionWindows(gap_ms)


@dataclass(frozen=True)
class GlobalWindows(WindowAssigner):
    is_event_time = False

    @staticmethod
    def create() -> "GlobalWindows":
        return GlobalWindows()

    def assign_windows(self, timestamp: int):
        return [GlobalWindow()]

    def default_trigger(self):
        from .triggers import NeverTrigger
        return NeverTrigger()
