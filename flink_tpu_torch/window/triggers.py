"""Window triggers and evictors (port of ``flink_tpu/window/triggers.py``).

A trigger decides when a window of the host WindowOperator fires and
whether it purges: at the watermark (``EventTimeTrigger``), at the
processing-time end (``ProcessingTimeTrigger``), every N elements
(``CountTrigger``), at an event-time interval while the window is open
(``ContinuousEventTimeTrigger``), each fire turned into fire-and-purge
(``PurgingTrigger``), or never (``NeverTrigger``, the global window's
default). It sees the operator's timers and per-(key, window) trigger
state through ``TriggerContext``. An evictor trims a list-state window's
elements before (and after) its function runs.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any

__all__ = [
    "TriggerResult", "Trigger", "TriggerContext", "EventTimeTrigger",
    "ProcessingTimeTrigger", "CountTrigger", "PurgingTrigger", "NeverTrigger",
    "ContinuousEventTimeTrigger", "Evictor", "CountEvictor", "TimeEvictor",
]


class TriggerResult(enum.Flag):
    CONTINUE = 0
    FIRE = enum.auto()
    PURGE = enum.auto()
    FIRE_AND_PURGE = FIRE | PURGE

    @property
    def fires(self) -> bool:
        return bool(self & TriggerResult.FIRE)

    @property
    def purges(self) -> bool:
        return bool(self & TriggerResult.PURGE)


class TriggerContext:
    """What a trigger can do (reference Trigger.TriggerContext): timers +
    per-(key,window) trigger state. Provided by the window operator."""

    def __init__(self, key, window, timer_service, state_accessor,
                 current_watermark: int):
        self.key = key
        self.window = window
        self._timers = timer_service
        self._state = state_accessor
        self.current_watermark = current_watermark

    def register_event_time_timer(self, ts: int) -> None:
        self._timers.register_event_time_timer(self.key, ts, self.window)

    def register_processing_time_timer(self, ts: int) -> None:
        self._timers.register_processing_time_timer(self.key, ts, self.window)

    def delete_event_time_timer(self, ts: int) -> None:
        self._timers.delete_event_time_timer(self.key, ts, self.window)

    def delete_processing_time_timer(self, ts: int) -> None:
        self._timers.delete_processing_time_timer(self.key, ts, self.window)

    def get_trigger_state(self, name: str, default: Any = None) -> Any:
        return self._state.get(name, default)

    def set_trigger_state(self, name: str, value: Any) -> None:
        self._state.set(name, value)

    def clear_trigger_state(self, name: str) -> None:
        self._state.clear(name)


class Trigger:
    def on_element(self, timestamp: int, window, ctx: TriggerContext) -> TriggerResult:
        return TriggerResult.CONTINUE

    def on_event_time(self, time: int, window, ctx: TriggerContext) -> TriggerResult:
        return TriggerResult.CONTINUE

    def on_processing_time(self, time: int, window,
                           ctx: TriggerContext) -> TriggerResult:
        return TriggerResult.CONTINUE

    def clear(self, window, ctx: TriggerContext) -> None:
        pass

    def can_merge(self) -> bool:
        return False

    def on_merge(self, window, ctx: TriggerContext) -> None:
        pass


class EventTimeTrigger(Trigger):
    """Fire once the watermark passes window end (reference EventTimeTrigger)."""

    def on_element(self, timestamp, window, ctx):
        if window.max_timestamp <= ctx.current_watermark:
            return TriggerResult.FIRE
        ctx.register_event_time_timer(window.max_timestamp)
        return TriggerResult.CONTINUE

    def on_event_time(self, time, window, ctx):
        return TriggerResult.FIRE if time == window.max_timestamp \
            else TriggerResult.CONTINUE

    def clear(self, window, ctx):
        ctx.delete_event_time_timer(window.max_timestamp)

    def can_merge(self) -> bool:
        return True

    def on_merge(self, window, ctx):
        if window.max_timestamp > ctx.current_watermark:
            ctx.register_event_time_timer(window.max_timestamp)


class ProcessingTimeTrigger(Trigger):
    def on_element(self, timestamp, window, ctx):
        ctx.register_processing_time_timer(window.max_timestamp)
        return TriggerResult.CONTINUE

    def on_processing_time(self, time, window, ctx):
        return TriggerResult.FIRE

    def clear(self, window, ctx):
        ctx.delete_processing_time_timer(window.max_timestamp)

    def can_merge(self) -> bool:
        return True

    def on_merge(self, window, ctx):
        ctx.register_processing_time_timer(window.max_timestamp)


@dataclass
class CountTrigger(Trigger):
    """Fire every N elements (reference CountTrigger)."""

    max_count: int

    @staticmethod
    def of(n: int) -> "CountTrigger":
        return CountTrigger(n)

    def on_element(self, timestamp, window, ctx):
        count = ctx.get_trigger_state("count", 0) + 1
        if count >= self.max_count:
            ctx.clear_trigger_state("count")
            return TriggerResult.FIRE
        ctx.set_trigger_state("count", count)
        return TriggerResult.CONTINUE

    def clear(self, window, ctx):
        ctx.clear_trigger_state("count")


@dataclass
class ContinuousEventTimeTrigger(Trigger):
    """Fire at a fixed event-time interval while the window is open."""

    interval: int

    @staticmethod
    def of(interval_ms: int) -> "ContinuousEventTimeTrigger":
        return ContinuousEventTimeTrigger(interval_ms)

    def on_element(self, timestamp, window, ctx):
        if window.max_timestamp <= ctx.current_watermark:
            return TriggerResult.FIRE
        ctx.register_event_time_timer(window.max_timestamp)
        if ctx.get_trigger_state("next-fire") is None:
            next_fire = timestamp - (timestamp % self.interval) + self.interval
            ctx.set_trigger_state("next-fire", next_fire)
            ctx.register_event_time_timer(next_fire)
        return TriggerResult.CONTINUE

    def on_event_time(self, time, window, ctx):
        if time == window.max_timestamp:
            return TriggerResult.FIRE
        next_fire = ctx.get_trigger_state("next-fire")
        if next_fire == time:
            ctx.set_trigger_state("next-fire", time + self.interval)
            ctx.register_event_time_timer(time + self.interval)
            return TriggerResult.FIRE
        return TriggerResult.CONTINUE

    def clear(self, window, ctx):
        ctx.delete_event_time_timer(window.max_timestamp)
        nf = ctx.get_trigger_state("next-fire")
        if nf is not None:
            ctx.delete_event_time_timer(nf)
            ctx.clear_trigger_state("next-fire")


@dataclass
class PurgingTrigger(Trigger):
    """Wraps a trigger so every FIRE becomes FIRE_AND_PURGE."""

    inner: Trigger

    @staticmethod
    def of(inner: Trigger) -> "PurgingTrigger":
        return PurgingTrigger(inner)

    def on_element(self, timestamp, window, ctx):
        return self._purge(self.inner.on_element(timestamp, window, ctx))

    def on_event_time(self, time, window, ctx):
        return self._purge(self.inner.on_event_time(time, window, ctx))

    def on_processing_time(self, time, window, ctx):
        return self._purge(self.inner.on_processing_time(time, window, ctx))

    def clear(self, window, ctx):
        self.inner.clear(window, ctx)

    @staticmethod
    def _purge(r: TriggerResult) -> TriggerResult:
        return TriggerResult.FIRE_AND_PURGE if r.fires else r


class NeverTrigger(Trigger):
    pass


# ---------------------------------------------------------------------------
# Evictors (list-state windows only — reference EvictingWindowOperator)
# ---------------------------------------------------------------------------

class Evictor:
    def evict_before(self, elements: list, window, current_watermark: int) -> list:
        return elements

    def evict_after(self, elements: list, window, current_watermark: int) -> list:
        return elements


@dataclass
class CountEvictor(Evictor):
    max_count: int

    @staticmethod
    def of(n: int) -> "CountEvictor":
        return CountEvictor(n)

    def evict_before(self, elements, window, current_watermark):
        return elements[-self.max_count:]


@dataclass
class TimeEvictor(Evictor):
    """Keep only elements within window_max_ts - keep_time."""

    keep_time: int

    @staticmethod
    def of(keep_ms: int) -> "TimeEvictor":
        return TimeEvictor(keep_ms)

    def evict_before(self, elements, window, current_watermark):
        if not elements:
            return elements
        max_ts = max(ts for _, ts in elements)
        return [(v, ts) for v, ts in elements if ts >= max_ts - self.keep_time]
