"""Internal timer service: per-key event-time and processing-time timers
(port of ``flink_tpu/runtime/timers.py``).

Timers are (timestamp, key, namespace) triples, deduplicated and
partitioned by key group, so they snapshot and restore with keyed state
and re-shard on rescale. Event-time timers fire when the operator's
watermark passes them; processing-time timers when the task's loop
advances the clock. A binary heap with a set of live timers; a deleted
timer stays in the heap and is skipped when it surfaces. Snapshots are
the reference's format: ``{"event": {kg: [(ts, key, ns)]}, "proc": ...,
"watermark": ts}``.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Any, Callable, Iterable

from ..core.keygroups import KeyGroupRange, assign_to_key_group
from ..core.records import MIN_TIMESTAMP

__all__ = ["Timer", "InternalTimerService"]


@dataclass(frozen=True, order=True)
class Timer:
    timestamp: int
    key: Any
    namespace: Any = None


class InternalTimerService:
    """One timer service per operator, confined to the task's thread."""

    def __init__(self, key_group_range: KeyGroupRange, max_parallelism: int,
                 on_event_time: Callable[[Timer], None],
                 on_processing_time: Callable[[Timer], None]):
        self.key_group_range = key_group_range
        self.max_parallelism = max_parallelism
        self._on_event_time = on_event_time
        self._on_processing_time = on_processing_time
        # heap entries are (ts, seq, kg, key, ns); seq breaks ties so keys
        # and namespaces (possibly not comparable) are never compared
        self._event_heap: list[tuple] = []
        self._event_set: set[tuple[int, Any, Any]] = set()
        self._proc_heap: list[tuple] = []
        self._proc_set: set[tuple[int, Any, Any]] = set()
        self._seq = 0
        self.current_watermark = MIN_TIMESTAMP

    def _register(self, heap: list, live: set, key: Any, timestamp: int,
                  namespace: Any) -> None:
        t = (int(timestamp), key, namespace)
        if t not in live:
            live.add(t)
            kg = assign_to_key_group(key, self.max_parallelism)
            self._seq += 1
            heapq.heappush(heap, (int(timestamp), self._seq, kg, key,
                                  namespace))

    def register_event_time_timer(self, key: Any, timestamp: int,
                                  namespace: Any = None) -> None:
        self._register(self._event_heap, self._event_set, key, timestamp,
                       namespace)

    def register_processing_time_timer(self, key: Any, timestamp: int,
                                       namespace: Any = None) -> None:
        self._register(self._proc_heap, self._proc_set, key, timestamp,
                       namespace)

    def delete_event_time_timer(self, key: Any, timestamp: int,
                                namespace: Any = None) -> None:
        self._event_set.discard((int(timestamp), key, namespace))

    def delete_processing_time_timer(self, key: Any, timestamp: int,
                                     namespace: Any = None) -> None:
        self._proc_set.discard((int(timestamp), key, namespace))

    # -- firing ------------------------------------------------------------
    @staticmethod
    def _fire(heap: list, live: set, upto: int, callback) -> None:
        while heap and heap[0][0] <= upto:
            ts, _seq, _kg, key, ns = heapq.heappop(heap)
            ident = (ts, key, ns)
            if ident in live:  # not deleted
                live.discard(ident)
                callback(Timer(ts, key, ns))

    def advance_watermark(self, watermark: int) -> None:
        """Fire every event-time timer at or before ``watermark``."""
        self.current_watermark = watermark
        self._fire(self._event_heap, self._event_set, watermark,
                   self._on_event_time)

    def advance_processing_time(self, now_ms: int) -> None:
        self._fire(self._proc_heap, self._proc_set, now_ms,
                   self._on_processing_time)

    # -- checkpointing: timers snapshot per key group ----------------------
    def snapshot(self) -> dict:
        def dump(heap, live):
            per_kg: dict[int, list] = {}
            for ts, _seq, kg, key, ns in heap:
                if (ts, key, ns) in live:
                    per_kg.setdefault(kg, []).append((ts, key, ns))
            return per_kg

        return {"event": dump(self._event_heap, self._event_set),
                "proc": dump(self._proc_heap, self._proc_set),
                "watermark": self.current_watermark}

    def restore(self, snapshots: Iterable[dict]) -> None:
        self._event_heap, self._event_set = [], set()
        self._proc_heap, self._proc_set = [], set()
        for snap in snapshots:
            for kind in ("event", "proc"):
                heap = self._event_heap if kind == "event" else \
                    self._proc_heap
                live = self._event_set if kind == "event" else self._proc_set
                for kg, timers in snap.get(kind, {}).items():
                    kg = int(kg)
                    if kg not in self.key_group_range:
                        continue
                    for ts, key, ns in timers:
                        ident = (int(ts), key, ns)
                        if ident not in live:
                            live.add(ident)
                            self._seq += 1
                            heapq.heappush(heap,
                                           (int(ts), self._seq, kg, key, ns))
            self.current_watermark = max(self.current_watermark,
                                         snap.get("watermark", MIN_TIMESTAMP))
