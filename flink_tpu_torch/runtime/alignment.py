"""Watermark alignment across sources (port of
``flink_tpu/runtime/alignment.py``).

Sources of one alignment group must not run ahead of the group's slowest
source by more than ``max_drift``: each source reports its watermark, the
coordinator combines the reports into a group minimum, and a source whose
watermark passes ``min + max_drift`` pauses reading until the group
catches up. This caps the event-time skew between sources, which is the
span of open panes a downstream device window's ring must hold.

A job's sources share one coordinator. ``set_remote_minima`` installs
minima combined elsewhere (the reference's distributed hosts ship theirs
with a heartbeat; the port's cluster layer, item 10 group 8, does not
call it yet).
"""

from __future__ import annotations

import threading

MAX_WATERMARK = (1 << 63) - 1

__all__ = ["WatermarkAlignmentCoordinator", "MAX_WATERMARK"]


class WatermarkAlignmentCoordinator:
    """Per-(group, source) watermarks and each group's largest allowed
    watermark. An idle or finished source reports MAX_WATERMARK, which
    leaves it out of the minimum."""

    def __init__(self):
        self._lock = threading.Lock()
        self._reported: dict[str, dict[str, int]] = {}   # group -> task -> wm
        self._drift: dict[str, int] = {}                 # group -> drift
        self._remote_min: dict[str, int] = {}

    def report(self, group: str, task_id: str, watermark: int,
               max_drift_ms: int) -> int:
        """Record ``task_id``'s watermark; returns the group's largest
        allowed watermark (min + drift)."""
        with self._lock:
            self._reported.setdefault(group, {})[task_id] = watermark
            self._drift[group] = max_drift_ms
            return self._max_allowed_locked(group)

    def unregister(self, group: str, task_id: str) -> None:
        """A finished source must not hold its group back."""
        with self._lock:
            self._reported.get(group, {}).pop(task_id, None)

    def group_min(self, group: str) -> int:
        """The minimum over this process's live reports."""
        with self._lock:
            wms = list(self._reported.get(group, {}).values())
            return min(wms) if wms else MAX_WATERMARK

    def local_minima(self) -> dict[str, int]:
        with self._lock:
            return {g: (min(t.values()) if t else MAX_WATERMARK)
                    for g, t in self._reported.items()}

    def set_remote_minima(self, minima: dict[str, int]) -> None:
        """Install minima combined elsewhere; replaces the previous view,
        so a group whose remote sources all finished stops constraining
        the local ones."""
        with self._lock:
            self._remote_min = dict(minima)

    def max_allowed(self, group: str) -> int:
        with self._lock:
            return self._max_allowed_locked(group)

    def _max_allowed_locked(self, group: str) -> int:
        wms = list(self._reported.get(group, {}).values())
        lo = min(wms) if wms else MAX_WATERMARK
        remote = self._remote_min.get(group)
        if remote is not None:
            lo = min(lo, remote)
        if lo >= MAX_WATERMARK:
            return MAX_WATERMARK
        return lo + self._drift.get(group, 0)
