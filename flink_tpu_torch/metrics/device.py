"""Process-global device-path counters (trimmed copy of
``flink_tpu/metrics/device.py``): the incremental fire engine's and the
coalesced ingest's accounting, with the reference's counter names.

* ``panes_sealed_total``: panes folded into the running window state (a
  seal counts 1, a rebuild every live pane of its window);
* ``fire_merge_rows_read``: pane rows read per window fire (a full merge
  reads W, a seal 2 or 1);
* ``batches_coalesced_total``: upstream micro-batches merged into one
  coalesced ingest step;
* ``chain_fused_dispatches_total``: micro-batches a certified fused
  source -> window chain ran as one dispatch (a CUDA graph replay on the
  card).
"""

from __future__ import annotations

import threading

__all__ = ["DeviceStats", "DEVICE_STATS"]


class DeviceStats:
    """Cumulative counters, safe to note from any thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self._panes_sealed = 0
        self._batches_coalesced = 0
        self._fire_merge_rows = 0
        self._chain_dispatches = 0

    def note_panes_sealed(self, n: int = 1) -> None:
        with self._lock:
            self._panes_sealed += int(n)

    def note_batches_coalesced(self, n: int) -> None:
        with self._lock:
            self._batches_coalesced += int(n)

    def note_fire_merge_rows(self, n: int) -> None:
        with self._lock:
            self._fire_merge_rows += int(n)

    def note_chain_dispatch(self) -> None:
        with self._lock:
            self._chain_dispatches += 1

    def snapshot(self) -> dict[str, int]:
        """Flat cumulative view, under the reference's keys."""
        with self._lock:
            return {"panes_sealed_total": self._panes_sealed,
                    "batches_coalesced_total": self._batches_coalesced,
                    "fire_merge_rows_read": self._fire_merge_rows,
                    "chain_fused_dispatches_total": self._chain_dispatches}


DEVICE_STATS = DeviceStats()
