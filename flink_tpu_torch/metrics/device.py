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
  card);
* tiered residency under an HBM budget (``state/tiering/``):
  ``tier_evictions_total`` and ``tier_evicted_keys_total``, key groups
  and keys paged to the host tier; ``tier_prefetches_total`` and
  ``tier_promoted_keys_total``, key groups and keys promoted back;
  ``tier_hot_hit_ratio``, accesses that found their group on the device
  over all accesses; ``tier_hbm_bytes_in_use``, the device bytes of the
  keyed-state planes at the last batch boundary.
* faults and the watchdog (``runtime/faults.py``, ``runtime/watchdog.py``):
  ``device_retries_total`` (transient trips and stalls retried, by scope),
  ``device_degraded_total`` (operators that walked the degrade ladder to
  their CPU rung), ``dead_letter_records_total`` and
  ``dead_letter_batches_total`` (rows and batches quarantined),
  ``injected_faults_total`` (trips of ``faults.spec`` rules),
  ``watchdog_trips_total`` (supervised calls past their deadline) and
  ``stall_detections_total`` (tasks the stall detector failed).
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
        self._tier_evictions = 0
        self._tier_evicted_keys = 0
        self._tier_prefetches = 0
        self._tier_promoted_keys = 0
        self._tier_hot_touches = 0
        self._tier_touches = 0
        self._tier_hbm_bytes = 0
        self._retries: dict[str, int] = {}
        self._degraded: dict[str, int] = {}
        self._injected: dict[str, int] = {}
        self._watchdog_trips: dict[str, int] = {}
        self._stalls: dict[str, int] = {}
        self.dead_letter_records = 0
        self.dead_letter_batches = 0

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

    def note_tier_eviction(self, groups: int, keys: int) -> None:
        with self._lock:
            self._tier_evictions += int(groups)
            self._tier_evicted_keys += int(keys)

    def note_tier_prefetch(self, groups: int, keys: int) -> None:
        with self._lock:
            self._tier_prefetches += int(groups)
            self._tier_promoted_keys += int(keys)

    def note_tier_touches(self, hot: int, total: int) -> None:
        with self._lock:
            self._tier_hot_touches += int(hot)
            self._tier_touches += int(total)

    def set_tier_hbm_bytes(self, nbytes: int) -> None:
        with self._lock:
            self._tier_hbm_bytes = int(nbytes)

    # -- faults, the device guard and the watchdog ------------------------
    def note_retry(self, scope: str, n: int = 1) -> None:
        with self._lock:
            self._retries[scope] = self._retries.get(scope, 0) + n

    def note_degraded(self, scope: str) -> None:
        with self._lock:
            self._degraded[scope] = self._degraded.get(scope, 0) + 1

    def note_injected(self, site: str) -> None:
        with self._lock:
            self._injected[site] = self._injected.get(site, 0) + 1

    def note_dead_letter(self, records: int, batches: int = 1) -> None:
        with self._lock:
            self.dead_letter_records += int(records)
            self.dead_letter_batches += int(batches)

    def note_watchdog_trip(self, site: str) -> None:
        with self._lock:
            self._watchdog_trips[site] = \
                self._watchdog_trips.get(site, 0) + 1

    def note_stall(self, scope: str) -> None:
        with self._lock:
            self._stalls[scope] = self._stalls.get(scope, 0) + 1

    @property
    def retries(self) -> int:
        with self._lock:
            return sum(self._retries.values())

    @property
    def degraded(self) -> int:
        with self._lock:
            return sum(self._degraded.values())

    @property
    def injected_faults(self) -> int:
        with self._lock:
            return sum(self._injected.values())

    @property
    def watchdog_trips(self) -> int:
        with self._lock:
            return sum(self._watchdog_trips.values())

    @property
    def stall_detections(self) -> int:
        with self._lock:
            return sum(self._stalls.values())

    def snapshot(self) -> dict:
        """Flat cumulative view, under the reference's keys."""
        with self._lock:
            return {"panes_sealed_total": self._panes_sealed,
                    "batches_coalesced_total": self._batches_coalesced,
                    "fire_merge_rows_read": self._fire_merge_rows,
                    "chain_fused_dispatches_total": self._chain_dispatches,
                    "tier_evictions_total": self._tier_evictions,
                    "tier_evicted_keys_total": self._tier_evicted_keys,
                    "tier_prefetches_total": self._tier_prefetches,
                    "tier_promoted_keys_total": self._tier_promoted_keys,
                    "tier_hot_hit_ratio": round(
                        self._tier_hot_touches / max(self._tier_touches, 1),
                        6),
                    "tier_hbm_bytes_in_use": self._tier_hbm_bytes,
                    "device_retries_total": sum(self._retries.values()),
                    "device_degraded_total": sum(self._degraded.values()),
                    "dead_letter_records_total": self.dead_letter_records,
                    "dead_letter_batches_total": self.dead_letter_batches,
                    "injected_faults_total": sum(self._injected.values()),
                    "watchdog_trips_total":
                        sum(self._watchdog_trips.values()),
                    "stall_detections_total": sum(self._stalls.values())}


DEVICE_STATS = DeviceStats()
