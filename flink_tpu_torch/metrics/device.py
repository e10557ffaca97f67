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
* live rescale of a mesh (``MeshWindowAggOperator.rescale_live``):
  ``rescales_total``, ``keygroups_migrated_total`` (populated key groups
  whose owner changed), ``rescale_bytes_moved_total`` (row bytes of the
  pages that moved) and ``rescale_ms`` (time inside the switches).
* transfers (``note_h2d``/``note_d2h``, where the reference notes them):
  ``h2d_bytes``, ``h2d_records``, ``h2d_batches``, ``d2h_bytes``,
  ``d2h_records``, ``d2h_fires``; each note is also a ``transfer.h2d`` or
  ``transfer.d2h`` sample of the device-time ledger, with its bytes.
* the build cache (``runtime/aot.py``): ``aot_hits_total`` (libraries
  loaded from a verified artifact), ``aot_misses_total``,
  ``aot_stores_total``, ``aot_fallbacks_total`` (a load that failed and
  fell back to a build), ``aot_in_memory_evictions_total`` (programs an
  in-memory cache evicted under ``aot.in-memory-max-programs``),
  ``verify_failures_total`` (artifacts and checkpoints that failed their
  digests) and ``compile_storms_total`` (live nvcc builds while the cache
  was on).
* kernel builds (``ops/kernels.py``, the port's counterpart of the
  reference's XLA compiles): ``compiles`` (nvcc builds),
  ``compile_cache_hits`` (libraries found built), ``compile_ms``; each
  build is a ``device.Compile`` span of the tracer set by
  ``set_compile_tracer``.
* ``restore_fallbacks_total`` (restores that skipped a corrupt
  checkpoint) and ``spans_dropped_total`` (spans the in-memory trace ring
  evicted).

With a tracer set (``set_compile_tracer``, done at deploy when
``traces.enabled``), each transfer note is also a ``device.H2D`` or
``device.D2H`` span, host times only; a verify failure dumps the flight
recorder (``corrupt-artifact``). ``bind_device_metrics`` registers every
counter as a gauge under the reference's name (``DEVICE_GAUGES``); the
names of the cluster's counters, which the port does not keep, are
``DEVICE_GAUGES_LEFT_OUT``.
"""

from __future__ import annotations

import threading
from typing import Optional

from .profiler import DEVICE_LEDGER

__all__ = ["DeviceStats", "DEVICE_STATS", "DEVICE_GAUGES",
           "DEVICE_GAUGES_LEFT_OUT", "bind_device_metrics",
           "set_compile_tracer"]


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
        self._rescales = 0
        self._keygroups_migrated = 0
        self._rescale_bytes_moved = 0
        self._rescale_ms = 0.0
        self.h2d_bytes = 0
        self.h2d_records = 0
        self.h2d_batches = 0
        self.d2h_bytes = 0
        self.d2h_records = 0
        self.d2h_fires = 0
        self._aot_hits: dict[str, int] = {}
        self._aot_misses: dict[str, int] = {}
        self._aot_stores: dict[str, int] = {}
        self._aot_fallbacks: dict[str, int] = {}
        self._aot_evictions = 0
        self._verify_failures: dict[str, int] = {}
        self._restore_fallbacks: dict[str, int] = {}
        self._compiles: dict[str, int] = {}
        self._cache_hits: dict[str, int] = {}
        self._compile_ms: dict[str, float] = {}
        self._compile_storms: dict[str, int] = {}
        self._spans_dropped = 0
        self._tracer = None  # a Tracer receiving device spans, or None

    # -- kernel builds -------------------------------------------------------
    def note_build(self, scope: str) -> None:
        with self._lock:
            self._compiles[scope] = self._compiles.get(scope, 0) + 1

    def note_cache_hit(self, scope: str) -> None:
        with self._lock:
            self._cache_hits[scope] = self._cache_hits.get(scope, 0) + 1

    def note_compile_done(self, scope: str, ms: float,
                          start_ms: Optional[int] = None) -> None:
        with self._lock:
            self._compile_ms[scope] = self._compile_ms.get(scope, 0.0) + ms
            tracer = self._tracer
        if tracer is not None:
            sb = tracer.span("device", "Compile").set_attribute(
                "scope", scope).set_attribute("ms", round(ms, 3))
            if start_ms is not None:
                sb.set_start_ts(start_ms)
            sb.finish()

    def note_compile_storm(self, scope: str) -> None:
        """A live build while the build cache was on: none on a warmed
        process is the cache's contract."""
        with self._lock:
            self._compile_storms[scope] = \
                self._compile_storms.get(scope, 0) + 1

    def note_spans_dropped(self, n: int = 1) -> None:
        with self._lock:
            self._spans_dropped += int(n)

    # -- transfers -----------------------------------------------------------
    def note_h2d(self, nbytes: int, records: int = 0,
                 ms: Optional[float] = None) -> None:
        with self._lock:
            self.h2d_bytes += int(nbytes)
            self.h2d_records += int(records)
            self.h2d_batches += 1
            tracer = self._tracer
        if tracer is not None:
            self._finish_transfer(tracer.span("device", "H2D"),
                                  nbytes, records, ms)
        DEVICE_LEDGER.record("transfer.h2d", ms or 0.0, nbytes=nbytes)

    def note_d2h(self, nbytes: int, records: int = 0,
                 ms: Optional[float] = None) -> None:
        with self._lock:
            self.d2h_bytes += int(nbytes)
            self.d2h_records += int(records)
            self.d2h_fires += 1
            tracer = self._tracer
        if tracer is not None:
            self._finish_transfer(tracer.span("device", "D2H"),
                                  nbytes, records, ms)
        DEVICE_LEDGER.record("transfer.d2h", ms or 0.0, nbytes=nbytes)

    @staticmethod
    def _finish_transfer(sb, nbytes: int, records: int,
                         ms: Optional[float]) -> None:
        from .tracing import now_ms
        end = now_ms()
        sb.set_attribute("bytes", int(nbytes))
        sb.set_attribute("records", int(records))
        sb.set_start_ts(end - int(ms) if ms else end)
        sb.finish(end)

    # -- the build cache -----------------------------------------------------
    def note_aot_hit(self, scope: str) -> None:
        with self._lock:
            self._aot_hits[scope] = self._aot_hits.get(scope, 0) + 1

    def note_aot_miss(self, scope: str) -> None:
        with self._lock:
            self._aot_misses[scope] = self._aot_misses.get(scope, 0) + 1

    def note_aot_store(self, scope: str) -> None:
        with self._lock:
            self._aot_stores[scope] = self._aot_stores.get(scope, 0) + 1

    def note_aot_fallback(self, scope: str) -> None:
        with self._lock:
            self._aot_fallbacks[scope] = \
                self._aot_fallbacks.get(scope, 0) + 1

    def note_aot_eviction(self, n: int = 1) -> None:
        with self._lock:
            self._aot_evictions += int(n)

    def note_verify_failure(self, scope: str) -> None:
        with self._lock:
            self._verify_failures[scope] = \
                self._verify_failures.get(scope, 0) + 1
        from .tracing import dump_flight_recorder
        dump_flight_recorder("corrupt-artifact", scope=scope)

    def note_restore_fallback(self, scope: str) -> None:
        with self._lock:
            self._restore_fallbacks[scope] = \
                self._restore_fallbacks.get(scope, 0) + 1

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

    def note_rescale(self, keygroups_migrated: int, bytes_moved: int,
                     duration_ms: float) -> None:
        with self._lock:
            self._rescales += 1
            self._keygroups_migrated += int(keygroups_migrated)
            self._rescale_bytes_moved += int(bytes_moved)
            self._rescale_ms += float(duration_ms)

    @property
    def rescales(self) -> int:
        with self._lock:
            return self._rescales

    @property
    def keygroups_migrated(self) -> int:
        with self._lock:
            return self._keygroups_migrated

    @property
    def rescale_bytes_moved(self) -> int:
        with self._lock:
            return self._rescale_bytes_moved

    @property
    def rescale_ms(self) -> float:
        with self._lock:
            return self._rescale_ms

    @property
    def compiles(self) -> int:
        with self._lock:
            return sum(self._compiles.values())

    @property
    def compile_cache_hits(self) -> int:
        with self._lock:
            return sum(self._cache_hits.values())

    @property
    def compile_ms(self) -> float:
        with self._lock:
            return sum(self._compile_ms.values())

    @property
    def compile_storms(self) -> int:
        with self._lock:
            return sum(self._compile_storms.values())

    @property
    def spans_dropped(self) -> int:
        with self._lock:
            return self._spans_dropped

    @property
    def verify_failures(self) -> int:
        with self._lock:
            return sum(self._verify_failures.values())

    @property
    def restore_fallbacks(self) -> int:
        with self._lock:
            return sum(self._restore_fallbacks.values())

    @property
    def aot_hits(self) -> int:
        with self._lock:
            return sum(self._aot_hits.values())

    @property
    def aot_misses(self) -> int:
        with self._lock:
            return sum(self._aot_misses.values())

    @property
    def aot_stores(self) -> int:
        with self._lock:
            return sum(self._aot_stores.values())

    @property
    def aot_fallbacks(self) -> int:
        with self._lock:
            return sum(self._aot_fallbacks.values())

    @property
    def aot_in_memory_evictions(self) -> int:
        with self._lock:
            return self._aot_evictions

    @property
    def panes_sealed(self) -> int:
        with self._lock:
            return self._panes_sealed

    @property
    def batches_coalesced(self) -> int:
        with self._lock:
            return self._batches_coalesced

    @property
    def fire_merge_rows(self) -> int:
        with self._lock:
            return self._fire_merge_rows

    @property
    def chain_dispatches(self) -> int:
        with self._lock:
            return self._chain_dispatches

    @property
    def tier_evictions(self) -> int:
        with self._lock:
            return self._tier_evictions

    @property
    def tier_prefetches(self) -> int:
        with self._lock:
            return self._tier_prefetches

    @property
    def tier_hot_hit_ratio(self) -> float:
        with self._lock:
            return self._tier_hot_touches / max(self._tier_touches, 1)

    @property
    def tier_hbm_bytes_in_use(self) -> int:
        with self._lock:
            return self._tier_hbm_bytes

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
                    "rescales_total": self._rescales,
                    "keygroups_migrated_total": self._keygroups_migrated,
                    "rescale_bytes_moved_total": self._rescale_bytes_moved,
                    "rescale_ms": round(self._rescale_ms, 3),
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
                    "stall_detections_total": sum(self._stalls.values()),
                    "h2d_bytes": self.h2d_bytes,
                    "h2d_records": self.h2d_records,
                    "h2d_batches": self.h2d_batches,
                    "d2h_bytes": self.d2h_bytes,
                    "d2h_records": self.d2h_records,
                    "d2h_fires": self.d2h_fires,
                    "aot_hits_total": sum(self._aot_hits.values()),
                    "aot_misses_total": sum(self._aot_misses.values()),
                    "aot_stores_total": sum(self._aot_stores.values()),
                    "aot_fallbacks_total": sum(self._aot_fallbacks.values()),
                    "aot_in_memory_evictions_total": self._aot_evictions,
                    "verify_failures_total":
                        sum(self._verify_failures.values()),
                    "restore_fallbacks_total":
                        sum(self._restore_fallbacks.values()),
                    "compiles": sum(self._compiles.values()),
                    "compile_cache_hits": sum(self._cache_hits.values()),
                    "compile_ms": round(sum(self._compile_ms.values()), 3),
                    "compile_storms_total":
                        sum(self._compile_storms.values()),
                    "spans_dropped_total": self._spans_dropped}

    def reset(self) -> None:
        """Every counter back to zero (test isolation: they are otherwise
        cumulative over the process, as Prometheus counters are). The
        compile tracer stays."""
        with self._lock:
            for name, value in vars(self).items():
                if isinstance(value, dict):
                    value.clear()
                elif isinstance(value, (int, float)) \
                        and not isinstance(value, bool):
                    setattr(self, name, type(value)(0))


DEVICE_STATS = DeviceStats()


def set_compile_tracer(tracer) -> None:
    """Route the device spans (``device.Compile``, ``H2D``, ``D2H``) into
    a Tracer; None turns them off."""
    DEVICE_STATS._tracer = tracer


#: (reference gauge name, DeviceStats attribute) of every counter the
#: port keeps, in the reference's order: the ``device`` scope of a
#: registry (Prometheus ``flink_tpu_device_<name>``)
DEVICE_GAUGES: tuple = (
    ("compiles", "compiles"),
    ("compile_cache_hits", "compile_cache_hits"),
    ("compile_ms", "compile_ms"),
    ("h2d_bytes", "h2d_bytes"),
    ("h2d_records", "h2d_records"),
    ("h2d_batches", "h2d_batches"),
    ("d2h_bytes", "d2h_bytes"),
    ("d2h_records", "d2h_records"),
    ("d2h_fires", "d2h_fires"),
    ("retries_total", "retries"),
    ("degraded_total", "degraded"),
    ("dead_letter_records_total", "dead_letter_records"),
    ("dead_letter_batches_total", "dead_letter_batches"),
    ("injected_faults_total", "injected_faults"),
    ("watchdog_trips_total", "watchdog_trips"),
    ("stall_detections_total", "stall_detections"),
    ("checkpoint_verify_failures_total", "verify_failures"),
    ("restore_fallbacks_total", "restore_fallbacks"),
    ("aot_hits_total", "aot_hits"),
    ("aot_misses_total", "aot_misses"),
    ("aot_stores_total", "aot_stores"),
    ("aot_fallbacks_total", "aot_fallbacks"),
    ("aot_in_memory_evictions_total", "aot_in_memory_evictions"),
    ("compile_storms_total", "compile_storms"),
    ("spans_dropped_total", "spans_dropped"),
    ("panes_sealed_total", "panes_sealed"),
    ("batches_coalesced_total", "batches_coalesced"),
    ("fire_merge_rows_read", "fire_merge_rows"),
    ("chain_fused_dispatches_total", "chain_dispatches"),
    ("rescales_total", "rescales"),
    ("keygroups_migrated_total", "keygroups_migrated"),
    ("rescale_bytes_moved_total", "rescale_bytes_moved"),
    ("rescale_ms", "rescale_ms"),
    ("tier_evictions_total", "tier_evictions"),
    ("tier_prefetches_total", "tier_prefetches"),
    ("tier_hot_hit_ratio", "tier_hot_hit_ratio"),
    ("tier_hbm_bytes_in_use", "tier_hbm_bytes_in_use"),
)

#: the reference's gauges of the cluster (item 10, group 8: the network
#: transport, coordinator high availability), which the port does not
#: keep and ``bind_device_metrics`` does not register
DEVICE_GAUGES_LEFT_OUT: tuple = (
    "network_reconnects_total", "frames_deduped_total",
    "zombies_fenced_total", "network_errors_total",
    "leader_elections_total", "coordinator_failovers_total",
)


def bind_device_metrics(registry) -> None:
    """Register every counter of ``DEVICE_GAUGES`` as a gauge under the
    ``device`` scope of a MetricRegistry, so ``prometheus_text`` and the
    reporters expose what ``snapshot()`` reads. Idempotent: binding again
    overwrites the same entries."""
    g = registry.root().group("device")
    s = DEVICE_STATS
    for name, attr in DEVICE_GAUGES:
        g.gauge(name, lambda attr=attr: getattr(s, attr))
