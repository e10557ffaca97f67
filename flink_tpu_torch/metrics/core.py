"""Metrics: counters, gauges, meters and histograms in scoped groups
(port of ``flink_tpu/metrics/core.py``).

A ``MetricRegistry`` holds every metric of a job under a tuple scope
(job, vertex, subtask[, operator], name). ``env.execute(...,
metrics_registry=reg)`` gives each task a ``TaskMetrics`` group: records
in and out, the busy, idle and backpressured ms a second of its loop,
its progress epoch, and a group per chained operator holding the
operator's watermark gauges and its ``latency`` histogram (ms from a
source's latency marker to the operator). Reporters
(``metrics/reporters.py``) expose a registry: Prometheus text over HTTP,
or a periodic log.

Every metric is safe to read from another thread while the task's
thread updates it.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Optional

__all__ = ["Counter", "Gauge", "Meter", "Histogram", "MetricGroup",
           "MetricRegistry", "TaskMetrics"]


class Counter:
    """A counter several threads may bump: ``+=`` is a read-modify-write
    the GIL does not make atomic, so updates take a lock."""

    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: int = 1) -> None:
        with self._lock:
            self._value -= n

    @property
    def count(self) -> int:
        return self._value


class Gauge:
    def __init__(self, fn: Callable[[], Any]):
        self._fn = fn

    @property
    def value(self) -> Any:
        return self._fn()


class Meter:
    """Events a second over a sliding minute."""

    def __init__(self):
        self._events: deque = deque()
        self._count = 0
        self._lock = threading.Lock()

    def mark(self, n: int = 1) -> None:
        now = time.time()
        with self._lock:
            self._count += n
            self._events.append((now, n))
            cutoff = now - 60.0
            while self._events and self._events[0][0] < cutoff:
                self._events.popleft()

    @property
    def rate(self) -> float:
        now = time.time()
        with self._lock:
            recent = sum(n for t, n in self._events if t >= now - 60.0)
        return recent / 60.0

    @property
    def count(self) -> int:
        return self._count


class Histogram:
    """A reservoir of the last ``window`` values with quantiles."""

    def __init__(self, window: int = 1024):
        self._values: deque = deque(maxlen=window)
        self._lock = threading.Lock()

    def update(self, value: float) -> None:
        with self._lock:
            self._values.append(float(value))

    def quantile(self, q: float) -> float:
        with self._lock:
            vals = sorted(self._values)
        if not vals:
            return 0.0
        return vals[min(int(q * len(vals)), len(vals) - 1)]

    #: the ``le`` bounds of the exposition's cumulative buckets: latency
    #: histograms are milliseconds, 1 ms to 10 s
    BUCKET_BOUNDS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                     500.0, 1000.0, 2500.0, 5000.0, 10000.0)

    def bucket_counts(self, bounds: Optional[tuple] = None
                      ) -> list[tuple[str, int]]:
        """Cumulative ``le``-labelled counts over the window, ending with
        ``("+Inf", count)``: buckets aggregate across processes, a
        summary's quantiles do not."""
        use = self.BUCKET_BOUNDS if bounds is None else tuple(bounds)
        with self._lock:
            vals = list(self._values)
        out = [(repr(float(b)), sum(1 for v in vals if v <= b)) for b in use]
        out.append(("+Inf", len(vals)))
        return out

    @property
    def count(self) -> int:
        return len(self._values)

    @property
    def mean(self) -> float:
        with self._lock:
            vals = list(self._values)
        return sum(vals) / len(vals) if vals else 0.0

    @property
    def sum(self) -> float:
        with self._lock:
            return float(sum(self._values))


class MetricGroup:
    """A scope: ``registry.root().group("job").group("task")...``."""

    def __init__(self, registry: "MetricRegistry", scope: tuple):
        self._registry = registry
        self.scope = scope

    def group(self, name: str) -> "MetricGroup":
        return MetricGroup(self._registry, self.scope + (name,))

    def _register(self, name: str, metric) -> Any:
        self._registry.register(self.scope + (name,), metric)
        return metric

    def counter(self, name: str) -> Counter:
        return self._register(name, Counter())

    def gauge(self, name: str, fn: Callable[[], Any]) -> Gauge:
        return self._register(name, Gauge(fn))

    def meter(self, name: str) -> Meter:
        return self._register(name, Meter())

    def histogram(self, name: str, window: int = 1024) -> Histogram:
        return self._register(name, Histogram(window))


class MetricRegistry:
    def __init__(self):
        self._metrics: dict[tuple, Any] = {}
        self._lock = threading.Lock()

    def register(self, scope: tuple, metric) -> None:
        with self._lock:
            self._metrics[scope] = metric

    def root(self) -> MetricGroup:
        return MetricGroup(self, ())

    def all_metrics(self) -> dict[tuple, Any]:
        with self._lock:
            return dict(self._metrics)

    def snapshot(self) -> dict[str, Any]:
        """A flat name -> number view."""
        out: dict[str, Any] = {}
        for scope, m in self.all_metrics().items():
            name = ".".join(scope)
            if isinstance(m, Counter):
                out[name] = m.count
            elif isinstance(m, Gauge):
                try:
                    out[name] = m.value
                except Exception:  # noqa: BLE001 - a gauge may race teardown
                    out[name] = None
            elif isinstance(m, Meter):
                out[name + ".rate"] = m.rate
                out[name + ".count"] = m.count
            elif isinstance(m, Histogram):
                out[name + ".p50"] = m.quantile(0.50)
                out[name + ".p99"] = m.quantile(0.99)
                out[name + ".mean"] = m.mean
        return out


class TaskMetrics:
    """A task's standard metrics under (job, vertex, subtask)."""

    def __init__(self, registry: MetricRegistry, job: str, vertex: str,
                 subtask: int):
        g = registry.root().group(job).group(vertex).group(str(subtask))
        self.records_in = g.counter("numRecordsIn")
        self.records_out = g.counter("numRecordsOut")
        # the reference's names, which nothing updates yet in either
        self.watermark_lag = g.histogram("watermarkLag")
        self.batch_size = g.histogram("batchSize")
        self.group = g
        self.io_timers = None

    def bind_io_timers(self, timers) -> None:
        """The task loop's busy, idle and backpressured time as gauges;
        the timers outlive the thread, so a finished job reads stable."""
        self.io_timers = timers
        g = self.group
        g.gauge("busyTimeMsPerSecond", lambda: timers.busy_ms_per_s)
        g.gauge("idleTimeMsPerSecond", lambda: timers.idle_ms_per_s)
        g.gauge("backPressuredTimeMsPerSecond",
                lambda: timers.backpressured_ms_per_s)
        g.gauge("busyTimeRatio", lambda: timers.busy_ratio)

    def bind_progress(self, progress) -> None:
        g = self.group
        g.gauge("lastProgressAgeMs", lambda: progress.age_ms)
        g.gauge("progressEpoch", lambda: progress.epoch)

    def operator_group(self, op_key: str) -> MetricGroup:
        """An operator's scope under this task."""
        return self.group.group(op_key)
