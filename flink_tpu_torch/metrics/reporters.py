"""Metric reporters: exporters over a ``MetricRegistry`` (port of
``flink_tpu/metrics/reporters.py``).

* ``prometheus_text(registry)``: the registry in the Prometheus text
  exposition format, with the reference's ``flink_tpu_`` series names, so
  one dashboard reads both packages. Counter -> counter, Gauge -> gauge,
  Meter -> gauge (rate) + counter, Histogram -> summary plus cumulative
  ``le`` buckets. A gauge that returns no number renders ``NaN``; one that
  raises is skipped; labels are escaped. With the device-time ledger on,
  its per-job rollups follow as job-labelled gauges.
* ``PrometheusReporter``: serves ``GET /metrics`` (pull) on
  ``utils/httpd.py``, by default on a free loopback port.
* ``LoggingReporter``: writes the registry's snapshot every
  ``interval_s`` seconds.
* ``register_reporter(name, factory)`` and ``reporters_from_config``: the
  names of ``metrics.reporters`` resolve to factories (a plugin's
  ``registry.metric_reporter`` registers here).

A job's caller opens reporters on the registry it passes to the job, as
in the reference::

    reg = MetricRegistry()
    for rep in reporters_from_config(env.config):
        rep.open(reg)
    env.execute("job", metrics_registry=reg)
"""

from __future__ import annotations

import http.server
import re
import threading
from typing import Callable, Optional

from .core import Counter, Gauge, Histogram, Meter, MetricRegistry

__all__ = ["MetricReporter", "PrometheusReporter", "LoggingReporter",
           "prometheus_text", "register_reporter", "reporters_from_config"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(parts: tuple) -> str:
    return _NAME_RE.sub("_", "_".join(("flink_tpu",) + tuple(parts)))


def _prom_value(v) -> str:
    """A finite number as it is, a non-finite float as Prometheus spells
    it, and anything that is no number as NaN."""
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        try:  # numpy scalars and 0-d arrays read as floats
            v = float(v)
        except (TypeError, ValueError):
            return "NaN"
    if isinstance(v, float):
        if v != v:
            return "NaN"
        if v == float("inf"):
            return "+Inf"
        if v == float("-inf"):
            return "-Inf"
    return repr(v)


def prometheus_text(registry: MetricRegistry) -> str:
    """The registry in the Prometheus text exposition format (see the
    module's docstring)."""
    lines: list[str] = []
    for scope, m in sorted(registry.all_metrics().items()):
        name = _prom_name(scope)
        if isinstance(m, Counter):
            lines.append(f"# TYPE {name} counter")
            lines.append(f"{name} {_prom_value(m.count)}")
        elif isinstance(m, Gauge):
            try:
                v = m.value
            except Exception:  # noqa: BLE001 - a gauge may race teardown
                continue
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {_prom_value(v)}")
        elif isinstance(m, Meter):
            lines.append(f"# TYPE {name}_rate gauge")
            lines.append(f"{name}_rate {_prom_value(m.rate)}")
            lines.append(f"# TYPE {name}_total counter")
            lines.append(f"{name}_total {_prom_value(m.count)}")
        elif isinstance(m, Histogram):
            lines.append(f"# TYPE {name} summary")
            for q in (0.5, 0.95, 0.99):
                lines.append(f'{name}{{quantile="{q}"}} '
                             f"{_prom_value(m.quantile(q))}")
            lines.append(f"{name}_sum {_prom_value(m.sum)}")
            lines.append(f"{name}_count {_prom_value(m.count)}")
            lines.append(f"# TYPE {name}_bucket histogram")
            for le, c in m.bucket_counts():
                lines.append(f'{name}_bucket{{le="{le}"}} {c}')
    _append_ledger_rollups(lines)
    return "\n".join(lines) + "\n"


def _prom_label(value: str) -> str:
    return str(value).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _append_ledger_rollups(lines: list[str]) -> None:
    """The ledger's per-job device ms, compile ms and dispatches as
    job-labelled gauges; nothing when the ledger is off or empty."""
    from .profiler import DEVICE_LEDGER
    if not DEVICE_LEDGER.enabled:
        return
    snap = DEVICE_LEDGER.snapshot()
    if not snap["jobs"]:
        return
    for base, field in (("flink_tpu_profiler_job_device_ms", "device_ms"),
                        ("flink_tpu_profiler_job_compile_ms", "compile_ms"),
                        ("flink_tpu_profiler_job_dispatches", "dispatches")):
        lines.append(f"# TYPE {base} gauge")
        for job, row in sorted(snap["jobs"].items()):
            lines.append(f'{base}{{job="{_prom_label(job)}"}} '
                         f"{_prom_value(row[field])}")


class MetricReporter:
    """The reporter interface: ``open`` on a registry, ``close``."""

    def open(self, registry: MetricRegistry) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class PrometheusReporter(MetricReporter):
    """Serves ``GET /metrics`` (or ``/``) in the text exposition format;
    ``port`` is the bound port once open."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._requested_port = port
        self._host = host
        self._server = None
        self.port: Optional[int] = None

    def open(self, registry: MetricRegistry) -> None:
        from ..utils.httpd import ThreadedHTTPServer

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - stdlib API
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_response(404)
                    self.end_headers()
                    return
                body = prometheus_text(registry).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # no request log
                pass

        self._server = ThreadedHTTPServer(Handler, self._requested_port,
                                          self._host, "prometheus-reporter")
        self.port = self._server.start()

    def close(self) -> None:
        if self._server is not None:
            self._server.stop()
            self._server = None


class LoggingReporter(MetricReporter):
    """Writes ``name=value`` lines of the registry's snapshot every
    ``interval_s`` seconds to ``sink`` (print by default)."""

    def __init__(self, interval_s: float = 10.0,
                 sink: Optional[Callable[[str], None]] = None):
        self._interval = interval_s
        self._sink = sink or print
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def open(self, registry: MetricRegistry) -> None:
        def loop():
            while not self._stop.wait(self._interval):
                snap = registry.snapshot()
                for name in sorted(snap):
                    self._sink(f"{name}={snap[name]}")

        self._thread = threading.Thread(target=loop,
                                        name="logging-reporter", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


_REPORTER_FACTORIES: dict[str, Callable[[], MetricReporter]] = {
    "log": LoggingReporter,
    "prometheus": PrometheusReporter,
}


def register_reporter(name: str,
                      factory: Callable[[], MetricReporter]) -> None:
    """Make ``name`` resolvable from ``metrics.reporters``."""
    _REPORTER_FACTORIES[name] = factory


def reporters_from_config(config) -> list[MetricReporter]:
    """One reporter for each name of ``metrics.reporters``
    (comma-separated), not opened yet; an unknown name raises with the
    known ones. A ``LoggingReporter`` logs every
    ``metrics.reporter.interval`` seconds (the reference's factory call
    leaves it at 10 s whatever the key says)."""
    from ..core.config import MetricOptions

    raw = config.get(MetricOptions.REPORTERS)
    out = []
    for name in (n.strip() for n in str(raw).split(",") if n.strip()):
        factory = _REPORTER_FACTORIES.get(name)
        if factory is None:
            raise ValueError(f"unknown metric reporter {name!r} "
                             f"(known: {sorted(_REPORTER_FACTORIES)})")
        rep = factory()
        if isinstance(rep, LoggingReporter):
            rep._interval = float(config.get(MetricOptions.INTERVAL))
        out.append(rep)
    return out
