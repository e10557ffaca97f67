"""Metrics of the port: counters, gauges, meters and histograms in scoped
groups, span tracing, reporters, the device-path counters and the
device-time ledger (the reference's ``flink_tpu.metrics`` exports, less
the XLA program cache's ``instrumented_program_cache`` and
``pytree_nbytes``)."""

from .core import (
    Counter, Gauge, Histogram, Meter, MetricGroup, MetricRegistry,
    TaskMetrics,
)
from .device import (
    DEVICE_STATS, DeviceStats, bind_device_metrics, set_compile_tracer,
)
from .profiler import (
    DEVICE_LEDGER, LEDGER_SITE_INVENTORY, DeviceLedger, ProgramKey,
    bind_ledger_metrics, clear_dispatch_context, dispatch_context,
    set_dispatch_context,
)
from .reporters import (
    LoggingReporter, MetricReporter, PrometheusReporter, prometheus_text,
    register_reporter, reporters_from_config,
)
from .tracing import (
    FLIGHT_RECORDER, TRACER, FlightRecorder, InMemoryTraceReporter, Span,
    SpanBuilder, TraceContext, TraceReporter, Tracer, chrome_trace_events,
    current_context, dump_flight_recorder, record_flight_event, use_context,
)

__all__ = [
    # core
    "Counter", "Gauge", "Meter", "Histogram", "MetricGroup",
    "MetricRegistry", "TaskMetrics",
    # tracing
    "Span", "SpanBuilder", "TraceReporter", "InMemoryTraceReporter",
    "Tracer", "TraceContext", "TRACER", "FlightRecorder",
    "FLIGHT_RECORDER", "chrome_trace_events", "current_context",
    "use_context", "record_flight_event", "dump_flight_recorder",
    # reporters
    "MetricReporter", "PrometheusReporter", "LoggingReporter",
    "prometheus_text", "register_reporter", "reporters_from_config",
    # device-path accounting
    "DeviceStats", "DEVICE_STATS", "bind_device_metrics",
    "set_compile_tracer",
    # device-time ledger
    "DeviceLedger", "DEVICE_LEDGER", "ProgramKey",
    "LEDGER_SITE_INVENTORY", "bind_ledger_metrics",
    "set_dispatch_context", "clear_dispatch_context", "dispatch_context",
]
