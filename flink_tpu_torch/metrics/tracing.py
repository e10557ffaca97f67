"""Job-wide causal tracing and the failure flight recorder (port of
``flink_tpu/metrics/tracing.py``).

Every span carries ``trace_id``/``span_id``/``parent_id``, so related work
forms one tree: a checkpoint's trigger, each subtask's barrier alignment
and snapshot, the store of the completed checkpoint and the completion
fan-out. A :class:`TraceContext` is the wire-portable (trace_id, span_id)
pair; it rides ``CheckpointBarrier.trace`` through the channels (and the
unaligned capture's replay), and crosses threads through an explicit
``parent=`` or the thread-local ambient context that ``with
tracer.span(...)`` pushes. The wire form is a plain dict, so a context
written by one package is read by the other.

Clocks: timestamps are reported as epoch milliseconds but measured on the
monotonic clock (the epoch offset is sampled once at import), so a step of
the wall clock never makes a negative ``duration_ms``.

A span is host work only: two ids, a dataclass, a lock and the reporters'
appends. Its times are host ``now_ms`` and its attributes host ints and
strings, so opening or closing one never waits on the card.

Reporters (:class:`TraceReporter`): a bounded in-memory ring
(``traces.max-retained``; evictions counted as ``spans_dropped_total``),
the Chrome trace-event (Perfetto) export :func:`chrome_trace_events`, and
the always-on :class:`FlightRecorder`, a ring of recent spans and events
dumped to ``flight-<reason>-<ts>.json`` at the fault chokepoints (a
watchdog stall, a region or job restart, a corrupt artifact).

The process-global :data:`TRACER` follows the ``configure(config)``
pattern of ``FAULTS``/``WATCHDOG`` and is configured by every deploy path
(``cluster/local.py::deploy_local``).
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional

__all__ = [
    "Span", "SpanBuilder", "TraceContext", "TraceReporter",
    "InMemoryTraceReporter", "FlightRecorder", "Tracer",
    "TRACER", "FLIGHT_RECORDER", "chrome_trace_events",
    "current_context", "use_context", "now_ms",
    "record_flight_event", "dump_flight_recorder", "SPAN_INVENTORY",
]

# Epoch offset sampled once at import: now_ms() is monotonic-derived but
# reports epoch milliseconds, so durations are immune to wall-clock steps
# while start times still line up with log timestamps.
_EPOCH_OFFSET_MS = time.time() * 1000.0 - time.monotonic() * 1000.0  # lint: wall-clock-ok sampled once at import to anchor the monotonic clock


def now_ms() -> int:
    """Epoch milliseconds measured on the monotonic clock."""
    return int(time.monotonic() * 1000.0 + _EPOCH_OFFSET_MS)


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclass(frozen=True)
class TraceContext:
    """The (trace_id, span_id) a child span parents itself on.
    ``to_wire()`` is a plain dict, safe on a barrier or in a message."""

    trace_id: str
    span_id: str

    def to_wire(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    @staticmethod
    def from_wire(d: Optional[dict]) -> Optional["TraceContext"]:
        if not d:
            return None
        try:
            return TraceContext(str(d["trace_id"]), str(d["span_id"]))
        except Exception:  # noqa: BLE001 - a malformed context parents nothing
            return None


@dataclass(frozen=True)
class Span:
    scope: str
    name: str
    start_ms: int
    end_ms: int
    attributes: dict = field(default_factory=dict)
    trace_id: str = ""
    span_id: str = ""
    parent_id: str = ""

    @property
    def duration_ms(self) -> int:
        return self.end_ms - self.start_ms

    def to_dict(self) -> dict:
        return {
            "scope": self.scope, "name": self.name,
            "start_ms": self.start_ms, "end_ms": self.end_ms,
            "duration_ms": self.duration_ms,
            "trace_id": self.trace_id, "span_id": self.span_id,
            "parent_id": self.parent_id,
            "attributes": dict(self.attributes),
        }


# The ambient context: a thread-local stack, so nested ``with
# tracer.span(...)`` blocks parent without a context argument. Crossing a
# thread or a channel stays explicit (``parent=``, ``use_context``).
_TLS = threading.local()


def current_context() -> Optional[TraceContext]:
    stack = getattr(_TLS, "stack", None)
    return stack[-1] if stack else None


class use_context:
    """Pin ``ctx`` as the ambient parent of spans started on this thread
    inside the block."""

    def __init__(self, ctx: Optional[TraceContext]):
        self._ctx = ctx

    def __enter__(self) -> Optional[TraceContext]:
        stack = getattr(_TLS, "stack", None)
        if stack is None:
            stack = _TLS.stack = []
        stack.append(self._ctx)
        return self._ctx

    def __exit__(self, exc_type, exc, tb) -> None:
        _TLS.stack.pop()


class SpanBuilder:
    """Fluent builder, used imperatively (``b = tracer.span(...); ...;
    b.finish()``) or as a context manager: entering resets the start and
    pushes this span's context as the ambient parent of the block."""

    def __init__(self, tracer: "Tracer", scope: str, name: str,
                 parent: Optional[TraceContext] = None):
        self._tracer = tracer
        self._scope = scope
        self._name = name
        self._start_ms = now_ms()
        self._attrs: dict = {}
        if parent is None:
            parent = current_context()
        self._trace_id = parent.trace_id if parent else _new_id()
        self._span_id = _new_id()
        self._parent_id = parent.span_id if parent else ""
        self._finished = False
        self._ctx_cm: Optional[use_context] = None

    @property
    def context(self) -> TraceContext:
        """This span's identity, for parenting children (on another
        thread) before the span itself finishes."""
        return TraceContext(self._trace_id, self._span_id)

    def set_parent(self, ctx: Optional[TraceContext]) -> "SpanBuilder":
        if ctx is not None:
            self._trace_id = ctx.trace_id
            self._parent_id = ctx.span_id
        return self

    def set_attribute(self, key: str, value: Any) -> "SpanBuilder":
        self._attrs[key] = value
        return self

    def set_start_ts(self, start_ms: int) -> "SpanBuilder":
        self._start_ms = int(start_ms)
        return self

    def finish(self, end_ms: Optional[int] = None) -> Span:
        end = now_ms() if end_ms is None else int(end_ms)
        if end < self._start_ms:        # caller skew: never negative
            end = self._start_ms
        span = Span(self._scope, self._name, self._start_ms, end,
                    dict(self._attrs), self._trace_id, self._span_id,
                    self._parent_id)
        if not self._finished:
            self._finished = True
            self._tracer._report(span)
        return span

    def __enter__(self) -> "SpanBuilder":
        self._start_ms = now_ms()
        self._ctx_cm = use_context(self.context)
        self._ctx_cm.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._ctx_cm is not None:
            self._ctx_cm.__exit__(exc_type, exc, tb)
            self._ctx_cm = None
        self.set_attribute("error", exc_type is not None)
        self.finish()


class TraceReporter:
    """Receives completed spans."""

    def add_span(self, span: Span) -> None:
        raise NotImplementedError


class InMemoryTraceReporter(TraceReporter):
    """The newest ``max_retained`` spans (``traces.max-retained``);
    evictions are counted into ``DEVICE_STATS`` as
    ``spans_dropped_total``."""

    def __init__(self, max_retained: int = 4096):
        self.spans: list[Span] = []
        self.max_retained = int(max_retained)
        self.dropped = 0
        self._lock = threading.Lock()

    def add_span(self, span: Span) -> None:
        excess = 0
        with self._lock:
            self.spans.append(span)
            if len(self.spans) > self.max_retained:
                excess = len(self.spans) - self.max_retained
                del self.spans[:excess]
                self.dropped += excess
        if excess:
            _note_spans_dropped(excess)

    def by_name(self, name: str) -> list[Span]:
        with self._lock:
            return [s for s in self.spans if s.name == name]

    def snapshot(self) -> list[Span]:
        with self._lock:
            return list(self.spans)

    def clear(self) -> None:
        with self._lock:
            self.spans.clear()
            self.dropped = 0


def _note_spans_dropped(n: int) -> None:
    try:
        from .device import DEVICE_STATS
        DEVICE_STATS.note_spans_dropped(n)
    except Exception:  # noqa: BLE001 - metrics must not kill reporting
        pass


class FlightRecorder(TraceReporter):
    """A ring of the most recent spans and events. ``dump(reason)``
    writes it to a timestamped JSON file (at most once per reason within
    ``min_dump_interval_s``); the fault chokepoints call it, so the
    seconds before a failure are kept, not just counters."""

    KEEP_DUMPS = 16

    def __init__(self, capacity: int = 512, dump_dir: Optional[str] = None,
                 min_dump_interval_s: float = 1.0):
        self.dump_dir = dump_dir
        self.min_dump_interval_s = min_dump_interval_s
        self.dumps: list[dict] = []
        self._ring: deque = deque(maxlen=int(capacity))
        self._last_dump_ms: Dict[str, int] = {}
        self._lock = threading.Lock()

    @property
    def capacity(self) -> int:
        return self._ring.maxlen or 0

    def set_capacity(self, capacity: int) -> None:
        with self._lock:
            self._ring = deque(self._ring, maxlen=max(1, int(capacity)))

    def add_span(self, span: Span) -> None:
        entry = {"type": "span", "ts_ms": span.end_ms}
        entry.update(span.to_dict())
        with self._lock:
            self._ring.append(entry)

    def record_event(self, kind: str, **fields: Any) -> None:
        entry = {"type": "event", "kind": kind, "ts_ms": now_ms()}
        entry.update(fields)
        with self._lock:
            self._ring.append(entry)

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    def dump(self, reason: str, **fields: Any) -> Optional[str]:
        """Write the ring to ``flight-<reason>-<ts>.json``; returns the
        path, or None when rate-limited or the write fails."""
        ts = now_ms()
        with self._lock:
            last = self._last_dump_ms.get(reason, 0)
            if ts - last < self.min_dump_interval_s * 1000.0:
                return None
            self._last_dump_ms[reason] = ts
            entries = list(self._ring)
        directory = self.dump_dir or os.path.join(
            tempfile.gettempdir(), "flink_tpu_flight")
        safe = re.sub(r"[^A-Za-z0-9._-]", "_", reason) or "fault"
        path = os.path.join(directory, f"flight-{safe}-{ts}.json")
        payload = {"reason": reason, "dumped_at_ms": ts,
                   "pid": os.getpid(), "entry_count": len(entries),
                   "context": dict(fields), "entries": entries}
        try:
            os.makedirs(directory, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f, default=str)
            os.replace(tmp, path)
        except OSError:
            return None
        record = {"reason": reason, "path": path, "ts_ms": ts,
                  "entry_count": len(entries)}
        record.update(fields)
        with self._lock:
            self.dumps.append(record)
            del self.dumps[:-self.KEEP_DUMPS]
        return path

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dumps.clear()
            self._last_dump_ms.clear()


class Tracer:
    """Span factory and reporter fan-out."""

    def __init__(self, reporters: Optional[list[TraceReporter]] = None):
        self._reporters = list(reporters or [])
        self.enabled = True

    def add_reporter(self, reporter: TraceReporter) -> None:
        self._reporters.append(reporter)

    def span(self, scope: str, name: str,
             parent: Optional[TraceContext] = None) -> SpanBuilder:
        return SpanBuilder(self, scope, name, parent=parent)

    def _report(self, span: Span) -> None:
        if not self.enabled:
            return
        for r in self._reporters:
            try:
                r.add_span(span)
            except Exception:  # noqa: BLE001 - reporters must not kill jobs
                pass

    def retained_spans(self) -> list[Span]:
        """The spans of the first attached in-memory reporter."""
        for r in self._reporters:
            if isinstance(r, InMemoryTraceReporter):
                return r.snapshot()
        return []

    def configure(self, config) -> None:
        """Adopt the ``traces.*`` keys of a job's Configuration."""
        from ..core.config import TraceOptions
        self.enabled = bool(config.get(TraceOptions.ENABLED))
        for r in self._reporters:
            if isinstance(r, InMemoryTraceReporter):
                r.max_retained = int(config.get(TraceOptions.MAX_RETAINED))
            elif isinstance(r, FlightRecorder):
                cap = int(config.get(TraceOptions.FLIGHT_CAPACITY))
                if cap != r.capacity:
                    r.set_capacity(cap)
                r.dump_dir = config.get(TraceOptions.FLIGHT_DIR) or None
                r.min_dump_interval_s = float(
                    config.get(TraceOptions.FLIGHT_MIN_INTERVAL))

    def reset(self) -> None:
        """Test hook: clear retained spans and any attached recorder."""
        self.enabled = True
        for r in self._reporters:
            if isinstance(r, InMemoryTraceReporter):
                r.clear()
            elif isinstance(r, FlightRecorder):
                r.reset()


def chrome_trace_events(spans: Iterable[Span], pid: int = 0,
                        counters: Optional[Iterable[dict]] = None) -> dict:
    """Spans as a Chrome trace-event JSON object (``ph: "X"`` complete
    events) that Perfetto and chrome://tracing load. Each scope is a
    track of its own; the causal ids ride in ``args``.

    ``counters`` takes the device-time ledger's samples
    (``DEVICE_LEDGER.trace_counters()``: ``ts_ms``/``site``/``ms``) as
    ``ph: "C"`` counter tracks, one ``device_ms:<site>`` series a
    dispatch site."""
    tids: Dict[str, int] = {}
    events: List[dict] = []
    for c in counters or ():
        events.append({
            "name": f"device_ms:{c['site']}", "cat": "profiler",
            "ph": "C", "ts": int(c["ts_ms"]) * 1000, "pid": pid,
            "args": {"ms": round(float(c["ms"]), 4)},
        })
    for span in spans:
        tid = tids.setdefault(span.scope, len(tids))
        args: Dict[str, Any] = {
            "trace_id": span.trace_id, "span_id": span.span_id,
        }
        if span.parent_id:
            args["parent_id"] = span.parent_id
        for k, v in span.attributes.items():
            args[k] = v if isinstance(v, (int, float, bool, str)) else str(v)
        events.append({
            "name": span.name, "cat": span.scope, "ph": "X",
            "ts": span.start_ms * 1000,
            "dur": max(span.duration_ms, 0) * 1000,
            "pid": pid, "tid": tid, "args": args,
        })
    for scope, tid in sorted(tids.items(), key=lambda kv: kv[1]):
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": scope}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# The process-global tracer and flight recorder (configured by every
# deploy path, as FAULTS and WATCHDOG are).
FLIGHT_RECORDER = FlightRecorder()

TRACER = Tracer()
TRACER.add_reporter(InMemoryTraceReporter())
TRACER.add_reporter(FLIGHT_RECORDER)


def _owning_job(fields: dict) -> dict:
    """Every flight event and dump names its job: callers that know it
    pass ``job=``; otherwise the thread's dispatch context (pinned at
    task-thread start) fills it in."""
    if not fields.get("job"):
        from .profiler import dispatch_context
        job = dispatch_context()[0]
        if job:
            fields = dict(fields, job=job)
    return fields


def record_flight_event(kind: str, **fields: Any) -> None:
    """Append a discrete (non-span) event to the flight recorder's ring."""
    try:
        FLIGHT_RECORDER.record_event(kind, **_owning_job(fields))
    except Exception:  # noqa: BLE001 - observability must not kill jobs
        pass


def dump_flight_recorder(reason: str, **fields: Any) -> Optional[str]:
    """Record ``reason`` as an event, then dump the ring to a file.
    Called from the fault chokepoints; never raises."""
    try:
        fields = _owning_job(fields)
        FLIGHT_RECORDER.record_event(reason, **fields)
        return FLIGHT_RECORDER.dump(reason, **fields)
    except Exception:  # noqa: BLE001 - observability must not kill jobs
        return None


#: (scope, name, where) of every span the port emits, sorted by (scope,
#: name): the reference's inventory less the cluster's (``ha.Takeover``,
#: ``net.Fence``, ``net.Reconnect``, ``sched.Admit``, ``sched.Shed``),
#: whose modules are not ported. ``flink_tpu_torch/docs/OBSERVABILITY.md``
#: renders it and the lint's TPU301 holds code, inventory and table to
#: one another.
SPAN_INVENTORY: tuple = (
    ("checkpoint", "Align",
     "runtime/stream_task.py — barrier arrival → alignment per subtask"),
    ("checkpoint", "Checkpoint",
     "checkpoint/coordinator.py — root span, trigger → complete"),
    ("checkpoint", "Notify",
     "checkpoint/coordinator.py — completion fan-out to tasks"),
    ("checkpoint", "Snapshot",
     "runtime/stream_task.py — per-subtask barrier broadcast + state "
     "snapshot + ack"),
    ("checkpoint", "Store",
     "checkpoint/coordinator.py — store of the completed checkpoint"),
    ("device", "Compile",
     "metrics/device.py note_compile_done, from ops/kernels.py — nvcc "
     "build of the kernel libraries"),
    ("device", "D2H",
     "metrics/device.py note_d2h — device→host transfer"),
    ("device", "Execute",
     "runtime/faults.py DeviceGuard.run — guarded device dispatch "
     "(an attempt: the enqueue, retries apart)"),
    ("device", "H2D",
     "metrics/device.py note_h2d — host→device transfer"),
    ("rescale", "Migrate",
     "runtime/operators/mesh_window.py rescale_live — page ownership "
     "diff + digest-verified key-group transfer"),
    ("rescale", "Rebuild",
     "runtime/operators/mesh_window.py rescale_live — state install on "
     "the new mesh + incremental-plane invalidation"),
    ("rescale", "Rescale",
     "cluster/local.py live_rescale + mesh_window rescale_live — root "
     "span, barrier-aligned shard-count change without restart"),
    ("restart", "JobRestart",
     "cluster/scheduler.py — full-job restart from the last verified "
     "checkpoint"),
    ("restart", "RegionRestart",
     "cluster/local.py restart_region — failover-region restart"),
    ("restore", "Fallback",
     "checkpoint/coordinator.py — corrupt candidate skipped, older "
     "checkpoint selected"),
    ("restore", "Restore",
     "checkpoint/coordinator.py latest_verified_checkpoint — verified "
     "restore-candidate selection"),
    ("task", "SourceBatch",
     "runtime/stream_task.py — one source read→emit mailbox cycle"),
    ("tier", "Evict",
     "state/device_backend.py _evict_cold_groups — cold key groups paged "
     "to the host tier + device table rebuild"),
    ("tier", "Prefetch",
     "state/tiering/prefetch.py PrefetchPipeline — host key groups "
     "gathered + staged for promotion at a batch boundary"),
    ("watchdog", "Stall",
     "runtime/watchdog.py _note_trip — deadline expiry at a bounded "
     "site"),
)
