"""Device-time ledger: per-site dispatch profiling, recompile attribution
and a shape-only cost model (port of ``flink_tpu/metrics/profiler.py``).

The process-global :data:`DEVICE_LEDGER` (configured by every deploy path
from the ``profiler.*`` keys, as ``FAULTS`` and ``WATCHDOG`` are) says
which site, operator and job spend device time. It is off by default: a
disabled ledger costs each site one attribute read,
``DEVICE_LEDGER.enabled``.

Every sample is attributed to a :class:`ProgramKey`
``(job, operator, site, shape_signature)``:

* ``job``/``operator`` ride a thread-local dispatch context that the
  operator chain pins at batch and watermark entry
  (``set_dispatch_context``); a site never knows whom it serves.
* ``site`` is a dotted name of :data:`LEDGER_SITE_INVENTORY`, the
  reference's names (the lint's TPU305 holds code, this inventory and
  ``flink_tpu_torch/docs/OBSERVABILITY.md`` to the same set).
* ``shape_signature`` is the ``repr`` of the tuple of shapes and dtypes
  the site dispatched.

Timing a site. ``begin(site, device)`` before its launches and ``end``
after them. On a CUDA device the pair is two ``torch.cuda.Event``
(``enable_timing=True``) from a reused per-device pool, recorded on the
device's current stream; the pair joins a bounded pending list and is
resolved without a host wait: by ``query()`` at the next ``begin``,
``end`` or ``record`` of any site, and by ``synchronize()`` only on the
read path (``snapshot``, ``profile``, ``trace_counters``). On the CPU the
site is timed with ``time.perf_counter()``, as the reference times every
dispatch. A site's first dispatch in the process is charged as
``kind="compile"`` (the reference charges a program's first dispatch so):
in the port it covers the library's load and any ``nvcc`` build behind
it. Nothing is recorded inside a CUDA graph capture: the fused chain
times its replay as one pair (``runtime/compiled.py``).

The cost model. The reference re-traces a program's jaxpr at read time;
the port's sites declare instead a function of the dispatched shapes and
dtypes that returns ``(flops, bytes)``: each input byte counted as read
once and each output byte as written once, from the shapes alone, so a
kernel's roofline reads the same work whatever implements it. ``end``
keeps the function and the shape tuple; the counts are computed lazily on
the read path and cached per (site, shape signature), never on the
dispatch path::

    estimated_ms = max(flops / gflops, bytes / gbps)

with ``profiler.cost-model.gflops`` / ``gbps`` as assumed rates;
``achieved_vs_estimated`` is measured / estimated.

Recompile attribution: ``note_build`` is called at each ``nvcc`` build of
a kernel library (``ops/kernels.py``) and at each CUDA graph capture
(``runtime/compiled.py``). Each build after a site's first is diffed
against the nearest prior build (most shared arguments) and the record
names the parameter that changed, down to the tuple element
(``shape[1]: 64 -> 128``).

Totals, reservoir percentiles, clamping, the EWMA duration and rate and
the bounded sample ring are the reference's arithmetic: the same
``record`` and ``note_build`` calls give the same ``snapshot`` and
``profile``. All mutation happens under the ledger's lock; read paths copy
under it. ``bind_ledger_metrics`` registers the rollups as gauges under a
registry's ``profiler`` scope (Prometheus ``flink_tpu_profiler_*``), and
``trace_counters`` feeds the Perfetto export's counter tracks
(``metrics/tracing.py::chrome_trace_events``).
"""

from __future__ import annotations

import inspect
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

from .tracing import now_ms

__all__ = [
    "ProgramKey", "DeviceLedger", "DEVICE_LEDGER", "LEDGER_SITE_INVENTORY",
    "set_dispatch_context", "clear_dispatch_context", "dispatch_context",
    "bind_ledger_metrics",
]


class ProgramKey(NamedTuple):
    """Stable attribution key for one profiled site and shape."""

    job: str
    operator: str
    site: str
    shape_signature: str


# ---------------------------------------------------------------------------
# Thread-local dispatch context: the operator chain pins (job, operator)
# at batch/watermark entry so device dispatch sites, which know only their
# site name, can attribute time to the owning job and operator.
# ---------------------------------------------------------------------------

_CTX = threading.local()


def set_dispatch_context(job: str, operator: str) -> None:
    """Pin the (job, operator) owner for ledger samples recorded on this
    thread until the next ``set_dispatch_context``/``clear``."""
    _CTX.job = job
    _CTX.operator = operator


def clear_dispatch_context() -> None:
    _CTX.job = ""
    _CTX.operator = ""


def dispatch_context() -> Tuple[str, str]:
    return (getattr(_CTX, "job", ""), getattr(_CTX, "operator", ""))


# ---------------------------------------------------------------------------
# Per-key ledger entries
# ---------------------------------------------------------------------------


class _Entry:
    """Mutable accumulator for one ProgramKey.  Mutated only under the
    owning ledger's lock; it carries no lock of its own."""

    __slots__ = ("count", "compiles", "self_ms", "compile_ms", "max_ms",
                 "ewma_ms", "ewma_interval_ms", "last_ts_ms", "nbytes",
                 "reservoir")

    def __init__(self, reservoir: int):
        self.count = 0              # dispatches (compile calls excluded)
        self.compiles = 0
        self.self_ms = 0.0          # device dispatch time
        self.compile_ms = 0.0       # first dispatch: load and build time
        self.max_ms = 0.0           # exact lifetime max dispatch duration
        self.ewma_ms = 0.0
        self.ewma_interval_ms = 0.0
        self.last_ts_ms = 0
        self.nbytes = 0             # payload bytes (transfer sites)
        self.reservoir: deque = deque(maxlen=max(1, int(reservoir)))


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[idx]


# ---------------------------------------------------------------------------
# Recompile attribution
# ---------------------------------------------------------------------------


def _bind_builder_args(builder, args: tuple, kwargs: dict) -> Dict[str, Any]:
    """Builder arguments by parameter name (repr-compared); positional
    fallback ``arg0``/``arg1``... when the signature cannot be bound."""
    try:
        bound = inspect.signature(builder).bind(*args, **kwargs)
        bound.apply_defaults()
        return dict(bound.arguments)
    except (TypeError, ValueError):
        named = {f"arg{i}": a for i, a in enumerate(args)}
        named.update(kwargs)
        return named


def _describe_changes(prev: Dict[str, Any],
                      cur: Dict[str, Any]) -> List[str]:
    """Human-readable per-parameter diff; tuples of equal length diff to
    the exact changed element (``shape[1]: 64 -> 128``)."""
    changed: List[str] = []
    for name in sorted(set(prev) | set(cur)):
        if name not in prev:
            changed.append(f"{name}: <absent> -> {cur[name]!r}")
            continue
        if name not in cur:
            changed.append(f"{name}: {prev[name]!r} -> <absent>")
            continue
        old, new = prev[name], cur[name]
        if repr(old) == repr(new):
            continue
        if (isinstance(old, tuple) and isinstance(new, tuple)
                and len(old) == len(new)):
            for i, (a, b) in enumerate(zip(old, new)):
                if repr(a) != repr(b):
                    changed.append(f"{name}[{i}]: {a!r} -> {b!r}")
        else:
            changed.append(f"{name}: {old!r} -> {new!r}")
    return changed


# ---------------------------------------------------------------------------
# Device timing
# ---------------------------------------------------------------------------

#: pairs of CUDA events kept for reuse, per device index
_POOL_MAX = 256
#: timed dispatches awaiting their events; past it the oldest is waited for
_PENDING_MAX = 4096


class _Token:
    """One timed dispatch in flight: its site, its device's event pair (or
    the perf_counter start on the CPU) and the owner pinned at ``begin``."""

    __slots__ = ("site", "pair", "t0", "job", "operator", "dev")

    def __init__(self, site: str, pair, t0: float, job: str, operator: str,
                 dev: int):
        self.site = site
        self.pair = pair
        self.t0 = t0
        self.job = job
        self.operator = operator
        self.dev = dev


# ---------------------------------------------------------------------------
# The ledger
# ---------------------------------------------------------------------------


class DeviceLedger:
    """Process-global device-time ledger.  All mutation under one lock;
    every read surface copies under the same lock (no torn reads on the
    read path).  Disabled, every site pays one attribute read."""

    # Priors retained per site for nearest-prior recompile diffing.
    _PRIORS_PER_SITE = 8

    def __init__(self):
        self._lock = threading.Lock()
        self.enabled = False
        self.reservoir = 256
        self.recompile_history = 64
        self.ewma_alpha = 0.2
        self.trace_samples = 2048
        self.cost_gflops = 50.0
        self.cost_gbps = 10.0
        self._entries: Dict[ProgramKey, _Entry] = {}
        self._builds: Dict[str, deque] = {}       # site -> prior builds
        self._recompiles: deque = deque(maxlen=64)
        self._samples: deque = deque(maxlen=2048)  # (ts_ms, site, ms)
        #: (site, shape signature) -> (cost function, shape tuple)
        self._cost_src: Dict[Tuple[str, str], tuple] = {}
        self._cost_cache: Dict[Tuple[str, str], Optional[Tuple[int, int]]] \
            = {}
        #: sites that dispatched once in this process (their first
        #: dispatch is charged as compile); kept across ``reset``
        self._seen: set = set()
        #: (token, shape signature, kind, nbytes, cost, sig, ts) whose
        #: events have not been read yet, in record order
        self._pending: deque = deque()
        self._pool: Dict[int, list] = {}
        #: pending dispatches waited for because the list was full
        self.forced_waits = 0

    # -- wiring ------------------------------------------------------------

    def configure(self, config) -> None:
        """Apply the ``profiler.*`` keys (same pattern as FAULTS /
        WATCHDOG); called by every deploy path."""
        from ..core.config import ProfilerOptions
        with self._lock:
            self.enabled = bool(config.get(ProfilerOptions.ENABLED))
            self.reservoir = int(config.get(ProfilerOptions.RESERVOIR))
            self.recompile_history = int(
                config.get(ProfilerOptions.RECOMPILE_HISTORY))
            self.ewma_alpha = float(config.get(ProfilerOptions.EWMA_ALPHA))
            self.trace_samples = int(
                config.get(ProfilerOptions.TRACE_SAMPLES))
            self.cost_gflops = float(
                config.get(ProfilerOptions.COST_GFLOPS))
            self.cost_gbps = float(config.get(ProfilerOptions.COST_GBPS))
            if self._recompiles.maxlen != self.recompile_history:
                self._recompiles = deque(
                    self._recompiles, maxlen=max(1, self.recompile_history))
            if self._samples.maxlen != self.trace_samples:
                self._samples = deque(
                    self._samples, maxlen=max(1, self.trace_samples))

    # -- timing a site (the dispatch path; call only when enabled) ---------

    def begin(self, site: str, device) -> Optional[_Token]:
        """Open a timed dispatch at ``site`` on ``device`` (a
        ``torch.device``): a start event on the device's current stream, or
        the perf_counter on the CPU. None inside a CUDA graph capture,
        where nothing runs until the replay."""
        job, operator = dispatch_context()
        if getattr(device, "type", "cpu") != "cuda":
            if self._pending:
                self._poll()
            return _Token(site, None, time.perf_counter(), job, operator, -1)
        import torch
        if torch.cuda.is_current_stream_capturing():
            return None
        if self._pending:
            self._poll()
        index = device.index if device.index is not None \
            else torch.cuda.current_device()
        pair = self._take_pair(index)
        pair[0].record(torch.cuda.current_stream(index))
        return _Token(site, pair, 0.0, job, operator, index)

    def end(self, token: Optional[_Token], sig: tuple = (),
            cost: Optional[Callable[..., Tuple[int, int]]] = None,
            nbytes: int = 0) -> None:
        """Close a timed dispatch. ``sig`` is the tuple of shapes and
        dtypes the site dispatched (its ``repr`` is the shape signature)
        and ``cost(*sig)`` the site's ``(flops, bytes)``, evaluated on the
        read path only."""
        if token is None:
            return
        shape_sig = repr(sig) if sig else ""
        ts = now_ms()
        if token.pair is None:
            ms = (time.perf_counter() - token.t0) * 1e3
            with self._lock:
                kind = self._kind_locked(token.site)
                self._note_cost_locked(token.site, shape_sig, cost, sig)
            self._record(token.site, ms, shape_sig, kind, nbytes,
                         token.job, token.operator, ts)
            return
        import torch
        token.pair[1].record(torch.cuda.current_stream(token.dev))
        with self._lock:
            kind = self._kind_locked(token.site)
            self._note_cost_locked(token.site, shape_sig, cost, sig)
            self._pending.append((token, shape_sig, kind, nbytes, ts))
            full = len(self._pending) > _PENDING_MAX
        if full:
            # the card is more than _PENDING_MAX dispatches behind: wait
            # for the oldest rather than drop its sample
            self._poll(wait_oldest=True)

    def _kind_locked(self, site: str) -> str:
        if site in self._seen:
            return "dispatch"
        self._seen.add(site)
        return "compile"

    def _note_cost_locked(self, site: str, shape_sig: str, cost, sig) -> None:
        if cost is not None and (site, shape_sig) not in self._cost_src:
            self._cost_src[(site, shape_sig)] = (cost, sig)

    def _take_pair(self, index: int):
        with self._lock:
            free = self._pool.setdefault(index, [])
            if free:
                return free.pop()
        import torch
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def _poll(self, wait_oldest: bool = False, wait_all: bool = False) -> None:
        """Read the events of finished dispatches, oldest first, and
        record them: ``query()`` only, no host wait, unless
        ``wait_oldest`` (the list overflowed) or ``wait_all`` (the read
        path)."""
        while True:
            with self._lock:
                if not self._pending:
                    return
                item = self._pending[0]
            end_evt = item[0].pair[1]
            if not end_evt.query():
                if wait_all or wait_oldest:
                    if wait_oldest:
                        with self._lock:
                            self.forced_waits += 1
                    end_evt.synchronize()
                    wait_oldest = False
                else:
                    return
            with self._lock:
                if not self._pending or self._pending[0] is not item:
                    continue   # another thread resolved it
                self._pending.popleft()
            tok, shape_sig, kind, nbytes, ts = item
            ms = tok.pair[0].elapsed_time(tok.pair[1])
            with self._lock:
                free = self._pool.setdefault(tok.dev, [])
                if len(free) < _POOL_MAX:
                    free.append(tok.pair)
            self._record(tok.site, ms, shape_sig, kind, nbytes, tok.job,
                         tok.operator, ts)

    # -- recording ----------------------------------------------------------

    def record(self, site: str, ms: float, *, shape_sig: str = "",
               kind: str = "dispatch", nbytes: int = 0,
               job: Optional[str] = None,
               operator: Optional[str] = None) -> None:
        """Account one timed event at ``site``.  ``kind="compile"``
        charges a site's first dispatch (library load and build);
        ``kind="dispatch"`` charges steady-state device time.  Durations
        are clamped non-negative (caller clock skew must never produce a
        negative total)."""
        if not self.enabled:
            return
        if self._pending:
            self._poll()
        if job is None or operator is None:
            cj, co = dispatch_context()
            job = cj if job is None else job
            operator = co if operator is None else operator
        self._record(site, ms, shape_sig, kind, nbytes, job, operator,
                     now_ms())

    def _record(self, site: str, ms: float, shape_sig: str, kind: str,
                nbytes: int, job: str, operator: str, ts: int) -> None:
        ms = max(float(ms), 0.0)
        key = ProgramKey(job, operator, site, shape_sig)
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                e = self._entries[key] = _Entry(self.reservoir)
            if kind == "compile":
                e.compiles += 1
                e.compile_ms += ms
            else:
                e.count += 1
                e.self_ms += ms
                e.nbytes += int(nbytes)
                if ms > e.max_ms:
                    e.max_ms = ms
                e.reservoir.append(ms)
                a = self.ewma_alpha
                e.ewma_ms = ms if e.count == 1 \
                    else (1.0 - a) * e.ewma_ms + a * ms
                if e.last_ts_ms:
                    dt = max(ts - e.last_ts_ms, 0)
                    e.ewma_interval_ms = dt if e.ewma_interval_ms == 0.0 \
                        else (1.0 - a) * e.ewma_interval_ms + a * dt
                e.last_ts_ms = ts
            self._samples.append((ts, site, ms))

    def note_build(self, site: str, build_key: str, builder,
                   args: tuple, kwargs: dict) -> None:
        """Recompile attribution: called at each kernel-library build and
        each graph capture.  The first build of a site is the expected
        one; each later build is diffed parameter by parameter against the
        nearest prior build (most shared arguments) and the record names
        exactly which dimension changed."""
        if not self.enabled:
            return
        named = _bind_builder_args(builder, args, kwargs)
        job, operator = dispatch_context()
        with self._lock:
            priors = self._builds.get(site)
            if priors is None:
                priors = self._builds[site] = deque(
                    maxlen=self._PRIORS_PER_SITE)
            record = None
            if priors:
                def shared(p):
                    return sum(1 for k, v in p[1].items()
                               if k in named and repr(named[k]) == repr(v))
                nearest = max(priors, key=shared)
                record = {
                    "site": site, "job": job, "operator": operator,
                    "key": build_key, "prior_key": nearest[0],
                    "changed": _describe_changes(nearest[1], named),
                    "ts_ms": now_ms(),
                }
            priors.append((build_key, named))
            if record is not None:
                self._recompiles.append(record)

    # -- read surfaces -----------------------------------------------------

    def _settle(self) -> None:
        """The read path: wait for every pending dispatch's events."""
        if self._pending:
            self._poll(wait_all=True)

    def _cost_for(self, site: str,
                  shape_signature: str) -> Optional[Tuple[int, int]]:
        # lazy + cached: the cost functions run on the read path only
        ck = (site, shape_signature)
        with self._lock:
            if ck in self._cost_cache:
                return self._cost_cache[ck]
            src = self._cost_src.get(ck)
        cost = None
        if src is not None:
            fn, sig = src
            flops, nbytes = fn(*sig)
            cost = (int(flops), int(nbytes))
        with self._lock:
            self._cost_cache[ck] = cost
        return cost

    def _entry_dict(self, key: ProgramKey, e: _Entry,
                    window: List[float]) -> dict:
        window.sort()
        mean = e.self_ms / e.count if e.count else 0.0
        rate = (1000.0 / e.ewma_interval_ms
                if e.ewma_interval_ms > 0.0 else 0.0)
        return {
            "job": key.job, "operator": key.operator, "site": key.site,
            "shape_signature": key.shape_signature,
            "count": e.count, "compiles": e.compiles,
            "self_ms": e.self_ms, "compile_ms": e.compile_ms,
            "total_ms": e.self_ms + e.compile_ms,
            "mean_ms": mean, "p50_ms": _percentile(window, 0.50),
            "p95_ms": _percentile(window, 0.95), "max_ms": e.max_ms,
            "ewma_ms": e.ewma_ms, "rate_hz": rate, "bytes": e.nbytes,
        }

    def _with_cost(self, d: dict) -> dict:
        """Attach the cost estimate to an entry dict."""
        cost = self._cost_for(d["site"], d["shape_signature"])
        if cost is None and d["site"].startswith("transfer.") and d["bytes"]:
            # a transfer runs no kernel; the byte term IS the model
            cost = (0, d["bytes"] // max(d["count"], 1))
        if cost is None:
            d.update(est_flops=None, est_bytes=None, est_ms=None,
                     achieved_vs_estimated=None)
            return d
        flops, nbytes = cost
        est_ms = max(flops / (self.cost_gflops * 1e6),
                     nbytes / (self.cost_gbps * 1e6))
        d.update(est_flops=flops, est_bytes=nbytes, est_ms=est_ms,
                 achieved_vs_estimated=(
                     d["mean_ms"] / est_ms if est_ms > 0.0 else None))
        return d

    def snapshot(self) -> dict:
        """Cheap rollups: totals plus per-job, per-site and per-operator
        device-time shares.  No cost work."""
        self._settle()
        with self._lock:
            items = [(k, e, list(e.reservoir))
                     for k, e in self._entries.items()]
            recompiles = len(self._recompiles)
        jobs: Dict[str, dict] = {}
        sites: Dict[str, dict] = {}
        operators: Dict[str, dict] = {}
        tot_self = tot_compile = 0.0
        tot_count = 0
        for key, e, _w in items:
            tot_self += e.self_ms
            tot_compile += e.compile_ms
            tot_count += e.count
            j = jobs.setdefault(key.job or "<unattributed>",
                                {"device_ms": 0.0, "compile_ms": 0.0,
                                 "dispatches": 0})
            j["device_ms"] += e.self_ms
            j["compile_ms"] += e.compile_ms
            j["dispatches"] += e.count
            s = sites.setdefault(key.site, {"device_ms": 0.0, "count": 0})
            s["device_ms"] += e.self_ms
            s["count"] += e.count
            o = operators.setdefault(key.operator or "<unattributed>",
                                     {"device_ms": 0.0, "count": 0})
            o["device_ms"] += e.self_ms
            o["count"] += e.count
        return {
            "enabled": self.enabled, "entries": len(items),
            "device_ms_total": tot_self, "compile_ms_total": tot_compile,
            "dispatches_total": tot_count,
            "recompiles_attributed": recompiles,
            "jobs": jobs, "sites": sites, "operators": operators,
        }

    def profile(self, job: Optional[str] = None, top: int = 10) -> dict:
        """The full attribution report: top-``top`` hot entries (cost
        model attached), per-operator device-time shares, and the
        recompile-attribution records.  ``job`` filters by exact job
        name; None aggregates every job."""
        self._settle()
        with self._lock:
            items = [(k, e, list(e.reservoir))
                     for k, e in self._entries.items()]
            recompiles = [dict(r) for r in self._recompiles]
        if job is not None:
            items = [(k, e, w) for k, e, w in items if k.job == job]
            recompiles = [r for r in recompiles if r.get("job") == job]
        rows = [self._entry_dict(k, e, w) for k, e, w in items]
        total_self = sum(r["self_ms"] for r in rows)
        total_compile = sum(r["compile_ms"] for r in rows)
        for r in rows:
            r["share"] = (r["self_ms"] / total_self) if total_self else 0.0
        rows.sort(key=lambda r: (-r["total_ms"], r["site"],
                                 r["shape_signature"]))
        operators: Dict[str, float] = {}
        for r in rows:
            op = r["operator"] or "<unattributed>"
            operators[op] = operators.get(op, 0.0) + r["self_ms"]
        op_rows = [{"operator": op, "device_ms": ms,
                    "share": (ms / total_self) if total_self else 0.0}
                   for op, ms in sorted(operators.items(),
                                        key=lambda kv: -kv[1])]
        return {
            "job": job, "enabled": self.enabled,
            "total_device_ms": total_self,
            "total_compile_ms": total_compile,
            "programs": [self._with_cost(r) for r in rows[:max(0, top)]],
            "operators": op_rows,
            "recompiles": recompiles,
        }

    def trace_counters(self) -> List[dict]:
        """Recent (ts_ms, site, ms) samples (the data of the reference's
        Perfetto counter tracks)."""
        self._settle()
        with self._lock:
            return [{"ts_ms": ts, "site": site, "ms": ms}
                    for ts, site, ms in self._samples]

    def reset(self) -> None:
        """Test hook: drop every entry, prior build, sample and pending
        dispatch (which site dispatched before stays known)."""
        with self._lock:
            self._entries.clear()
            self._builds.clear()
            self._recompiles.clear()
            self._samples.clear()
            self._cost_src.clear()
            self._cost_cache.clear()
            self._pending.clear()
            self.forced_waits = 0


DEVICE_LEDGER = DeviceLedger()


def bind_ledger_metrics(registry) -> None:
    """Register the ledger's rollups as gauges under the ``profiler``
    scope of a MetricRegistry (Prometheus ``flink_tpu_profiler_*``).
    Idempotent: binding again overwrites the same entries."""
    g = registry.root().group("profiler")
    led = DEVICE_LEDGER
    g.gauge("enabled", lambda: 1 if led.enabled else 0)
    for name, key in (("entries", "entries"),
                      ("device_ms_total", "device_ms_total"),
                      ("compile_ms_total", "compile_ms_total"),
                      ("dispatches_total", "dispatches_total"),
                      ("recompiles_attributed_total",
                       "recompiles_attributed")):
        g.gauge(name, lambda key=key: led.snapshot()[key])


# Every ledger dispatch site, with its recording location.  The "Ledger
# sites" table of flink_tpu_torch/docs/OBSERVABILITY.md renders this
# inventory and the lint's TPU305 holds code literals (every
# ``DEVICE_LEDGER.begin("<site>", ...)`` and ``DEVICE_LEDGER.record(
# "<site>", ...)``), this tuple and the table identical.  The names are
# the reference's; ``device_window.native_fold`` (the CPU fallback's native
# index) and ``sched.throttle`` (the admission gate) have no counterpart.
# Keep entries sorted by site.
LEDGER_SITE_INVENTORY: tuple = (
    ("chain.fused_prelude",
     "runtime/compiled.py FusedChain.run — a new CUDA graph's capture "
     "(compile marker of zero ms; the capture is charged to the first "
     "replay)"),
    ("chain.fused_step",
     "runtime/compiled.py FusedChain.run — one decode + ingest_step graph "
     "replay per certified micro-batch"),
    ("device_session.fire",
     "runtime/operators/device_session.py — one session_fire round"),
    ("device_session.step",
     "runtime/operators/device_session.py — a batch's (key, ts) sort and "
     "its session_step launch"),
    ("device_window.fire",
     "runtime/operators/device_window.py — a full fire: pane-row merge, "
     "emit mask, select and health scalars"),
    ("device_window.fire_inc",
     "runtime/operators/device_window.py — an incremental fire over the "
     "sealed view"),
    ("device_window.fire_rebuild",
     "runtime/operators/device_window.py — the window_rebuild launch of a "
     "stale incremental state"),
    ("device_window.seal",
     "runtime/operators/device_window.py — the window_seal launch of an "
     "incremental fire"),
    ("device_window.step",
     "runtime/operators/device_window.py — a device batch's ingest_step "
     "launch"),
    ("mesh.fire",  # lint: key-ok ledger site, not a config key
     "parallel/sharded_window.py — the compact fire over every shard"),
    ("mesh.fire_full",
     "parallel/sharded_window.py — the full merge of every shard"),
    ("mesh.fire_inc",
     "parallel/sharded_window.py — the fire over the shards' sealed view"),
    ("mesh.rebuild_inc",
     "parallel/sharded_window.py — one window_rebuild a shard"),
    ("mesh.retire",  # lint: key-ok ledger site, not a config key
     "parallel/sharded_window.py — a retired pane's ring row reset"),
    ("mesh.seal_inc",
     "parallel/sharded_window.py — one window_seal a shard"),
    ("mesh.step",  # lint: key-ok ledger site, not a config key
     "parallel/sharded_window.py — one exchange_bucket and one counted "
     "ingest_step a shard"),
    ("ops.pallas_topk",
     "ops/radix_topk.py masked_topk_hist — the hist256 radix select"),
    ("sql.device_group_agg",
     "sql/device_group_agg.py — a batch's group_agg step"),
    ("state.reset_row",
     "state/device_backend.py reset_ring_row — a retired pane's ring row "
     "back to identity"),
    ("transfer.d2h",
     "metrics/device.py note_d2h — device→host transfer"),
    ("transfer.h2d",
     "metrics/device.py note_h2d — host→device transfer"),
)
