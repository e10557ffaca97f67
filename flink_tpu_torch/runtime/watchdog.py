"""Stall watchdog: deadline-bounded blocking calls and task-progress
supervision (trimmed port of ``flink_tpu/runtime/watchdog.py``).

* **Deadline-bounded calls** (``WATCHDOG.run``, ``stall_bounded``): the
  regions that really block, an upload or a device->host read
  (``transfer.h2d``/``d2h``), the in-flight wait, a checkpoint write or
  load and a tier move, run on a supervised worker under the site's
  deadline (``watchdog.*`` keys). Past it the caller abandons the worker
  and gets a :class:`StallError`. The work is then under way and may
  still change state, so nothing runs it again: the error goes to task
  failover. A guarded dispatch (``DeviceGuard``, site ``device.execute``)
  runs on the caller's thread: it ends at its launches and blocks on
  nothing.
* **Injected hangs** sleep on the caller's thread when the site is
  visited, before the region starts. A hang past the region's deadline
  sleeps only to it and is that region's stall: a trip counted here, and
  a ``StallError`` the caller may retry, since nothing has run.
* **Task-progress supervision** (``TaskProgress``,
  ``TaskStallDetector``): each task loop bumps its progress epoch; a
  job-level detector fails any task whose epoch has not moved for
  ``task.stall-timeout`` while its input holds queued data, which sends
  it down the same restart path as any task failure. A dispatch wedged
  on its caller's thread surfaces there.

The worker. The reference starts a fresh thread for every supervised
call. Here each calling thread keeps one long-lived worker and hands it
each call: the same deadline and abandonment, without a thread start per
call. An abandoned worker finishes its call and exits; the caller's next
call starts a fresh one. A worker whose owner thread has ended exits when
it next wakes. The worker launches on the caller's CUDA stream
(``torch.cuda.current_stream()`` is per thread), so its launches keep
their order with the caller's other work, and with the caller's ledger
dispatch context (``metrics/profiler.py``), so its samples keep their
(job, operator).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

__all__ = ["StallError", "Watchdog", "WATCHDOG", "stall_bounded",
           "TaskProgress", "TaskStallDetector", "PROGRESS"]

_IDLE_CHECK_S = 5.0   # a parked worker checks its owner this often


class StallError(RuntimeError):
    """A supervised call passed its deadline (or a task's progress epoch
    stalled). Transient for the degrade ladder: retry first, escalate on
    repetition."""

    def __init__(self, site: str, deadline_s: float,
                 scope: Optional[str] = None):
        where = f"{site}[{scope}]" if scope else site
        super().__init__(
            f"operation at {where} stalled past its "
            f"{deadline_s:.3g}s deadline")
        self.site = site
        self.deadline_s = deadline_s
        self.scope = scope


class _Call:
    """One supervised call: its result or exception and the abandon flag."""

    __slots__ = ("fn", "stream", "done", "result", "exc", "abandoned")

    def __init__(self, fn: Callable, stream):
        self.fn = fn
        self.stream = stream
        self.done = threading.Event()
        self.result = None
        self.exc: Optional[BaseException] = None
        self.abandoned = False

    def execute(self) -> None:
        try:
            if self.stream is None:
                self.result = self.fn()
            else:
                import torch
                with torch.cuda.stream(self.stream):
                    self.result = self.fn()
        except BaseException as e:  # noqa: BLE001 - relayed to the caller
            self.exc = e
        finally:
            self.done.set()


class _Worker:
    """The long-lived worker of one calling thread."""

    def __init__(self, owner: threading.Thread):
        self.owner = owner
        self.inbox: queue.SimpleQueue = queue.SimpleQueue()
        self.abandoned = False
        self.thread = threading.Thread(target=self._loop,
                                       name=f"watchdog:{owner.name}",
                                       daemon=True)
        self.thread.start()

    def _loop(self) -> None:
        while True:
            try:
                call = self.inbox.get(timeout=_IDLE_CHECK_S)
            except queue.Empty:
                if not self.owner.is_alive():
                    return
                continue
            call.execute()
            done = call.abandoned or self.abandoned
            # an idle worker holds nothing of its last call: its function
            # and result may hold a finished job's operator and state
            call = None
            if done:
                return


def _caller_stream():
    """The calling thread's current CUDA stream, or None when CUDA was
    never initialised in this process (a CPU run)."""
    import torch
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    return torch.cuda.current_stream()


class Watchdog:
    """Per-site deadline supervisor. One per process (``WATCHDOG``),
    configured from the job's Configuration by ``deploy_local``, as
    ``FAULTS`` is."""

    #: site -> the key its deadline reads
    _SITE_KEYS = {
        "device.compile": "watchdog.device.compile-timeout",
        "device.execute": "watchdog.device.execute-timeout",
        "transfer.h2d": "watchdog.transfer-timeout",
        "transfer.d2h": "watchdog.transfer-timeout",
        "checkpoint.write": "watchdog.checkpoint-timeout",
        "checkpoint.load": "watchdog.checkpoint-timeout",
        "tier.evict": "watchdog.tier-timeout",
        "tier.prefetch": "watchdog.tier-timeout",
        "aot.warmup": "watchdog.aot-warmup-timeout",
    }

    def __init__(self):
        self._lock = threading.Lock()
        self._workers = threading.local()
        self.enabled = True
        self.deadlines: dict[str, float] = self._default_deadlines()
        self.stall_retries = 1
        self.trips: dict[str, int] = {}
        #: bounded stall-event log
        self.events: list[dict] = []
        #: supervised calls made and workers started, for the run's record
        self.calls = 0
        self.workers_started = 0

    @staticmethod
    def _default_deadlines() -> dict[str, float]:
        from ..core.config import DEFAULTS
        return {site: float(DEFAULTS[key])
                for site, key in Watchdog._SITE_KEYS.items()}

    # -- configuration ---------------------------------------------------
    def configure(self, config) -> None:
        """Adopt the ``watchdog.*`` keys of a job's Configuration."""
        with self._lock:
            self.enabled = bool(config.get("watchdog.enabled"))
            self.stall_retries = int(config.get("watchdog.stall-retries"))
            for site, key in self._SITE_KEYS.items():
                self.deadlines[site] = float(config.get(key))

    def reset(self) -> None:
        """Back to the defaults, trip accounting cleared (test isolation)."""
        with self._lock:
            self.enabled = True
            self.deadlines = self._default_deadlines()
            self.stall_retries = 1
            self.trips.clear()
            self.events.clear()

    def deadline_for(self, site: str) -> float:
        return self.deadlines.get(site, 0.0)

    def deadline_in_force(self, site: str,
                          deadline: Optional[float] = None) -> float:
        """The deadline a region at ``site`` runs under: 0 when the
        watchdog is off or the region unbounded."""
        d = self.deadline_for(site) if deadline is None else deadline
        return float(d) if self.enabled and d and d > 0 else 0.0

    def note_stall(self, site: str, deadline: float,
                   scope: Optional[str] = None) -> StallError:
        """Record a deadline expiry seen on the caller's own thread (an
        injected hang past its region's deadline): the trip counts as one
        of ``run``'s; returns the error for the caller to raise."""
        self._note_trip(site, scope, deadline)
        return StallError(site, deadline, scope)

    def trips_total(self) -> int:
        with self._lock:
            return sum(self.trips.values())

    # -- the supervised call ---------------------------------------------
    def _worker(self) -> _Worker:
        w = getattr(self._workers, "w", None)
        if w is None or w.abandoned or not w.thread.is_alive():
            w = self._workers.w = _Worker(threading.current_thread())
            with self._lock:
                self.workers_started += 1
        return w

    def run(self, site: str, fn: Callable, deadline: Optional[float] = None,
            scope: Optional[str] = None):
        """Run ``fn`` under ``site``'s deadline on this thread's worker;
        raise :class:`StallError` past it, with ``fn`` still running. A
        disabled watchdog or a deadline <= 0 calls ``fn`` directly."""
        d = self.deadline_in_force(site, deadline)
        if not d:
            return fn()
        with self._lock:
            self.calls += 1
        # the worker is another thread: re-pin the caller's (job,
        # operator) dispatch context so device-time ledger samples
        # recorded inside fn keep their attribution across the hop
        from ..metrics.profiler import dispatch_context, set_dispatch_context
        job, operator = dispatch_context()
        if job or operator:
            inner = fn

            def fn():
                set_dispatch_context(job, operator)
                return inner()

        call = _Call(fn, _caller_stream())
        worker = self._worker()
        worker.inbox.put(call)
        if call.done.wait(d):
            if call.exc is not None:
                raise call.exc
            return call.result
        call.abandoned = True
        worker.abandoned = True
        self._note_trip(site, scope, d)
        raise StallError(site, d, scope)

    def _note_trip(self, site: str, scope: Optional[str],
                   deadline: float) -> None:
        """Count a trip, then (on the caller's thread, so under the
        caller's trace context, not the worker's) report the
        ``watchdog.Stall`` span and dump the flight recorder: the span is
        in the ring before the dump reads it, so the dump's tail holds
        the stall."""
        from ..metrics.profiler import dispatch_context
        job = dispatch_context()[0]
        with self._lock:
            self.trips[site] = self.trips.get(site, 0) + 1
            if len(self.events) < 1024:
                self.events.append({
                    "timestamp": time.time(), "kind": "watchdog-stall",
                    "site": site, "scope": scope, "job": job,
                    "deadline_s": deadline})
        from ..metrics.device import DEVICE_STATS
        DEVICE_STATS.note_watchdog_trip(site)
        from ..metrics.tracing import TRACER, dump_flight_recorder
        (TRACER.span("watchdog", "Stall")
         .set_attribute("site", site)
         .set_attribute("scope", scope)
         .set_attribute("job", job)
         .set_attribute("deadline_s", deadline)
         .finish())
        dump_flight_recorder("stall", site=site, scope=scope, job=job,
                             deadline_s=deadline)


#: The process-global watchdog every bounded site consults.
WATCHDOG = Watchdog()


def stall_bounded(site: str, fn: Callable, scope: Optional[str] = None,
                  deadline: Optional[float] = None,
                  retries: Optional[int] = None):
    """Watchdog a region: visit ``site``'s rule on the caller's thread,
    then run ``fn``. Raising trips keep their transient-retry semantics; a
    hang past the deadline is a stall before ``fn`` began, retried in
    place up to ``watchdog.stall-retries`` times. A blocking region (an
    upload, a device->host read) runs under the site's deadline on the
    worker; a stall of ``fn`` itself goes to task failover as it is: ``fn``
    is still running on the abandoned worker, so it is never run again. A
    ``device.execute`` region ends at its launches and blocks on nothing,
    so it runs on the caller's thread, as ``DeviceGuard``'s dispatches
    do."""
    from .faults import FAULTS, fire_with_retries

    if FAULTS.enabled:
        bound = (site, WATCHDOG.deadline_in_force(site, deadline), scope)
        max_retries = WATCHDOG.stall_retries if retries is None else retries
        for attempt in range(max_retries + 1):
            try:
                fire_with_retries(site, scope=scope, bound=bound)
                break
            except StallError:
                if attempt >= max_retries:
                    raise
                from ..metrics.device import DEVICE_STATS
                DEVICE_STATS.note_retry(scope or site)
    if site == "device.execute":
        return fn()
    return WATCHDOG.run(site, fn, deadline=deadline, scope=scope)


# ---------------------------------------------------------------------------
# task-progress supervision
# ---------------------------------------------------------------------------

class TaskProgress:
    """A subtask's progress epoch: its loop bumps it once per processed
    event; the age is wall time since the last bump."""

    __slots__ = ("epoch", "last_ts")

    def __init__(self):
        self.epoch = 0
        self.last_ts = time.time()

    def bump(self) -> None:
        self.epoch += 1
        self.last_ts = time.time()

    @property
    def age_ms(self) -> float:
        return (time.time() - self.last_ts) * 1000.0


class _ProgressRegistry:
    """Process-global task id -> TaskProgress view."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tasks: dict[str, TaskProgress] = {}

    def register(self, task_id: str, progress: TaskProgress) -> None:
        with self._lock:
            self._tasks[task_id] = progress

    def unregister(self, task_id: str) -> None:
        with self._lock:
            self._tasks.pop(task_id, None)

    def ages_ms(self) -> dict[str, float]:
        with self._lock:
            items = list(self._tasks.items())
        return {tid: round(p.age_ms, 1) for tid, p in items}


PROGRESS = _ProgressRegistry()


class TaskStallDetector:
    """Job-level stall detector: fails any subtask whose progress epoch
    has not moved within ``task.stall-timeout`` while its input holds
    queued data, with a ``StallError``, so it takes the job's restart
    path (a region restart or a restart from the latest checkpoint under
    a supervisor; a failed job under ``run_job``)."""

    def __init__(self, job, stall_timeout: float,
                 interval: Optional[float] = None):
        self.job = job
        self.stall_timeout = stall_timeout
        self.interval = interval or max(stall_timeout / 4.0, 0.01)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_epoch: dict[str, tuple[int, float]] = {}
        self.detections = 0

    def start(self) -> "TaskStallDetector":
        if self.stall_timeout and self.stall_timeout > 0:
            self._thread = threading.Thread(
                target=self._loop, name="task-stall-detector", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        """Stop and wait for the thread (from any other thread): once a
        job has returned, no thread of it holds its tasks, so its device
        state is freed with the job."""
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(5.0)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            if self.job._done.is_set():
                return
            self.scan()

    def scan(self) -> list[str]:
        """One detection pass; returns the task ids flagged."""
        now = time.time()
        flagged = []
        for task_id, task in list(self.job.tasks.items()):
            progress = getattr(task, "progress", None)
            if progress is None or not task.is_alive:
                self._last_epoch.pop(task_id, None)
                continue
            epoch = progress.epoch
            seen, since = self._last_epoch.get(task_id, (None, now))
            if epoch != seen:
                self._last_epoch[task_id] = (epoch, now)
                continue
            if now - since < self.stall_timeout:
                continue
            if not task.input_pending():
                continue  # idle, not stalled
            self._last_epoch[task_id] = (epoch, now)  # re-arm
            flagged.append(task_id)
            self._flag(task_id, task, now - since)
        return flagged

    def _flag(self, task_id: str, task, age_s: float) -> None:
        self.detections += 1
        from ..metrics.device import DEVICE_STATS
        DEVICE_STATS.note_stall(task_id)
        err = StallError("task.progress", self.stall_timeout, scope=task_id)
        history = getattr(self.job, "failure_history", None)
        if history is not None:
            history.append({
                "timestamp": time.time(), "task": task_id,
                "kind": "stall-detected",
                "error": (f"no progress for {age_s:.3g}s with queued "
                          f"input (task.stall-timeout="
                          f"{self.stall_timeout:.3g}s)")})
        # cancel first: when the wedged thread unwinds it must not report
        # a second failure for this attempt
        task.cancel()
        self.job.task_failed(task_id, err)
