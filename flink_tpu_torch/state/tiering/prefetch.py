"""PrefetchPipeline: stage warm->hot promotions off the task's thread (port
of ``flink_tpu/state/tiering/prefetch.py``).

The backend decides *which* key groups to promote (ResidencyManager);
this pipeline does the expensive part, gathering the groups' rows out of
the host-warm tier and copying them to the device, on a background
thread, so one payload can stage while the task thread works. The task
thread only ever:

* enqueues a request (:meth:`request`), and
* polls for a finished payload at a batch boundary (:meth:`poll`),

so promotions land exactly at batch boundaries. A staging failure is
raised again on the task thread at the next poll. ``cancel()`` (called
on restore) bumps an epoch so in-flight stagings are discarded: a stale
payload can never apply against post-restore state.

The staging callback supplied by the backend owns all device work; the
worker thread runs while requests are queued and ends when the queue is
empty, so an idle pipeline holds no thread. Each staging visits the
``tier.prefetch`` fault site before it gathers (a transient trip retries
with nothing mutated, a persistent one aborts the staging and is raised
at the next poll) and runs under the stall watchdog's
``watchdog.tier-timeout``, inside a ``tier.Prefetch`` span.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Optional, Sequence

import numpy as np

_SCOPE = "tiering.prefetch"


class PrefetchPipeline:
    """Double-buffered background staging of promotion payloads.

    ``stage_fn(groups) -> payload | None`` is supplied by the backend and
    performs the host-tier gather plus the copy to the device; a ``None``
    return means the groups left the warm tier in the meantime and the
    request is dropped.
    """

    def __init__(self, stage_fn: Callable[[np.ndarray], Optional[dict]],
                 *, asynchronous: bool = True, depth: int = 2):
        self._stage_fn = stage_fn
        self._asynchronous = bool(asynchronous)
        self._lock = threading.Lock()
        self._requests: collections.deque = collections.deque()
        self._staged: collections.deque = collections.deque()
        self._depth = max(1, depth)
        self._pending_groups: set = set()
        self._epoch = 0
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self.staged_total = 0
        self.cancelled_total = 0

    @property
    def asynchronous(self) -> bool:
        """True when staging runs on the pipeline's thread."""
        return self._asynchronous

    # ------------------------------------------------------------------
    # task-thread API
    # ------------------------------------------------------------------
    def request(self, groups: Sequence[int]) -> int:
        """Queue ``groups`` for staging; returns how many were accepted.

        Groups already queued or staged are skipped, so repeated boundary
        polls do not pile up duplicate work.  In synchronous mode
        (``state.tiering.async-prefetch: false``) staging happens inline,
        which keeps single-threaded runs fully deterministic.
        """
        with self._lock:
            if self._closed:
                return 0
            fresh = [int(g) for g in groups
                     if int(g) not in self._pending_groups]
            if not fresh:
                return 0
            self._pending_groups.update(fresh)
            self._requests.append((self._epoch, np.asarray(fresh, np.int64)))
            epoch = self._epoch
            if self._asynchronous and self._thread is None:
                self._thread = threading.Thread(
                    target=self._worker, name="tier-prefetch", daemon=True)
                self._thread.start()
        if not self._asynchronous:
            self._drain_one(epoch)
        return len(fresh)

    def poll(self) -> Optional[dict]:
        """Return a staged payload if one is ready; else ``None``.

        Raises any staging failure here, on the task thread, so it surfaces
        at a batch boundary instead of dying silently on the background
        thread.
        """
        with self._lock:
            if self._error is not None:
                err, self._error = self._error, None
                raise err
            while self._staged:
                epoch, groups, payload = self._staged.popleft()
                if epoch != self._epoch:
                    continue
                self._pending_groups.difference_update(int(g) for g in groups)
                return payload
            return None

    def forget(self, groups: Sequence[int]) -> None:
        """Drop ``groups`` from the pending set (payload was discarded)."""
        with self._lock:
            self._pending_groups.difference_update(int(g) for g in groups)

    def cancel(self) -> None:
        """Discard queued and staged work; in-flight stagings expire.

        Called on restore: the epoch bump means a payload staged against
        pre-restore state can never reach :meth:`poll`.
        """
        with self._lock:
            self._epoch += 1
            dropped = len(self._requests) + len(self._staged) + len(
                self._pending_groups)
            self._requests.clear()
            self._staged.clear()
            self._pending_groups.clear()
            self._error = None
            if dropped:
                self.cancelled_total += 1

    def close(self) -> None:
        self.cancel()
        with self._lock:
            self._closed = True
            t = self._thread
        if t is not None:
            t.join(timeout=5.0)

    @property
    def idle(self) -> bool:
        with self._lock:
            return not (self._requests or self._staged or self._pending_groups)

    # ------------------------------------------------------------------
    # staging (background thread in async mode, inline otherwise)
    # ------------------------------------------------------------------
    def _stage(self, groups: np.ndarray) -> Optional[dict]:
        from ...metrics.tracing import TRACER
        from ...runtime.faults import fire_with_retries
        from ...runtime.watchdog import WATCHDOG
        fire_with_retries("tier.prefetch", _SCOPE)
        with TRACER.span("tier", "Prefetch") as sp:
            payload = WATCHDOG.run(
                "tier.prefetch", lambda: self._stage_fn(groups), scope=_SCOPE)
            sp.set_attribute("groups", int(len(groups)))
            sp.set_attribute("keys", 0 if payload is None
                             else int(payload.get("n", 0)))
        return payload

    def _worker(self) -> None:
        while True:
            with self._lock:
                # the thread is marked gone under the lock that request()
                # appends under: a request either sees it gone and starts
                # another, or is seen here
                if not self._requests or self._closed:
                    self._thread = None
                    return
            self._drain_one()

    def _drain_one(self, only_epoch: Optional[int] = None) -> None:
        with self._lock:
            if not self._requests:
                return
            epoch, groups = self._requests.popleft()
            if epoch != self._epoch or (
                    only_epoch is not None and epoch != only_epoch):
                self._pending_groups.difference_update(int(g) for g in groups)
                return
        try:
            payload = self._stage(groups)
        except Exception as exc:  # raised again at the next poll()
            with self._lock:
                if epoch == self._epoch:
                    self._error = exc
                    self._pending_groups.difference_update(
                        int(g) for g in groups)
            return
        with self._lock:
            if epoch != self._epoch:
                return
            if payload is None:
                self._pending_groups.difference_update(int(g) for g in groups)
                return
            if len(self._staged) == self._depth:
                # both buffers full: the oldest payload goes, and its
                # groups may be requested again
                _e, old, _p = self._staged.popleft()
                self._pending_groups.difference_update(int(g) for g in old)
            self._staged.append((epoch, groups, payload))
            self.staged_total += 1
