"""Async I/O: lookups outside the stream without blocking it (port of
``flink_tpu/runtime/operators/async_io.py``).

Flink's AsyncWaitOperator and AsyncFunction (``AsyncDataStream``): each
record issues a request; at most ``capacity`` are in flight, and a full
queue holds the task back (the operator polls, sleeping 1 ms, as the
reference does). Results go on in record order (``ordered``) or as they
complete (``unordered``). A request past its timeout, or one that failed,
is retried by the ``RetryPolicy``; then the job fails (``fail``) or the
function's ``timeout`` row is used (``ignore``).

Completed requests are drained at every batch, watermark and
processing-time tick, in place of Flink's mailbox. A watermark and the
end of input wait for every request before them. The snapshot is the
queue of unresolved input elements, ``{"operator": {"pending": [(row,
ts), ...]}}`` as the reference writes it; a restore submits them again,
so what resolved after the barrier is emitted once.

A device batch comes home once: each column is copied to the host a
batch, and the function gets rows of Python values.
"""

from __future__ import annotations

import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from ...core.records import RecordBatch, Schema, scalar
from .base import OneInputOperator

__all__ = ["AsyncFunction", "AsyncWaitOperator", "RetryPolicy"]


class AsyncFunction:
    """The user's function: ``async_invoke`` returns the result itself (a
    synchronous answer) or a Future of it. A result is one row tuple, an
    iterable of row tuples, or None (no row)."""

    def open(self) -> None:
        pass

    def async_invoke(self, row: tuple, timestamp: int):
        raise NotImplementedError

    def timeout(self, row: tuple):
        """The result when the retries are spent under ``ignore``."""
        return None

    def close(self) -> None:
        pass


@dataclass
class RetryPolicy:
    """A fixed delay between attempts (Flink's AsyncRetryStrategies)."""

    max_attempts: int = 3
    delay_ms: int = 100


@dataclass
class _Entry:
    row: tuple
    ts: int
    future: Any                   # None while it waits out a retry delay
    deadline: Optional[float]     # monotonic seconds
    attempts: int = 1
    not_before: float = 0.0       # the retry's earliest submit


class AsyncWaitOperator(OneInputOperator):
    #: a request that never answers must not hold the job for ever
    DEFAULT_TIMEOUT_MS = 60_000

    def __init__(self, fn: AsyncFunction, capacity: int = 100,
                 timeout_ms: Optional[int] = None, mode: str = "ordered",
                 retry: Optional[RetryPolicy] = None,
                 on_timeout: str = "fail",
                 out_schema: Optional[Schema] = None,
                 name: str = "AsyncWait"):
        super().__init__(name)
        if mode not in ("ordered", "unordered"):
            raise ValueError("mode must be ordered|unordered")
        if on_timeout not in ("fail", "ignore"):
            raise ValueError("on_timeout must be fail|ignore")
        self._fn = fn
        self._capacity = capacity
        self._timeout_ms = (self.DEFAULT_TIMEOUT_MS if timeout_ms is None
                            else timeout_ms)
        self._mode = mode
        self._retry = retry or RetryPolicy(max_attempts=1)
        self._on_timeout = on_timeout
        self.out_schema = out_schema
        self._pending: deque[_Entry] = deque()
        self._restored_rows: list[tuple] = []

    def open(self) -> None:
        self._fn.open()
        # the requests in flight at the snapshot, submitted again
        for row, ts in self._restored_rows:
            self._pending.append(self._submit(tuple(row), int(ts)))
        self._restored_rows = []

    def close(self) -> None:
        self._fn.close()

    # -- requests ----------------------------------------------------------
    def _submit(self, row: tuple, ts: int, attempts: int = 1) -> _Entry:
        try:
            result = self._fn.async_invoke(row, ts)
        except Exception as exc:  # noqa: BLE001 - a raise is a failed future
            result = Future()
            result.set_exception(exc)
        if not isinstance(result, Future):
            done: Future = Future()
            done.set_result(result)
            result = done
        deadline = (time.monotonic() + self._timeout_ms / 1000.0
                    if self._timeout_ms is not None else None)
        return _Entry(row, ts, result, deadline, attempts)

    def _fail_or_retry(self, e: _Entry, why: str) -> str:
        """A timeout or a failure: a retry after the delay, or ``why``."""
        if e.attempts < self._retry.max_attempts:
            if e.future is not None:
                e.future.cancel()    # frees queued work in the user's pool
            e.future = None
            e.not_before = time.monotonic() + self._retry.delay_ms / 1000.0
            return "waiting"
        return why

    def _entry_state(self, e: _Entry) -> str:
        """done | waiting | timed_out | failed."""
        now = time.monotonic()
        if e.future is None:
            if now < e.not_before:
                return "waiting"
            new = self._submit(e.row, e.ts, e.attempts + 1)
            e.future, e.deadline, e.attempts = \
                new.future, new.deadline, new.attempts
        if e.future.done():
            if e.future.exception() is not None:
                return self._fail_or_retry(e, "failed")
            return "done"
        if e.deadline is not None and now > e.deadline:
            return self._fail_or_retry(e, "timed_out")
        return "waiting"

    def _resolve(self, e: _Entry, out_rows: list, out_ts: list,
                 state: str) -> None:
        if state in ("timed_out", "failed"):
            if self._on_timeout == "fail":
                if state == "failed":
                    raise e.future.exception()
                raise TimeoutError(
                    f"async request timed out after {e.attempts} attempts "
                    f"for row {e.row!r}")
            result = self._fn.timeout(e.row)
        else:
            result = e.future.result()
        if result is None:
            return
        for r in ([result] if isinstance(result, tuple) else list(result)):
            out_rows.append(r if isinstance(r, tuple) else tuple(r))
            out_ts.append(e.ts)

    def _drain(self, wait_all: bool, out_rows: list, out_ts: list) -> None:
        """Take the completed entries: from the head only (ordered) or
        anywhere (unordered). ``wait_all`` polls until the queue is
        empty."""
        while self._pending:
            if self._mode == "ordered":
                head = self._pending[0]
                state = self._entry_state(head)
                if state == "waiting":
                    if not wait_all:
                        return
                    time.sleep(0.001)
                    continue
                self._pending.popleft()
                self._resolve(head, out_rows, out_ts, state)
                continue
            progressed = False
            for _ in range(len(self._pending)):
                e = self._pending.popleft()
                state = self._entry_state(e)
                if state == "waiting":
                    self._pending.append(e)
                else:
                    self._resolve(e, out_rows, out_ts, state)
                    progressed = True
            if not self._pending or not wait_all:
                return
            if not progressed:
                time.sleep(0.001)

    def _emit(self, out_rows: list, out_ts: list) -> None:
        if not out_rows:
            return
        # a column widens when a later value needs it (never truncates)
        batch, self.out_schema = RecordBatch.from_rows_infer(
            self.out_schema, out_rows, out_ts)
        self.output.emit(batch)

    # -- data path ---------------------------------------------------------
    def process_batch(self, batch: RecordBatch) -> None:
        if batch.n == 0:
            return
        cols = []
        for n in batch.schema.names:
            col = np.asarray(batch.column(n))
            cols.append([scalar(v) for v in col] if col.dtype == object
                        else col.tolist())
        stamps = np.asarray(batch.timestamps).tolist()
        out_rows: list = []
        out_ts: list = []
        ordered = self._mode == "ordered"
        for i in range(batch.n):
            row = tuple(c[i] for c in cols)
            while len(self._pending) >= self._capacity:
                # a full queue holds the task back
                before = len(self._pending)
                self._drain(False, out_rows, out_ts)
                if len(self._pending) == before:
                    time.sleep(0.001)
            self._pending.append(self._submit(row, stamps[i]))
            if ordered:
                self._drain(False, out_rows, out_ts)
        if not ordered:
            # unordered, a drain scans the whole queue: once a batch (and
            # whenever the queue is full) instead of after every row; the
            # rows go out at the batch's end either way
            self._drain(False, out_rows, out_ts)
        self._emit(out_rows, out_ts)

    def _drain_and_emit(self, wait_all: bool) -> None:
        out_rows: list = []
        out_ts: list = []
        self._drain(wait_all, out_rows, out_ts)
        self._emit(out_rows, out_ts)

    def process_watermark(self, watermark) -> None:
        # every request before the watermark resolves first
        self._drain_and_emit(True)
        super().process_watermark(watermark)

    def advance_processing_time(self, now_ms: int) -> None:
        self._drain_and_emit(False)

    def finish(self) -> None:
        self._drain_and_emit(True)

    # -- checkpointing -----------------------------------------------------
    def snapshot_state(self, checkpoint_id: int) -> dict:
        """The unresolved input elements. The barrier has gone on already,
        so a result that resolves later is emitted after it, and the
        restore's resubmission reproduces it once; a drain here would put
        rows of after the barrier into this checkpoint."""
        return {"operator": {
            "pending": [(list(e.row), e.ts) for e in self._pending]}}

    def initialize_state(self, keyed_snapshots: list,
                         operator_snapshot) -> None:
        if operator_snapshot and operator_snapshot.get("pending"):
            self._restored_rows = [(tuple(r), int(t))
                                   for r, t in operator_snapshot["pending"]]
