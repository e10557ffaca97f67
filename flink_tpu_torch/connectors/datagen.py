"""Generator and in-memory collection sources (port of the datagen and
collection parts of ``flink_tpu/connectors/core.py``).

``DataGenSource(gen_fn, ...)`` calls ``gen_fn(idx) -> {column: values}``
on a batch of global record indices. Under parallelism P, subtask s reads
the indices ``(start + i) * P + s``; a reader's only state is its next
``start``, so resume is exact. ``rate_per_sec`` caps each subtask's
records per second: a rate-limited reader waits until a whole
micro-batch is due (or the tail of a bounded share), so batch shapes do
not shrink to whatever the clock allows.

* Host reader: ``idx`` is an int64 numpy array, columns come back as
  numpy.
* Device reader (``device=True``): ``idx`` is an int64 torch tensor on the
  job's device and ``gen_fn`` returns torch columns there, so the batch
  never touches the host. A batch's event-time bounds come from calling
  ``gen_fn`` on a 2-element CPU tensor of its endpoint indices, which is
  why the timestamp column must be non-decreasing in the index. That
  contract is checked on the device for every batch (within the batch and
  against the previous batch's tail) into a running flag that is read
  once, when the source is exhausted or closed, and at checkpoints.
* Fused mode (``enable_fused``, armed by the deployer for a certified
  source -> window chain): the device reader does no device work at all
  and emits ``LazyDeviceBatch`` handles; the chained window operator runs
  the decode and its ingest step as one dispatch (``runtime/compiled.py``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from ..core.device_records import DeviceRecordBatch, LazyDeviceBatch
from ..core.records import MIN_TIMESTAMP, RecordBatch, Schema
from ..device import torch_dtype

__all__ = ["DataGenSource", "CollectionSource", "SourceReader", "SourceSplit"]


@dataclass
class SourceSplit:
    split_id: str
    payload: Any = None


class SourceReader:
    def read_batch(self, max_records: int) -> Optional[RecordBatch]:
        """Next batch (empty: nothing due yet), or None when exhausted."""
        raise NotImplementedError

    def snapshot(self) -> Any:
        return None

    def restore(self, state: Any) -> None:
        pass

    def close(self) -> None:
        pass


class DataGenSource:
    def __init__(self, gen_fn: Callable[[Any], dict], schema: Schema,
                 count: Optional[int] = None,
                 rate_per_sec: Optional[float] = None,
                 timestamp_column: Optional[str] = None,
                 device: bool = False):
        self._gen = gen_fn
        self.schema = schema
        self._count = count
        self.bounded = count is not None
        self._rate = rate_per_sec
        self._ts_col = timestamp_column
        self._device = bool(device)

    def set_rate(self, rate_per_sec: Optional[float]) -> None:
        """Change the rate cap while the job runs: 0 pauses the source,
        None lifts the cap. A reader re-anchors its clock at its next read,
        so no burst makes up for a pause."""
        self._rate = rate_per_sec

    def create_splits(self, parallelism: int) -> list[SourceSplit]:
        return [SourceSplit(f"datagen-{i}", (i, parallelism))
                for i in range(parallelism)]

    def create_reader(self, split: SourceSplit,
                      device: torch.device) -> SourceReader:
        """``device`` is the job's device, used when the source generates
        on the device."""
        subtask, parallelism = split.payload
        if self._device:
            return _DeviceDataGenReader(self, subtask, parallelism, device)
        return _DataGenReader(self, subtask, parallelism)


class _DataGenReader(SourceReader):
    def __init__(self, source: DataGenSource, subtask: int,
                 parallelism: int):
        self._s = source
        self._subtask = subtask
        self._parallelism = parallelism
        self._next = 0
        self._started = time.time()
        self._rate_seen = source._rate

    def _plan_batch(self, max_records: int) -> Optional[int]:
        """How many records the next batch holds (None: exhausted, 0:
        nothing due yet)."""
        rate = self._s._rate
        if rate != self._rate_seen:
            self._rate_seen = rate
            if rate:
                self._started = time.time() - self._next / rate
        n = max_records
        if self._s._count is not None:
            total = self._s._count
            share = total // self._parallelism + (
                1 if self._subtask < total % self._parallelism else 0)
            if self._next >= share:
                return None
            n = min(n, share - self._next)
        if rate is not None:
            due = int((time.time() - self._started) * rate) - self._next
            if due < n:
                return 0
        return n

    def _indices(self, n: int, lib, **kw):
        return (self._next + lib.arange(n, **kw)) * self._parallelism \
            + self._subtask

    def read_batch(self, max_records: int) -> Optional[RecordBatch]:
        n = self._plan_batch(max_records)
        if n is None:
            return None
        if n == 0:
            return RecordBatch.empty(self._s.schema)
        cols = self._s._gen(self._indices(n, np, dtype=np.int64))
        self._next += n
        batch = RecordBatch(self._s.schema, cols)
        if self._s._ts_col is not None:
            batch = batch.with_timestamps(
                batch.column(self._s._ts_col).astype(np.int64))
        return batch

    def snapshot(self) -> Any:
        return self._next

    def restore(self, state: Any) -> None:
        self._next = int(state)
        if self._s._rate:
            # the rate holds from here on, not from the reader's creation
            self._started = time.time() - self._next / self._s._rate


class _DeviceDataGenReader(_DataGenReader):
    def __init__(self, source: DataGenSource, subtask: int,
                 parallelism: int, device: torch.device):
        super().__init__(source, subtask, parallelism)
        self._dev = torch.device(device)
        # running device flag of the monotonicity contract, read once at
        # the end (and at checkpoints); the fused chain ORs into it too
        self._viol = torch.zeros((), dtype=torch.bool, device=self._dev)
        self._viol_checked = True
        # the previous batch's tail timestamp: a device scalar, or in fused
        # mode the host int of its analytic bound
        self._prev_last: Any = MIN_TIMESTAMP
        self._fused = False

    def enable_fused(self) -> bool:
        """Emit ``LazyDeviceBatch`` handles instead of decoding (certified
        fused chains only); needs a timestamp column."""
        if self._s._ts_col is None:
            return False
        self._fused = True
        return True

    def _check_monotonic(self) -> None:
        if self._viol_checked:
            return
        self._viol_checked = True
        # lint: sync-ok the monotonicity flag, read once per job at its end
        if bool(self._viol):
            raise ValueError(
                "DataGenSource(device=True) contract violated: the "
                f"timestamp column {self._s._ts_col!r} is not non-decreasing "
                "in the index (detected on the device); window results of "
                "this run are unreliable")

    def decode(self, start: int, n: int, prev_last):
        """The batch of ``n`` records from reader index ``start``: device
        columns, the int64 timestamps (None without a timestamp column),
        and the monotonicity flag ORed into the running flag."""
        idx = (start + torch.arange(n, dtype=torch.int64, device=self._dev)) \
            * self._parallelism + self._subtask
        cols = self._s._gen(idx)
        out = {f.name: torch.as_tensor(cols[f.name], device=self._dev).to(
                   torch_dtype(f.dtype))
               for f in self._s.schema.fields}
        ts_col = self._s._ts_col
        if ts_col is None:
            return out, None
        ts = out[ts_col].to(torch.int64)
        self._viol |= (ts[1:] < ts[:-1]).any() | (ts[0] < prev_last)
        self._viol_checked = False
        return out, ts

    def _bounds(self, n: int) -> tuple[int, int]:
        """Event-time bounds of the next batch from its endpoint indices."""
        first = self._next * self._parallelism + self._subtask
        last = (self._next + n - 1) * self._parallelism + self._subtask
        ends = self._s._gen(torch.tensor([first, last], dtype=torch.int64))
        ts_min, ts_max = (int(v) for v in ends[self._s._ts_col])
        if ts_min > ts_max:
            raise ValueError(
                "DataGenSource(device=True) needs a timestamp column "
                f"non-decreasing in the index; got ts({first})={ts_min} "
                f"> ts({last})={ts_max}")
        return ts_min, ts_max

    def read_batch(self, max_records: int):
        n = self._plan_batch(max_records)
        if n is None:
            self._check_monotonic()
            return None
        if n == 0:
            return RecordBatch.empty(self._s.schema)
        if n != max_records:
            n = 1 << (n.bit_length() - 1)   # power-of-two tail batches
        ts_col = self._s._ts_col
        if self._fused:
            ts_min, ts_max = self._bounds(n)
            batch = LazyDeviceBatch(self._s.schema, self, self._next, n,
                                    int(self._prev_last), ts_min, ts_max,
                                    ts_column=ts_col)
            self._prev_last = ts_max
            self._next += n
            return batch
        out, ts = self.decode(self._next, n, self._prev_last)
        if ts_col is None:
            self._next += n
            return DeviceRecordBatch(self._s.schema, out, None,
                                     MIN_TIMESTAMP, MIN_TIMESTAMP)
        ts_min, ts_max = self._bounds(n)
        self._prev_last = ts[-1]
        self._next += n
        return DeviceRecordBatch(self._s.schema, out, ts, ts_min, ts_max,
                                 ts_column=ts_col)

    def close(self) -> None:
        self._check_monotonic()

    # -- checkpointing: the deferred violation flag and the cross-batch
    # tail timestamp are part of the reader's exact-resume state ---------
    def snapshot(self) -> Any:
        return {"next": self._next, "prev_last": int(self._prev_last),
                "viol": bool(self._viol)}

    def restore(self, state: Any) -> None:
        if not isinstance(state, dict):   # a host reader's bare index
            state = {"next": state, "prev_last": MIN_TIMESTAMP}
        super().restore(state["next"])
        self._prev_last = int(state["prev_last"])
        if state.get("viol"):
            # the violation predates this checkpoint; resuming would
            # silently launder it
            raise ValueError(
                "DataGenSource(device=True) checkpoint records a timestamp "
                "monotonicity contract violation; the job's window results "
                "are unreliable")


class CollectionSource:
    """Bounded source over an in-memory collection of rows (one split)."""

    bounded = True

    def __init__(self, elements: Sequence[Any],
                 schema: Optional[Schema] = None,
                 timestamps: Optional[Sequence[int]] = None):
        self._elements = list(elements)
        self.schema = schema or Schema.infer(self._elements[0])
        self._timestamps = (list(timestamps) if timestamps is not None
                            else None)

    def create_splits(self, parallelism: int) -> list[SourceSplit]:
        return [SourceSplit(f"collection-{i}", i) for i in range(parallelism)]

    def create_reader(self, split: SourceSplit,
                      device: torch.device) -> SourceReader:
        return _CollectionReader(self, split.payload)


class _CollectionReader(SourceReader):
    """Reads every P-th element from its split's offset; parallelism is
    set by the deployer (from_collection pins it to 1)."""

    _parallelism = 1

    def __init__(self, source: CollectionSource, offset: int):
        self._s = source
        self._offset = offset
        self._pos = 0

    def read_batch(self, max_records: int) -> Optional[RecordBatch]:
        idx = range(self._offset, len(self._s._elements),
                    self._parallelism)[self._pos:self._pos + max_records]
        if not idx:
            return None
        rows = [self._s._elements[i] for i in idx]
        ts = ([self._s._timestamps[i] for i in idx]
              if self._s._timestamps is not None else None)
        self._pos += len(idx)
        return RecordBatch.from_rows(self._s.schema, rows, ts)

    def snapshot(self) -> Any:
        return self._pos

    def restore(self, state: Any) -> None:
        self._pos = int(state)
