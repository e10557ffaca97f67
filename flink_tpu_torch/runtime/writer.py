"""Record writer and stream partitioners (trimmed port of
``flink_tpu/runtime/writer.py``).

Partitioning is batch-granular: a keyed exchange splits one batch into
per-subtask sub-batches in one vectorized pass; rebalance, rescale and
shuffle move whole batches; broadcast copies each batch to every
channel; a custom partitioner picks a channel a record. Watermarks, barriers and end of input broadcast to every output
channel, which is what makes downstream alignment and min-combine
correct.

A keyed exchange into one channel forwards the batch untouched, so a
device batch stays on the device. A task with several outputs (a source
feeding a window and a join) hands the same batch to each writer: a
device batch reaches every consumer by reference. Splitting a device batch by key group
across several subtasks is multi-device work the port does not do yet:
it raises.

``FeedbackRecordWriter`` writes an iteration's back edge: only batches
and the end of input flow into the loop; watermarks, barriers, status
and latency markers are dropped there.
"""

from __future__ import annotations

import random
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np

from ..core.elements import EndOfInput, Watermark
from ..core.keygroups import hash_batch, key_groups_for_hash_batch
from ..core.records import RecordBatch
from .channels import Channel
from .faults import FAULTS, fire_with_retries

__all__ = ["StreamPartitioner", "ForwardPartitioner", "RebalancePartitioner",
           "RescalePartitioner", "BroadcastPartitioner", "ShufflePartitioner",
           "GlobalPartitioner", "KeyGroupPartitioner", "CustomPartitioner",
           "RecordWriter", "FeedbackRecordWriter", "WriterCancelled"]


class StreamPartitioner:
    """Decides which downstream subtask(s) receive a batch."""

    name = "partitioner"

    def route(self, batch: RecordBatch, num_channels: int,
              subtask_index: int) -> Sequence[tuple[int, RecordBatch]]:
        raise NotImplementedError


class ForwardPartitioner(StreamPartitioner):
    name = "forward"

    def route(self, batch, num_channels, subtask_index):
        return [(subtask_index % num_channels, batch)]


class RebalancePartitioner(StreamPartitioner):
    """Round-robin whole batches."""

    name = "rebalance"

    def __init__(self):
        self._next = -1

    def route(self, batch, num_channels, subtask_index):
        self._next = (self._next + 1) % num_channels
        return [(self._next, batch)]


class RescalePartitioner(RebalancePartitioner):
    """Round-robin within the pointwise group (the edge wiring gives the
    locality; the rotation is rebalance's)."""

    name = "rescale"


class BroadcastPartitioner(StreamPartitioner):
    """Every batch to every channel (a device batch by reference)."""

    name = "broadcast"

    def route(self, batch, num_channels, subtask_index):
        return [(i, batch) for i in range(num_channels)]


class ShufflePartitioner(StreamPartitioner):
    """A random channel a batch."""

    name = "shuffle"

    def __init__(self, seed: Optional[int] = None):
        # seed None draws from the OS, as the reference's does
        self._rng = random.Random(seed)

    def route(self, batch, num_channels, subtask_index):
        return [(self._rng.randrange(num_channels), batch)]


class GlobalPartitioner(StreamPartitioner):
    """Every batch to subtask 0 (the singleton Top-N's input)."""

    name = "global"

    def route(self, batch, num_channels, subtask_index):
        return [(0, batch)]


class KeyGroupPartitioner(StreamPartitioner):
    """Hash -> key group -> downstream subtask, vectorized over the batch."""

    name = "hash"

    def __init__(self, key_extractor: Callable[[RecordBatch], np.ndarray],
                 max_parallelism: int):
        self._key_extractor = key_extractor
        self.max_parallelism = max_parallelism

    def route(self, batch, num_channels, subtask_index):
        if num_channels == 1:
            # every key group maps to subtask 0: forward the handle without
            # touching the columns (device batches stay on the device)
            return [(0, batch)]
        if getattr(batch, "is_device", False):
            raise NotImplementedError(
                "a keyed exchange into more than one subtask splits a device "
                "batch by key group, which the port does not do yet (the "
                "multi-device slice); run the device window at parallelism "
                "1, or generate host batches (datagen(device=False))")
        keys = self._key_extractor(batch)
        groups = key_groups_for_hash_batch(hash_batch(keys),
                                           self.max_parallelism)
        # subtask = kg * parallelism // max_parallelism, vectorized
        targets = (groups.astype(np.int64) * num_channels
                   // self.max_parallelism).astype(np.int32)
        parts = batch.split_by(targets, num_channels)
        return [(i, p) for i, p in enumerate(parts) if p.n]


class CustomPartitioner(StreamPartitioner):
    """``fn(key, num_channels) -> channel`` a record."""

    name = "custom"

    def __init__(self, fn: Callable[[Any, int], int],
                 key_extractor: Callable[[RecordBatch], np.ndarray]):
        self._fn = fn
        self._key_extractor = key_extractor

    def route(self, batch, num_channels, subtask_index):
        keys = self._key_extractor(batch)
        targets = np.fromiter((self._fn(k, num_channels) for k in keys),
                              dtype=np.int32, count=batch.n)
        parts = batch.split_by(targets, num_channels)
        return [(i, p) for i, p in enumerate(parts) if p.n]


class WriterCancelled(Exception):
    """Raised out of a blocked emit when the owning task is cancelled."""


class RecordWriter:
    """Writes one operator output to its downstream channels. A full
    channel blocks the writer (backpressure); a cancelled task unwinds out
    of the wait. ``stall_timeout`` (``task.backpressure.stall-timeout``, 0:
    unbounded) caps the time one element may wait on a full channel: a
    peer that never drains then fails this task with a StallError, and a
    restart from a checkpoint replays the element (it is never dropped)."""

    def __init__(self, channels: list[Channel], partitioner: StreamPartitioner,
                 subtask_index: int, put_timeout: float = 0.1,
                 stall_timeout: float = 0.0):
        self.channels = channels
        self.partitioner = partitioner
        self.subtask_index = subtask_index
        self._put_timeout = put_timeout
        self.stall_timeout = stall_timeout
        self.cancel_event = None  # set by the task that owns this writer
        #: seconds spent blocked on a full channel
        self.backpressured_s = 0.0
        #: the owning task's ``TaskIOTimers`` (backpressured time)
        self.io_timers = None
        #: the most elements a channel held just after a put
        self.max_queued = 0

    def _put_blocking(self, channel: Channel, element: Any) -> None:
        if not channel.put(element, timeout=0):
            t0 = time.perf_counter()
            try:
                while not channel.put(element, timeout=self._put_timeout):
                    if (self.cancel_event is not None
                            and self.cancel_event.is_set()):
                        raise WriterCancelled()
                    if (self.stall_timeout and time.perf_counter() - t0
                            > self.stall_timeout):
                        from ..metrics.device import DEVICE_STATS
                        from .watchdog import StallError
                        DEVICE_STATS.note_stall("channel.backpressure")
                        raise StallError(
                            "channel.backpressure", self.stall_timeout,
                            scope=f"subtask {self.subtask_index}")
            finally:
                dt = time.perf_counter() - t0
                self.backpressured_s += dt
                if self.io_timers is not None:
                    self.io_timers.backpressured_s += dt
        self.max_queued = max(self.max_queued, channel.size())

    def emit(self, batch: RecordBatch) -> None:
        if not batch.n:
            return
        # fault site channel.send: a transient trip is one failed flush,
        # retried in place; a persistent one fails the task
        if FAULTS.enabled:
            fire_with_retries("channel.send")
        for idx, part in self.partitioner.route(
                batch, len(self.channels), self.subtask_index):
            self._put_blocking(self.channels[idx], part)

    def broadcast(self, element) -> None:
        """Watermarks, barriers and status go to every channel."""
        for ch in self.channels:
            self._put_blocking(ch, element)

    def emit_watermark(self, wm: Watermark) -> None:
        self.broadcast(wm)


class FeedbackRecordWriter(RecordWriter):
    """The writer of an iteration's back edge: batches and the end of
    input only. Event time does not advance through the loop (the head's
    gate keeps feedback channels idle), and a barrier circulating the
    loop would start the head's alignment again, which is why a job with
    an iteration takes no checkpoint."""

    def broadcast(self, element) -> None:
        if isinstance(element, EndOfInput):
            super().broadcast(element)
