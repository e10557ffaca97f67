"""Source and sink SPI (trimmed port of ``flink_tpu/connectors/core.py``):
a ``Source`` splits its input over the source subtasks and makes one
``SourceReader`` a split (the reader's snapshot is its replay position);
a ``Sink`` makes one ``SinkWriter`` per sink subtask, and ``CollectSink``
keeps what it is given, the SQL layer's result sink.

``CollectSink`` keeps the columnar batches in arrival order and builds
Python rows only when they are asked for, so a large changelog can be
read column by column (``TableResult.batches``).
``TransactionalCollectSink`` shows a batch only once the checkpoint after
it completed (or the input ended): a restart from a checkpoint drops what
the failed attempt wrote since, so every row shows once."""

from __future__ import annotations

import threading
from typing import Any

from ..core.records import RecordBatch
from .datagen import SourceReader, SourceSplit

__all__ = ["Source", "SourceReader", "SourceSplit", "Sink", "SinkWriter",
           "CollectSink", "TransactionalCollectSink"]


class Source:
    """``bounded``: the input ends; ``schema``: the batches' schema."""

    bounded = True
    schema = None

    def create_splits(self, parallelism: int) -> list[SourceSplit]:
        raise NotImplementedError

    def create_reader(self, split: SourceSplit,
                      device=None) -> SourceReader:
        """``device``: the job's device (host readers ignore it)."""
        raise NotImplementedError


class Sink:
    def create_writer(self, subtask_index: int) -> "SinkWriter":
        raise NotImplementedError


class SinkWriter:
    def write_batch(self, batch: RecordBatch) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        """End of input (and a checkpoint's first phase)."""

    def prepare_commit(self, checkpoint_id: int) -> None:
        pass

    def commit(self, checkpoint_id: int) -> None:
        pass

    def snapshot(self) -> Any:
        return None

    def restore(self, state: Any) -> None:
        pass

    def close(self) -> None:
        pass


class CollectSink(Sink):
    """Collects every batch of every sink subtask, in arrival order."""

    def __init__(self):
        self.batches: list[RecordBatch] = []
        self._lock = threading.Lock()

    def create_writer(self, subtask_index: int) -> SinkWriter:
        sink = self

        class _Writer(SinkWriter):
            def write_batch(self, batch: RecordBatch) -> None:
                with sink._lock:
                    sink.batches.append(batch)

        return _Writer()

    @property
    def rows(self) -> list:
        return [r for b in self.batches for r in b.iter_rows()]


class TransactionalCollectSink(Sink):
    """A two-phase collecting sink: each writer stages its batches, a
    checkpoint's snapshot moves them into that checkpoint's transaction,
    and the checkpoint's completion publishes them to ``batches``. A
    writer of a failed attempt is dropped with what it staged."""

    def __init__(self):
        self.batches: list[RecordBatch] = []
        self._lock = threading.Lock()

    def create_writer(self, subtask_index: int) -> SinkWriter:
        sink = self

        class _Writer(SinkWriter):
            def __init__(self):
                self.staged: list[RecordBatch] = []
                self.prepared: dict[int, list[RecordBatch]] = {}

            def write_batch(self, batch: RecordBatch) -> None:
                self.staged.append(batch)

            def prepare_commit(self, checkpoint_id: int) -> None:
                self.prepared.setdefault(checkpoint_id, []).extend(
                    self.staged)
                self.staged = []

            def commit(self, checkpoint_id: int) -> None:
                done = sorted(c for c in self.prepared if c <= checkpoint_id)
                with sink._lock:
                    for c in done:
                        sink.batches.extend(self.prepared.pop(c))

        return _Writer()

    @property
    def rows(self) -> list:
        return [r for b in self.batches for r in b.iter_rows()]
