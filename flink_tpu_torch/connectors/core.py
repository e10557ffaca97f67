"""Sink SPI (trimmed port of ``flink_tpu/connectors/core.py``): a
``Sink`` makes one ``SinkWriter`` per sink subtask, and ``CollectSink``
keeps what it is given, the SQL layer's result sink.

``CollectSink`` keeps the columnar batches in arrival order and builds
Python rows only when they are asked for, so a large changelog can be
read column by column (``TableResult.batches``)."""

from __future__ import annotations

import threading
from typing import Any

from ..core.records import RecordBatch

__all__ = ["Sink", "SinkWriter", "CollectSink"]


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
