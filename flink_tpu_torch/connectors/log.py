"""Partitioned-log (Kafka-shaped) source and sink (port of
``flink_tpu/connectors/log.py``).

Topics of ordered partitions, read by partition-offset splits and written
by a transactional producer, against a pluggable ``LogBroker``:
``InMemoryLogBroker`` here, ``connectors/log_net.py``'s TCP client across
processes. A reader's snapshot is ``{partition: next offset}``; a
writer's is ``{"staged": {checkpoint id: {partition: [lines]}}}``.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from ..core.keygroups import stable_hash
from ..core.records import RecordBatch
from ..formats.core import Format
from .core import Sink, SinkWriter, Source, SourceReader, SourceSplit

__all__ = ["LogBroker", "InMemoryLogBroker", "LogSource", "LogSink"]


class LogBroker:
    """The partitioned-log API the connectors consume."""

    def partitions(self, topic: str) -> int:
        raise NotImplementedError

    def poll(self, topic: str, partition: int, offset: int,
             max_records: int) -> list[tuple[int, str]]:
        """[(offset, payload), ...] from ``offset`` on."""
        raise NotImplementedError

    def append(self, topic: str, partition: int,
               payloads: list[str]) -> None:
        raise NotImplementedError

    def append_txn(self, txn_id: str, topic: str, partition: int,
                   payloads: list[str]) -> None:
        """An idempotent append: a ``txn_id`` applied before is a no-op
        (the transactional producer an exactly-once sink needs)."""
        raise NotImplementedError

    def end_offset(self, topic: str, partition: int) -> int:
        raise NotImplementedError


class InMemoryLogBroker(LogBroker):
    """A process-local broker."""

    def __init__(self, num_partitions: int = 4):
        self._topics: dict[str, list[list[str]]] = {}
        self._n = num_partitions
        self._applied_txns: set[str] = set()
        self._lock = threading.Lock()

    def create_topic(self, topic: str,
                     num_partitions: Optional[int] = None) -> None:
        with self._lock:
            self._topics.setdefault(
                topic, [[] for _ in range(num_partitions or self._n)])

    def partitions(self, topic: str) -> int:
        with self._lock:
            return len(self._topics[topic])

    def poll(self, topic: str, partition: int, offset: int,
             max_records: int) -> list[tuple[int, str]]:
        with self._lock:
            log = self._topics[topic][partition]
            end = min(len(log), offset + max_records)
            return [(o, log[o]) for o in range(offset, end)]

    def append(self, topic: str, partition: int,
               payloads: list[str]) -> None:
        with self._lock:
            self._topics.setdefault(
                topic, [[] for _ in range(self._n)])[partition].extend(
                payloads)

    def append_txn(self, txn_id: str, topic: str, partition: int,
                   payloads: list[str]) -> None:
        with self._lock:
            if txn_id in self._applied_txns:
                return
            self._applied_txns.add(txn_id)
            self._topics.setdefault(
                topic, [[] for _ in range(self._n)])[partition].extend(
                payloads)

    def end_offset(self, topic: str, partition: int) -> int:
        with self._lock:
            return len(self._topics[topic][partition])


class LogSource(Source):
    """Splits are partitions, dealt round-robin over the subtasks; a
    reader's state is its next offset a partition, so a replay after a
    restore is exact."""

    def __init__(self, broker: LogBroker, topic: str, fmt: Format,
                 bounded: bool = False,
                 starting_offsets: str = "earliest"):
        self._broker = broker
        self._topic = topic
        self._fmt = fmt
        self.schema = fmt.schema
        self.bounded = bounded
        self._start = starting_offsets

    def create_splits(self, parallelism: int) -> list[SourceSplit]:
        parts = list(range(self._broker.partitions(self._topic)))
        return [SourceSplit(f"{self._topic}-{i}", parts[i::parallelism])
                for i in range(parallelism)]

    def create_reader(self, split: SourceSplit,
                      device=None) -> SourceReader:
        return _LogReader(self._broker, self._topic, self._fmt,
                          split.payload, self.bounded, self._start)


class _LogReader(SourceReader):
    def __init__(self, broker: LogBroker, topic: str, fmt: Format,
                 partitions: list, bounded: bool, start: str):
        self._b = broker
        self._topic = topic
        self._fmt = fmt
        self._parts = list(partitions)
        self._bounded = bounded
        self._offsets = {p: (0 if start == "earliest"
                             else broker.end_offset(topic, p))
                         for p in self._parts}
        self._rr = 0

    def read_batch(self, max_records: int) -> Optional[RecordBatch]:
        """The next partition in turn with records; None once a bounded
        reader has read every partition to its end."""
        if not self._parts:
            return None if self._bounded else RecordBatch.empty(
                self._fmt.schema)
        done = 0
        for _ in range(len(self._parts)):
            p = self._parts[self._rr % len(self._parts)]
            self._rr += 1
            recs = self._b.poll(self._topic, p, self._offsets[p],
                                max_records)
            if recs:
                self._offsets[p] = recs[-1][0] + 1
                return self._fmt.decode_lines([r for _, r in recs])
            if self._offsets[p] >= self._b.end_offset(self._topic, p):
                done += 1
        if self._bounded and done == len(self._parts):
            return None
        return RecordBatch.empty(self._fmt.schema)

    def snapshot(self) -> Any:
        return dict(self._offsets)

    def restore(self, state: Any) -> None:
        self._offsets.update({int(k): int(v) for k, v in state.items()})


class LogSink(Sink):
    """Transactional produce: lines buffer per checkpoint and reach the
    broker only when the checkpoint completes, each (checkpoint,
    partition) as one idempotent ``append_txn``."""

    def __init__(self, broker: LogBroker, topic: str, fmt: Format,
                 partition_by: Optional[str] = None):
        self._broker = broker
        self._topic = topic
        self._fmt = fmt
        self._partition_by = partition_by

    def create_writer(self, subtask_index: int) -> SinkWriter:
        return _LogWriter(self._broker, self._topic, self._fmt,
                          self._partition_by, subtask_index)


class _LogWriter(SinkWriter):
    def __init__(self, broker: LogBroker, topic: str, fmt: Format,
                 partition_by: Optional[str], subtask: int):
        self._b = broker
        self._topic = topic
        self._fmt = fmt
        self._partition_by = partition_by
        self._subtask = subtask
        self._open_lines: dict[int, list[str]] = {}          # partition
        self._staged: dict[int, dict[int, list[str]]] = {}   # checkpoint

    def _partition_of(self, row, n_parts: int) -> int:
        if self._partition_by is None:
            return self._subtask % n_parts
        idx = self._fmt.schema.index_of(self._partition_by)
        v = row[idx] if isinstance(row, tuple) else row
        return stable_hash(v) % n_parts   # stable across processes

    def write_batch(self, batch: RecordBatch) -> None:
        if batch.n == 0:
            return
        n_parts = self._b.partitions(self._topic)
        text = self._fmt.encode_batch(batch).rstrip("\n")
        lines = text.split("\n") if text else []
        for row, line in zip(batch.iter_rows(), lines):
            p = self._partition_of(row, n_parts)
            self._open_lines.setdefault(p, []).append(line)

    def prepare_commit(self, checkpoint_id: int) -> None:
        if self._open_lines:
            self._staged[checkpoint_id] = self._open_lines
            self._open_lines = {}

    def _txn_id(self, cid, partition: int) -> str:
        return f"{self._topic}/{self._subtask}/{cid}/{partition}"

    def commit(self, checkpoint_id: int) -> None:
        for cid in sorted(k for k in self._staged if k <= checkpoint_id):
            for p, lines in self._staged.pop(cid).items():
                # the transaction id makes a redelivery a no-op
                self._b.append_txn(self._txn_id(cid, p), self._topic, p,
                                   lines)

    def snapshot(self) -> Any:
        return {"staged": {cid: {p: list(ls) for p, ls in parts.items()}
                           for cid, parts in self._staged.items()}}

    def restore(self, state: Any) -> None:
        # the restored checkpoint's staged lines commit now (it completed,
        # since the job restores from it); append_txn drops those the
        # failed attempt already committed
        for cid, parts in state.get("staged", {}).items():
            for p, lines in parts.items():
                self._b.append_txn(self._txn_id(cid, int(p)), self._topic,
                                   int(p), list(lines))
