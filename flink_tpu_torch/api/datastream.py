"""DataStream API of the port (trimmed port of
``flink_tpu/api/datastream.py``): a lazy Transformation DAG of sources,
keyed exchanges, device window aggregates, custom one-input operators and
sinks, compiled and run by ``StreamExecutionEnvironment.execute``."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.records import RecordBatch
from ..graph.transformations import OneInputTransformation, \
    PartitionTransformation, SinkTransformation, Transformation
from ..runtime.operators.device_window import DeviceWindowAggOperator
from ..runtime.operators.sink import CollectSink, SinkOperator
from ..runtime.writer import KeyGroupPartitioner, RebalancePartitioner
from ..window.assigners import WindowAssigner

__all__ = ["DataStream", "KeyedStream", "WindowedStream"]


def _column_extractor(key: str):
    def extract(batch: RecordBatch) -> np.ndarray:
        return batch.column(key)
    extract.column = key
    return extract


class DataStream:
    def __init__(self, env, transformation: Transformation):
        self.env = env
        self.transformation = transformation

    def _one_input(self, name: str, factory, parallelism=None,
                   key_extractor=None, traceable=False) -> "DataStream":
        t = OneInputTransformation(
            name=name, operator_factory=factory, parallelism=parallelism,
            inputs=[self.transformation], key_extractor=key_extractor,
            traceable=traceable)
        self.env._transformations.append(t)
        return DataStream(self.env, t)

    def transform(self, name: str, operator_factory,
                  parallelism: Optional[int] = None,
                  traceable: bool = False) -> "DataStream":
        """Attach a custom one-input operator; ``traceable`` declares it
        device-safe (a pure columnwise step the fusion certifier may fuse
        through)."""
        return self._one_input(name, operator_factory, parallelism,
                               traceable=traceable)

    def key_by(self, key: str) -> "KeyedStream":
        """Key by an integer column: a hash exchange by key group."""
        if not isinstance(key, str):
            raise ValueError("the port keys by a column name")
        extractor = _column_extractor(key)
        maxp = self.env.max_parallelism
        t = PartitionTransformation(
            name="keyed-exchange",
            partitioner_factory=lambda: KeyGroupPartitioner(extractor, maxp),
            partitioner_name="hash", inputs=[self.transformation])
        self.env._transformations.append(t)
        return KeyedStream(self.env, t, extractor, key)

    def rebalance(self) -> "DataStream":
        t = PartitionTransformation(
            name="rebalance", partitioner_factory=RebalancePartitioner,
            partitioner_name="rebalance", inputs=[self.transformation])
        self.env._transformations.append(t)
        return DataStream(self.env, t)

    def add_sink(self, sink, name: str = "Sink",
                 parallelism: Optional[int] = None) -> "DataStream":
        """``sink``: a callable taking a batch, or an object with
        ``invoke_batch(batch)``."""
        t = SinkTransformation(name=name,
                               operator_factory=lambda: SinkOperator(sink,
                                                                     name),
                               parallelism=parallelism,
                               inputs=[self.transformation])
        self.env._transformations.append(t)
        self.env._sinks.append(t)
        return self

    def execute_and_collect(self, job_name: str = "collect") -> list:
        sink = CollectSink()
        self.add_sink(sink, "Collect")
        self.env.execute(job_name)
        return sink.rows

    def set_parallelism(self, parallelism: int) -> "DataStream":
        self.transformation.parallelism = parallelism
        return self

    def uid(self, uid: str) -> "DataStream":
        self.transformation.uid = uid
        return self

    def name(self, name: str) -> "DataStream":
        self.transformation.name = name
        return self

    def disable_chaining(self) -> "DataStream":
        self.transformation.chaining_allowed = False
        return self


class KeyedStream(DataStream):
    def __init__(self, env, transformation: Transformation, key_extractor,
                 key_spec: str):
        super().__init__(env, transformation)
        self.key_extractor = key_extractor
        self.key_spec = key_spec

    def window(self, assigner: WindowAssigner) -> "WindowedStream":
        return WindowedStream(self, assigner)


class WindowedStream:
    def __init__(self, keyed: KeyedStream, assigner: WindowAssigner):
        self.keyed = keyed
        self.assigner = assigner

    def device_aggregate(self, aggs, capacity: int = 1 << 16,
                         ring_size: int = 64,
                         emit_window_bounds: bool = True,
                         emit_topk: Optional[int] = None,
                         defer_overflow: bool = False,
                         async_fire: bool = False,
                         hbm_budget_slots: int = 0,
                         spill_staging_slots: int = 1 << 16,
                         name: str = "DeviceWindowAgg") -> DataStream:
        """Device window aggregation: rows (key, [window_start,
        window_end], *aggregates); ``emit_topk=k`` emits the top k keys by
        the first aggregate per window (the Q5 hot-items fire).
        ``hbm_budget_slots`` caps the device state and pages cold key
        groups to host RAM; ``spill_staging_slots`` is the rows the
        deferred step can stage for the host between two watermarks."""
        assigner, key_col = self.assigner, self.keyed.key_spec
        device = self.keyed.env.device

        def factory():
            return DeviceWindowAggOperator(
                assigner, key_col, aggs, capacity=capacity,
                ring_size=ring_size, emit_window_bounds=emit_window_bounds,
                emit_topk=emit_topk, defer_overflow=defer_overflow,
                async_fire=async_fire, hbm_budget_slots=hbm_budget_slots,
                spill_staging_slots=spill_staging_slots, device=device,
                name=name)

        return self.keyed._one_input(name, factory,
                                     key_extractor=self.keyed.key_extractor)
