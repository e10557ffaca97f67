"""DataStream API of the port (the Q5 subset of
``flink_tpu/api/datastream.py``): a linear chain source -> key_by ->
window -> device_aggregate -> sink."""

from __future__ import annotations

from typing import Optional

from ..runtime.operators.device_window import DeviceWindowAggOperator
from ..runtime.operators.sink import CollectSink, SinkOperator
from ..window.assigners import WindowAssigner

__all__ = ["DataStream", "KeyedStream", "WindowedStream"]


class DataStream:
    """One linear pipeline: a source, its watermark strategy and a list of
    operator factories, run by ``env.execute``."""

    def __init__(self, env, source, watermark_strategy, factories=()):
        self.env = env
        self.source = source
        self.watermark_strategy = watermark_strategy
        self.factories = list(factories)

    def _then(self, factory) -> "DataStream":
        return DataStream(self.env, self.source, self.watermark_strategy,
                          self.factories + [factory])

    def key_by(self, key_column: str) -> "KeyedStream":
        """Key by an integer column. One subtask owns every key group, so
        the keyed exchange is the identity."""
        if not isinstance(key_column, str):
            raise ValueError("the port keys by a column name")
        return KeyedStream(self, key_column)

    def add_sink(self, sink, name: str = "Sink") -> "DataStream":
        """``sink``: a callable taking a batch, or an object with
        ``invoke_batch(batch)``."""
        stream = self._then(lambda: SinkOperator(sink, name))
        self.env._pipelines.append(stream)
        return stream

    def execute_and_collect(self, job_name: str = "collect") -> list:
        sink = CollectSink()
        self.add_sink(sink, "Collect")
        self.env.execute(job_name)
        return sink.rows


class KeyedStream:
    def __init__(self, stream: DataStream, key_column: str):
        self.stream = stream
        self.key_column = key_column

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
                         name: str = "DeviceWindowAgg") -> DataStream:
        """Device window aggregation: rows (key, [window_start,
        window_end], *aggregates); ``emit_topk=k`` emits the top k keys by
        the first aggregate per window (the Q5 hot-items fire)."""
        stream = self.keyed.stream
        assigner, key_col = self.assigner, self.keyed.key_column
        device = stream.env.device

        def factory():
            return DeviceWindowAggOperator(
                assigner, key_col, aggs, capacity=capacity,
                ring_size=ring_size, emit_window_bounds=emit_window_bounds,
                emit_topk=emit_topk, defer_overflow=defer_overflow,
                async_fire=async_fire, device=device, name=name)

        return stream._then(factory)
