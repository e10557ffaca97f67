"""Transformation DAG: what the fluent API records (copy of
``flink_tpu/graph/transformations.py``): a lazy DAG the environment
translates into a StreamGraph (graph/stream_graph.py)."""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ..core.records import Schema
from ..core.watermarks import WatermarkStrategy

__all__ = [
    "Transformation", "SourceTransformation", "OneInputTransformation",
    "TwoInputTransformation", "PartitionTransformation", "UnionTransformation",
    "SinkTransformation", "SideOutputTransformation",
]

_ids = itertools.count(1)


@dataclass
class Transformation:
    name: str
    parallelism: Optional[int] = None
    max_parallelism: Optional[int] = None
    schema: Optional[Schema] = None
    inputs: list["Transformation"] = field(default_factory=list)
    id: int = field(default_factory=lambda: next(_ids))
    chaining_allowed: bool = True
    slot_sharing_group: str = "default"
    uid: Optional[str] = None  # stable operator id for savepoint mapping

    @property
    def effective_uid(self) -> str:
        return self.uid or f"op-{self.id}"


@dataclass
class SourceTransformation(Transformation):
    source: Any = None
    watermark_strategy: WatermarkStrategy = field(
        default_factory=WatermarkStrategy.no_watermarks)


@dataclass
class OneInputTransformation(Transformation):
    """operator_factory() -> OneInputOperator (fresh instance per subtask)."""

    operator_factory: Callable[[], Any] = None
    # keyed inputs: extractor recomputed downstream for state addressing
    key_extractor: Optional[Callable] = None
    traceable: bool = False  # declared device-safe (fusable)


@dataclass
class TwoInputTransformation(Transformation):
    operator_factory: Callable[[], Any] = None
    key_extractor1: Optional[Callable] = None
    key_extractor2: Optional[Callable] = None


@dataclass
class PartitionTransformation(Transformation):
    """Repartitioning edge: carries a partitioner factory so each upstream
    subtask gets a fresh stateful partitioner (round-robin counters)."""

    partitioner_factory: Callable[[], Any] = None
    partitioner_name: str = "forward"


@dataclass
class UnionTransformation(Transformation):
    pass


@dataclass
class SinkTransformation(Transformation):
    operator_factory: Callable[[], Any] = None


@dataclass
class SideOutputTransformation(Transformation):
    tag: str = ""


@dataclass
class FeedbackTransformation(Transformation):
    """Iteration head: a pass-through node whose input set grows a
    FEEDBACK edge at close_with time. The port builds no iterations; the
    graph compiler refuses one."""

    feedback_inputs: list["Transformation"] = field(default_factory=list)
    max_wait_s: float = 2.0
