"""User function APIs (trimmed port of ``flink_tpu/core/functions.py``).

The function contracts of a DataStream job: map, flat map, filter,
reduce, incremental aggregate, key selector, process functions with
timers and side outputs, sources and sinks, and the adapters that turn
plain callables into them.

A function may declare a **vectorized** path (``map_batch``,
``filter_batch``) besides its per-row path; the operators take the
vectorized path when it answers and fall back to a row loop otherwise.
The vectorized path receives the batch itself: numpy columns
(``batch.columns``) for a host batch, torch tensors on the batch's device
(``batch.dcolumns``) for a ``DeviceRecordBatch``, so a device batch is
mapped or filtered with torch ops where it lies. ``open``/``close``
mirror RichFunction; ``RuntimeContext`` gives subtask facts and keyed
state. ``KeyedBroadcastProcessFunction`` is the keyed side and the
broadcast side of the broadcast state pattern, the keyed side seeing the
broadcast maps through a read-only ``_ReadOnlyMap``.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Callable, Generic, Iterable, Optional, TypeVar

IN = TypeVar("IN")
OUT = TypeVar("OUT")
ACC = TypeVar("ACC")
KEY = TypeVar("KEY")

__all__ = [
    "copy_per_subtask", "RuntimeContext", "Function", "MapFunction",
    "FlatMapFunction", "FilterFunction", "ReduceFunction",
    "AggregateFunction", "KeySelector", "Collector", "ProcessFunction",
    "KeyedProcessFunction", "KeyedBroadcastProcessFunction",
    "SourceFunction", "SinkFunction", "as_map",
    "as_flat_map", "as_filter", "as_reduce", "as_key_selector",
    "BuiltinAggregate", "ReduceAggregate",
]


def copy_per_subtask(fn):
    """A copy of ``fn`` for one subtask: user functions are never shared
    between subtasks. A function that cannot be copied must make its
    resources in open(), not in __init__."""
    try:
        return copy.deepcopy(fn)
    except Exception as e:
        raise ValueError(
            f"function {type(fn).__name__} is not copyable per subtask "
            f"({e!r}); create connections/pools/handles in open() instead "
            "of __init__") from e


class RuntimeContext:
    """What a rich function sees at runtime."""

    def __init__(self, task_name: str, subtask_index: int, parallelism: int,
                 max_parallelism: int, state_backend=None):
        self.task_name = task_name
        self.subtask_index = subtask_index
        self.parallelism = parallelism
        self.max_parallelism = max_parallelism
        self._state_backend = state_backend

    def get_state(self, descriptor) -> Any:
        """Keyed state for the enclosing keyed operator's current key."""
        if self._state_backend is None:
            raise RuntimeError("Keyed state is only available in keyed "
                               "operators")
        return self._state_backend.get_partitioned_state(descriptor)


class Function:
    """Base lifecycle (RichFunction.open/close)."""

    def open(self, ctx: RuntimeContext) -> None:  # pragma: no cover
        pass

    def close(self) -> None:  # pragma: no cover
        pass


class MapFunction(Function, Generic[IN, OUT]):
    def map(self, value: IN) -> OUT:
        raise NotImplementedError

    def map_batch(self, batch) -> Optional[Any]:
        """Optional vectorized path: batch -> batch (a device batch may
        map to a device batch), or None for the per-row loop."""
        return None


class FlatMapFunction(Function, Generic[IN, OUT]):
    def flat_map(self, value: IN) -> Iterable[OUT]:
        raise NotImplementedError


class FilterFunction(Function, Generic[IN]):
    def filter(self, value: IN) -> bool:
        raise NotImplementedError

    def filter_batch(self, batch) -> Optional[Any]:
        """Optional vectorized path: a bool mask a row (numpy for a host
        batch, a torch bool tensor on the batch's device for a device
        batch), or None for the per-row loop."""
        return None


class ReduceFunction(Function, Generic[IN]):
    """Commutative-associative pairwise combine."""

    def reduce(self, a: IN, b: IN) -> IN:
        raise NotImplementedError


class AggregateFunction(Function, Generic[IN, ACC, OUT]):
    """Incremental aggregation: ``add`` folds a record into an
    accumulator, ``merge`` folds two accumulators; both must agree."""

    def create_accumulator(self) -> ACC:
        raise NotImplementedError

    def add(self, value: IN, accumulator: ACC) -> ACC:
        raise NotImplementedError

    def get_result(self, accumulator: ACC) -> OUT:
        raise NotImplementedError

    def merge(self, a: ACC, b: ACC) -> ACC:
        raise NotImplementedError


class KeySelector(Function, Generic[IN, KEY]):
    def get_key(self, value: IN) -> KEY:
        raise NotImplementedError


@dataclass
class Collector(Generic[OUT]):
    """Push-style output."""

    _sink: Callable[[OUT, Optional[int]], None]

    def collect(self, value: OUT, timestamp: Optional[int] = None) -> None:
        self._sink(value, timestamp)


class ProcessFunction(Function, Generic[IN, OUT]):
    """Per-record access with timers and side outputs."""

    class Context:
        def __init__(self, timestamp, timer_service, current_key=None,
                     side_collector=None):
            self.timestamp = timestamp
            self.timer_service = timer_service
            self.current_key = current_key
            self._side = side_collector

        def output(self, tag: str, value: Any,
                   timestamp: Optional[int] = None) -> None:
            if self._side is None:
                raise RuntimeError("side outputs not wired")
            self._side(tag, value, timestamp)

    class OnTimerContext(Context):
        def __init__(self, timestamp, timer_service, time_domain,
                     current_key, side_collector=None):
            super().__init__(timestamp, timer_service, current_key,
                             side_collector)
            self.time_domain = time_domain  # "event" | "processing"

    def process_element(self, value: IN, ctx: "ProcessFunction.Context",
                        out: Collector[OUT]) -> None:
        raise NotImplementedError

    def on_timer(self, timestamp: int, ctx: "ProcessFunction.OnTimerContext",
                 out: Collector[OUT]) -> None:
        pass


KeyedProcessFunction = ProcessFunction  # keyed-ness comes from the stream


class KeyedBroadcastProcessFunction(Function, Generic[IN, OUT]):
    """The function of a keyed stream connected to a broadcast stream
    (Flink's KeyedBroadcastProcessFunction, run by
    CoBroadcastWithKeyedOperator). ``process_element`` sees a keyed
    record and the broadcast state read-only; ``process_broadcast_element``
    sees each broadcast record on every subtask, with the broadcast state
    read-write. Replicas stay equal as long as the broadcast side's
    updates are deterministic. The canonical use is dynamic rules: rules
    ride the broadcast side into the state, and the keyed side holds each
    event against them."""

    class ReadOnlyContext:
        def __init__(self, timestamp, current_key, broadcast_view,
                     timer_service=None):
            self.timestamp = timestamp
            self.current_key = current_key
            self.timer_service = timer_service
            self._view = broadcast_view

        def get_broadcast_state(self, descriptor) -> "_ReadOnlyMap":
            return self._view(descriptor.name)

    class Context:
        def __init__(self, timestamp, broadcast_rw, apply_keyed=None):
            self.timestamp = timestamp
            self._rw = broadcast_rw
            self._apply_keyed = apply_keyed

        def get_broadcast_state(self, descriptor) -> dict:
            return self._rw(descriptor.name)

        def apply_to_keyed_state(self, descriptor, fn) -> None:
            """``fn(key, state)`` for every key of this subtask holding
            state under ``descriptor`` (Flink's applyToKeyedState): the
            broadcast side's one way into the keyed state, e.g. to hold
            the events buffered before a rule against it."""
            if self._apply_keyed is None:
                raise RuntimeError("keyed state access not wired")
            self._apply_keyed(descriptor, fn)

    def process_element(self, value: IN,
                        ctx: "KeyedBroadcastProcessFunction.ReadOnlyContext",
                        out: Collector[OUT]) -> None:
        raise NotImplementedError

    def process_broadcast_element(
            self, value: IN, ctx: "KeyedBroadcastProcessFunction.Context",
            out: Collector[OUT]) -> None:
        raise NotImplementedError

    def on_timer(self, timestamp: int,
                 ctx: "KeyedBroadcastProcessFunction.ReadOnlyContext",
                 out: Collector[OUT]) -> None:
        pass


class _ReadOnlyMap:
    """A broadcast map as the keyed side sees it: reads only (a write
    from one subtask would make the replicas differ), so an item
    assignment raises TypeError."""

    __slots__ = ("_m",)

    def __init__(self, m: dict):
        self._m = m

    def get(self, k, default=None):
        return self._m.get(k, default)

    def __getitem__(self, k):
        return self._m[k]

    def __contains__(self, k):
        return k in self._m

    def __iter__(self):
        return iter(self._m)

    def __len__(self):
        return len(self._m)

    def items(self):
        return self._m.items()

    def keys(self):
        return self._m.keys()

    def values(self):
        return self._m.values()


class SourceFunction(Function, Generic[OUT]):
    """Run/cancel source; connectors are preferred."""

    def run(self, emit: Callable[[OUT, Optional[int]], None]) -> None:
        raise NotImplementedError

    def cancel(self) -> None:
        pass


class SinkFunction(Function, Generic[IN]):
    def invoke(self, value: IN, timestamp: Optional[int] = None) -> None:
        raise NotImplementedError

    def invoke_batch(self, batch) -> bool:
        """Optional vectorized path; True when the batch was consumed."""
        return False


# -- adapters: the DataStream API accepts plain callables ---------------------

class _LambdaMap(MapFunction):
    def __init__(self, fn: Callable):
        self._fn = fn

    def map(self, value):
        return self._fn(value)


class _LambdaFlatMap(FlatMapFunction):
    def __init__(self, fn: Callable):
        self._fn = fn

    def flat_map(self, value):
        return self._fn(value)


class _LambdaFilter(FilterFunction):
    def __init__(self, fn: Callable):
        self._fn = fn

    def filter(self, value):
        return self._fn(value)


class _LambdaReduce(ReduceFunction):
    def __init__(self, fn: Callable):
        self._fn = fn

    def reduce(self, a, b):
        return self._fn(a, b)


class _LambdaKeySelector(KeySelector):
    def __init__(self, fn: Callable):
        self._fn = fn

    def get_key(self, value):
        return self._fn(value)


def as_map(f) -> MapFunction:
    return f if isinstance(f, MapFunction) else _LambdaMap(f)


def as_flat_map(f) -> FlatMapFunction:
    return f if isinstance(f, FlatMapFunction) else _LambdaFlatMap(f)


def as_filter(f) -> FilterFunction:
    return f if isinstance(f, FilterFunction) else _LambdaFilter(f)


def as_reduce(f) -> ReduceFunction:
    return f if isinstance(f, ReduceFunction) else _LambdaReduce(f)


def as_key_selector(f) -> KeySelector:
    return f if isinstance(f, KeySelector) else _LambdaKeySelector(f)


# -- built-in aggregates ---------------------------------------------------------

@dataclass(frozen=True)
class BuiltinAggregate:
    """A reduction the device operators run as a fold plane."""

    kind: str             # sum | count | min | max | avg
    field: Optional[str]  # input column; None for count

    @property
    def accumulator_fields(self) -> tuple[str, ...]:
        if self.kind == "avg":
            return ("sum", "count")
        return (self.kind,)


class ReduceAggregate(AggregateFunction):
    """A ReduceFunction under the AggregateFunction contract (what a
    reducing state does)."""

    _EMPTY = object()

    def __init__(self, reduce_fn: ReduceFunction):
        self._reduce = reduce_fn

    def create_accumulator(self):
        return self._EMPTY

    def add(self, value, acc):
        return value if acc is self._EMPTY else self._reduce.reduce(acc, value)

    def merge(self, a, b):
        if a is self._EMPTY:
            return b
        if b is self._EMPTY:
            return a
        return self._reduce.reduce(a, b)

    def get_result(self, acc):
        return None if acc is self._EMPTY else acc
