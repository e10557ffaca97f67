"""State descriptors: named, typed handles to keyed state (trimmed port of
``flink_tpu/state/descriptors.py``): value, list, map, reducing and
aggregating descriptors, with their TTL config. The device backend's row
plane holds the value kind; the heap backend (``state/heap.py``) holds
every kind. ``descriptor.queryable(name)`` exposes a state to point
reads from outside the job (``state/queryable.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

from ..core.functions import AggregateFunction, ReduceFunction

__all__ = ["StateDescriptor", "ValueStateDescriptor", "ListStateDescriptor",
           "ReducingStateDescriptor", "AggregatingStateDescriptor",
           "MapStateDescriptor", "StateTtlConfig"]


@dataclass(frozen=True)
class StateTtlConfig:
    """Relaxed TTL: entries expire ttl seconds after last update; cleanup
    happens lazily on access and on snapshot."""

    ttl: float
    update_on_read: bool = False


@dataclass(frozen=True)
class StateDescriptor:
    name: str
    kind: str  # value | list | reducing | aggregating | map
    default: Any = None
    ttl: Optional[StateTtlConfig] = None
    # the name a queryable-state client reads it by (None: private)
    queryable_name: Optional[str] = None
    # value serializer (None: the registry's default); its name and
    # version are written with a heap snapshot and resolved on restore
    serializer: Any = None

    def __post_init__(self):
        if self.kind not in ("value", "list", "reducing", "aggregating",
                             "map"):
            raise ValueError(f"Unknown state kind {self.kind!r}")

    def queryable(self, external_name: str) -> "StateDescriptor":
        """This state, exposed to queryable-state clients under
        ``external_name`` (a copy: the reducing and aggregating
        descriptors' own ``__init__`` rule out ``dataclasses.replace``)."""
        import copy
        c = copy.copy(self)
        object.__setattr__(c, "queryable_name", external_name)
        return c


def ValueStateDescriptor(name: str, default: Any = None,
                         ttl: Optional[StateTtlConfig] = None,
                         serializer: Any = None) -> StateDescriptor:
    return StateDescriptor(name, "value", default, ttl,
                           serializer=serializer)


def ListStateDescriptor(name: str, ttl: Optional[StateTtlConfig] = None
                        ) -> StateDescriptor:
    return StateDescriptor(name, "list", None, ttl)


def MapStateDescriptor(name: str, ttl: Optional[StateTtlConfig] = None
                       ) -> StateDescriptor:
    return StateDescriptor(name, "map", None, ttl)


@dataclass(frozen=True)
class ReducingStateDescriptor(StateDescriptor):
    reduce_function: ReduceFunction = None  # type: ignore[assignment]

    def __init__(self, name: str, reduce_function: ReduceFunction,
                 ttl: Optional[StateTtlConfig] = None):
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "kind", "reducing")
        object.__setattr__(self, "default", None)
        object.__setattr__(self, "ttl", ttl)
        object.__setattr__(self, "queryable_name", None)
        object.__setattr__(self, "serializer", None)
        object.__setattr__(self, "reduce_function", reduce_function)


@dataclass(frozen=True)
class AggregatingStateDescriptor(StateDescriptor):
    aggregate_function: AggregateFunction = None  # type: ignore[assignment]

    def __init__(self, name: str, aggregate_function: AggregateFunction,
                 ttl: Optional[StateTtlConfig] = None):
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "kind", "aggregating")
        object.__setattr__(self, "default", None)
        object.__setattr__(self, "ttl", ttl)
        object.__setattr__(self, "queryable_name", None)
        object.__setattr__(self, "serializer", None)
        object.__setattr__(self, "aggregate_function", aggregate_function)
