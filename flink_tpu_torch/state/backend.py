"""Keyed state backend interface and registry (trimmed port of
``flink_tpu/state/backend.py``).

A keyed backend owns all keyed state of one operator subtask's key-group
range. State is addressed by (key, namespace): the namespace is the
window of a windowed operator. Backends are chosen by name through a
registry: ``tpu``, the device backend (``state/device_backend.py``),
whose row plane holds value state only, and ``hashmap``, the heap
backend (``state/heap.py``), which holds every kind. Operators that need
namespaced list, aggregating or map state on a partial backend ask
``backend_supports_general_state`` and pin ``hashmap``.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Iterable, Optional

from ..core.keygroups import KeyGroupRange, assign_to_key_group
from .descriptors import StateDescriptor

__all__ = ["State", "ValueState", "ListState", "ReducingState",
           "AggregatingState", "MapState", "KeyedStateBackend",
           "register_backend", "create_backend",
           "backend_supports_general_state", "VOID_NAMESPACE"]

VOID_NAMESPACE = None


class State:
    def clear(self) -> None:
        raise NotImplementedError


class ValueState(State):
    def value(self) -> Any:
        raise NotImplementedError

    def update(self, value: Any) -> None:
        raise NotImplementedError


class ListState(State):
    def get(self) -> Iterable[Any]:
        raise NotImplementedError

    def add(self, value: Any) -> None:
        raise NotImplementedError

    def update(self, values: list) -> None:
        raise NotImplementedError


class ReducingState(State):
    def get(self) -> Any:
        raise NotImplementedError

    def add(self, value: Any) -> None:
        raise NotImplementedError


class AggregatingState(State):
    def get(self) -> Any:
        raise NotImplementedError

    def add(self, value: Any) -> None:
        raise NotImplementedError


class MapState(State):
    def get(self, key: Any) -> Any:
        raise NotImplementedError

    def put(self, key: Any, value: Any) -> None:
        raise NotImplementedError

    def remove(self, key: Any) -> None:
        raise NotImplementedError

    def contains(self, key: Any) -> bool:
        raise NotImplementedError

    def items(self) -> Iterable[tuple]:
        raise NotImplementedError


class KeyedStateBackend:
    """Owns keyed state for one key-group range. Subtask-confined: no
    locking, as every call comes from the task's thread."""

    def __init__(self, key_group_range: KeyGroupRange, max_parallelism: int):
        self.key_group_range = key_group_range
        self.max_parallelism = max_parallelism
        self._current_key: Any = None
        self._current_key_group: int = -1
        self._current_namespace: Any = VOID_NAMESPACE

    def set_current_key(self, key: Any,
                        key_group: Optional[int] = None) -> None:
        self._current_key = key
        self._current_key_group = (
            assign_to_key_group(key, self.max_parallelism)
            if key_group is None else key_group)

    def set_current_namespace(self, namespace: Any) -> None:
        self._current_namespace = namespace

    @property
    def current_key(self) -> Any:
        return self._current_key

    #: the job's queryable-state registry, set by the operator context
    kv_registry: Any = None

    def get_partitioned_state(self, descriptor: StateDescriptor) -> State:
        raise NotImplementedError

    def read_raw(self, state_name: str, key: Any,
                 namespace: Any = VOID_NAMESPACE) -> Any:
        """A point read for queryable state; None when absent."""
        raise NotImplementedError

    def snapshot(self, checkpoint_id: int) -> dict:
        """Serializable snapshot keyed by key group, so a restore can
        re-shard."""
        raise NotImplementedError

    def restore(self, snapshots: Iterable[dict]) -> None:
        """Restore from snapshots, keeping only this range's key groups."""
        raise NotImplementedError


# -- the registry ------------------------------------------------------------------

StateBackendFactory = Callable[..., Any]
_BACKENDS: dict[str, StateBackendFactory] = {}
# built-in backends whose modules register themselves at first use
_LAZY_BACKENDS = {"tpu": "flink_tpu_torch.state.device_backend",
                  "hashmap": "flink_tpu_torch.state.heap",
                  "changelog": "flink_tpu_torch.state.changelog"}


def register_backend(name: str, factory: StateBackendFactory) -> None:
    _BACKENDS[name] = factory


def _load(name: str) -> None:
    if name not in _BACKENDS and name in _LAZY_BACKENDS:
        importlib.import_module(_LAZY_BACKENDS[name])  # registers itself


def backend_supports_general_state(name: str) -> bool:
    """Whether the named backend holds namespaced list, aggregating and
    map state. A partial backend (the device row plane) declares
    ``SUPPORTS_GENERAL_STATE = False``; unknown names are assumed
    capable."""
    _load(name)
    cls = _BACKENDS.get(name)
    return getattr(cls, "SUPPORTS_GENERAL_STATE", True) if cls else True


def create_backend(name: str, key_group_range: KeyGroupRange,
                   max_parallelism: int, **kwargs):
    _load(name)
    if name not in _BACKENDS:
        if ":" in name:  # a "module:attr" factory, plugin-style
            mod, attr = name.split(":", 1)
            factory = getattr(importlib.import_module(mod), attr)
            return factory(key_group_range, max_parallelism, **kwargs)
        raise ValueError(
            f"Unknown state backend {name!r}; known: {sorted(_BACKENDS)}")
    return _BACKENDS[name](key_group_range, max_parallelism, **kwargs)
