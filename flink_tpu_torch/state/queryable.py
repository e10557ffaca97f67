"""Queryable state: point reads of live keyed state from outside the
job (port of ``flink_tpu/state/queryable.py``).

A state whose descriptor is ``queryable("name")`` registers its backend
in the job's ``KvStateRegistry`` (``LocalJob.kv_registry``) when the
operator first makes its handle; a client resolves (name, key) to the
key group and the backend that owns it, and reads the current value
without touching the data path. ``QueryableStateClient(job)`` reads in
the same process; ``state/queryable_net.py`` serves the same registry
over TCP. Reads are dirty: they see the live state, not a checkpoint's.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from ..core.keygroups import assign_to_key_group
from .backend import VOID_NAMESPACE, KeyedStateBackend

__all__ = ["KvStateRegistry", "QueryableStateClient", "UnknownKvStateError"]


class UnknownKvStateError(KeyError):
    pass


class KvStateRegistry:
    """The queryable states of a job: name -> (backend, state name) of
    each subtask that registered it."""

    def __init__(self):
        # queryable name -> list of (backend, internal state name)
        self._entries: dict[str, list[tuple[KeyedStateBackend, str]]] = {}
        self._lock = threading.Lock()

    def register(self, queryable_name: str, state_name: str,
                 backend: KeyedStateBackend) -> None:
        with self._lock:
            entries = self._entries.setdefault(queryable_name, [])
            for b, s in entries:
                if s != state_name:
                    raise ValueError(
                        f"queryable name {queryable_name!r} already bound "
                        f"to state {s!r}; cannot also bind {state_name!r}")
                if b is backend:
                    return
            entries.append((backend, state_name))

    def unregister_backend(self, backend: KeyedStateBackend) -> None:
        with self._lock:
            for name in list(self._entries):
                self._entries[name] = [
                    (b, s) for b, s in self._entries[name] if b is not backend]
                if not self._entries[name]:
                    del self._entries[name]

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._entries)

    def lookup(self, queryable_name: str,
               key_group: int) -> tuple[KeyedStateBackend, str]:
        with self._lock:
            entries = list(self._entries.get(queryable_name) or ())
        if not entries:
            raise UnknownKvStateError(
                f"no queryable state {queryable_name!r}; registered: "
                f"{self.names()}")
        for backend, state_name in entries:
            if key_group in backend.key_group_range:
                return backend, state_name
        raise UnknownKvStateError(
            f"key group {key_group} of {queryable_name!r} not on this job")

    def lookup_by_key(self, queryable_name: str,
                      key: Any) -> tuple[KeyedStateBackend, str]:
        """The backend that owns ``key`` (what clients call)."""
        with self._lock:
            entries = list(self._entries.get(queryable_name) or ())
        if not entries:
            raise UnknownKvStateError(
                f"no queryable state {queryable_name!r}; registered: "
                f"{self.names()}")
        kg = assign_to_key_group(key, entries[0][0].max_parallelism)
        for backend, state_name in entries:
            if kg in backend.key_group_range:
                return backend, state_name
        raise UnknownKvStateError(
            f"key group {kg} of {queryable_name!r} not on this job")


class QueryableStateClient:
    """Point reads of a local job's queryable states."""

    def __init__(self, job):
        registry = getattr(job, "kv_registry", None)
        if registry is None:
            raise ValueError("job has no KvStateRegistry (not a local job?)")
        self._registry = registry

    def get_kv_state(self, queryable_name: str, key: Any,
                     namespace: Any = VOID_NAMESPACE,
                     default: Any = None) -> Any:
        try:
            backend, state_name = self._registry.lookup_by_key(
                queryable_name, key)
        except UnknownKvStateError:
            if queryable_name in self._registry.names():
                # a subtask registers at its first access: one that has
                # not yet holds no state for the key
                return default
            raise
        value = backend.read_raw(state_name, key, namespace)
        return default if value is None else value
