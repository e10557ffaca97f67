"""Host in-memory keyed state backend, ``hashmap`` (port of
``flink_tpu/state/heap.py``).

Layout is ``states[name][key_group][(key, namespace)] -> entry``, so a
snapshot is partitioned by key group and a restore keeps the groups of
its own range. The backend holds every state kind (value, list,
reducing, aggregating, map) under any namespace; the host window
operator keeps its window contents, trigger state and merging-window
set here whenever the configured backend is the partial device one.

Snapshots are the reference's schema field for field: ``{"kind":
"heap", "states": {name: {kg: [((key, ns), value, expiry)]}},
"serializers": {name: [serializer, version]}}``. A state's serializer
is its descriptor's, else the registry's default (``core/serializers.py``);
a restore resolves each recorded (name, version) against the current
serializer and runs the registry's value migrations from an older
version, and refuses another serializer, a newer version or a version
with no migration path. A snapshot and a restore copy each list, map
and set value: list and map state change theirs in place, and an
in-memory checkpoint keeps the snapshot by reference (the reference
shares them, ROADMAP Queue 3).

A state whose descriptor is ``queryable(name)`` registers in the job's
``KvStateRegistry`` (``kv_registry``) when its handle is first made, and
``read_raw`` serves its point reads.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Iterable, Optional

from ..core.keygroups import KeyGroupRange, assign_to_key_group
from ..core.serializers import registry
from .backend import AggregatingState, KeyedStateBackend, ListState, \
    MapState, ReducingState, State, ValueState, register_backend
from .descriptors import AggregatingStateDescriptor, \
    ReducingStateDescriptor, StateDescriptor

__all__ = ["HeapKeyedStateBackend"]

def _detached(value: Any) -> Any:
    """A list, map or set value copied: list and map state change their
    value in place, so a snapshot (which an in-memory checkpoint keeps
    by reference) and a restore each take their own."""
    return copy.copy(value) if isinstance(value, (list, dict, set)) \
        else value


class _Entry:
    __slots__ = ("value", "expiry")

    def __init__(self, value: Any, expiry: Optional[float] = None):
        self.value = value
        self.expiry = expiry


class HeapKeyedStateBackend(KeyedStateBackend):
    def __init__(self, key_group_range: KeyGroupRange, max_parallelism: int,
                 **_kwargs):
        super().__init__(key_group_range, max_parallelism)
        # name -> kg -> {(key, ns): _Entry}
        self._states: dict[str, dict[int, dict]] = {}
        self._descriptors: dict[str, StateDescriptor] = {}
        self._handles: dict[str, State] = {}
        # state name -> its descriptor's serializer (absent: the default)
        self._serializers: dict[str, Any] = {}

    # -- internals ---------------------------------------------------------
    def _table(self, name: str) -> dict[int, dict]:
        return self._states.setdefault(name, {})

    def _kg_map(self, name: str) -> dict:
        kg = self._current_key_group
        if kg not in self.key_group_range:
            raise KeyError(
                f"Key group {kg} outside backend range {self.key_group_range}")
        return self._table(name).setdefault(kg, {})

    def _get(self, desc: StateDescriptor) -> Any:
        m = self._kg_map(desc.name)
        e = m.get((self._current_key, self._current_namespace))
        if e is None:
            return None
        if e.expiry is not None and e.expiry <= time.time():
            del m[(self._current_key, self._current_namespace)]
            return None
        return e.value

    def _put(self, desc: StateDescriptor, value: Any) -> None:
        expiry = time.time() + desc.ttl.ttl if desc.ttl else None
        self._kg_map(desc.name)[(self._current_key,
                                 self._current_namespace)] = \
            _Entry(value, expiry)

    def _remove(self, desc: StateDescriptor) -> None:
        self._kg_map(desc.name).pop(
            (self._current_key, self._current_namespace), None)

    # -- state handles -----------------------------------------------------
    def get_partitioned_state(self, descriptor: StateDescriptor) -> State:
        handle = self._handles.get(descriptor.name)
        if handle is None:
            prev = self._descriptors.get(descriptor.name)
            if prev is not None and prev.kind != descriptor.kind:
                raise ValueError(f"State {descriptor.name!r} already "
                                 f"registered as {prev.kind}")
            self._descriptors[descriptor.name] = descriptor
            if descriptor.serializer is not None:
                self._serializers[descriptor.name] = descriptor.serializer
            handle = _HANDLE_TYPES[descriptor.kind](self, descriptor)
            self._handles[descriptor.name] = handle
            if descriptor.queryable_name and self.kv_registry is not None:
                self.kv_registry.register(descriptor.queryable_name,
                                          descriptor.name, self)
        return handle

    def read_raw(self, state_name: str, key: Any,
                 namespace: Any = None) -> Any:
        """A point read of ``key``'s value (queryable state); None when
        absent or expired. Reads are dirty: the live state, not a
        checkpoint's."""
        kg = assign_to_key_group(key, self.max_parallelism)
        e = self._table(state_name).get(kg, {}).get((key, namespace))
        if e is None or (e.expiry is not None and e.expiry <= time.time()):
            return None
        return e.value

    def entries(self, state_name: str):
        """((key, namespace), value) of a state across the range."""
        for kg_map in self._table(state_name).values():
            for kn, e in kg_map.items():
                yield kn, e.value

    def keys(self, state_name: str, namespace: Any = None) -> Iterable[Any]:
        """The keys holding state ``state_name`` under ``namespace``
        (the broadcast side's ``apply_to_keyed_state``)."""
        for kg_map in self._table(state_name).values():
            for (key, ns) in list(kg_map):
                if ns == namespace:
                    yield key

    # -- checkpointing -----------------------------------------------------
    def snapshot(self, checkpoint_id: int) -> dict:
        now = time.time()
        out: dict[str, dict[int, list]] = {}
        for name, table in self._states.items():
            per_kg: dict[int, list] = {}
            for kg, kg_map in table.items():
                items = [(kn, _detached(e.value), e.expiry)
                         for kn, e in kg_map.items()
                         if e.expiry is None or e.expiry > now]
                if items:
                    per_kg[kg] = items
            out[name] = per_kg
        sers = {}
        for name in out:
            ser = self._serializers.get(name) or registry.default()
            sers[name] = [ser.name, ser.version]
        return {"kind": "heap", "states": out, "serializers": sers}

    def _value_migration(self, state_name: str, snap_sers: dict):
        """The migration of one state's values from the snapshot's
        serializer version to the current one: None when they match.
        Restore runs before the operator registers its descriptors, so a
        state without one resolves the recorded name in the registry."""
        rec = (snap_sers or {}).get(state_name)
        if rec is None:
            return None  # a snapshot from before serializers were recorded
        sname, sver = rec[0], int(rec[1])
        cur = self._serializers.get(state_name)
        if cur is None:
            try:
                cur = registry.get(sname)
            except KeyError:
                raise RuntimeError(
                    f"state {state_name!r}: snapshot was written by "
                    f"serializer {sname!r} v{sver}, which is not registered "
                    "in this process (core.serializers.registry.register)"
                ) from None
        if sname != cur.name:
            raise RuntimeError(
                f"state {state_name!r}: snapshot was written by serializer "
                f"{sname!r} v{sver} but the current serializer is "
                f"{cur.name!r} v{cur.version}; serializer replacement "
                "needs an offline rewrite (state-processor API)")
        if sver == cur.version:
            return None
        if sver > cur.version:
            raise RuntimeError(
                f"state {state_name!r}: snapshot serializer {sname!r} "
                f"v{sver} is NEWER than the running v{cur.version}; "
                "downgrade is not supported")
        if not registry.has_migration_path(sname, sver, cur.version):
            raise RuntimeError(
                f"state {state_name!r}: serializer {sname!r} snapshot "
                f"v{sver} is incompatible with current v{cur.version} and "
                f"no migration chain v{sver}->v{cur.version} is "
                "registered (registry.register_migration)")
        return (lambda v, _n=sname, _f=sver, _t=cur.version:
                registry.migrate_value(_n, _f, _t, v))

    def restore(self, snapshots: Iterable[dict]) -> None:
        self._states.clear()
        self._handles.clear()
        for snap in snapshots:
            snap_sers = snap.get("serializers")
            for name, per_kg in snap.get("states", {}).items():
                migrate = self._value_migration(name, snap_sers)
                table = self._table(name)
                for kg, items in per_kg.items():
                    kg = int(kg)
                    if kg not in self.key_group_range:
                        continue  # rescaling: not ours
                    m = table.setdefault(kg, {})
                    for kn, value, expiry in items:
                        value = _detached(value)
                        if migrate is not None:
                            value = migrate(value)
                        m[tuple(kn) if isinstance(kn, list) else kn] = \
                            _Entry(value, expiry)


class _HeapValueState(ValueState):
    def __init__(self, backend: HeapKeyedStateBackend, desc: StateDescriptor):
        self._b, self._d = backend, desc

    def value(self) -> Any:
        v = self._b._get(self._d)
        return self._d.default if v is None else v

    def update(self, value: Any) -> None:
        self._b._put(self._d, value)

    def clear(self) -> None:
        self._b._remove(self._d)


class _HeapListState(ListState):
    def __init__(self, backend: HeapKeyedStateBackend, desc: StateDescriptor):
        self._b, self._d = backend, desc

    def get(self) -> list:
        return self._b._get(self._d) or []

    def add(self, value: Any) -> None:
        cur = self._b._get(self._d)
        if cur is None:
            self._b._put(self._d, [value])
        else:
            cur.append(value)
            self._b._put(self._d, cur)

    def update(self, values: list) -> None:
        self._b._put(self._d, list(values))

    def clear(self) -> None:
        self._b._remove(self._d)


class _HeapReducingState(ReducingState):
    def __init__(self, backend: HeapKeyedStateBackend,
                 desc: ReducingStateDescriptor):
        self._b, self._d = backend, desc
        self._fn = desc.reduce_function

    def get(self) -> Any:
        return self._b._get(self._d)

    def add(self, value: Any) -> None:
        cur = self._b._get(self._d)
        self._b._put(self._d,
                     value if cur is None else self._fn.reduce(cur, value))

    def clear(self) -> None:
        self._b._remove(self._d)


class _HeapAggregatingState(AggregatingState):
    def __init__(self, backend: HeapKeyedStateBackend,
                 desc: AggregatingStateDescriptor):
        self._b, self._d = backend, desc
        self._fn = desc.aggregate_function

    def get(self) -> Any:
        acc = self._b._get(self._d)
        return None if acc is None else self._fn.get_result(acc)

    def get_accumulator(self) -> Any:
        return self._b._get(self._d)

    def add(self, value: Any) -> None:
        acc = self._b._get(self._d)
        if acc is None:
            acc = self._fn.create_accumulator()
        self._b._put(self._d, self._fn.add(value, acc))

    def merge_accumulator(self, other: Any) -> None:
        acc = self._b._get(self._d)
        self._b._put(self._d,
                     other if acc is None else self._fn.merge(acc, other))

    def clear(self) -> None:
        self._b._remove(self._d)


class _HeapMapState(MapState):
    def __init__(self, backend: HeapKeyedStateBackend, desc: StateDescriptor):
        self._b, self._d = backend, desc

    def _map(self) -> dict:
        m = self._b._get(self._d)
        if m is None:
            m = {}
            self._b._put(self._d, m)
        return m

    def get(self, key: Any) -> Any:
        return self._map().get(key)

    def put(self, key: Any, value: Any) -> None:
        m = self._map()
        m[key] = value
        self._b._put(self._d, m)

    def remove(self, key: Any) -> None:
        m = self._map()
        m.pop(key, None)
        self._b._put(self._d, m)

    def contains(self, key: Any) -> bool:
        return key in self._map()

    def items(self):
        return self._map().items()

    def clear(self) -> None:
        self._b._remove(self._d)


_HANDLE_TYPES = {
    "value": _HeapValueState,
    "list": _HeapListState,
    "reducing": _HeapReducingState,
    "aggregating": _HeapAggregatingState,
    "map": _HeapMapState,
}

register_backend("hashmap", HeapKeyedStateBackend)
