"""Port parity: the heap keyed-state backend (``state/heap.py``,
``hashmap``) and the backend registry (``state/backend.py``) of
flink_tpu_torch against flink_tpu's.

* The same seeded script of value, list, reducing, aggregating and map
  state calls, under keys and namespaces (windows among them), gives the
  same reads in both packages and snapshots equal field by field
  (``kind``, the per-key-group items, the serializer records).
* A snapshot of either package restores into the other and reads as
  it does at home, whole and split by key-group range (a rescale).
* The registry answers as the reference's: ``create_backend`` makes the
  heap backend for ``hashmap`` and the device backend for ``tpu``;
  ``backend_supports_general_state`` is False for ``tpu`` only; unknown
  names raise.
* The device backend refuses list, map, reducing and aggregating
  descriptors with the reference's error.

Tolerance: exact.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import flink_tpu.state.backend as ref_backend  # noqa: E402
import flink_tpu.state.descriptors as ref_desc  # noqa: E402
import flink_tpu.state.heap  # noqa: E402,F401 - registers hashmap
import flink_tpu.window as ref_window  # noqa: E402
from flink_tpu.core.functions import AggregateFunction as RefAgg  # noqa: E402
from flink_tpu.core.functions import ReduceFunction as RefReduce  # noqa: E402
from flink_tpu.core.keygroups import KeyGroupRange as RefRange  # noqa: E402
import flink_tpu_torch.state.backend as port_backend  # noqa: E402
import flink_tpu_torch.state.descriptors as port_desc  # noqa: E402
import flink_tpu_torch.window as port_window  # noqa: E402
from flink_tpu_torch.core.functions import AggregateFunction, \
    ReduceFunction  # noqa: E402
from flink_tpu_torch.core.keygroups import KeyGroupRange  # noqa: E402

MAXP = 128


def _fns(agg_base, reduce_base):
    class Avg(agg_base):
        def create_accumulator(self):
            return (0, 0)

        def add(self, v, acc):
            return (acc[0] + v, acc[1] + 1)

        def merge(self, a, b):
            return (a[0] + b[0], a[1] + b[1])

        def get_result(self, acc):
            return acc[0] / acc[1]

    class Max(reduce_base):
        def reduce(self, a, b):
            return max(a, b)
    return Avg(), Max()


SIDES = {
    "ref": (ref_backend, ref_desc, ref_window, RefRange, _fns(RefAgg,
                                                                 RefReduce)),
    "port": (port_backend, port_desc, port_window, KeyGroupRange,
             _fns(AggregateFunction, ReduceFunction)),
}


def _descs(d, fns):
    avg, mx = fns
    return {"value": d.ValueStateDescriptor("v", default=-1),
            "list": d.ListStateDescriptor("l"),
            "reducing": d.ReducingStateDescriptor("r", mx),
            "aggregating": d.AggregatingStateDescriptor("a", avg),
            "map": d.MapStateDescriptor("m")}


def _script(seed: int, n: int = 600) -> list:
    rng = np.random.default_rng(seed)
    keys = [int(k) for k in rng.integers(0, 50, n)]
    strs = [f"k{int(k)}" for k in rng.integers(0, 20, n)]
    return [(keys[i] if i % 3 else strs[i], int(rng.integers(0, 4)),
             int(rng.integers(0, 9)), int(rng.integers(-100, 100)))
            for i in range(n)]


def _namespace(w, i: int):
    return (None, w.TimeWindow(0, 10), w.TimeWindow(10, 20),
            w.GlobalWindow())[i]


def _drive(side: str, script: list, backend=None):
    """Run ``script`` on a heap backend of ``side``: every state kind a
    call, reads recorded."""
    mod, d, w, rng_cls, fns = SIDES[side]
    b = backend or mod.create_backend("hashmap", rng_cls(0, MAXP - 1), MAXP)
    descs = _descs(d, fns)
    reads = []
    for key, ns, op, v in script:
        b.set_current_key(key)
        b.set_current_namespace(_namespace(w, ns))
        kind = ("value", "list", "reducing", "aggregating", "map")[op % 5]
        h = b.get_partitioned_state(descs[kind])
        if op >= 7:
            h.clear()
        elif kind == "value":
            reads.append(h.value())
            h.update(v)
        elif kind == "list":
            h.add(v) if op < 5 else h.update([v, v + 1])
            reads.append(list(h.get()))
        elif kind == "map":
            h.put(v % 5, v)
            if v % 3 == 0:
                h.remove((v + 1) % 5)
            reads.append((h.get(v % 5), h.contains(1), sorted(h.items())))
        else:
            h.add(v)
            reads.append(h.get())
    return b, reads


def _read_all(side: str, b, script: list) -> list:
    """Every (key, namespace, kind) of ``script`` read back."""
    mod, d, w, _r, fns = SIDES[side]
    descs = _descs(d, fns)
    out = []
    for key, ns, _op, _v in script:
        b.set_current_key(key)
        b.set_current_namespace(_namespace(w, ns))
        out.append((b.get_partitioned_state(descs["value"]).value(),
                    list(b.get_partitioned_state(descs["list"]).get()),
                    b.get_partitioned_state(descs["reducing"]).get(),
                    b.get_partitioned_state(descs["aggregating"]).get(),
                    sorted(b.get_partitioned_state(descs["map"]).items())))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_every_state_kind_under_namespaces_equals_reference(seed):
    script = _script(seed)
    (rb, r_reads), (pb, p_reads) = (_drive(s, script) for s in SIDES)
    assert p_reads == r_reads
    rs, ps = rb.snapshot(1), pb.snapshot(1)
    assert ps == rs
    assert ps["kind"] == "heap"
    assert set(ps["states"]) == {"v", "l", "r", "a", "m"}
    assert ps["serializers"] == rs["serializers"]
    for name in ps["states"]:
        assert list(ps["states"][name]) == list(rs["states"][name])


@pytest.mark.parametrize("direction", [("ref", "port"), ("port", "ref")])
def test_snapshots_restore_across_the_packages(direction):
    src, dst = direction
    script = _script(7)
    b, _ = _drive(src, script)
    snap = b.snapshot(3)
    mod, _d, _w, rng_cls, _f = SIDES[dst]
    whole = mod.create_backend("hashmap", rng_cls(0, MAXP - 1), MAXP)
    whole.restore([snap])
    assert whole.snapshot(4) == snap
    home = SIDES[src][0].create_backend("hashmap",
                                        SIDES[src][3](0, MAXP - 1), MAXP)
    home.restore([snap])
    # (a map read creates the empty map it reads, in both packages)
    assert _read_all(dst, whole, script) == _read_all(src, home, script)
    # split by key-group range (a rescale to 2): each half keeps its groups
    halves = [mod.create_backend("hashmap", rng_cls(lo, hi), MAXP)
              for lo, hi in ((0, MAXP // 2 - 1), (MAXP // 2, MAXP - 1))]
    for h in halves:
        h.restore([snap])
    merged = {}
    for h in halves:
        for name, per_kg in h.snapshot(5)["states"].items():
            merged.setdefault(name, {}).update(per_kg)
    assert merged == {n: dict(v) for n, v in snap["states"].items()}


def test_registry_answers_as_the_reference():
    for side, (mod, _d, _w, rng_cls, _f) in SIDES.items():
        assert mod.backend_supports_general_state("hashmap")
        assert not mod.backend_supports_general_state("tpu")
        assert mod.backend_supports_general_state("plugin:unknown")
        b = mod.create_backend("hashmap", rng_cls(0, MAXP - 1), MAXP)
        assert type(b).__name__ == "HeapKeyedStateBackend"
        with pytest.raises(ValueError, match="Unknown state backend"):
            mod.create_backend("nope", rng_cls(0, MAXP - 1), MAXP)
    dev = port_backend.create_backend("tpu", KeyGroupRange(0, MAXP - 1), MAXP,
                                      device="cpu")
    assert type(dev).__name__ == "DeviceKeyedStateBackend"
    assert dev.device.type == "cpu"


def test_device_backend_refuses_general_state_as_the_reference():
    ref = ref_backend.create_backend("tpu", RefRange(0, MAXP - 1), MAXP)
    port = port_backend.create_backend("tpu", KeyGroupRange(0, MAXP - 1),
                                       MAXP, device="cpu")
    for kind in ("list", "reducing", "aggregating", "map"):
        errors = []
        for side, b in (("ref", ref), ("port", port)):
            d = _descs(SIDES[side][1], SIDES[side][4])[kind]
            with pytest.raises(NotImplementedError) as e:
                b.get_partitioned_state(d)
            errors.append(str(e.value))
        assert errors[0] == errors[1]
    # value state works on both and reads the same
    for side, b in (("ref", ref), ("port", port)):
        d = SIDES[side][1].ValueStateDescriptor("x", default=0.0)
        h = b.get_partitioned_state(d)
        b.set_current_key(5)
        h.update(2.5)
        assert h.value() == 2.5
