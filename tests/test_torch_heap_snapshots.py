"""The heap backend's snapshot holds the state as it was (a kept
difference from the reference, ROADMAP Queue 3).

List and map state change their value in place (``ListState.add``
appends, ``MapState.put`` sets), and an in-memory checkpoint keeps the
snapshot by reference. The reference's snapshot shares those values, so
what is added after the barrier leaks into the checkpoint, and a restore
then holds it twice: once from the checkpoint and once from the replayed
input (chip_smoke.py's broadcast part (c) emitted alerts twice across a
restore). The port's snapshot and restore copy each list, map and set
value.
"""

import pytest

jax = pytest.importorskip("jax")

from flink_tpu.core.keygroups import KeyGroupRange as RefRange  # noqa: E402
from flink_tpu.state import descriptors as ref_desc  # noqa: E402
from flink_tpu.state.heap import HeapKeyedStateBackend as RefHeap  # noqa: E402
from flink_tpu_torch.core.keygroups import KeyGroupRange  # noqa: E402
from flink_tpu_torch.state import descriptors as port_desc  # noqa: E402
from flink_tpu_torch.state.heap import HeapKeyedStateBackend  # noqa: E402

SIDES = {"ref": (RefHeap, RefRange, ref_desc),
         "port": (HeapKeyedStateBackend, KeyGroupRange, port_desc)}


def _backend(side: str):
    heap, rng, _desc = SIDES[side]
    return heap(rng(0, 127), 128)


@pytest.mark.parametrize("side", list(SIDES))
def test_snapshot_keeps_list_and_map_state_as_they_were(side):
    desc = SIDES[side][2]
    pend = desc.ListStateDescriptor("pending")
    rules = desc.MapStateDescriptor("rules")
    b = _backend(side)
    b.set_current_key(7)
    b.get_partitioned_state(pend).add(1)
    b.get_partitioned_state(rules).put("hot", 10)
    snap = b.snapshot(1)
    # after the barrier: the live values change in place
    b.get_partitioned_state(pend).add(2)
    b.get_partitioned_state(rules).put("cold", 90)
    restored = _backend(side)
    restored.restore([snap])
    restored.set_current_key(7)
    got = (list(restored.get_partitioned_state(pend).get()),
           dict(restored.get_partitioned_state(rules).items()))
    if side == "ref":
        # the reference's fault: the later writes are in the checkpoint
        assert got == ([1, 2], {"hot": 10, "cold": 90})
    else:
        assert got == ([1], {"hot": 10})
        # and a restored backend's writes do not reach the checkpoint
        restored.get_partitioned_state(pend).add(3)
        again = _backend(side)
        again.restore([snap])
        again.set_current_key(7)
        assert list(again.get_partitioned_state(pend).get()) == [1]
