"""Port parity of queryable state (``state/queryable.py``,
``state/queryable_net.py``, ``StateDescriptor.queryable``, the heap
backend's registration and ``read_raw``) against the reference, on
tests/test_queryable_state_processor.py's queryable cases (:28, :62,
:269): the registry and point reads, a live job read in process, and the
TCP server with its remote client. The savepoint reader and writer
cases wait for ``state_processor/`` (item 10, group 10).

Servers bind loopback port 0, so the file is xdist-safe.
"""

import threading
import time
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import flink_tpu.core.functions as ref_fn  # noqa: E402
import flink_tpu.core.keygroups as ref_kg  # noqa: E402
import flink_tpu.core.records as ref_rec  # noqa: E402
import flink_tpu.state.descriptors as ref_desc  # noqa: E402
import flink_tpu.state.heap as ref_heap  # noqa: E402
import flink_tpu.state.queryable as ref_q  # noqa: E402
import flink_tpu.state.queryable_net as ref_qn  # noqa: E402
from flink_tpu.api.environment import \
    StreamExecutionEnvironment as RefEnv  # noqa: E402
from flink_tpu.connectors.core import CollectSink as RefCollect  # noqa: E402
import flink_tpu_torch.core.functions as port_fn  # noqa: E402
import flink_tpu_torch.core.keygroups as port_kg  # noqa: E402
import flink_tpu_torch.core.records as port_rec  # noqa: E402
import flink_tpu_torch.state.descriptors as port_desc  # noqa: E402
import flink_tpu_torch.state.heap as port_heap  # noqa: E402
import flink_tpu_torch.state.queryable as port_q  # noqa: E402
import flink_tpu_torch.state.queryable_net as port_qn  # noqa: E402
from flink_tpu_torch.api.environment import \
    StreamExecutionEnvironment as PortEnv  # noqa: E402
from flink_tpu_torch.runtime.operators.sink import \
    CollectSink as PortCollect  # noqa: E402

SIDES = {
    "ref": types.SimpleNamespace(fn=ref_fn, kg=ref_kg, rec=ref_rec,
                                 desc=ref_desc, heap=ref_heap, q=ref_q,
                                 qn=ref_qn, env=lambda: RefEnv(),
                                 sink=RefCollect),
    "port": types.SimpleNamespace(fn=port_fn, kg=port_kg, rec=port_rec,
                                  desc=port_desc, heap=port_heap, q=port_q,
                                  qn=port_qn,
                                  env=lambda: PortEnv(device="cpu"),
                                  sink=PortCollect),
}


def both(fn, *a, **kw):
    got = {name: fn(side, *a, **kw) for name, side in SIDES.items()}
    assert got["ref"] == got["port"], got
    return got["port"]


def test_registry_and_read_raw():
    rng = np.random.default_rng(7)
    keys = [int(k) for k in rng.integers(0, 1 << 40, 64)]

    def run(side):
        reg = side.q.KvStateRegistry()
        lo = side.heap.HeapKeyedStateBackend(side.kg.KeyGroupRange(0, 63),
                                             128)
        hi = side.heap.HeapKeyedStateBackend(
            side.kg.KeyGroupRange(64, 127), 128)
        desc = side.desc.ValueStateDescriptor("cnt").queryable("counts")
        for b in (lo, hi):
            b.kv_registry = reg
            b.get_partitioned_state(desc)          # registers
        for i, key in enumerate(keys):
            kg = side.kg.assign_to_key_group(key, 128)
            owner = lo if kg <= 63 else hi
            owner.set_current_key(key)
            owner.get_partitioned_state(desc).update(i)
        reads = []
        for key in keys:
            kg = side.kg.assign_to_key_group(key, 128)
            backend, state = reg.lookup("counts", kg)
            reads.append((backend is (lo if kg <= 63 else hi),
                          backend.read_raw(state, key)))
        with pytest.raises(side.q.UnknownKvStateError):
            reg.lookup("nope", 0)
        with pytest.raises(ValueError, match="already bound"):
            reg.register("counts", "other", lo)
        reg.unregister_backend(lo)
        return reg.names(), reads, lo.read_raw("cnt", -1)

    names, reads, missing = both(run)
    assert names == ["counts"] and missing is None
    assert reads == [(True, i) for i in range(len(keys))]


def test_queryable_descriptor_is_a_copy():
    def run(side):
        red = side.desc.ReducingStateDescriptor(
            "r", side.fn.ReduceFunction.of(lambda a, b: a + b)
            if hasattr(side.fn.ReduceFunction, "of") else _Sum(side))
        q = red.queryable("sums")
        v = side.desc.ValueStateDescriptor("v", default=3)
        return (red.queryable_name, q.queryable_name, q.kind, q.name,
                v.queryable("x").default, v.queryable_name)

    assert both(run) == (None, "sums", "reducing", "r", 3, None)


def _Sum(side):
    class S(side.fn.ReduceFunction):
        def reduce(self, a, b):
            return a + b
    return S()


def count_job(side, rows, parallelism=2, delay=0.0, backend="hashmap"):
    class CountKeyed(side.fn.ProcessFunction):
        def open(self, ctx):
            self.ctx = ctx

        def process_element(self, value, ctx, out):
            if delay:
                time.sleep(delay)
            desc = side.desc.ValueStateDescriptor(
                "cnt", default=0).queryable("q-counts")
            st = self.ctx.get_state(desc)
            st.update(st.value() + 1)
            out.collect(value)

    env = side.env()
    env.set_parallelism(parallelism)
    # the reference's default; the port's is the device backend, whose
    # row plane serves no queryable state (nor does the reference's)
    env.set_state_backend(backend)
    sch = side.rec.Schema([("k", np.int64), ("v", np.int64)])
    ds = env.from_collection(rows, sch, timestamps=list(range(len(rows))))
    ds.key_by("k").process(CountKeyed()).add_sink(side.sink(), "sink")
    return env


@pytest.mark.parametrize("backend", ["hashmap", "changelog"])
def test_queryable_state_of_a_finished_job(backend):
    rows = [(i % 4, i) for i in range(40)]

    def run(side):
        job = count_job(side, rows, backend=backend).execute("qstate")
        client = side.q.QueryableStateClient(job)
        got = [client.get_kv_state("q-counts", k) for k in range(4)]
        with pytest.raises(side.q.UnknownKvStateError):
            client.get_kv_state("nope", 1)
        return got, client.get_kv_state("q-counts", 99, default=-1)

    assert both(run) == ([10] * 4, -1)


def test_kvstate_server_and_remote_client():
    rows = [(i % 4, i) for i in range(40)]

    def run(side):
        job = count_job(side, rows).execute("qstate-net")
        srv = side.qn.KvStateServer.for_job(job)
        try:
            client = side.qn.RemoteQueryableStateClient(srv.address)
            names = client.names()
            got = [client.get_kv_state("q-counts", k) for k in range(4)]
            miss = client.get_kv_state("q-counts", 99, default=-1)
            with pytest.raises(side.q.UnknownKvStateError):
                client.get_kv_state("nope", 1)
            client2 = side.qn.RemoteQueryableStateClient(srv.address)
            again = (client2.get_kv_state("q-counts", 2),
                     client.get_kv_state("q-counts", 3))
            client.close()
            client2.close()
        finally:
            srv.close()
        return names, got, miss, again

    assert both(run) == (["q-counts"], [10] * 4, -1, (10, 10))


def test_reads_of_a_running_job_over_tcp_only_grow():
    """Dirty reads while the job runs: every key's count read over TCP
    never decreases, and ends at the oracle's."""
    rows = [(i % 8, i) for i in range(400)]
    env = count_job(SIDES["port"], rows, parallelism=2, delay=0.001)
    job = env.execute_async("qstate-live")
    srv = port_qn.KvStateServer.for_job(job)
    client = port_qn.RemoteQueryableStateClient(srv.address)
    seen = {k: [] for k in range(8)}
    done = threading.Event()

    def wait():
        job.wait(60)
        done.set()

    threading.Thread(target=wait, daemon=True).start()
    try:
        while not done.is_set():
            for k in range(8):
                seen[k].append(client.get_kv_state("q-counts", k, default=0))
            time.sleep(0.01)
        final = [client.get_kv_state("q-counts", k) for k in range(8)]
    finally:
        client.close()
        srv.close()
    assert final == [50] * 8
    assert all(v == sorted(v) for v in seen.values())


def test_non_loopback_bind_without_a_secret_is_refused(monkeypatch):
    monkeypatch.delenv("FLINK_TPU_CLUSTER_SECRET", raising=False)

    def run(side):
        with pytest.raises(RuntimeError, match="WITHOUT a cluster secret"):
            side.qn.KvStateServer(side.q.KvStateRegistry(), host="0.0.0.0")
        return True

    assert both(run)
