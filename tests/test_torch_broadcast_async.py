"""Port parity of the broadcast state pattern
(``runtime/operators/co_broadcast.py``, ``KeyedBroadcastProcessFunction``,
``DataStream.broadcast(descriptor)`` and ``KeyedStream.connect``) and of
async I/O (``runtime/operators/async_io.py``, ``DataStream.async_io``)
against the reference, on the cases of tests/test_broadcast_state.py and
tests/test_async_io.py:

* dynamic rules end to end at parallelism 1 and 2; a checkpoint through
  the harness keeping the rules and the keyed counts, restored within
  and across the packages both ways; the rescale hand-out of the
  broadcast maps (the port's ``redistribute_operator_state`` against the
  reference's ``OperatorStateBackend.redistribute``), also through
  ``build_restore_map``; the keyed side's read-only view; a non-keyed
  connect refused;
* async I/O: ordered and unordered, the synchronous answer and None,
  several rows a request, timeout with ``fail`` and ``ignore``, retries
  after a timeout, an exception and a synchronous raise, capacity, the
  snapshot of the requests in flight restored across the packages both
  ways, and a job at parallelism 2.

Each case runs in both packages and the outputs are compared: row for
row where the order is defined, as multisets otherwise. Timeouts leave
seconds of slack where a request must not time out.
"""

import threading
import time
import types
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import flink_tpu.core.functions as ref_fn  # noqa: E402
import flink_tpu.core.records as ref_rec  # noqa: E402
import flink_tpu.runtime.harness as ref_harness  # noqa: E402
import flink_tpu.runtime.operators.async_io as ref_async  # noqa: E402
import flink_tpu.runtime.operators.co_broadcast as ref_cob  # noqa: E402
import flink_tpu.state.descriptors as ref_desc  # noqa: E402
from flink_tpu.api.environment import \
    StreamExecutionEnvironment as RefEnv  # noqa: E402
from flink_tpu.state.backend import OperatorStateBackend  # noqa: E402
import flink_tpu_torch.core.functions as port_fn  # noqa: E402
import flink_tpu_torch.core.records as port_rec  # noqa: E402
import flink_tpu_torch.runtime.harness as port_harness  # noqa: E402
import flink_tpu_torch.runtime.operators.async_io as port_async  # noqa: E402
import flink_tpu_torch.runtime.operators.co_broadcast as port_cob  # noqa: E402
import flink_tpu_torch.state.descriptors as port_desc  # noqa: E402
from flink_tpu_torch.api.environment import \
    StreamExecutionEnvironment as PortEnv  # noqa: E402
from flink_tpu_torch.checkpoint.coordinator import \
    redistribute_operator_state  # noqa: E402

SIDES = {
    "ref": types.SimpleNamespace(
        fn=ref_fn, rec=ref_rec, h=ref_harness, aio=ref_async, cob=ref_cob,
        desc=ref_desc, env=lambda: RefEnv()),
    "port": types.SimpleNamespace(
        fn=port_fn, rec=port_rec, h=port_harness, aio=port_async,
        cob=port_cob, desc=port_desc, env=lambda: PortEnv(device="cpu")),
}
EVENTS = [("k", np.int64), ("v", np.int64)]
RULES = [("name", object), ("threshold", np.int64)]


# -- broadcast state ----------------------------------------------------------

def _alert(side: str):
    """The reference test's rule function: each event against the rules
    in force, buffered in keyed state and replayed against each newly
    arriving rule (apply_to_keyed_state), so every (event, rule) pair is
    evaluated once whatever the interleaving."""
    s = SIDES[side]
    desc = s.desc.MapStateDescriptor("rules")

    class Alert(s.fn.KeyedBroadcastProcessFunction):
        def open(self, ctx):
            self._buf = s.desc.ValueStateDescriptor("buffered", default=())
            self._cnt = s.desc.ValueStateDescriptor("matches", default=0)
            self._ctx = ctx

        def process_element(self, value, ctx, out):
            for name, thr in ctx.get_broadcast_state(desc).items():
                if value[1] > thr:
                    st = self._ctx.get_state(self._cnt)
                    st.update(st.value() + 1)
                    out.collect((value[0], value[1], name), ctx.timestamp)
            buf = self._ctx.get_state(self._buf)
            buf.update(buf.value() + ((int(value[0]), int(value[1])),))

        def process_broadcast_element(self, value, ctx, out):
            name, thr = value[0], int(value[1])
            ctx.get_broadcast_state(desc)[name] = thr

            def replay(key, state):
                for k, v in state.value():
                    if v > thr:
                        out.collect((k, v, name), None)

            ctx.apply_to_keyed_state(self._buf, replay)

    return Alert(), desc


def _rules_job(side: str, parallelism: int):
    s = SIDES[side]
    env = s.env()
    env.set_parallelism(parallelism)
    env.set_state_backend("hashmap")
    env.config.set("pipeline.micro-batch-size", 8)
    fn, desc = _alert(side)
    rules = env.from_collection([("hot", 50), ("warm", 20)],
                                s.rec.Schema(RULES), timestamps=[0, 1])
    rng = np.random.default_rng(4)
    events = [(int(k), int(v)) for k, v in
              zip(rng.integers(0, 10, 200), rng.integers(0, 100, 200))]
    ds = env.from_collection(events, s.rec.Schema(EVENTS),
                             timestamps=list(range(10, 210)))
    out = (ds.key_by("k").connect(rules.broadcast(desc)).process(fn)
           .execute_and_collect())
    expect = sorted((k, v, name) for k, v in events
                    for name, thr in (("hot", 50), ("warm", 20)) if v > thr)
    return sorted((int(r[0]), int(r[1]), r[2]) for r in out), expect


@pytest.mark.parametrize("parallelism", [1, 2])
def test_dynamic_rules_end_to_end_equal_reference(parallelism):
    got = {side: _rules_job(side, parallelism) for side in SIDES}
    assert got["ref"] == got["port"]
    rows, expect = got["port"]
    assert rows == expect and len(rows) > 100
    assert len({k for k, _v, _n in rows}) >= 8


def _hashmap(side: str) -> dict:
    """The harness's configuration: the port's default backend is the
    device one, whose row plane holds numbers only; the reference's
    harness defaults to the heap."""
    if side == "ref":
        return {}
    from flink_tpu_torch.core.config import Configuration
    return {"config": Configuration({"state.backend.type": "hashmap"})}


def _co_harness(side: str, fn=None, desc=None):
    s = SIDES[side]
    if fn is None:
        fn, desc = _alert(side)
    op = s.cob.CoBroadcastWithKeyedOperator(
        fn, lambda b: np.asarray(b.column("k")), [desc])
    h = s.h.TwoInputOperatorTestHarness(op, schema1=s.rec.Schema(EVENTS),
                                        schema2=s.rec.Schema(RULES),
                                        **_hashmap(side))
    return op, h


def _feed(h, rules=(), events=(), t0=100):
    if rules:
        h.process_elements2(list(rules), list(range(len(rules))))
    if events:
        h.process_elements1(list(events), list(range(t0, t0 + len(events))))


@pytest.mark.parametrize("src,dst", [("ref", "ref"), ("port", "port"),
                                     ("ref", "port"), ("port", "ref")])
def test_checkpoint_keeps_rules_and_keyed_counts_across_packages(src, dst):
    op1, h1 = _co_harness(src)
    _feed(h1, rules=[("hot", 10)], events=[(1, 50), (2, 5)])
    snap = op1.snapshot_state(1)
    assert snap["operator"]["broadcast"]["rules"] == {"hot": 10}
    op2, h2 = _co_harness(dst)
    h2.open(keyed_snapshots=[snap["keyed"]],
            operator_snapshot=snap["operator"])
    _feed(h2, events=[(1, 99), (2, 5)], t0=200)
    out = [tuple(r) for r in h2.get_output()]
    assert out == [(1, 99, "hot")]
    # the keyed buffers came across: a new rule replays both keys' events
    h2.clear_output()
    _feed(h2, rules=[("any", 0)])
    assert sorted(tuple(r) for r in h2.get_output()) == [
        (1, 50, "any"), (1, 99, "any"), (2, 5, "any"), (2, 5, "any")]
    assert op2.snapshot_state(2)["operator"]["broadcast"]["rules"] == {
        "hot": 10, "any": 0}


def test_rescale_hands_every_subtask_the_broadcast_replica():
    snaps = []
    for _sub in range(2):
        op, h = _co_harness("port")
        _feed(h, rules=[("hot", 10), ("cold", 90)])
        snaps.append(op.snapshot_state(1)["operator"])
    ref_parts = OperatorStateBackend.redistribute(snaps, 3)
    parts = redistribute_operator_state(snaps, 3)
    assert [p["broadcast"] for p in parts] == \
        [p["broadcast"] for p in ref_parts]
    assert redistribute_operator_state([{"pending": []}], 2) == [None, None]
    op3, h3 = _co_harness("port")
    h3.open(operator_snapshot=parts[2])
    _feed(h3, events=[(7, 95)])
    out = [tuple(r) for r in h3.get_output()]
    assert (7, 95, "hot") in out and (7, 95, "cold") in out


def test_a_rescaled_job_restores_the_broadcast_maps_on_every_subtask():
    """Through the runtime: a checkpoint at parallelism 2, restored at 3
    (``build_restore_map``); each new subtask holds the rules."""
    from flink_tpu_torch.checkpoint.coordinator import build_restore_map
    from flink_tpu_torch.checkpoint.storage import CompletedCheckpoint
    from flink_tpu_torch.graph.stream_graph import build_job_graph, \
        build_stream_graph

    op, h = _co_harness("port")
    _feed(h, rules=[("hot", 10)])
    chain = {"0:CoBroadcastWithKeyed": op.snapshot_state(1)}
    env = PortEnv(device="cpu")
    env.set_parallelism(3)
    fn, desc = _alert("port")
    rules = env.from_collection([("x", 1)], port_rec.Schema(RULES))
    ds = env.from_collection([(1, 1)], port_rec.Schema(EVENTS))
    ds.key_by("k").connect(rules.broadcast(desc)).process(fn).add_sink(
        lambda b: None)
    jg = build_job_graph(build_stream_graph(env._sinks, env.config),
                         env.config)
    vid = next(v for v, vx in jg.vertices.items()
               if "CoBroadcast" in vx.name)
    cp = CompletedCheckpoint(
        checkpoint_id=1, timestamp=0.0,
        task_snapshots={f"{vid}#{i}": {"chain": chain}
                                         for i in range(2)},
        vertex_parallelism={vid: 2})
    restored = build_restore_map(cp, jg)
    maps = [restored[f"{vid}#{i}"]["chain"]["0:CoBroadcastWithKeyed"][
        "operator"]["broadcast"] for i in range(3)]
    assert maps == [{"rules": {"hot": 10}}] * 3


@pytest.mark.parametrize("side", list(SIDES))
def test_keyed_side_cannot_write_broadcast_state(side):
    s = SIDES[side]
    desc = s.desc.MapStateDescriptor("rules")

    class Mutator(s.fn.KeyedBroadcastProcessFunction):
        def process_element(self, value, ctx, out):
            ctx.get_broadcast_state(desc)["x"] = 1

        def process_broadcast_element(self, value, ctx, out):
            pass

    _op, h = _co_harness(side, Mutator(), desc)
    with pytest.raises(TypeError):
        _feed(h, events=[(1, 1)])


def test_broadcast_stream_connects_to_a_keyed_stream_only():
    for side in SIDES:
        s = SIDES[side]
        env = s.env()
        rules = env.from_collection([("a", 1)], s.rec.Schema(RULES))
        ds = env.from_collection([(1, 1)], s.rec.Schema(EVENTS))
        b = rules.broadcast(s.desc.MapStateDescriptor("rules"))
        assert type(b).__name__ == "BroadcastStream"
        with pytest.raises(NotImplementedError, match="KEYED"):
            ds.connect(b)
        assert type(ds.key_by("k").connect(b)).__name__ == \
            "BroadcastConnectedStream"
        assert type(rules.broadcast()).__name__ == "DataStream"


# -- async I/O ----------------------------------------------------------------

IN = [("k", np.int64)]
OUT = [("k", np.int64), ("enriched", object)]


def _doubler(side: str):
    """Resolves out of submission order: even keys slowly."""
    class Doubler(SIDES[side].aio.AsyncFunction):
        def open(self):
            self.pool = ThreadPoolExecutor(4)

        def async_invoke(self, row, ts):
            k = row[0]

            def work():
                if k % 2 == 0:
                    time.sleep(0.05)
                return (k, f"v{k * 2}")
            return self.pool.submit(work)

        def close(self):
            self.pool.shutdown(wait=False)
    return Doubler()


def _async_harness(side: str, fn, **kw):
    s = SIDES[side]
    op = s.aio.AsyncWaitOperator(fn, out_schema=s.rec.Schema(OUT), **kw)
    return op, s.h.OneInputOperatorTestHarness(op, schema=s.rec.Schema(IN))


def _both(make_fn, keys, wm=100, **kw):
    got = {}
    for side in SIDES:
        _op, h = _async_harness(side, make_fn(side), **kw)
        h.process_elements(list(keys), list(range(len(keys))))
        h.process_watermark(wm)
        h.close()
        got[side] = h.get_output()
    return got


def test_ordered_and_unordered_equal_reference():
    got = _both(_doubler, (0, 1, 2, 3), mode="ordered")
    assert got["ref"] == got["port"]
    assert [r[0] for r in got["port"]] == [0, 1, 2, 3]
    got = _both(_doubler, tuple(range(8)), mode="unordered")
    assert sorted(got["ref"]) == sorted(got["port"])
    assert sorted(r[0] for r in got["port"]) == list(range(8))


def test_sync_answers_none_and_several_rows_equal_reference():
    def make(side):
        class F(SIDES[side].aio.AsyncFunction):
            def async_invoke(self, row, ts):
                if row[0] == 1:
                    return None
                if row[0] == 2:
                    return [(row[0], "a"), (row[0], "b")]
                return (row[0], "sync")
        return F()

    got = _both(make, (0, 1, 2, 3), wm=10)
    assert got["ref"] == got["port"] == [(0, "sync"), (2, "a"), (2, "b"),
                                         (3, "sync")]


@pytest.mark.parametrize("on_timeout", ["fail", "ignore"])
def test_timeout_fails_or_falls_back_as_reference(on_timeout):
    def make(side):
        class Hang(SIDES[side].aio.AsyncFunction):
            def async_invoke(self, row, ts):
                return Future()

            def timeout(self, row):
                return (row[0], "fallback")
        return Hang()

    for side in SIDES:
        _op, h = _async_harness(side, make(side), timeout_ms=20,
                                on_timeout=on_timeout)
        h.process_elements([1], [0])
        if on_timeout == "fail":
            with pytest.raises(TimeoutError):
                h.process_watermark(10)
        else:
            h.process_watermark(10)
            assert h.get_output() == [(1, "fallback")]


def _flaky(side: str, how: str):
    class Flaky(SIDES[side].aio.AsyncFunction):
        def __init__(self):
            self.calls = 0

        def async_invoke(self, row, ts):
            self.calls += 1
            if self.calls < 3:
                if how == "raise":
                    raise ConnectionError("refused")
                f = Future()
                if how == "exception":
                    f.set_exception(ConnectionError("transient"))
                return f              # "hang": unresolved
            if how == "raise":
                return (row[0], "up")
            f = Future()
            f.set_result((row[0], "ok"))
            return f
    return Flaky()


@pytest.mark.parametrize("how", ["hang", "exception", "raise"])
def test_retries_after_timeout_exception_and_raise_equal_reference(how):
    out = {}
    for side in SIDES:
        fn = _flaky(side, how)
        retry = SIDES[side].aio.RetryPolicy(max_attempts=5, delay_ms=1)
        _op, h = _async_harness(side, fn, timeout_ms=10, on_timeout="ignore",
                                retry=retry)
        h.process_elements([7], [0])
        h.process_watermark(10)
        out[side] = (h.get_output(), fn.calls)
    assert out["ref"] == out["port"]
    assert out["port"][1] == 3 and len(out["port"][0]) == 1
    # spent retries with fail re-raise the function's own error
    for side in SIDES:
        class Down(SIDES[side].aio.AsyncFunction):
            def async_invoke(self, row, ts):
                f = Future()
                f.set_exception(ConnectionError("down"))
                return f
        retry = SIDES[side].aio.RetryPolicy(max_attempts=2, delay_ms=1)
        _op, h = _async_harness(side, Down(), on_timeout="fail", retry=retry)
        h.process_elements([1], [0])
        with pytest.raises(ConnectionError):
            h.process_watermark(10)


@pytest.mark.parametrize("mode", ["ordered", "unordered"])
def test_capacity_holds_the_requests_in_flight(mode):
    for side in SIDES:
        inflight, lock, most = [], threading.Lock(), [0]

        class Slow(SIDES[side].aio.AsyncFunction):
            def open(self):
                self.pool = ThreadPoolExecutor(16)

            def async_invoke(self, row, ts):
                def work():
                    with lock:
                        inflight.append(1)
                        most[0] = max(most[0], len(inflight))
                    time.sleep(0.01)
                    with lock:
                        inflight.pop()
                    return (row[0], "x")
                return self.pool.submit(work)

        _op, h = _async_harness(side, Slow(), capacity=3, mode=mode)
        h.process_elements(list(range(12)), list(range(12)))
        h.process_watermark(100)
        assert sorted(r[0] for r in h.get_output()) == list(range(12))
        assert most[0] <= 3, side


@pytest.mark.parametrize("src,dst", [("ref", "port"), ("port", "ref"),
                                     ("port", "port")])
def test_in_flight_snapshot_restores_across_packages(src, dst):
    """Slow requests in flight at the snapshot; the restored operator
    submits them again and emits each once."""
    def gate(side):
        release = threading.Event()

        class Gated(SIDES[side].aio.AsyncFunction):
            def open(self):
                self.pool = ThreadPoolExecutor(4)

            def async_invoke(self, row, ts):
                def work():
                    release.wait(30)
                    return (row[0], f"v{row[0]}")
                return self.pool.submit(work)
        return Gated(), release

    fn, release = gate(src)
    _op, h = _async_harness(src, fn)
    h.process_elements([2, 4, 6], [0, 1, 2])
    snap = h.snapshot(1)
    assert sorted(r for r, _ in snap["operator"]["pending"]) == [[2], [4],
                                                                  [6]]
    release.set()
    h.process_watermark(10)
    assert sorted(h.get_output()) == [(2, "v2"), (4, "v4"), (6, "v6")]
    s = SIDES[dst]
    h2 = s.h.OneInputOperatorTestHarness.restored(
        lambda: s.aio.AsyncWaitOperator(_doubler(dst),
                                        out_schema=s.rec.Schema(OUT)),
        snap, schema=s.rec.Schema(IN))
    h2.process_watermark(10)
    assert sorted(h2.get_output()) == [(2, "v4"), (4, "v8"), (6, "v12")]
    assert h2.snapshot(2)["operator"]["pending"] == []


def test_async_io_job_at_parallelism_2_equals_reference():
    got = {}
    for side in SIDES:
        s = SIDES[side]
        env = s.env()
        env.set_parallelism(2)
        ds = env.from_collection(list(range(40)), s.rec.Schema(IN),
                                 timestamps=list(range(40)))
        out = ds.async_io(_doubler(side), mode="ordered",
                          out_schema=s.rec.Schema(OUT))
        got[side] = sorted(out.execute_and_collect("async"))
    assert got["ref"] == got["port"]
    assert [r[0] for r in got["port"]] == list(range(40))
