"""Port parity: two-input jobs and the interval join
(flink_tpu_torch/sql/join.py, runtime/stream_task.py::TwoInputStreamTask,
the connect API and the two-input graph) against flink_tpu's.

Both packages' IntervalJoinOperators are driven through their
TwoInputOperatorTestHarness with the same batches and watermarks, on the
device plane (``state.backend.type`` tpu: list state on the device, the
plain versions of the kernels here) and the host plane (hashmap): rows
equal and in the same order, both planes being deterministic. Tolerance:
exact (integer and float bits). A small Nexmark Q7 join (bench.py::
bench_framework_q7_join's job) runs through env.execute() in both
packages, and in a process where JAX and the JAX package cannot be
imported; its winners equal chip_smoke.py's numpy oracle as a multiset.
"""

import importlib.util
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from flink_tpu_torch.core import Configuration, Schema
from flink_tpu_torch.core.elements import CheckpointBarrier, EndOfInput, \
    Watermark
from flink_tpu_torch.core.records import RecordBatch
from flink_tpu_torch.graph.fusion import certify
from flink_tpu_torch.graph.stream_graph import build_job_graph, \
    build_stream_graph
from flink_tpu_torch.runtime.channels import InputGate, LocalChannel
from flink_tpu_torch.runtime.harness import TwoInputOperatorTestHarness
from flink_tpu_torch.runtime.operators.base import CollectingOutput, \
    OperatorChain, OperatorContext
from flink_tpu_torch.runtime.stream_task import TwoInputStreamTask
from flink_tpu_torch.sql.join import IntervalJoinOperator

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

L_SCHEMA = [("lk", np.int64), ("lv", np.int64)]
R_SCHEMA = [("rk_", np.int64), ("rv", np.float64)]
OUT = [("lk", np.int64), ("lv", np.int64), ("rk_", np.int64),
       ("rv", np.float64)]
#: a small Q7 join: 8 panes of 10 s over 2^13 bids, batches of 2^11
SMALL_Q7 = {"auctions": 500, "bids": 1 << 13, "window_capacity": 1 << 10,
            "store_capacity": 1 << 10, "device_batches": False,
            "batch": 1 << 11}


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import types

    from flink_tpu.core.config import Configuration as RefConfig
    from flink_tpu.core.config import StateOptions
    from flink_tpu.core.records import Schema as RefSchema
    from flink_tpu.runtime.harness import TwoInputOperatorTestHarness as H
    from flink_tpu.sql.join import IntervalJoinOperator as Op
    return types.SimpleNamespace(Config=RefConfig, State=StateOptions,
                                 Schema=RefSchema, Harness=H, Op=Op)


def _data(seed, n=120, n_keys=15):
    rng = np.random.default_rng(seed)
    left = [((int(k), int(a)), int(t)) for k, a, t in
            zip(rng.integers(0, n_keys, n), rng.integers(0, 100, n),
                np.sort(rng.integers(0, 2000, n)))]
    right = [((int(k), float(b)), int(t)) for k, b, t in
             zip(rng.integers(0, n_keys, n), rng.integers(0, 80, n) / 8,
                 np.sort(rng.integers(0, 2000, n)))]
    return left, right


def _schedule(left, right, batch=7, prune_every=0):
    """Interleaved by ts: (side, rows, timestamps) batches, with both
    watermarks after every ``prune_every`` batches."""
    seq = sorted([(1, r, t) for r, t in left] + [(2, r, t) for r, t in right],
                 key=lambda e: (e[2], e[0]))
    out, i = [], 0
    while i < len(seq):
        side = seq[i][0]
        j = i
        while j < len(seq) and j - i < batch and seq[j][0] == side:
            j += 1
        out.append(("batch", side, [e[1] for e in seq[i:j]],
                    [e[2] for e in seq[i:j]]))
        if prune_every and len(out) % prune_every == 0:
            out.append(("watermark", seq[j - 1][2] - 150))
        i = j
    return out


def _port_harness(backend="tpu", op=None, **kw):
    op = op or IntervalJoinOperator(0, 0, -100, 100, Schema(OUT),
                                    rows_per_key=64, device="cpu", **kw)
    return TwoInputOperatorTestHarness(
        op, Schema(L_SCHEMA), Schema(R_SCHEMA),
        Configuration({"state.backend.type": backend})), op


def _ref_harness(ref, backend="tpu"):
    cfg = ref.Config()
    cfg.set(ref.State.BACKEND, backend)
    op = ref.Op(0, 0, -100, 100, ref.Schema(OUT), rows_per_key=64)
    return ref.Harness(op, ref.Schema(L_SCHEMA), ref.Schema(R_SCHEMA),
                       cfg), op


def _drive(h, schedule):
    for ev in schedule:
        if ev[0] == "watermark":
            h.process_watermark1(ev[1])
            h.process_watermark2(ev[1])
        elif ev[1] == 1:
            h.process_elements1(ev[2], ev[3])
        else:
            h.process_elements2(ev[2], ev[3])
    return [tuple(r) for r in h.get_output()]


@pytest.mark.parametrize("backend", ["tpu", "hashmap"])
def test_rows_equal_the_reference_in_order(ref, backend):
    for seed in (3, 4):
        sched = _schedule(*_data(seed))
        (hp, op), (hr, _r) = _port_harness(backend), _ref_harness(ref,
                                                                  backend)
        got, want = _drive(hp, sched), _drive(hr, sched)
        assert got == want and len(got) > 40
        assert (op._stores[0] is not None) == (backend == "tpu")


@pytest.mark.parametrize("backend", ["tpu", "hashmap"])
def test_pruning_watermarks(ref, backend):
    sched = _schedule(*_data(8), prune_every=3)
    (hp, op), (hr, rop) = _port_harness(backend), _ref_harness(ref, backend)
    assert _drive(hp, sched) == _drive(hr, sched)
    assert hp.get_watermarks() == hr.get_watermarks()
    if backend == "tpu":
        assert sum(s.stats["prunes"] for s in op._stores) > 0
        for s, rs in zip(op._stores, rop._stores):
            assert s._occ == rs._occ
    else:
        assert op.buffers == rop.buffers


def _split_run(first, second, schedule):
    """Half the schedule on ``first``, its snapshot restored into
    ``second`` for the rest; both harnesses' rows."""
    h1, op1 = first()
    half = len(schedule) // 2
    out = _drive(h1, schedule[:half])
    h2, op2 = second()
    h2.open([op1.snapshot_state(1)["keyed"]], None)
    return out + _drive(h2, schedule[half:])


@pytest.mark.parametrize("backend", ["tpu", "hashmap"])
def test_checkpoint_restore_within_and_across_packages(ref, backend):
    sched = _schedule(*_data(11), prune_every=4)
    whole = _drive(_port_harness(backend)[0], sched)
    port = lambda: _port_harness(backend)  # noqa: E731
    refh = lambda: _ref_harness(ref, backend)  # noqa: E731
    for first, second in ((port, port), (port, refh), (refh, port)):
        assert _split_run(first, second, sched) == whole


def test_checkpoint_before_first_batch_keeps_state(ref):
    left, right = _data(13, n=60)
    h1, op1 = _port_harness()
    for row, ts in left:
        h1.process_elements1([row], [ts])
    h2, op2 = _port_harness()
    h2.open([op1.snapshot_state(1)["keyed"]], None)
    snap2 = op2.snapshot_state(2)           # before any batch
    assert len(snap2["keyed"]["backend"]["list-left"]["keys"]) > 0
    h3, _op3 = _port_harness()
    h3.open([snap2["keyed"]], None)
    for row, ts in right:
        h3.process_elements2([row], [ts])
    assert len(h3.get_output()) > 0


def test_routing_rules():
    """A string column takes the host plane; device state followed by an
    input the device plane cannot take raises; outer joins raise."""
    op = IntervalJoinOperator(0, 0, -10, 10, Schema(
        [("k", np.int64), ("s", object), ("k2", np.int64)]), device="cpu")
    h = TwoInputOperatorTestHarness(op, Schema([("k", np.int64),
                                                ("s", object)]),
                                    Schema([("k2", np.int64)]))
    h.process_elements1([(1, "a")], [5])
    h.process_elements2([1], [7])
    assert h.get_output() == [(1, "a", 1)] and op._stores == [None, None]
    h2, op2 = _port_harness()
    h2.process_elements1([(1, 2)], [5])
    assert op2._stores[0] is not None
    bad = RecordBatch.from_rows(Schema([("rk_", np.int64), ("rv", object)]),
                                [(1, "x")], [6])
    with pytest.raises(TypeError, match="not device-eligible"):
        h2.process_batch2(bad)
    with pytest.raises(NotImplementedError, match="inner-only"):
        IntervalJoinOperator(0, 0, -1, 1, Schema(OUT), join_type="left",
                             device="cpu")


def test_device_batches_join_on_the_device_plane(ref):
    """A batch of device columns (as datagen(device=True) makes them) is
    packed and appended without a host copy and joins like host rows."""
    from flink_tpu_torch.core.device_records import DeviceRecordBatch

    left, right = _data(21)
    hp, _op = _port_harness()
    hd, _op2 = _port_harness()
    for rows, side in ((left, 1), (right, 2)):
        schema = Schema(L_SCHEMA if side == 1 else R_SCHEMA)
        b = RecordBatch.from_rows(schema, [r for r, _t in rows],
                                  [t for _r, t in rows])
        dcols = {n: torch.from_numpy(b.column(n)) for n in schema.names}
        db = DeviceRecordBatch(schema, dcols, torch.from_numpy(b.timestamps),
                               int(b.timestamps.min()),
                               int(b.timestamps.max()))
        (hp.process_batch1 if side == 1 else hp.process_batch2)(b)
        (hd.process_batch1 if side == 1 else hd.process_batch2)(db)
        assert db._host is None            # never materialised
    assert hd.get_output() == hp.get_output() and hp.get_output()


def test_two_input_graph_and_job_graph():
    env, _got = cs.q7_join_env(torch, torch.device("cpu"), SMALL_Q7)
    sg = build_stream_graph(env._sinks, env.config)
    (join,) = [n for n in sg.nodes.values() if n.kind == "two_input"]
    ins = sorted((e.target_input, sg.nodes[e.source_id].kind,
                  e.partitioner_name) for e in sg.in_edges(join.id))
    assert ins == [(0, "one_input", "forward"), (1, "source", "forward")]
    src = [n for n in sg.nodes.values() if n.kind == "source"][0]
    assert len(sg.out_edges(src.id)) == 2      # the window and the join
    jg = build_job_graph(sg, env.config, "q7-join")
    kinds = sorted(v.kind for v in jg.vertices.values())
    assert kinds == ["one_input", "source", "two_input"]
    (v,) = [v for v in jg.vertices.values() if v.kind == "two_input"]
    assert [n.name for n in v.chained_nodes] == ["q7-join", "is-winner",
                                                 "winners"]
    assert sorted(e.target_input for e in jg.in_edges(v.id)) == [0, 1]
    cert = certify(sg, jg, env.config)
    head = cert.chain_for_vertex(v.id).ops[0]
    assert head.category == "two-input"
    with pytest.raises(NotImplementedError, match="DataStream"):
        env.from_collection([1, 2]).connect(object())


class _Reporter:
    def __init__(self):
        self.acks = []

    def acknowledge_checkpoint(self, task_id, cid, snap):
        self.acks.append((cid, snap))

    def task_finished(self, *a):
        pass

    def task_failed(self, task_id, err):
        raise AssertionError(err)


def _task(channels1, channels2, op=None):
    ctx = OperatorContext("t", 0, 1, 128)
    rep = _Reporter()
    task = TwoInputStreamTask("t#0", ctx, InputGate(channels1),
                              InputGate(channels2), [], rep)
    op = op or IntervalJoinOperator(0, 0, -100, 100, Schema(OUT),
                                    device="cpu")
    out = CollectingOutput()
    task.chain = OperatorChain([op], ctx, out)
    return task, rep, out


def test_two_input_barrier_completes_when_other_gate_ends():
    """The reference's regression (tests/test_join.py:369): a barrier held
    on one gate completes once the other input ends."""
    c1, c2 = LocalChannel(), LocalChannel()
    task, rep, _out = _task([c1], [c2])
    c1.put(CheckpointBarrier(1, 0))
    c1.put(EndOfInput())
    c2.put(EndOfInput())
    t = task.start()
    t.join(5.0)
    assert not t.is_alive(), "two-input task deadlocked"
    assert [cid for cid, _s in rep.acks] == [1]


def test_two_gate_alignment_snapshots_after_both_barriers():
    """The gate that delivered its barrier first is held: its later rows
    are not in the snapshot, the other gate's rows before its barrier
    are; watermarks min-combine across the gates."""
    c1, c2 = LocalChannel(), LocalChannel()
    task, rep, out = _task([c1], [c2])
    lb = RecordBatch.from_rows(Schema(L_SCHEMA), [(1, 10)], [100])
    rb = RecordBatch.from_rows(Schema(R_SCHEMA), [(1, 0.5)], [150])
    late_l = RecordBatch.from_rows(Schema(L_SCHEMA), [(2, 20)], [160])
    c1.put(lb)
    c1.put(CheckpointBarrier(7, 0))
    c1.put(late_l)
    c1.put(Watermark(500))
    c2.put(Watermark(300))
    t = task.start()
    time.sleep(0.2)
    assert rep.acks == []                 # gate 2 has no barrier yet
    c2.put(rb)
    c2.put(CheckpointBarrier(7, 0))
    c2.put(EndOfInput())
    c1.put(EndOfInput())
    t.join(5.0)
    assert not t.is_alive()
    ((cid, snap),) = rep.acks
    (state,) = snap["chain"].values()
    lists = state["keyed"]["backend"]
    assert cid == 7
    assert list(lists["list-left"]["keys"]) == [1]      # not key 2
    assert list(lists["list-right"]["keys"]) == [1]
    assert out.rows() == [(1, 10, 1, 0.5)]
    assert [w.timestamp for w in out.watermarks][:1] == [300]


def _ref_q7_join(c):
    """bench.py::bench_framework_q7_join's job in the JAX package, small."""
    from flink_tpu.api import StreamExecutionEnvironment as RefEnv
    from flink_tpu.core import WatermarkStrategy
    from flink_tpu.core.config import PipelineOptions
    from flink_tpu.core.functions import SinkFunction
    from flink_tpu.core.records import Schema as RefSchema
    from flink_tpu.runtime.operators.device_window import AggSpec
    from flink_tpu.runtime.operators.simple import BatchFnOperator
    from flink_tpu.sql.join import IntervalJoinOperator as RefJoin
    from flink_tpu.window import TumblingEventTimeWindows

    env = RefEnv.get_execution_environment()
    env.set_state_backend("tpu")
    env.config.set(PipelineOptions.BATCH_SIZE, c["batch"])
    env.config.set(PipelineOptions.AUTO_WATERMARK_INTERVAL, 0)
    schema = RefSchema([("auction", np.int64), ("price", np.int64),
                        ("ts", np.int64)])
    ws = WatermarkStrategy.for_monotonous_timestamps() \
        .with_timestamp_column("ts")
    bids = env.datagen(cs.q7_join_gen(c["auctions"], c["bids"], False),
                       schema, count=c["bids"], timestamp_column="ts",
                       watermark_strategy=ws)
    maxes = (bids.key_by("auction")
             .window(TumblingEventTimeWindows.of(cs.Q7J_PANE_MS))
             .device_aggregate([AggSpec("max", "price",
                                        out_name="maxprice")],
                               capacity=c["window_capacity"],
                               ring_size=cs.RING, emit_window_bounds=False))
    out = RefSchema([("m_auction", np.int64), ("maxprice", np.int64),
                     ("auction", np.int64), ("price", np.int64),
                     ("ts", np.int64)])
    got = []

    class Sink(SinkFunction):
        def invoke_batch(self, b):
            got.append(cs.q7j_winner_word(b.column("auction"),
                                          b.column("price"), b.column("ts")))
            return True

    (maxes.connect(bids).transform(
        "q7-join", lambda: RefJoin(0, 0, -(cs.Q7J_PANE_MS - 1), 0, out,
                                   rows_per_key=cs.Q7J_ROWS_PER_KEY,
                                   store_capacity=c["store_capacity"]))
     .transform("is-winner", lambda: BatchFnOperator(
         lambda b: b.take(np.flatnonzero(b.column("price")
                                         == b.column("maxprice"))),
         "is-winner"))
     .add_sink(Sink(), "w"))
    env.execute("q7-join", timeout=300.0)
    return np.sort(np.concatenate(got))


def test_q7_join_both_packages_equal_winners(ref):
    expected = cs.q7_join_expected(SMALL_Q7)
    assert np.array_equal(_ref_q7_join(SMALL_Q7), expected)
    for device_batches in (False, True):
        c = dict(SMALL_Q7, device_batches=device_batches)
        job, got = cs.run_q7_join(torch, torch.device("cpu"), c)
        assert cs.q7_join_check(expected, got) == len(expected)
        op = cs.q7_join_operator(job)
        assert op._device and op.stats["matches"] == SMALL_Q7["bids"]


def test_skipped_probes_keep_the_reference_rows(ref):
    """Two streams whose batches alternate in bursts far apart in time:
    most batches' intervals miss the other side's live rows (or meet an
    emptied store) and skip their probe, and the rows, in order, still
    equal the reference's."""
    rng = np.random.default_rng(11)
    left, right, t = [], [], 0
    for burst in range(12):
        n = int(rng.integers(5, 30))
        ts = np.sort(rng.integers(t, t + 150, n))
        keys = rng.integers(0, 12, n)
        if burst % 3 == 2:   # left and right close together: matches
            half = n // 2
            left += [((int(k), int(v)), int(x)) for k, v, x in
                     zip(keys[:half], rng.integers(0, 100, half), ts[:half])]
            right += [((int(k), float(v) / 8), int(x)) for k, v, x in
                      zip(keys[half:], rng.integers(0, 80, n - half),
                          ts[half:])]
        elif burst % 2:
            left += [((int(k), int(v)), int(x)) for k, v, x in
                     zip(keys, rng.integers(0, 100, n), ts)]
        else:
            right += [((int(k), float(v) / 8), int(x)) for k, v, x in
                      zip(keys, rng.integers(0, 80, n), ts)]
        t += 1000
    sched = _schedule(left, right, batch=6, prune_every=3)
    hp, op = _port_harness()
    hr, _ = _ref_harness(ref)
    got, want = _drive(hp, sched), _drive(hr, sched)
    assert got == want and len(got) > 0
    skipped = sum(s.stats["probes_skipped"] for s in op._stores)
    assert skipped > 0 and sum(s.stats["probes"] for s in op._stores) > 0


def test_q7_join_skips_the_probes_of_bids_past_the_maxes():
    """The Q7 join through env.execute() on the CPU: the winners equal the
    oracle, and the maxes' store skips probes (a bid batch after a fire
    lies past every max's ts, or meets a store its prune emptied)."""
    c = dict(SMALL_Q7, bids=1 << 14, batch=1 << 10)
    job, got = cs.run_q7_join(torch, torch.device("cpu"), c)
    assert cs.q7_join_check(cs.q7_join_expected(c), got) > 0
    maxes, bids = cs.q7_join_operator(job)._stores
    assert maxes.stats["probes_skipped"] > 0
    assert maxes.stats["probes"] + maxes.stats["probes_skipped"] \
        + bids.stats["probes"] + bids.stats["probes_skipped"] > 0


def test_q7_join_checkpoint_and_restore():
    """The job checkpoints with the source paused, is cancelled and
    restored from the checkpoint: the winners of both jobs together are
    the oracle's, none repeated."""
    from flink_tpu_torch.runtime.stream_task import TwoInputStreamTask as T

    c = dict(SMALL_Q7, bids=1 << 14)
    sources = []
    env, got = cs.q7_join_env(
        torch, torch.device("cpu"), c, rate=c["bids"] / 2.0,
        source_hook=sources.append,
        settings={"execution.checkpointing.interval": 0.1})
    job = env.execute_async("q7-join-checkpointed")
    t0 = time.perf_counter()
    while not got and time.perf_counter() - t0 < 60:
        time.sleep(0.01)             # a pane has closed and joined
    cs.wait_checkpoints(job, 1, after=time.time())
    sources[0].set_rate(0)
    cs.wait_checkpoints(job, 2, after=time.time())
    job.cancel()
    assert any(isinstance(t, T) for t in job.tasks.values())
    cp = job.coordinator.latest_checkpoint()
    before = list(got)
    env2, got2 = cs.q7_join_env(torch, torch.device("cpu"), c)
    env2.restore_from_checkpoint(cp)
    env2.execute("q7-join-restored", timeout=120.0)
    assert before and got2
    assert cs.q7_join_check(cs.q7_join_expected(c), before + got2) > 0


def test_q7_join_runs_without_jax():
    """The port's Q7 join in a process where neither jax nor flink_tpu
    can be imported."""
    code = (
        "import sys; sys.modules['jax'] = None; "
        "sys.modules['flink_tpu'] = None\n"
        "import importlib.util, torch\n"
        "spec = importlib.util.spec_from_file_location('cs', "
        "'chip_smoke.py'); cs = importlib.util.module_from_spec(spec); "
        "spec.loader.exec_module(cs)\n"
        f"c = {SMALL_Q7!r}\n"
        "job, got = cs.run_q7_join(torch, torch.device('cpu'), c)\n"
        "print(cs.q7_join_check(cs.q7_join_expected(c), got))\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'flink_tpu.')) "
        "for m in sys.modules if sys.modules[m] is not None)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split()[-1]) == len(
        cs.q7_join_expected(SMALL_Q7))
