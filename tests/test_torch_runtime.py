"""Port parity: the graph runtime of flink_tpu_torch against flink_tpu's.

* ``build_job_graph`` of the same pipeline gives the same vertices
  (chained operator names, parallelism, uid), the same edges and edge
  partitioners in both packages: Q5 with fusion off and on, with chaining
  disabled, and with the window at another parallelism than the source.
* A tiny Q5 (every row, and the top-k fire under the ROADMAP tie rule) and
  a tiny Q7 through ``env.execute()`` give the reference's rows, with
  ``pipeline.fusion.enabled`` off and on.
* The watermark interval changes when windows fire, not what they hold.
* Parallelism 2 on host batches (``datagen(device=False)`` into
  ``device_aggregate(defer_overflow=False)``: each subtask's backend holds
  its key-group range) gives the reference's rows.
* The keyed exchange splits host batches as the reference does, forwards
  a device batch into one channel untouched and refuses to split one; the
  input gate aligns barriers and combines watermarks as the reference's.
* The datagen reader strides subtasks, resumes exactly, and its lazy
  (fused) batches decode to the unfused batches.

Tolerance: exact everywhere (integer aggregates).
"""

import importlib.util
import os
import pathlib
import sys
from collections import defaultdict

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from flink_tpu.api import StreamExecutionEnvironment as RefEnv  # noqa: E402
from flink_tpu.connectors.core import CollectSink as RefCollectSink  # noqa: E402
from flink_tpu.core import WatermarkStrategy as RefWS  # noqa: E402
from flink_tpu.core.elements import CheckpointBarrier as RefBarrier  # noqa: E402
from flink_tpu.core.elements import EndOfInput as RefEnd  # noqa: E402
from flink_tpu.core.elements import Watermark as RefWatermark  # noqa: E402
from flink_tpu.core.elements import WatermarkStatus as RefStatus  # noqa: E402
from flink_tpu.core.records import RecordBatch as RefBatch  # noqa: E402
from flink_tpu.core.records import Schema as RefSchema  # noqa: E402
from flink_tpu.graph.stream_graph import build_job_graph as ref_build_job  # noqa: E402
from flink_tpu.graph.stream_graph import \
    build_stream_graph as ref_build_stream  # noqa: E402
from flink_tpu.runtime.channels import InputGate as RefGate  # noqa: E402
from flink_tpu.runtime.channels import LocalChannel as RefChannel  # noqa: E402
from flink_tpu.runtime.operators.device_window import \
    AggSpec as RefAggSpec  # noqa: E402
from flink_tpu.runtime.writer import \
    KeyGroupPartitioner as RefKeyGroupPartitioner  # noqa: E402
from flink_tpu.window import SlidingEventTimeWindows as RefSliding  # noqa: E402
from flink_tpu_torch.api import StreamExecutionEnvironment  # noqa: E402
from flink_tpu_torch.connectors.datagen import DataGenSource  # noqa: E402
from flink_tpu_torch.core import Configuration, Schema, WatermarkStrategy  # noqa: E402
from flink_tpu_torch.core.device_records import DeviceRecordBatch  # noqa: E402
from flink_tpu_torch.core.elements import CheckpointBarrier, EndOfInput, \
    Watermark, WatermarkStatus  # noqa: E402
from flink_tpu_torch.core.records import RecordBatch  # noqa: E402
from flink_tpu_torch.graph import build_job_graph, build_stream_graph  # noqa: E402
from flink_tpu_torch.metrics import DEVICE_STATS  # noqa: E402
from flink_tpu_torch.runtime.channels import InputGate, LocalChannel  # noqa: E402
from flink_tpu_torch.runtime.operators import AggSpec  # noqa: E402
from flink_tpu_torch.runtime.writer import KeyGroupPartitioner  # noqa: E402
from flink_tpu_torch.window import SlidingEventTimeWindows  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIELDS = [("auction", np.int64), ("price", np.int64), ("ts", np.int64)]
N_EVENTS, N_KEYS, SPAN, BATCH = 8192, 300, 16_000, 1024
MULT = 0x9E3779B97F4A7C15


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _smoke()


def _numpy_gen(idx):
    """bench.py's Q5 generator in uint64 numpy."""
    u = idx.astype(np.uint64) * np.uint64(MULT)
    return {"auction": (u % np.uint64(N_KEYS)).astype(np.int64),
            "price": (idx % 997) + 1, "ts": (idx * SPAN) // N_EVENTS}


def _ref_env(settings):
    env = RefEnv()
    env.set_state_backend("tpu")
    env.config.set("pipeline.micro-batch-size", BATCH)
    for key, value in settings.items():
        env.config.set(key, value)
    return env


def _port_env(settings):
    return StreamExecutionEnvironment(
        Configuration({"pipeline.micro-batch-size": BATCH, **settings}),
        device="cpu")


def _q5(env, ref: bool, device=True, topk=None, defer=True, source_par=None):
    """The Q5 pipeline on ``env`` (reference or port), up to the window."""
    ws = (RefWS if ref else WatermarkStrategy).for_monotonous_timestamps() \
        .with_timestamp_column("ts")
    schema = (RefSchema if ref else Schema)(FIELDS)
    agg = RefAggSpec if ref else AggSpec
    sliding = RefSliding if ref else SlidingEventTimeWindows
    gen = _numpy_gen if (ref or not device) else \
        CS.q5_gen(N_KEYS, N_EVENTS, SPAN)
    return (env.datagen(gen, schema, count=N_EVENTS, timestamp_column="ts",
                        watermark_strategy=ws, device=device,
                        parallelism=source_par)
            .key_by("auction")
            .window(sliding.of(5000, 1000))
            .device_aggregate([agg("count", out_name="bids", value_bits=31),
                               agg("sum", "price", out_name="revenue")],
                              capacity=1 << 10, ring_size=32, emit_topk=topk,
                              defer_overflow=defer, async_fire=True))


# -- the job graph ------------------------------------------------------------
GRAPH_CASES = {
    "fusion_off": ({}, None, None),
    "fusion_on": ({"pipeline.fusion.enabled": True}, None, None),
    "chaining_disabled": ({"pipeline.operator-chaining": False}, None, None),
    # the window and sink at 2, the source at 1: a hash edge between
    # unequal parallelisms never chains, fused or not
    "parallelism_mismatch": ({"pipeline.parallelism": 2}, 1, None),
    "parallelism_mismatch_fused": ({"pipeline.parallelism": 2,
                                    "pipeline.fusion.enabled": True}, 1, None),
    # a sink at another parallelism than the window it follows
    "sink_parallelism": ({"pipeline.fusion.enabled": True}, None, 2),
}


def _graph_shape(jg):
    names = {vid: v.name for vid, v in jg.vertices.items()}
    vertices = sorted((v.name, v.parallelism, v.max_parallelism, v.uid,
                       tuple(n.kind for n in v.chained_nodes))
                      for v in jg.vertices.values())
    edges = sorted((names[e.source_vertex], names[e.target_vertex],
                    e.partitioner_name) for e in jg.edges)
    order = [v.name for v in jg.topological_order()]
    return vertices, edges, order


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_job_graph_matches_reference(case):
    settings, source_par, sink_par = GRAPH_CASES[case]
    shapes = []
    for ref in (True, False):
        env = _ref_env(settings) if ref else _port_env(settings)
        _q5(env, ref, source_par=source_par).add_sink(
            RefCollectSink() if ref else (lambda b: None), "Sink",
            parallelism=sink_par)
        if ref:
            sg = ref_build_stream(env._sinks, env.config)
            jg = ref_build_job(sg, env.config, "q5")
        else:
            sg = build_stream_graph(env._sinks, env.config)
            jg = build_job_graph(sg, env.config, "q5")
        shapes.append(_graph_shape(jg))
    assert shapes[1] == shapes[0]
    vertices = shapes[0][0]
    fused = settings.get("pipeline.fusion.enabled") and source_par is None
    assert (len(vertices) == 1) == bool(fused and sink_par is None)


# -- rows through env.execute() -----------------------------------------------
_REF_ROWS: dict = {}


def _ref_rows(topk):
    if topk not in _REF_ROWS:
        _REF_ROWS[topk] = _q5(_ref_env({}), True, topk=topk) \
            .execute_and_collect()
    return _REF_ROWS[topk]


def _port_rows(topk, settings):
    env = _port_env(settings)
    rows = _q5(env, False, topk=topk).execute_and_collect()
    return rows, env.last_job


def _by_window(rows):
    out = defaultdict(list)
    for auction, _start, end, bids, revenue in rows:
        out[end].append((auction, bids, revenue))
    return out


def _assert_topk_rule(got, want, full):
    """ROADMAP's tie rule per window: values equal, keys above the k-th
    value equal, keys at it a subset of its tie class, rows exact."""
    windows, prows_by, rrows_by = _by_window(full), _by_window(got), \
        _by_window(want)
    assert sorted(prows_by) == sorted(rrows_by) == sorted(windows)
    for end, prows in prows_by.items():
        rrows = rrows_by[end]
        assert [r[1] for r in prows] == [r[1] for r in rrows]
        kth = prows[-1][1]
        assert {r[0] for r in prows if r[1] > kth} == \
            {r[0] for r in rrows if r[1] > kth}
        ties = {a for a, bids, _rev in windows[end] if bids == kth}
        assert {r[0] for r in prows if r[1] == kth} <= ties
        exact = {a: (bids, rev) for a, bids, rev in windows[end]}
        assert all(exact[a] == (bids, rev) for a, bids, rev in prows)


@pytest.mark.parametrize("topk", [None, 10])
def test_q5_rows_equal_reference_fused_and_unfused(topk):
    full = _ref_rows(None)
    want = _ref_rows(topk)
    assert len(full) > 100
    for fused in (False, True):
        before = DEVICE_STATS.snapshot()["chain_fused_dispatches_total"]
        got, job = _port_rows(topk, {"pipeline.fusion.enabled": fused})
        dispatches = DEVICE_STATS.snapshot()[
            "chain_fused_dispatches_total"] - before
        assert dispatches == (N_EVENTS // BATCH if fused else 0)
        assert len(job.job_graph.vertices) == (1 if fused else 2)
        assert job.fusion_declined == {}
        if topk is None:
            assert got == want
        else:
            _assert_topk_rule(got, want, full)


def test_q7_rows_equal_reference_fused_and_unfused():
    n_keys, n_events, cap, batch = 500, 1 << 14, 1 << 10, 1 << 10
    span = CS.q5_panes(n_events, batch) * CS.Q7_PANE_MS
    expected = CS.q7_expected(n_keys, n_events, span)
    from flink_tpu.window import TumblingEventTimeWindows as RefTumbling

    def gen(idx):
        u = idx.astype(np.uint64)
        auction = ((u * np.uint64(MULT)) % np.uint64(n_keys)).astype(np.int64)
        return {"auction": auction,
                "packed": (((idx % 9973) + 1) << 20) | (idx % (1 << 20)),
                "ts": (idx * span) // n_events}

    env = _ref_env({"pipeline.micro-batch-size": batch})
    want = (env.datagen(gen, RefSchema([("auction", np.int64),
                                        ("packed", np.int64),
                                        ("ts", np.int64)]),
                        count=n_events, timestamp_column="ts",
                        watermark_strategy=RefWS.for_monotonous_timestamps()
                        .with_timestamp_column("ts"))
            .key_by("auction").window(RefTumbling.of(CS.Q7_PANE_MS))
            .device_aggregate([RefAggSpec("max", "packed", out_name="best",
                                          value_bits=34)],
                              capacity=cap, ring_size=CS.RING,
                              emit_window_bounds=True, emit_topk=1,
                              defer_overflow=True, async_fire=True)
            .execute_and_collect())
    for fused in (False, True):
        job, got, got_span = CS.run_q7(torch, torch.device("cpu"), n_keys,
                                       n_events, cap, batch=batch,
                                       fused=fused)
        assert got_span == span
        assert [tuple(int(c[0]) for c in cols) for _ts, *cols in got] == \
            [tuple(r) for r in want]
        assert CS.q7_check(expected, got) == 9
        assert len(job.job_graph.vertices) == (1 if fused else 2)


def test_watermark_interval_changes_timing_not_rows():
    """Interval 0 (a watermark after every batch) against an hour (every
    window fires at the end of input): the same rows in the same order;
    the long interval emits no watermark but the final one."""
    want = _ref_rows(None)
    for interval in (0.0, 3600.0):
        got, job = _port_rows(None, {"pipeline.auto-watermark-interval":
                                     interval})
        assert got == want
        (src,) = job.source_tasks.values()
        if interval:
            assert src.watermarks_out <= 1
        else:
            assert src.watermarks_out >= N_EVENTS // BATCH - 1


def test_parallelism_two_on_host_batches_matches_reference():
    """Host batches keyed across two window subtasks: each backend holds
    its key-group range; the rows are the reference's at parallelism 2 and
    the port's own at parallelism 1."""
    settings = {"pipeline.parallelism": 2}
    want = _q5(_ref_env(settings), True, device=False, defer=False) \
        .execute_and_collect()
    env = _port_env(settings)
    got = _q5(env, False, device=False, defer=False).execute_and_collect()
    assert len(want) > 100
    assert sorted(got) == sorted(want)
    windows = [t for t in env.last_job.tasks.values()
               if t.chain is not None and t.chain.operators
               and t.chain.operators[0].name == "DeviceWindowAgg"]
    assert len(windows) == 2
    ranges = [(t.chain.operators[0].backend.key_group_range.start,
               t.chain.operators[0].backend.key_group_range.end)
              for t in windows]
    assert sorted(ranges) == [(0, 63), (64, 127)]
    single = _q5(_port_env({}), False, device=False, defer=False) \
        .execute_and_collect()
    assert sorted(single) == sorted(got)


def test_many_subtasks_under_a_short_switch_interval():
    """More task threads than cores, the interpreter switching threads
    every 10 us: keyed host batches over many window subtasks, each with
    its own backend, and one collect sink fed from all of them. A lost
    update (a row, a key group routed twice, a sink append) breaks the
    equality with the single-subtask run."""
    par = min(16, (os.cpu_count() or 8) // 2 + 1)
    want = sorted(_q5(_port_env({}), False, device=False, defer=False)
                  .execute_and_collect())
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        env = _port_env({"pipeline.parallelism": par})
        got = _q5(env, False, device=False, defer=False) \
            .execute_and_collect()
    finally:
        sys.setswitchinterval(interval)
    assert len(env.last_job.tasks) == 2 * par > (os.cpu_count() or 8)
    assert sorted(got) == want


# -- exchange and gate ----------------------------------------------------------
def test_key_group_partitioner_splits_like_reference():
    rng = np.random.default_rng(3)
    keys = rng.integers(-(1 << 40), 1 << 40, 3000, dtype=np.int64)
    cols = {"auction": keys, "price": np.arange(3000, dtype=np.int64),
            "ts": np.arange(3000, dtype=np.int64)}
    port_batch = RecordBatch(Schema(FIELDS), dict(cols))
    ref_batch = RefBatch(RefSchema(FIELDS), dict(cols))
    for channels in (1, 2, 3, 7):
        for maxp in (128, 4096):
            port = KeyGroupPartitioner(lambda b: b.column("auction"), maxp)
            ref = RefKeyGroupPartitioner(lambda b: b.column("auction"), maxp)
            got = port.route(port_batch, channels, 0)
            want = ref.route(ref_batch, channels, 0)
            assert [i for i, _p in got] == [i for i, _p in want]
            for (_i, p), (_j, r) in zip(got, want):
                for name, _dt in FIELDS:
                    np.testing.assert_array_equal(p.column(name),
                                                  r.column(name))
    dev = DeviceRecordBatch(Schema(FIELDS),
                            {k: torch.from_numpy(v) for k, v in cols.items()},
                            torch.from_numpy(cols["ts"]), 0, 2999,
                            ts_column="ts")
    part = KeyGroupPartitioner(lambda b: b.column("auction"), 128)
    assert part.route(dev, 1, 0) == [(0, dev)]
    with pytest.raises(NotImplementedError, match="multi-device"):
        part.route(dev, 2, 0)


def _gate_events(gate_cls, channel_cls, batch_cls, schema_cls, wm_cls,
                 barrier_cls, end_cls, status_cls, aligned):
    """Drive a 3-channel gate through an interleaving of batches,
    watermarks, a channel going idle and back, two checkpoints' barriers
    and end of input; returns what it handed out, normalized."""
    chans = [channel_cls() for _ in range(3)]
    batch = batch_cls(schema_cls([("k", np.int64)]),
                      {"k": np.arange(4, dtype=np.int64)})
    script = [
        (0, wm_cls(100)), (1, wm_cls(50)), (2, wm_cls(70)),
        (1, status_cls(False)), (2, status_cls(False)), (1, status_cls(True)),
        (2, status_cls(True)),
        (0, batch), (0, barrier_cls(1, 0.0)), (0, batch), (0, wm_cls(300)),
        (1, batch), (1, barrier_cls(1, 0.0)), (2, wm_cls(90)), (2, batch),
        (2, barrier_cls(1, 0.0)), (1, wm_cls(400)), (2, wm_cls(500)),
        (0, barrier_cls(2, 0.0)), (0, end_cls()), (1, barrier_cls(2, 0.0)),
        (1, end_cls()), (2, end_cls()),
    ]
    for ch, element in script:
        chans[ch].put(element)
    gate = gate_cls(chans, aligned=aligned)
    out = []
    for _ in range(200):
        ev = gate.poll()
        if ev is None:
            if gate.all_ended():
                break
            continue
        value = ev.value
        if ev.kind == "batch":
            value = ev.channel
        elif ev.kind == "watermark":
            value = value.timestamp
        elif ev.kind == "barrier":
            value = value.checkpoint_id
        elif ev.kind == "idle":
            value = value.active
        out.append((ev.kind, value))
    return out


@pytest.mark.parametrize("aligned", [True, False])
def test_input_gate_aligns_like_reference(aligned):
    want = _gate_events(RefGate, RefChannel, RefBatch, RefSchema,
                        RefWatermark, RefBarrier, RefEnd, RefStatus, aligned)
    got = _gate_events(InputGate, LocalChannel, RecordBatch, Schema,
                       Watermark, CheckpointBarrier, EndOfInput,
                       WatermarkStatus, aligned)
    assert got == want
    assert ("barrier", 1) in got and ("barrier", 2) in got
    assert ("idle", True) in got


# -- the datagen reader -------------------------------------------------------------
def test_datagen_reader_strides_resumes_and_decodes_lazily():
    gen = CS.q5_gen(N_KEYS, N_EVENTS, SPAN)
    src = DataGenSource(gen, Schema(FIELDS), count=1000,
                        timestamp_column="ts", device=True)
    splits = src.create_splits(3)
    for sub, split in enumerate(splits):
        reader = src.create_reader(split, torch.device("cpu"))
        first = reader.read_batch(64)
        idx = (torch.arange(64) * 3 + sub)
        assert torch.equal(first.device_column("price"), idx % 997 + 1)
        state = reader.snapshot()
        again = src.create_reader(split, torch.device("cpu"))
        again.restore(state)
        rest = [b.n for b in iter(lambda r=reader: r.read_batch(64), None)]
        rest2 = [b.n for b in iter(lambda r=again: r.read_batch(64), None)]
        assert rest == rest2
        assert 64 + sum(rest) == 1000 // 3 + (1 if sub < 1000 % 3 else 0)
    # lazy batches decode to the unfused reader's batches, tails included
    plain = src.create_reader(src.create_splits(1)[0], torch.device("cpu"))
    lazy = src.create_reader(src.create_splits(1)[0], torch.device("cpu"))
    assert lazy.enable_fused()
    lengths = []
    while (b := plain.read_batch(300)) is not None:
        lb = lazy.read_batch(300)
        assert lb.lazy and not lb.realized
        assert (lb.n, lb.ts_min, lb.ts_max) == (b.n, b.ts_min, b.ts_max)
        for name, _dt in FIELDS:
            assert torch.equal(lb.device_column(name), b.device_column(name))
        lengths.append(b.n)
    assert lazy.read_batch(300) is None
    assert lengths == [300, 300, 300, 64, 32, 4]


def test_rate_limited_source_and_async_job():
    """A paced source: nothing is due at first, so the job runs for at
    least count / rate seconds; execute_async returns a running job."""
    env = _port_env({})
    rows = []
    (env.datagen(_numpy_gen, Schema(FIELDS), count=2048, rate_per_sec=8000,
                 timestamp_column="ts",
                 watermark_strategy=WatermarkStrategy
                 .for_monotonous_timestamps().with_timestamp_column("ts"))
        .key_by("auction").window(SlidingEventTimeWindows.of(5000, 1000))
        .device_aggregate([AggSpec("count", out_name="bids")],
                          capacity=1 << 10, ring_size=32)
        .add_sink(lambda b: rows.extend(b.iter_rows())))
    job = env.execute_async("paced")
    job.wait(60)
    assert job.wall_s >= 2048 / 8000 * 0.9
    assert job.records_in == 2048
    assert sum(r[3] for r in rows) == 2048 * 5   # 5 windows per event
