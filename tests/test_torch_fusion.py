"""Port parity: the fusion certifier (flink_tpu_torch/graph/fusion.py) and
the fused source -> window chain (flink_tpu_torch/runtime/compiled.py)
against flink_tpu.

* ``certify`` gives the reference's certificate for every pipeline the
  port can build: per vertex the verdict, the categories of its
  operators, the certified runs and the ``lowered_prefix`` (by operator
  name), and the rule of each finding.
* A fused tiny Q5 emits the unfused run's rows byte for byte (and the
  reference's), with ``chain_fused_dispatches_total`` equal to the
  micro-batches, power-of-two tails included, as
  ``tests/test_fusion.py::test_fused_chain_byte_identical_and_one_dispatch``
  holds the reference.
* The deployer declines fusion only for the reference's gates, and
  records why on the job.
* The table grows under fusion with the rows unchanged.
* ``ingest_step`` with ``first_open`` in a device scalar (the form a CUDA
  graph replays) equals the by-value form.

The ``cuda``-marked tests run the chain on the card: one CUDA graph launch
and one ``ingest_step`` per micro-batch, a new capture when the table
grows, and the kernel's scalar-buffer form against the plain version.
The reference is imported by a fixture, so on a machine with PyTorch
alone the parity tests skip and the card tests run:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_fusion.py

Tolerance: exact (integer aggregates, integer state).
"""

import importlib.util
import pathlib
import types

import numpy as np
import pytest
import torch

from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches
from flink_tpu_torch.api import StreamExecutionEnvironment
from flink_tpu_torch.core import Configuration, Schema, WatermarkStrategy
from flink_tpu_torch.graph import build_job_graph, build_stream_graph
from flink_tpu_torch.graph.fusion import certify
from flink_tpu_torch.metrics import DEVICE_STATS
from flink_tpu_torch.ops.hash_table import EMPTY_KEY, ingest_step, \
    ingest_step_plain, make_table
from flink_tpu_torch.runtime.operators import AggSpec
from flink_tpu_torch.runtime.operators.base import OneInputOperator
from flink_tpu_torch.window import SlidingEventTimeWindows

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIELDS = [("auction", np.int64), ("price", np.int64), ("ts", np.int64)]
MULT = 0x9E3779B97F4A7C15
MIN_TIMESTAMP = -(1 << 62)
# tests/test_fusion.py's shape: 8 batches of 512, a 256 tail, a 16 tail
N, KEYS, BATCH = 4096 + 256 + 16, 257, 512


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _smoke()


@pytest.fixture(scope="module")
def ref():
    """The reference's modules."""
    pytest.importorskip("jax")
    from flink_tpu.api import StreamExecutionEnvironment as Env
    from flink_tpu.connectors.core import CollectSink
    from flink_tpu.core import WatermarkStrategy as WS
    from flink_tpu.core.records import Schema as RefSchema
    from flink_tpu.graph import fusion
    from flink_tpu.graph.stream_graph import build_job_graph as job
    from flink_tpu.graph.stream_graph import build_stream_graph as stream
    from flink_tpu.runtime.operators.device_window import AggSpec as Agg
    from flink_tpu.runtime.operators.simple import BatchFnOperator
    from flink_tpu.window import SlidingEventTimeWindows as Sliding

    return types.SimpleNamespace(
        Env=Env, CollectSink=CollectSink, WS=WS, Schema=RefSchema,
        fusion=fusion, build_job=job, build_stream=stream, Agg=Agg,
        BatchFn=BatchFnOperator, Sliding=Sliding)


def _numpy_gen(idx):
    u = idx.astype(np.uint64) * np.uint64(MULT)
    return {"auction": (u % np.uint64(KEYS)).astype(np.int64),
            "price": (idx % 997) + 1, "ts": (idx * 20_000) // N}


class _Stage(OneInputOperator):
    """A pass-through one-input operator: pure when declared traceable,
    host-effectful otherwise."""

    def process_batch(self, batch):
        self.output.emit(batch)


# -- the certificate -------------------------------------------------------------
def _pipeline(env, r, case, fused):
    """Build ``case`` on ``env``; ``r`` is the reference namespace or None
    for the port."""
    ws = (r.WS if r else WatermarkStrategy).for_monotonous_timestamps() \
        .with_timestamp_column("ts")
    device = case != "host_source"
    gen = _numpy_gen if (r or not device) else CS.q5_gen(KEYS, N, 20_000)
    s = env.datagen(gen, (r.Schema if r else Schema)(FIELDS), count=N,
                    timestamp_column="ts", watermark_strategy=ws,
                    device=device)
    if case == "rebalance_into_pure":
        s = s.rebalance()

    def stage(name, traceable):
        if r:
            return lambda: r.BatchFn(lambda b: b, name=name,
                                     traceable=traceable)
        return lambda: _Stage(name)

    if case in ("pure_stage", "opaque_stage", "rebalance_into_pure"):
        s = s.transform("PureStage", stage("PureStage", True),
                        traceable=True)
    if case == "opaque_stage":
        s = s.transform("OpaqueStage", stage("OpaqueStage", False))
    if case not in ("opaque_stage", "rebalance_into_pure"):
        agg = r.Agg if r else AggSpec
        s = (s.key_by("auction")
             .window((r.Sliding if r else SlidingEventTimeWindows)
                     .of(5000, 1000))
             .device_aggregate([agg("count", out_name="bids")],
                               capacity=1 << 10, ring_size=32,
                               defer_overflow=True))
    s.add_sink(r.CollectSink() if r else (lambda b: None), "Sink")


CERT_CASES = {
    "q5_fused": ({"pipeline.fusion.enabled": True}),
    "q5_unfused": ({}),
    "host_source": ({"pipeline.fusion.enabled": True}),
    "pure_stage": ({"pipeline.fusion.enabled": True}),
    "opaque_stage": ({"pipeline.fusion.enabled": True}),
    "rebalance_into_pure": ({"pipeline.fusion.enabled": True}),
    "chaining_disabled": ({"pipeline.fusion.enabled": True,
                           "pipeline.operator-chaining": False}),
    "parallelism_2": ({"pipeline.fusion.enabled": True,
                       "pipeline.parallelism": 2}),
}


def _cert_shape(cert, jg):
    names = {n.id: n.name for v in jg.vertices.values()
             for n in v.chained_nodes}
    return sorted(
        (c.name, c.parallelism, c.verdict,
         tuple(o.category for o in c.ops),
         tuple(tuple(names[i] for i in run) for run in c.certified),
         tuple(names[i] for i in c.lowered_prefix),
         tuple(f.rule for f in c.findings),
         tuple(f.symbol.split(":", 1)[1] for f in c.findings))
        for c in cert.chains)


@pytest.mark.parametrize("case", sorted(CERT_CASES))
def test_certificate_matches_reference(case, ref):
    settings = CERT_CASES[case]
    shapes = []
    for r in (ref, None):
        if r:
            env = r.Env()
            env.set_state_backend("tpu")
            for key, value in settings.items():
                env.config.set(key, value)
        else:
            env = StreamExecutionEnvironment(Configuration(settings),
                                             device="cpu")
        _pipeline(env, r, case, settings.get("pipeline.fusion.enabled"))
        if r:
            sg = r.build_stream(env._sinks, env.config)
            jg = r.build_job(sg, env.config, "job")
            saved = list(r.fusion.CERTIFICATE_LOG)
            cert = r.fusion.certify(sg, jg, env.config)
            r.fusion.CERTIFICATE_LOG.clear()   # leave the log as it was
            r.fusion.CERTIFICATE_LOG.extend(saved)
        else:
            sg = build_stream_graph(env._sinks, env.config)
            jg = build_job_graph(sg, env.config, "job")
            cert = certify(sg, jg, env.config)
        assert cert.fusion_enabled == bool(
            settings.get("pipeline.fusion.enabled"))
        shapes.append(_cert_shape(cert, jg))
    assert shapes[1] == shapes[0]
    lowered = [c[5] for c in shapes[0] if c[5]]
    want = {"q5_fused": [("DataGen", "DeviceWindowAgg")],
            "pure_stage": [("DataGen", "PureStage", "DeviceWindowAgg")]}
    assert lowered == want.get(case, [])
    rules = sorted(rule for c in shapes[0] for rule in c[6])
    assert rules == {"opaque_stage": ["PLAN601"],
                     "rebalance_into_pure": ["PLAN603"]}.get(case, [])


# -- the fused chain through env.execute() -----------------------------------------
def _run_q5(settings, device="cpu", capacity=1 << 12, defer=True,
            ts_column="ts", keys=KEYS, async_fire=True):
    # a watermark after every batch: fires (and growth) land between
    # batches whatever the speed of the machine
    env = StreamExecutionEnvironment(
        Configuration({"pipeline.micro-batch-size": BATCH,
                       "pipeline.auto-watermark-interval": 0, **settings}),
        device=device)
    ws = WatermarkStrategy.for_monotonous_timestamps() \
        .with_timestamp_column("ts")
    rows = (env.datagen(CS.q5_gen(keys, N, 20_000), Schema(FIELDS),
                        count=N, timestamp_column=ts_column,
                        watermark_strategy=ws, device=True)
            .key_by("auction")
            .window(SlidingEventTimeWindows.of(5000, 1000))
            .device_aggregate([AggSpec("count", out_name="bids",
                                       value_bits=31),
                               AggSpec("sum", "price", out_name="revenue")],
                              capacity=capacity, ring_size=32,
                              defer_overflow=defer, async_fire=async_fire)
            .execute_and_collect())
    return sorted(tuple(int(v) for v in r) for r in rows), env.last_job


def _dispatches(fn):
    before = DEVICE_STATS.snapshot()["chain_fused_dispatches_total"]
    out = fn()
    return out, DEVICE_STATS.snapshot()["chain_fused_dispatches_total"] \
        - before


def test_fused_rows_byte_identical_and_one_dispatch_per_micro_batch(ref):
    (unfused, job0), d0 = _dispatches(lambda: _run_q5({}))
    (fused, job1), d1 = _dispatches(
        lambda: _run_q5({"pipeline.fusion.enabled": True}))
    assert fused == unfused and len(fused) > 100
    assert d0 == 0 and d1 == N // BATCH + 2   # 8 full, one 256, one 16
    assert len(job0.job_graph.vertices) == 2
    assert len(job1.job_graph.vertices) == 1
    op = job1.operators[0]
    assert op.fused_chain is not None and op.fused_chain.captures == 0
    env = ref.Env()
    env.set_state_backend("tpu")
    env.config.set("pipeline.fusion.enabled", True)
    env.config.set("pipeline.micro-batch-size", BATCH)
    want = (env.datagen(_numpy_gen, ref.Schema(FIELDS), count=N,
                        timestamp_column="ts", device=True,
                        watermark_strategy=ref.WS.for_monotonous_timestamps()
                        .with_timestamp_column("ts"))
            .key_by("auction").window(ref.Sliding.of(5000, 1000))
            .device_aggregate([ref.Agg("count", out_name="bids",
                                       value_bits=31),
                               ref.Agg("sum", "price", out_name="revenue")],
                              capacity=1 << 12, ring_size=32,
                              defer_overflow=True, async_fire=True)
            .execute_and_collect())
    assert fused == sorted(tuple(int(v) for v in r) for r in want)


def test_fusion_declined_only_for_the_reference_gates():
    """Deferred overflow off, or a device source without a timestamp
    column: the chain runs unfused, the job says why, the rows are the
    same."""
    want, _job = _run_q5({})
    for kw, why in ((dict(defer=False), "deferred overflow is off"),
                    (dict(ts_column=None), "no device reader with a "
                                           "timestamp column")):
        (got, job), d = _dispatches(
            lambda kw=kw: _run_q5({"pipeline.fusion.enabled": True}, **kw))
        assert got == want
        assert d == 0
        (reason,) = job.fusion_declined.values()
        assert why in reason


def test_table_grows_under_fusion():
    """40 keys into 64 slots pass the 0.6 load bound: the table doubles at
    a fire between two batches (synchronous, so the growth lands before
    the next batch) while the fused chain folds, and the rows equal the
    unfused run's."""
    want, _job = _run_q5({}, capacity=64, keys=40, async_fire=False)
    (got, job), d = _dispatches(
        lambda: _run_q5({"pipeline.fusion.enabled": True}, capacity=64,
                        keys=40, async_fire=False))
    assert got == want
    assert job.operators[0].backend.capacity == 128
    assert d == N // BATCH + 2


def _step_case(seed, n=2048, cap=1 << 12, ring=8):
    rng = np.random.default_rng(seed)
    ts = torch.from_numpy(np.sort(rng.integers(0, 40_000, n)))
    keys = torch.from_numpy(rng.integers(-500, 500, n))
    price = torch.from_numpy(rng.integers(1, 1000, n))
    return ts, keys, price, cap, ring


def test_scalar_buffer_step_equals_by_value():
    """first_open from a 0-d int64 tensor (what a graph replay reads)
    against the int: the same table, planes, late and dropped counts,
    with rows behind first_open, in both the plain step and the
    wrapper."""
    for seed, first_open in ((1, MIN_TIMESTAMP), (2, 7), (3, 15), (4, 40)):
        ts, keys, price, cap, ring = _step_case(seed)
        out = []
        for step, fo in ((ingest_step_plain, first_open),
                         (ingest_step_plain, torch.tensor(first_open)),
                         (ingest_step, torch.tensor(first_open)),
                         (ingest_step, first_open)):
            table = make_table(cap, torch.device("cpu"))
            count = torch.zeros(ring, cap, dtype=torch.int32)
            rev = torch.zeros(ring, cap, dtype=torch.int64)
            late = torch.zeros((), dtype=torch.int64)
            dropped = torch.zeros((), dtype=torch.int64)
            step(table, [("count", count, None), ("sum", rev, price)], ts,
                 keys, 1000, 0, fo, late, dropped)
            out.append((table, count, rev, late, dropped))
        for other in out[1:]:
            for a, b in zip(out[0], other):
                assert torch.equal(a, b)
        assert (int(out[0][3]) > 0) == (first_open > 0)
    with pytest.raises(ValueError, match="first_open"):
        ingest_step(make_table(64, torch.device("cpu")),
                    [("count", torch.zeros(8, 64, dtype=torch.int32), None)],
                    ts, keys, 1000, 0, torch.tensor(3, dtype=torch.int32),
                    torch.zeros((), dtype=torch.int64),
                    torch.zeros((), dtype=torch.int64))


# -- on the card ----------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_fused_chain_is_one_graph_replay_per_micro_batch(card):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    want, _job = _run_q5({}, device=card)
    reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        (got, job), d = _dispatches(
            lambda: _run_q5({"pipeline.fusion.enabled": True}, device=card))
    assert got == want
    batches = N // BATCH + 2
    assert d == batches == KERNEL_LAUNCHES["ingest_step"]
    graph_launches = sum("cudaGraphLaunch" in e.name for e in prof.events()
                         if e.device_type == DeviceType.CPU)
    steps = sum("ingest_step_kernel" in e.name for e in prof.events()
                if e.device_type == DeviceType.CUDA)
    assert graph_launches == steps == batches
    # one graph per batch length: 512, 256 and 16
    assert job.operators[0].fused_chain.captures == 3


@pytest.mark.cuda
def test_growth_under_fusion_recaptures_on_the_card(card):
    want, _job = _run_q5({}, device=card, capacity=64, keys=40,
                         async_fire=False)
    (got, job), d = _dispatches(
        lambda: _run_q5({"pipeline.fusion.enabled": True}, device=card,
                        capacity=64, keys=40, async_fire=False))
    assert got == want
    assert d == N // BATCH + 2
    assert job.operators[0].backend.capacity == 128
    # the fire after the second batch grows the table: the 512-row graph
    # is captured anew, never replayed into freed memory
    assert job.operators[0].fused_chain.captures == 4


@pytest.mark.cuda
def test_scalar_buffer_kernel_equals_plain(card):
    for seed, first_open in ((1, MIN_TIMESTAMP), (3, 15), (4, 40)):
        ts, keys, price, cap, ring = _step_case(seed)
        out = []
        for step, fo in ((ingest_step_plain, first_open),
                         (ingest_step, torch.tensor(first_open,
                                                    device=card))):
            table = make_table(cap, card)
            count = torch.zeros(ring, cap, dtype=torch.int32, device=card)
            rev = torch.zeros(ring, cap, dtype=torch.int64, device=card)
            late = torch.zeros((), dtype=torch.int64, device=card)
            dropped = torch.zeros((), dtype=torch.int64, device=card)
            step(table, [("count", count, None), ("sum", rev, price.to(card))],
                 ts.to(card), keys.to(card), 1000, 0, fo, late, dropped)
            occupied = torch.nonzero(table != EMPTY_KEY).flatten()
            sorted_keys, order = torch.sort(table[occupied])
            slots = occupied[order]
            out.append((sorted_keys, count[:, slots], rev[:, slots], late,
                        dropped))
        for a, b in zip(*out):
            assert torch.equal(a, b)
