"""Port parity of iterations (``DataStream.iterate``, the graph's feedback
edges, ``FeedbackRecordWriter``, ``IterationGate``) and latency markers
(``metrics.latency.interval``, ``process_latency_marker``, the
``latency`` histograms of ``metrics/core.py``) against the reference, on
tests/test_iterations.py's five cases and tests/test_latency_markers.py's
two, the latter through the port's device window chain.

Iteration rows are compared as multisets (the loop's interleaving is the
host's); the loop's quiescence wait is 1 s or less. Marker counts depend
on the host's speed, so the markers are checked for reaching every
operator, never for a count or a latency.
"""

import time
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import flink_tpu.api as ref_api  # noqa: E402
import flink_tpu.connectors.core as ref_connectors  # noqa: E402
import flink_tpu.core as ref_core  # noqa: E402
import flink_tpu.core.elements as ref_el  # noqa: E402
import flink_tpu.core.functions as ref_fn  # noqa: E402
import flink_tpu.core.records as ref_rec  # noqa: E402
import flink_tpu.metrics.core as ref_metrics  # noqa: E402
import flink_tpu.runtime.operators.base as ref_base  # noqa: E402
import flink_tpu.runtime.operators.simple as ref_simple  # noqa: E402
import flink_tpu.window as ref_window  # noqa: E402
from flink_tpu.runtime.operators.device_window import \
    AggSpec as RefAggSpec, DeviceWindowAggOperator as RefDWA  # noqa: E402
import flink_tpu_torch.api as port_api  # noqa: E402
import flink_tpu_torch.core as port_core  # noqa: E402
import flink_tpu_torch.core.elements as port_el  # noqa: E402
import flink_tpu_torch.core.functions as port_fn  # noqa: E402
import flink_tpu_torch.core.records as port_rec  # noqa: E402
import flink_tpu_torch.metrics.core as port_metrics  # noqa: E402
import flink_tpu_torch.runtime.operators.base as port_base  # noqa: E402
import flink_tpu_torch.runtime.operators.simple as port_simple  # noqa: E402
import flink_tpu_torch.window as port_window  # noqa: E402
from flink_tpu_torch.runtime.operators import AggSpec  # noqa: E402
from flink_tpu_torch.runtime.operators.device_window import \
    DeviceWindowAggOperator  # noqa: E402
from flink_tpu_torch.runtime.operators.sink import \
    CollectSink as PortCollect  # noqa: E402

SIDES = {
    "ref": types.SimpleNamespace(
        api=ref_api, core=ref_core, el=ref_el, fn=ref_fn, rec=ref_rec,
        metrics=ref_metrics, base=ref_base, simple=ref_simple, w=ref_window,
        Agg=RefAggSpec, DWA=RefDWA, Collect=ref_connectors.CollectSink),
    "port": types.SimpleNamespace(
        api=port_api, core=port_core, el=port_el, fn=port_fn, rec=port_rec,
        metrics=port_metrics, base=port_base, simple=port_simple,
        w=port_window, Agg=AggSpec, DWA=DeviceWindowAggOperator,
        Collect=PortCollect),
}


def both(fn, *a, **kw):
    got = {name: fn(side, *a, **kw) for name, side in SIDES.items()}
    assert got["ref"] == got["port"], got
    return got["port"]


def env_of(side, batch: int = 16, checkpoint_s: float = 0.0):
    if side is SIDES["ref"]:
        env = side.api.StreamExecutionEnvironment()
    else:
        env = side.api.StreamExecutionEnvironment(device="cpu")
    env.set_parallelism(1)
    env.config.set("pipeline.micro-batch-size", batch)
    if checkpoint_s:
        env.config.set("execution.checkpointing.interval", checkpoint_s)
    return env


# -- iterations ---------------------------------------------------------------

def collatz_job(side, starts: list, max_wait_s: float = 1.0):
    sch = side.rec.Schema([("v", np.int64)])
    env = env_of(side)
    ds = env.from_collection([(n,) for n in starts], sch,
                             timestamps=[0] * len(starts))
    it = ds.iterate(max_wait_s=max_wait_s)

    def step(batch):
        v = batch.column("v")
        return side.rec.RecordBatch(
            sch, {"v": np.where(v % 2 == 0, v // 2, 3 * v + 1)},
            batch.timestamps)

    stepped = it.transform("collatz-step",
                           lambda: side.simple.BatchFnOperator(
                               step, "collatz-step"))
    it.close_with(stepped.filter(lambda row: row[0] != 1, name="loop"))
    sink = side.Collect()
    stepped.filter(lambda row: row[0] == 1, name="done").add_sink(sink,
                                                                  "sink")
    env.execute("collatz", timeout=60.0)
    return sorted(int(r[0]) for r in sink.rows)


def test_collatz_loop_brings_every_start_to_one():
    rng = np.random.default_rng(22)
    starts = [int(s) for s in rng.integers(2, 500, 40)]
    assert both(collatz_job, starts) == [1] * 40


def test_bounded_rounds_counted_in_the_record():
    def run(side):
        sch = side.rec.Schema([("v", np.int64), ("round", np.int64)])
        env = env_of(side)
        rows = [(i, 0) for i in range(1, 11)]
        ds = env.from_collection(rows, sch, timestamps=[0] * len(rows))
        it = ds.iterate(max_wait_s=1.0)

        def step(batch):
            return side.rec.RecordBatch(sch, {
                "v": batch.column("v") * 2,
                "round": batch.column("round") + 1}, batch.timestamps)

        stepped = it.transform("double", lambda: side.simple.BatchFnOperator(
            step, "double"))
        it.close_with(stepped.filter(lambda r: r[1] < 5, name="more"))
        sink = side.Collect()
        stepped.filter(lambda r: r[1] >= 5, name="exit").add_sink(sink, "s")
        env.execute("rounds", timeout=60.0)
        return sorted(int(r[0]) for r in sink.rows)

    assert both(run) == [i * 32 for i in range(1, 11)]


def test_head_ends_when_the_loop_drains():
    def run(side):
        sch = side.rec.Schema([("v", np.int64)])
        env = env_of(side)
        ds = env.from_collection([(1,), (2,)], sch, timestamps=[0, 0])
        it = ds.iterate(max_wait_s=0.3)
        it.close_with(it.filter(lambda r: False, name="drop-all"))
        sink = side.Collect()
        it.filter(lambda r: True, name="pass").add_sink(sink, "sink")
        t0 = time.time()
        env.execute("drain", timeout=30.0)
        return sorted(int(r[0]) for r in sink.rows), time.time() - t0 < 10

    assert both(run) == ([1, 2], True)


def test_an_unclosed_iteration_fails_loud():
    def run(side):
        sch = side.rec.Schema([("v", np.int64)])
        env = env_of(side)
        it = env.from_collection([(1,)], sch, timestamps=[0]).iterate()
        it.add_sink(side.Collect(), "s")
        with pytest.raises(ValueError, match="never closed"):
            env.execute("unclosed", timeout=10.0)
        return True

    assert both(run)


def test_an_iteration_refuses_periodic_checkpoints():
    def run(side):
        sch = side.rec.Schema([("v", np.int64)])
        env = env_of(side, checkpoint_s=0.1)
        it = env.from_collection([(4,)], sch, timestamps=[0]).iterate()
        body = it.filter(lambda r: r[0] > 1, name="f")
        it.close_with(body)
        body.add_sink(side.Collect(), "s")
        with pytest.raises(ValueError, match="checkpoint"):
            env.execute("ckpt-loop", timeout=10.0)
        return True

    assert both(run)


def test_feedback_edges_in_the_job_graph():
    def run(side):
        sch = side.rec.Schema([("v", np.int64)])
        env = env_of(side)
        it = env.from_collection([(4,)], sch, timestamps=[0]).iterate()
        body = it.filter(lambda r: r[0] > 1, name="f")
        it.close_with(body)
        body.add_sink(side.Collect(), "s")
        jg = env.get_job_graph("loop")
        edges = [(jg.vertices[e.source_vertex].name,
                  jg.vertices[e.target_vertex].name, e.feedback)
                 for e in jg.edges]
        heads = [v.name for v in jg.vertices.values()
                 if v.chained_nodes[0].iteration_head]
        return edges, heads

    # the head chains with nothing; the back edge never chains
    assert both(run) == ([("Collection", "iteration", False),
                          ("f", "iteration", True),
                          ("iteration", "f", False), ("f", "s", False)],
                         ["iteration"])


# -- latency markers ----------------------------------------------------------

LAT_N, LAT_SPAN = 20_000, 40_000


def _lat_gen(idx):
    return {"k": idx % 97, "v": (idx % 13) + 1,
            "ts": (idx * LAT_SPAN) // LAT_N}


def _all_ops(job):
    for task in job.tasks.values():
        chain = getattr(task, "chain", None)
        if chain is not None:
            yield from chain.operators


def test_markers_reach_the_sink_through_the_device_window_chain():
    def run(side):
        if side is SIDES["ref"]:
            env = side.api.StreamExecutionEnvironment()
        else:
            env = side.api.StreamExecutionEnvironment(device="cpu")
        env.set_state_backend("tpu")
        env.config.set("pipeline.micro-batch-size", 512)
        env.config.set("metrics.latency.interval", 1e-6)
        ws = side.core.WatermarkStrategy.for_monotonous_timestamps() \
            .with_timestamp_column("ts")
        sch = side.core.Schema([("k", np.int64), ("v", np.int64),
                                ("ts", np.int64)])
        sink = side.Collect()
        reg = side.metrics.MetricRegistry()
        (env.datagen(_lat_gen, sch, count=LAT_N, timestamp_column="ts",
                     watermark_strategy=ws)
            .key_by("k")
            .window(side.w.TumblingEventTimeWindows.of(4000))
            .device_aggregate([side.Agg("sum", "v", out_name="total")],
                              capacity=1 << 10, ring_size=32)
            .add_sink(sink, "s"))
        env.execute("latency-e2e", metrics_registry=reg)
        job = env.last_job
        windows = [o for o in _all_ops(job) if isinstance(o, side.DWA)]
        sinks = [o for o in _all_ops(job) if "Sink" in type(o).__name__]
        hists = {".".join(scope): m for scope, m in
                 reg.all_metrics().items()
                 if scope[-1] == "latency"
                 and isinstance(m, side.metrics.Histogram)}
        per_op = []
        for op in windows + sinks:
            hit = [m for name, m in hists.items() if op._op_key in name]
            per_op.append((op._op_key.split(":")[0], bool(hit),
                           sum(m.count for m in hit) > 0,
                           all(m.quantile(0.5) >= 0.0 for m in hit)))
        rows = sorted(tuple(int(x) for x in r) for r in sink.rows)
        return (bool(windows), bool(sinks),
                all(o.latency_markers_seen > 0 for o in windows + sinks),
                per_op, rows)

    got = both(run)
    assert got[:3] == (True, True, True)
    assert all(p[1:] == (True, True, True) for p in got[3])


def test_markers_walk_a_local_chain():
    def run(side):
        ident = side.simple.BatchFnOperator(lambda b: b, "ident")
        ident2 = side.simple.BatchFnOperator(lambda b: b, "ident2")
        ctx = side.base.OperatorContext(task_name="t", subtask_index=0,
                                        parallelism=1, max_parallelism=8)
        out = side.base.CollectingOutput()
        chain = side.base.OperatorChain([ident, ident2], ctx, out)
        chain.open()
        marker = side.el.LatencyMarker(time.time(), "src#0", 0)
        chain.process_latency_marker(marker)
        return (ident.latency_markers_seen, ident2.latency_markers_seen,
                out.latency_markers == [marker])

    assert both(run) == (1, 1, True)


def test_metric_registry_snapshot_of_a_job():
    def run(side):
        env = env_of(side, batch=64)
        env.config.set("metrics.latency.interval", 0.001)
        sch = side.rec.Schema([("v", np.int64)])
        reg = side.metrics.MetricRegistry()
        ds = env.from_collection([(i,) for i in range(500)], sch,
                                 timestamps=list(range(500)))
        ds.filter(lambda r: r[0] % 2 == 0, name="even") \
            .add_sink(side.Collect(), "s")
        env.execute("metrics", metrics_registry=reg)
        # the task scopes (job.vertex.subtask.name), without the
        # process-global device and profiler gauges both bind at the root
        snap = {k: v for k, v in reg.snapshot().items() if k.count(".") >= 3}
        names = sorted({k.split(".", 3)[-1] for k in snap})
        ins = sorted(v for k, v in snap.items()
                     if k.endswith("numRecordsIn"))
        return (names, ins,
                all(0 <= snap[k] <= 1000 for k in snap
                    if k.endswith("MsPerSecond")))

    names, ins, ratios = both(run)
    assert ins == [500] and ratios
    assert "numRecordsOut" in names and "busyTimeMsPerSecond" in names


# -- the smoke's runtime_io phase, tiny, without JAX --------------------------

_BLOCKED = """
import sys
sys.modules["jax"] = None
sys.modules["flink_tpu"] = None
sys.path.insert(0, {root!r})
import importlib.util, json
import torch
spec = importlib.util.spec_from_file_location("chip_smoke",
                                              {root!r} + "/chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
cs.fresh_memory = lambda torch: {{}}
torch.cuda.max_memory_allocated = lambda *a, **k: 0
cs.emit = lambda obj: None
q5 = {{"keys": 3000, "events": 1 << 15, "capacity": 1 << 13,
       "batch": 1 << 10, "topk": 20}}
sizes = {{"unaligned": dict(q5, paced_s=2.0, hold_batch=2,
                              trigger_batch=6),
          "alignment": q5,
          "changelog": {{"bids": 1 << 11, "auctions": 1 << 8,
                         "batch": 1 << 7, "paced_s": 1.5}},
          "iteration": {{"seeds": 1 << 10, "batch": 1 << 8}}}}
out = cs.runtime_io_phase(torch, torch.device("cpu"), sizes)
assert "jax" not in sys.modules or sys.modules["jax"] is None
a, b = out["unaligned"], out["alignment"]["aligned"]
print(json.dumps({{
    "inflight": a["unaligned"]["inflight_batches"],
    "aligned_inflight": a["aligned"]["inflight_batches"],
    "windows": a["restore_from_fs"]["windows_before_cancel"]
    + a["restore_from_fs"]["windows_after_restore"],
    "pauses": b["alignment_pauses"]["fast"],
    "markers": b["latency_markers"]["sink_saw"],
    "windows_b": b["windows_checked"],
    "changelog_rows": out["changelog"]["changelog"]["rows_before_cancel"]
    + out["changelog"]["changelog"]["rows_after_restore"],
    "hashmap_rows": out["changelog"]["hashmap"]["rows_before_cancel"]
    + out["changelog"]["hashmap"]["rows_after_restore"],
    "materializations": out["changelog"]["changelog"]["materializations"],
    "seeds": out["iteration"]["rows"]}}))
"""


def test_runtime_io_phase_runs_tiny_with_jax_and_flink_tpu_blocked():
    import json
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c",
                           _BLOCKED.format(root=str(root))],
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["inflight"] > 0 and got["aligned_inflight"] == 0
    assert got["windows"] == got["windows_b"] > 5
    assert got["pauses"] > 0 and got["markers"] > 0
    assert got["changelog_rows"] == got["hashmap_rows"] > 0
    assert got["materializations"] >= 1 and got["seeds"] == 1 << 10
