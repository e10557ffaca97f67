"""Port parity: restart strategies, failover regions and the job
supervisor (flink_tpu_torch/cluster/failover.py, regions.py,
scheduler.py, ``env.execute(recover=True)``) against
flink_tpu/cluster/failover.py, regions.py and scheduler.py.

* Each restart strategy, made from the same configuration, gives the same
  ``can_restart`` and backoff over a scripted failure timeline (the clock
  monkeypatched in both packages).
* ``compute_regions``, ``affected_vertices`` and ``region_task_ids`` are
  equal on the same graphs, and on the job graphs both packages build for
  the same program.
* A job with a persistent ``sink.invoke`` fault, run with recovery, ends
  with the reference's windows, attempts and failure-history kinds: a
  whole-job restart from the latest verified checkpoint for a connected
  job, a region restart for a job of two disconnected pipelines. The
  port's two-phase sink shows every window once; the reference's sink
  repeats those fired between the checkpoint and the failure, so its
  rows are compared as a set.
* ``latest_verified_checkpoint`` walks past a checkpoint whose chunks
  fail their digests.
* The new modules run in a process where jax and flink_tpu cannot be
  imported.

Tolerance: exact (integer sums). The injector and the watchdog are
process-global in both packages: the autouse fixture resets them after
every test.
"""

import pathlib
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from flink_tpu.api import StreamExecutionEnvironment as RefEnv  # noqa: E402
from flink_tpu.cluster import failover as ref_failover  # noqa: E402
from flink_tpu.cluster import regions as ref_regions  # noqa: E402
from flink_tpu.cluster.scheduler import JobSupervisor as RefSupervisor  # noqa: E402
from flink_tpu.connectors.core import CollectSink as RefCollectSink  # noqa: E402
from flink_tpu.core.config import Configuration as RefConfiguration  # noqa: E402
from flink_tpu.core.records import Schema as RefSchema  # noqa: E402
from flink_tpu.ops.hash_table import ensure_x64  # noqa: E402
from flink_tpu.runtime import faults as ref_faults  # noqa: E402
from flink_tpu.runtime import watchdog as ref_watchdog  # noqa: E402
from flink_tpu.runtime.operators.device_window import \
    AggSpec as RefAggSpec  # noqa: E402
from flink_tpu.window import TumblingEventTimeWindows as RefTumbling  # noqa: E402
from flink_tpu_torch.api import StreamExecutionEnvironment  # noqa: E402
from flink_tpu_torch.checkpoint.coordinator import CheckpointCoordinator  # noqa: E402
from flink_tpu_torch.checkpoint.storage import CompletedCheckpoint, \
    CorruptArtifactError  # noqa: E402
from flink_tpu_torch.cluster import failover as port_failover  # noqa: E402
from flink_tpu_torch.cluster import regions as port_regions  # noqa: E402
from flink_tpu_torch.connectors.core import TransactionalCollectSink  # noqa: E402
from flink_tpu_torch.core import Configuration, Schema, \
    WatermarkStrategy  # noqa: E402
from flink_tpu_torch.runtime import faults as port_faults  # noqa: E402
from flink_tpu_torch.runtime import watchdog as port_watchdog  # noqa: E402
from flink_tpu_torch.runtime.operators import AggSpec  # noqa: E402
from flink_tpu_torch.window import TumblingEventTimeWindows  # noqa: E402

ensure_x64()
ROOT = pathlib.Path(__file__).resolve().parents[1]
FIELDS = [("k", np.int64), ("v", np.int64)]


@pytest.fixture(autouse=True)
def _reset_both():
    for f, w in ((ref_faults, ref_watchdog), (port_faults, port_watchdog)):
        f.FAULTS.reset()
        w.WATCHDOG.reset()
    yield
    for f, w in ((ref_faults, ref_watchdog), (port_faults, port_watchdog)):
        f.FAULTS.reset()
        w.WATCHDOG.reset()


# -- restart strategies -------------------------------------------------------
STRATEGIES = [
    {"restart-strategy.type": "none"},
    {"restart-strategy.type": "fixed-delay",
     "restart-strategy.fixed-delay.attempts": 3,
     "restart-strategy.fixed-delay.delay": 0.25},
    {"restart-strategy.type": "exponential-delay",
     "restart-strategy.exponential-delay.initial-backoff": 0.05,
     "restart-strategy.exponential-delay.max-backoff": 1.5},
    {},   # the default: exponential delay
    {"restart-strategy.type": "failure-rate",
     "restart-strategy.failure-rate.max-failures-per-interval": 2,
     "restart-strategy.failure-rate.failure-rate-interval": 10.0,
     "restart-strategy.failure-rate.delay": 0.5},
]


def _timeline(seed: int) -> list:
    """(seconds to advance, event) with events failure / recovered /
    query."""
    rng = np.random.default_rng(seed)
    kinds = ("failure", "failure", "recovered", "query")
    return [(float(rng.choice([0.5, 3.0, 20.0, 90.0])),
             kinds[int(rng.integers(0, 4))]) for _ in range(40)]


def test_restart_strategies_equal_reference(monkeypatch):
    clock = [10_000.0]
    for mod in (ref_failover, port_failover):
        monkeypatch.setattr(mod.time, "time", lambda: clock[0])
    for settings in STRATEGIES:
        for seed in (0, 1, 2):
            trace = {}
            for name, mod, conf in (
                    ("ref", ref_failover, RefConfiguration()),
                    ("port", port_failover, Configuration())):
                for k, v in settings.items():
                    conf.set(k, v)
                clock[0] = 10_000.0
                strat = mod.restart_strategy_from_config(conf)
                seen = [type(strat).__name__]
                for dt, event in _timeline(seed):
                    clock[0] += dt
                    if event == "failure":
                        strat.notify_failure()
                    elif event == "recovered":
                        strat.notify_recovered()
                    seen.append((strat.can_restart(),
                                 round(strat.backoff_seconds(), 9)))
                trace[name] = seen
            assert trace["port"] == trace["ref"], settings


# -- regions --------------------------------------------------------------------
def _graph(edges: list, n: int, par: dict) -> types.SimpleNamespace:
    vertices = {f"v{i}": types.SimpleNamespace(parallelism=par.get(i, 1))
                for i in range(n)}
    return types.SimpleNamespace(vertices=vertices, edges=[
        types.SimpleNamespace(source_vertex=f"v{a}", target_vertex=f"v{b}")
        for a, b in edges])


def _canon(regions) -> list:
    return sorted(sorted(r) for r in regions)


def test_regions_equal_reference():
    rng = np.random.default_rng(4)
    graphs = [_graph([], 1, {}), _graph([(0, 1), (1, 2)], 3, {1: 2}),
              _graph([(0, 1), (2, 3)], 4, {0: 2, 3: 3}),
              _graph([(0, 2), (1, 2), (3, 4), (5, 5)], 7, {})]
    for _ in range(12):
        n = int(rng.integers(2, 12))
        edges = [tuple(int(x) for x in rng.integers(0, n, 2))
                 for _ in range(int(rng.integers(0, n)))]
        graphs.append(_graph(edges, n, {i: int(rng.integers(1, 4))
                                        for i in range(n)}))
    for g in graphs:
        port = port_regions.compute_regions(g)
        assert _canon(port) == _canon(ref_regions.compute_regions(g))
        for v in g.vertices:
            failed = [f"{v}#0"]
            assert port_regions.affected_vertices(port, failed) == \
                ref_regions.affected_vertices(port, failed)
            vids = port_regions.affected_vertices(port, failed)
            assert sorted(port_regions.region_task_ids(g, vids)) == \
                sorted(ref_regions.region_task_ids(g, vids))
    # the job graphs of one program of two pipelines, from each package
    graphs = {}
    for ref in (True, False):
        env = RefEnv() if ref else StreamExecutionEnvironment(device="cpu")
        for i in range(2):
            _pipeline(env, ref, _data(i)[:10],
                      RefCollectSink() if ref else TransactionalCollectSink(),
                      f"src{i}")
        graphs[ref] = env.get_job_graph("regions")
    # (vertex ids count nodes across a process: compare by vertex name)
    named = {ref: sorted(sorted(graphs[ref].vertices[v].name for v in r)
                         for r in mod.compute_regions(graphs[ref]))
             for ref, mod in ((True, ref_regions), (False, port_regions))}
    assert named[False] == named[True] and len(named[False]) == 2


# -- the supervisor -------------------------------------------------------------
N, PANE, BATCH = 6000, 500, 200


def _data(seed: int):
    rng = np.random.default_rng(seed)
    return [(int(k), int(v)) for k, v in zip(rng.integers(0, 40, N),
                                              rng.integers(1, 9, N))]


SETTINGS = {"pipeline.micro-batch-size": BATCH,
            "execution.checkpointing.interval": 0.05,
            "restart-strategy.type": "fixed-delay",
            "restart-strategy.fixed-delay.attempts": 5,
            "restart-strategy.fixed-delay.delay": 0.01,
            "pipeline.auto-watermark-interval": 0.0}


def _pipeline(env, ref: bool, rows: list, sink, name: str):
    schema = (RefSchema if ref else Schema)(FIELDS)
    tumbling = RefTumbling if ref else TumblingEventTimeWindows
    agg = (RefAggSpec("sum", "v", out_name="s") if ref
           else AggSpec("sum", "v", out_name="s", dtype=torch.int64))
    (env.from_collection(rows, schema, timestamps=list(range(len(rows))),
                         name=name)
        .key_by("k").window(tumbling.of(PANE))
        .device_aggregate([agg], capacity=1 << 8, ring_size=8)
        .add_sink(sink))


def _windows(rows) -> list:
    return sorted((int(r[0]), int(r[2]), int(r[3])) for r in rows)


def _run(ref: bool, spec: str, pipelines: int):
    settings = {**SETTINGS, "faults.enabled": True, "faults.spec": spec}
    if ref:
        env = RefEnv()
        env.set_state_backend("tpu")
        env.config.set("state.backend.tpu.host-index", False)
        for k, v in settings.items():
            env.config.set(k, v)
        sinks = [RefCollectSink() for _ in range(pipelines)]
    else:
        env = StreamExecutionEnvironment(Configuration(settings),
                                         device="cpu")
        sinks = [TransactionalCollectSink() for _ in range(pipelines)]
    for i, sink in enumerate(sinks):
        _pipeline(env, ref, _data(i), sink, f"src{i}")
    if ref:
        sup = RefSupervisor(env.get_job_graph("recover"), env.config)
        sup.run(timeout=120.0)
    else:
        env.execute("recover", timeout=120.0, recover=True)
        sup = env.last_supervisor
    kinds = [h["kind"] for h in sup.failure_history]
    return [_windows(s.rows) for s in sinks], sup.attempt, kinds


def _expected(seed: int) -> list:
    out: dict = {}
    for t, (k, v) in enumerate(_data(seed)):
        end = (t // PANE + 1) * PANE
        out[(k, end)] = out.get((k, end), 0) + v
    return sorted((k, e, s) for (k, e), s in out.items())


@pytest.mark.parametrize("pipelines,restart", [(1, "restart"),
                                               (2, "region-restart")])
def test_recover_equals_reference(pipelines, restart):
    spec = "sink.invoke=once@9!persistent"
    port_rows, port_attempts, port_kinds = _run(False, spec, pipelines)
    ref_rows, ref_attempts, ref_kinds = _run(True, spec, pipelines)
    for i in range(pipelines):
        # the port's sink shows each window once, the reference's may
        # repeat the windows of the replayed stretch
        assert port_rows[i] == sorted(set(port_rows[i])) == _expected(i)
        assert sorted(set(ref_rows[i])) == port_rows[i]
    assert (port_attempts, port_kinds) == (ref_attempts, ref_kinds)
    assert port_kinds == ["task-failure", restart]
    assert port_attempts == (2 if restart == "restart" else 1)


def test_rescale_resplits_keyed_state_from_a_savepoint():
    """``JobSupervisor.rescale`` mid-run takes the window from one
    subtask to two: the savepoint's keyed state re-splits by key group
    (each new backend holds only keys of its range, together all of
    them), the source resumes where it was, and every window shows once
    with the oracle's sums."""
    import threading
    import time
    from flink_tpu_torch.cluster.scheduler import JobSupervisor
    from flink_tpu_torch.core.keygroups import hash_batch, \
        key_groups_for_hash_batch

    n = 20_000

    def gen(idx):
        return {"k": (idx * 7919) % 97, "v": idx % 5 + 1, "ts": idx}

    env = StreamExecutionEnvironment(Configuration({
        "pipeline.micro-batch-size": 250, "pipeline.auto-watermark-interval": 0,
        "execution.checkpointing.interval": 0.05}), device="cpu")
    sink = TransactionalCollectSink()
    schema = Schema([("k", np.int64), ("v", np.int64), ("ts", np.int64)])
    ws = WatermarkStrategy.for_monotonous_timestamps() \
        .with_timestamp_column("ts")
    (env.datagen(gen, schema, count=n, rate_per_sec=n / 1.5,
                 timestamp_column="ts", watermark_strategy=ws)
        .key_by("k").window(TumblingEventTimeWindows.of(PANE))
        .device_aggregate([AggSpec("sum", "v", out_name="s",
                                   dtype=torch.int64)],
                          capacity=1 << 8, ring_size=8)
        .add_sink(sink))
    jg = env.get_job_graph("rescale")
    (window,) = [v for v in jg.vertices.values() if v.kind != "source"]
    sup = JobSupervisor(jg, env.config, "cpu")
    done = []
    runner = threading.Thread(target=lambda: done.append(sup.run(120.0)))
    runner.start()
    while sup.coordinator is None or \
            sup.coordinator.latest_checkpoint() is None:
        assert runner.is_alive()
        time.sleep(0.001)
    sup.rescale({window.id: 2})
    runner.join(120)
    assert done and window.parallelism == 2 and sup.attempt == 1
    ops = [op for op in done[0].operators if hasattr(op, "backend")]
    assert len(ops) == 2
    seen = []
    for op in ops:
        kgr = op.backend.key_group_range
        t = op.backend.table.numpy()
        keys = t[t != np.iinfo(np.int64).max]
        groups = key_groups_for_hash_batch(hash_batch(keys), 128)
        assert ((groups >= kgr.start) & (groups <= kgr.end)).all()
        seen.extend(keys.tolist())
    assert len(seen) == len(set(seen))
    rows = sorted((int(r[0]), int(r[2]), int(r[3])) for r in sink.rows)
    want: dict = {}
    for i in range(n):
        key = (i * 7919 % 97, (i // PANE + 1) * PANE)
        want[key] = want.get(key, 0) + i % 5 + 1
    assert rows == sorted((k, e, v) for (k, e), v in want.items())


def test_latest_verified_checkpoint_walks_past_a_corrupt_one(tmp_path):
    job = types.SimpleNamespace(job_graph=types.SimpleNamespace(
        vertices={}), tasks={}, source_tasks={}, failure_history=[])
    coord = CheckpointCoordinator(job, Configuration({
        "execution.checkpointing.dir": str(tmp_path)}))
    keys = np.arange(2048, dtype=np.int64)
    for cid in (1, 2):
        snap = {"kind": "tpu", "keys": keys + cid * 10_000,
                "key_groups": np.sort(keys % 128),
                "max_parallelism": 128,
                "states": {"acc": {"kind": "sum", "dtype": "int64",
                                   "ring": 0, "values": keys * cid}}}
        cp = coord.storage.store(CompletedCheckpoint(
            cid, 0.0, {"v0#0": {"chain": {"0:w": {"keyed": {
                "backend": snap}}}}}))
        coord._completed.append(cp)
    assert coord.latest_verified_checkpoint().checkpoint_id == 2
    # damage the key pages of checkpoint 2 (its keys are its own)
    manifest = pickle.loads((tmp_path / "chk-2" / "_manifest.pkl")
                            .read_bytes())
    backend = manifest.task_snapshots["v0#0"]["chain"]["0:w"]["keyed"][
        "backend"]
    for ref in backend["keys"].pages:
        path = tmp_path / "chunks" / ref.digest
        data = bytearray(path.read_bytes())
        data[len(data) // 2] ^= 0x40
        path.write_bytes(bytes(data))
    assert coord.latest_verified_checkpoint().checkpoint_id == 1
    assert [e["kind"] for e in job.failure_history] == ["corrupt-artifact"]
    assert (tmp_path / "chk-2.corrupt").is_dir()
    coord._completed.clear()
    assert coord.latest_verified_checkpoint() is None
    coord._completed.append(cp)   # the quarantined one, nothing else
    with pytest.raises(CorruptArtifactError):
        coord.latest_verified_checkpoint()


_BLOCKED = """
import sys
sys.modules["jax"] = None
sys.modules["flink_tpu"] = None
sys.path.insert(0, {root!r})
import numpy as np, torch
from flink_tpu_torch.api import StreamExecutionEnvironment
from flink_tpu_torch.cluster import failover, regions, scheduler
from flink_tpu_torch.connectors.core import TransactionalCollectSink
from flink_tpu_torch.core import Configuration, Schema
from flink_tpu_torch.runtime import faults, watchdog
from flink_tpu_torch.runtime.operators import AggSpec
from flink_tpu_torch.window import TumblingEventTimeWindows
env = StreamExecutionEnvironment(Configuration({{
    "pipeline.micro-batch-size": 100, "execution.checkpointing.interval": 0.05,
    "faults.enabled": True, "faults.spec": "sink.invoke=once@3!persistent",
    "restart-strategy.type": "fixed-delay",
    "restart-strategy.fixed-delay.delay": 0.01}}), device="cpu")
sink = TransactionalCollectSink()
rows = [(i % 7, 1) for i in range(2000)]
(env.from_collection(rows, Schema([("k", np.int64), ("v", np.int64)]),
                     timestamps=list(range(2000)))
    .key_by("k").window(TumblingEventTimeWindows.of(250))
    .device_aggregate([AggSpec("sum", "v", out_name="s", dtype=torch.int64)],
                      capacity=64, ring_size=8)
    .add_sink(sink))
env.execute("blocked", recover=True)
sup = env.last_supervisor
windows = sorted((r[0], r[2], r[3]) for r in sink.rows)
assert len(windows) == len(set(windows)) == 56, windows
assert sum(w[2] for w in windows) == 2000
print("attempts", sup.attempt, "kinds", *[h["kind"] for h in sup.failure_history])
print("trips", watchdog.WATCHDOG.trips_total(), len(faults.FAULTS.events))
"""


def test_the_new_modules_run_with_jax_and_flink_tpu_blocked():
    out = subprocess.run([sys.executable, "-c",
                          _BLOCKED.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=240,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["attempts", "2", "kinds", "task-failure",
                                  "restart", "trips", "0", "1"]
