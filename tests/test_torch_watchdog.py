"""Port parity: the stall watchdog (flink_tpu_torch/runtime/watchdog.py)
and the bounded sites of the session and GROUP BY operators against
flink_tpu/runtime/watchdog.py and the reference operators.

* ``Watchdog.run`` relays results and exceptions, raises StallError past
  the deadline and counts the trip, and calls through directly when
  disabled or unbounded, as the reference's; the port's worker lives
  across calls of one thread, one per calling thread, a fresh one after
  an abandoned call, and exits after its owner thread.
* ``stall_bounded`` retries a stall in place up to
  ``watchdog.stall-retries`` times and visits its site as the reference's
  (same trips, retries and visits).
* A stall of the bounded region itself is never retried: the region is
  still running on the abandoned worker. A hang before the region
  starts sleeps on the caller's thread and is retried; a
  ``device.execute`` region runs on the caller's thread.
* ``configure`` reads the reference's keys and deadlines.
* ``TaskStallDetector.scan`` flags the same tasks as the reference's over
  the same scripted progress, cancels them and fails them into the job.
* ``run_job`` fails a job whose task stalls with queued input.
* The session and GROUP BY operators under transient and hang specs give
  the reference's rows and the same visits.

Tolerance: exact. The injector and the watchdog are process-global in
both packages: the autouse fixture resets them after every test. Timing:
injected hangs of seconds against deadlines of a quarter second, and a
sink that blocks until the detector has flagged it; no assertion depends
on how long real work takes.
"""

import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from flink_tpu.core.config import Configuration as RefConfiguration  # noqa: E402
from flink_tpu.core.records import RecordBatch as RefBatch  # noqa: E402
from flink_tpu.core.records import Schema as RefSchema  # noqa: E402
from flink_tpu.ops.hash_table import ensure_x64  # noqa: E402
from flink_tpu.runtime import faults as ref_faults  # noqa: E402
from flink_tpu.runtime import watchdog as ref_watchdog  # noqa: E402
from flink_tpu.runtime.harness import \
    OneInputOperatorTestHarness as RefHarness  # noqa: E402
from flink_tpu.runtime.operators import device_session as ref_ds  # noqa: E402
from flink_tpu.runtime.operators import device_window as ref_dw  # noqa: E402
from flink_tpu.sql.device_group_agg import \
    DeviceGroupAggOperator as RefGroupAgg  # noqa: E402
from flink_tpu.sql.group_agg import SqlAggSpec as RefSpec  # noqa: E402
from flink_tpu_torch.api import StreamExecutionEnvironment  # noqa: E402
from flink_tpu_torch.core import Configuration, Schema  # noqa: E402
from flink_tpu_torch.core.records import RecordBatch  # noqa: E402
from flink_tpu_torch.metrics import DEVICE_STATS  # noqa: E402
from flink_tpu_torch.runtime import faults as port_faults  # noqa: E402
from flink_tpu_torch.runtime import watchdog as port_watchdog  # noqa: E402
from flink_tpu_torch.runtime.harness import OneInputOperatorTestHarness  # noqa: E402
from flink_tpu_torch.runtime.operators import AggSpec, \
    DeviceSessionWindowOperator  # noqa: E402
from flink_tpu_torch.sql.device_group_agg import DeviceGroupAggOperator  # noqa: E402
from flink_tpu_torch.sql.group_agg import SqlAggSpec  # noqa: E402

ensure_x64()
PACKAGES = {"ref": (ref_faults, ref_watchdog, RefConfiguration),
            "port": (port_faults, port_watchdog, Configuration)}
KIND = "__rowkind__"


@pytest.fixture(autouse=True)
def _reset_both():
    for f, w, _c in PACKAGES.values():
        f.FAULTS.reset()
        w.WATCHDOG.reset()
    yield
    for f, w, _c in PACKAGES.values():
        f.FAULTS.reset()
        w.WATCHDOG.reset()


def _config(pkg: str, spec: str = "", **extra):
    conf = PACKAGES[pkg][2]()
    settings = dict(extra)
    if spec:
        settings.update({"faults.enabled": True, "faults.spec": spec})
    for k, v in settings.items():
        conf.set(k, v)
    return conf


def _arm(pkg: str, conf) -> None:
    faults, watchdog, _c = PACKAGES[pkg]
    faults.FAULTS.configure(conf)
    watchdog.WATCHDOG.configure(conf)


def test_run_relays_stalls_and_calls_through_alike():
    def trial(pkg):
        wd = PACKAGES[pkg][1].Watchdog()
        out = [wd.run("transfer.d2h", lambda: 7, deadline=5.0)]
        try:
            wd.run("transfer.d2h", lambda: 1 / 0, deadline=5.0)
        except ZeroDivisionError:
            out.append("relayed")
        gate = threading.Event()
        try:
            wd.run("transfer.d2h", gate.wait, deadline=0.25, scope="s")
        except PACKAGES[pkg][1].StallError as e:
            out.append((e.site, e.scope, e.deadline_s))
        gate.set()
        caller = threading.get_ident()
        out.append(wd.run("transfer.d2h", threading.get_ident,
                          deadline=0) == caller)
        wd.enabled = False
        out.append(wd.run("device.execute", threading.get_ident) == caller)
        out.append((wd.trips_total(), dict(wd.trips),
                    [e["site"] for e in wd.events]))
        return out

    assert trial("port") == trial("ref")


def test_worker_lives_per_thread_and_is_replaced_after_a_stall(monkeypatch):
    monkeypatch.setattr(port_watchdog, "_IDLE_CHECK_S", 0.02)
    wd = port_watchdog.Watchdog()
    ids = {wd.run("transfer.h2d", threading.get_ident) for _ in range(20)}
    assert len(ids) == 1 and wd.workers_started == 1 and wd.calls == 20
    assert threading.get_ident() not in ids
    # another calling thread gets its own worker
    other = []
    t = threading.Thread(target=lambda: other.append(
        wd.run("transfer.h2d", threading.get_ident)))
    t.start()
    t.join()
    assert wd.workers_started == 2 and other[0] not in ids
    # a stall abandons the worker: the next call runs on a fresh one
    gate = threading.Event()
    with pytest.raises(port_watchdog.StallError):
        wd.run("transfer.h2d", gate.wait, deadline=0.1)
    gate.set()
    fresh = wd.run("transfer.h2d", threading.get_ident)
    assert fresh not in ids and wd.workers_started == 3
    # the other thread's worker ends once its owner has
    deadline = time.monotonic() + 10
    while any(th.name == f"watchdog:{t.name}" and th.is_alive()
              for th in threading.enumerate()):
        assert time.monotonic() < deadline
        time.sleep(0.01)


def test_an_idle_worker_holds_nothing_of_its_last_call():
    """A worker waiting for the next call keeps no reference to the last
    one's function or result, which may hold a finished job's state."""
    import gc
    import weakref

    class State:
        pass

    wd = port_watchdog.Watchdog()
    state = State()
    ref = weakref.ref(state)
    assert wd.run("device.execute", lambda: state) is state
    del state
    gc.collect()
    assert ref() is None


def test_stall_bounded_equals_reference():
    cases = [("transfer.d2h=once@2!hang@5000", {}, 4),
             ("transfer.d2h=once@1!hang@5000", {"watchdog.stall-retries": 0},
              2),
             ("transfer.h2d=every@2", {}, 5),
             ("tier.evict=once@2!persistent", {}, 3)]
    for spec, extra, calls in cases:
        seen = []
        for pkg in PACKAGES:
            faults, watchdog, _c = PACKAGES[pkg]
            faults.FAULTS.reset()
            watchdog.WATCHDOG.reset()
            site = spec.split("=")[0]
            deadline_key = {"transfer.d2h": "watchdog.transfer-timeout",
                            "transfer.h2d": "watchdog.transfer-timeout",
                            "tier.evict": "watchdog.tier-timeout"}[site]
            _arm(pkg, _config(pkg, spec, **{deadline_key: 0.25, **extra}))
            ran, out = [], []
            for i in range(calls):
                try:
                    out.append(watchdog.stall_bounded(
                        site, lambda i=i: ran.append(i) or i, scope="t"))
                except watchdog.StallError:
                    out.append("stall")
                except faults.InjectedFault as e:
                    out.append(("fault", e.transient))
            seen.append((out, ran, watchdog.WATCHDOG.trips_total(),
                         faults.FAULTS.snapshot()["visits"]))
        assert seen[0] == seen[1], spec


def test_a_region_that_stalls_itself_runs_once_and_fails():
    _arm("port", _config("port", "transfer.h2d=once@1!hang@5000",
                         **{"watchdog.transfer-timeout": 0.25}))
    wd = port_watchdog.WATCHDOG
    retries0 = DEVICE_STATS.retries
    caller = threading.get_ident()
    # the hang sleeps on this thread before the region, then retries it
    ran = []
    assert port_watchdog.stall_bounded(
        "transfer.h2d", lambda: ran.append(threading.get_ident()) or 5) == 5
    assert len(ran) == 1 and ran[0] != caller
    assert wd.trips == {"transfer.h2d": 1}
    assert DEVICE_STATS.retries == retries0 + 1
    # the region itself blocks past the deadline: no retry, one run
    gate, started = threading.Event(), []

    def region():
        started.append(1)
        gate.wait()

    try:
        with pytest.raises(port_watchdog.StallError):
            port_watchdog.stall_bounded("transfer.h2d", region)
    finally:
        gate.set()
    assert started == [1] and wd.trips == {"transfer.h2d": 2}
    assert DEVICE_STATS.retries == retries0 + 1
    # a device.execute region stays on the caller's thread
    assert port_watchdog.stall_bounded("device.execute",
                                       threading.get_ident) == caller


def test_configure_reads_the_reference_keys():
    settings = {"watchdog.enabled": False,
                "watchdog.device.execute-timeout": 1.5,
                "watchdog.transfer-timeout": 2.5,
                "watchdog.checkpoint-timeout": 3.5,
                "watchdog.tier-timeout": 4.5, "watchdog.stall-retries": 3}
    wds = {}
    for pkg in PACKAGES:
        wd = PACKAGES[pkg][1].Watchdog()
        wd.configure(_config(pkg, **settings))
        wds[pkg] = wd
    port, ref = wds["port"], wds["ref"]
    assert (port.enabled, port.stall_retries) == (ref.enabled,
                                                  ref.stall_retries)
    for site, deadline in port.deadlines.items():
        assert deadline == ref.deadline_for(site), site
    fresh = (port_watchdog.Watchdog(), ref_watchdog.Watchdog())
    for site in fresh[0].deadlines:
        assert fresh[0].deadline_for(site) == fresh[1].deadline_for(site)


class _FakeTask:
    def __init__(self, pkg: str, pending: bool):
        self.progress = PACKAGES[pkg][1].TaskProgress()
        self.pending = pending
        self.is_alive = True
        self.cancelled = False

    def input_pending(self) -> bool:
        return self.pending

    def cancel(self) -> None:
        self.cancelled = True


class _FakeJob:
    def __init__(self, tasks: dict):
        self.tasks = tasks
        self._done = threading.Event()
        self.failed = []
        self.failure_history = []

    def task_failed(self, task_id, err) -> None:
        self.failed.append((task_id, type(err).__name__))


def test_task_stall_detector_equals_reference(monkeypatch):
    clock = [1000.0]
    for pkg in PACKAGES:
        monkeypatch.setattr(PACKAGES[pkg][1].time, "time", lambda: clock[0])
    rng = np.random.default_rng(5)
    script = [(rng.random(4) < 0.5, rng.random(4) < 0.6) for _ in range(30)]
    results = {}
    for pkg in PACKAGES:
        clock[0] = 1000.0
        tasks = {f"v{i}#0": _FakeTask(pkg, pending=bool(i % 2))
                 for i in range(4)}
        job = _FakeJob(tasks)
        det = PACKAGES[pkg][1].TaskStallDetector(job, stall_timeout=2.0)
        flagged = []
        for bump, pend in script:
            clock[0] += 0.75
            for (tid, t), b, p in zip(tasks.items(), bump, pend):
                t.pending = bool(p)
                if b:
                    t.progress.bump()
            flagged.append(det.scan())
        results[pkg] = (flagged, job.failed, det.detections,
                        [h["kind"] for h in job.failure_history],
                        {tid: t.cancelled for tid, t in tasks.items()})
    assert results["port"] == results["ref"]
    assert results["port"][2] > 0


def test_a_finished_job_leaves_no_detector_holding_its_state():
    """Once ``env.execute()`` has returned, the stall detector's thread
    has ended: the job's operators, and their device state, go with the
    job at the next collection (a detector not yet scheduled after its
    stop kept the whole job alive, a second copy of the state beside the
    next run's)."""
    import gc
    import weakref

    alive = 0
    for _ in range(5):
        env = StreamExecutionEnvironment(Configuration({
            "pipeline.micro-batch-size": 64, "task.stall-timeout": 30.0}),
            device="cpu")
        env.from_collection([(i % 7, i) for i in range(256)],
                            Schema([("k", np.int64), ("v", np.int64)]),
                            timestamps=list(range(256))).add_sink(
                                lambda b: None)
        job = env.execute("released")
        ref = weakref.ref(next(iter(job.tasks.values())))
        del env, job
        gc.collect()
        alive += ref() is not None
    assert alive == 0


def test_run_job_fails_a_task_stalled_with_queued_input():
    """A sink that does not return, in a task of its own: the stall
    detector fails it, and the job fails with a StallError."""
    gate = threading.Event()
    env = StreamExecutionEnvironment(Configuration({
        "pipeline.micro-batch-size": 4, "task.stall-timeout": 0.5,
        "pipeline.operator-chaining": False}), device="cpu")
    rows = [(i, i) for i in range(400)]
    env.from_collection(rows, Schema([("k", np.int64), ("v", np.int64)]),
                        timestamps=list(range(400))) \
        .add_sink(lambda b: gate.wait())
    stalls0 = DEVICE_STATS.stall_detections

    def release():
        # the sink returns once the detector has flagged it, so the
        # cancelled task can unwind
        while DEVICE_STATS.stall_detections == stalls0:
            time.sleep(0.01)
        gate.set()

    threading.Thread(target=release, daemon=True).start()
    try:
        with pytest.raises(RuntimeError, match="stalled past"):
            env.execute("stalled", timeout=120)
    finally:
        gate.set()
    assert DEVICE_STATS.stall_detections == stalls0 + 1
    kinds = [h["kind"] for h in env.last_job.failure_history] \
        if env.last_job is not None else None
    assert kinds is None or "stall-detected" in kinds


# -- the session and GROUP BY operators' bounded sites -----------------------
SESSION_FIELDS = [("k", np.int64), ("v", np.int64)]
SESSION_AGGS = [("sum", "v", "total"), ("count", None, "cnt")]


def _session_stream(seed: int):
    rng = np.random.default_rng(seed)
    ts = np.cumsum(rng.integers(0, 40, 480))
    keys = rng.integers(0, 12, 480)
    vals = rng.integers(1, 9, 480)
    batches = [(list(zip(keys[i:i + 60].tolist(), vals[i:i + 60].tolist())),
                ts[i:i + 60].tolist()) for i in range(0, 480, 60)]
    return batches, [int(ts[i + 59]) - 150 for i in range(0, 480, 60)]


def _session_run(pkg: str, spec: str, seed: int, extra: dict) -> tuple:
    faults = PACKAGES[pkg][0]
    conf = _config(pkg, spec, **extra)
    _arm(pkg, conf)
    if pkg == "ref":
        op = ref_ds.DeviceSessionWindowOperator(
            100, "k", [ref_dw.AggSpec(k, f, out_name=o)
                       for k, f, o in SESSION_AGGS], capacity=1 << 10,
            lanes=16)
        h = RefHarness(op, schema=RefSchema(SESSION_FIELDS), config=conf)
        Batch, schema = RefBatch, RefSchema(SESSION_FIELDS)
    else:
        op = DeviceSessionWindowOperator(
            100, "k", [AggSpec(k, f, out_name=o) for k, f, o in SESSION_AGGS],
            capacity=1 << 10, lanes=16, device="cpu")
        h = OneInputOperatorTestHarness(op, schema=Schema(SESSION_FIELDS),
                                        config=conf)
        Batch, schema = RecordBatch, Schema(SESSION_FIELDS)
    batches, wms = _session_stream(seed)
    for (rows, ts), wm in zip(batches, wms):
        h.process_batch(Batch.from_rows(schema, rows, ts))
        h.process_watermark(wm)
    h.process_watermark(1 << 40)
    h.close()
    rows = set()
    for b in h.output.batches:
        cols = [np.asarray(b.column(c)) for c in
                ("k", "window_start", "window_end", "total", "cnt")]
        rows.update(tuple(c[i].item() for c in cols) for i in range(b.n))
    return rows, faults.FAULTS.snapshot(), \
        [(e["site"], e["visit"]) for e in faults.FAULTS.events]


def test_session_operator_sites_equal_reference():
    cases = [("device.execute=p0.3,transfer.h2d=p0.2,transfer.d2h=every@2",
              {}),
             ("device.execute=once@3!hang@5000,transfer.d2h=once@2!hang@5000",
              {"watchdog.device.execute-timeout": 0.25,
               "watchdog.transfer-timeout": 0.25})]
    for spec, extra in cases:
        for seed in (0, 1):
            got = _session_run("port", spec, seed, extra)
            want = _session_run("ref", spec, seed, extra)
            assert got == want, (spec, seed)
            assert len(got[0]) > 20 and got[2]


GAGG_FIELDS = [("k", np.int64), ("v", np.int64), (KIND, np.int8)]
GAGG_AGGS = [("sum", "v", "s"), ("count", None, "c"), ("max", "v", "mx")]


def _gagg_run(pkg: str, spec: str, seed: int, extra: dict) -> tuple:
    faults = PACKAGES[pkg][0]
    conf = _config(pkg, spec, **extra)
    _arm(pkg, conf)
    if pkg == "ref":
        op = RefGroupAgg(["k"], [RefSpec(*a) for a in GAGG_AGGS],
                         capacity=16)
        h = RefHarness(op, RefSchema(GAGG_FIELDS), config=conf)
        Batch, schema = RefBatch, RefSchema(GAGG_FIELDS)
    else:
        op = DeviceGroupAggOperator(["k"], [SqlAggSpec(*a)
                                            for a in GAGG_AGGS],
                                    capacity=16, device="cpu")
        h = OneInputOperatorTestHarness(op, Schema(GAGG_FIELDS), config=conf)
        Batch, schema = RecordBatch, Schema(GAGG_FIELDS)
    rng = np.random.default_rng(seed)
    for t in range(8):
        cols = {"k": rng.integers(0, 30, 50), "v": rng.integers(1, 90, 50),
                KIND: np.where(rng.random(50) < 0.3, 1, 0).astype(np.int8)}
        h.process_batch(Batch(schema, cols, np.full(50, t, np.int64)))
    rows = [tuple(float(x) if isinstance(x, float) else int(x) for x in r)
            for b in h.output.batches for r in b.iter_rows()]
    return rows, faults.FAULTS.snapshot(), \
        [(e["site"], e["visit"]) for e in faults.FAULTS.events]


def test_group_agg_sites_equal_reference():
    cases = [("device.execute=p0.3,transfer.h2d=every@3,transfer.d2h=p0.3",
              {}),
             ("device.execute=once@4!hang@5000",
              {"watchdog.device.execute-timeout": 0.25})]
    for spec, extra in cases:
        for seed in (2, 3):
            got = _gagg_run("port", spec, seed, extra)
            want = _gagg_run("ref", spec, seed, extra)
            assert got == want, (spec, seed)
            assert len(got[0]) > 50 and got[2]
