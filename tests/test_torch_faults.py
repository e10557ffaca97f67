"""Port parity: fault injection (flink_tpu_torch/runtime/faults.py, the
channel, writer, sink and checkpoint-storage sites) against
flink_tpu/runtime/faults.py and its sites, on the same specs, seeds and
scripted visit sequences.

* ``FaultRule.parse`` gives the reference's rules, and rejects what the
  reference rejects; the port rejects the sites it does not thread.
* The same spec and seed over the same visit sequence give the same trip
  log (site, visit, transient, poison, hang), visit and trip counts.
* ``configure`` is idempotent on an unchanged spec in both; suppression
  stops every trip; ``fire_with_retries`` absorbs the same transient trips.
* ``DeviceGuard`` gives the same retries, failures and stalls, and raises
  the same kind, under the same schedules; an injected hang is a stall.
  The port classifies only injected faults and stalls: a CUDA error (the
  port's kernel wrapper's) or a programming error propagates untouched in
  both packages. In the port the guard classifies only its own visit,
  before the dispatch: a fault or a stall the dispatch itself raises (a
  region nested in it) propagates untouched too, and the dispatch runs
  once (the reference retries it).
* The channel, writer and sink sites: a ``channel.backpressure`` trip
  loses nothing, a transient ``channel.send`` or ``sink.invoke`` trip is
  retried, a persistent one raises.
* Checkpoint storage: a ``checkpoint.write`` trip fails that store, and a
  ``checkpoint.corrupt`` or ``checkpoint.truncate`` chunk fails its digest
  at load.

Tolerance: exact (counts and logs). The injector and the watchdog are
process-global in both packages: the autouse fixture resets all four
after every test. Timing: injected hangs of seconds against deadlines of
a quarter second; no assertion depends on how long real work takes.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from flink_tpu.core.config import Configuration as RefConfiguration  # noqa: E402
from flink_tpu.runtime import faults as ref_faults  # noqa: E402
from flink_tpu.runtime import watchdog as ref_watchdog  # noqa: E402
from flink_tpu_torch.checkpoint.storage import CompletedCheckpoint, \
    CorruptArtifactError, FsCheckpointStorage, MemoryCheckpointStorage, \
    load_checkpoint  # noqa: E402
from flink_tpu_torch.core import Configuration, Schema  # noqa: E402
from flink_tpu_torch.core.elements import Watermark  # noqa: E402
from flink_tpu_torch.core.records import RecordBatch  # noqa: E402
from flink_tpu_torch.metrics import DEVICE_STATS  # noqa: E402
from flink_tpu_torch.runtime import faults as port_faults  # noqa: E402
from flink_tpu_torch.runtime import watchdog as port_watchdog  # noqa: E402
from flink_tpu_torch.runtime.channels import LocalChannel  # noqa: E402
from flink_tpu_torch.runtime.operators.sink import SinkOperator  # noqa: E402
from flink_tpu_torch.runtime.writer import ForwardPartitioner, \
    RecordWriter  # noqa: E402

PACKAGES = {"ref": (ref_faults, ref_watchdog, RefConfiguration),
            "port": (port_faults, port_watchdog, Configuration)}
#: sites both packages thread, and how each is visited
RAISING = ("device.execute", "transfer.h2d", "transfer.d2h", "channel.send",
           "checkpoint.write", "checkpoint.load", "sink.invoke",
           "tier.evict", "tier.prefetch")
DROP = ("channel.backpressure", "checkpoint.corrupt", "checkpoint.truncate")


@pytest.fixture(autouse=True)
def _reset_both():
    for f, w, _c in PACKAGES.values():
        f.FAULTS.reset()
        w.WATCHDOG.reset()
    yield
    for f, w, _c in PACKAGES.values():
        f.FAULTS.reset()
        w.WATCHDOG.reset()


def _config(pkg: str, spec: str, seed: int = 0, **extra):
    conf = PACKAGES[pkg][2]()
    for k, v in {"faults.enabled": True, "faults.seed": seed,
                 "faults.spec": spec, **extra}.items():
        conf.set(k, v)
    return conf


def _rule_fields(rule) -> tuple:
    return (rule.site, rule.mode, rule.at, rule.p, rule.transient,
            rule.poison, rule.hang_ms)


def test_rule_parsing_equals_reference():
    good = ["device.execute=once@3", "sink.invoke=once", "tier.evict=always",
            "transfer.d2h=every@4!persistent", "transfer.h2d=p0.25",
            "device.execute=once@2!poison", "device.execute=off",
            "checkpoint.write=once@1!persistent!transient",
            "device.execute=every@2!hang@40", " channel.send = p0 "]
    for entry in good:
        assert _rule_fields(port_faults.FaultRule.parse(entry)) == \
            _rule_fields(ref_faults.FaultRule.parse(entry)), entry
    bad = ["device.execute", "device.execute=sometimes",
           "device.execute=p1.5", "device.execute=every@0",
           "device.execute=once!bogus", "device.execute=once!hang@0",
           "nosuch.site=once"]
    for entry in bad:
        for mod in (port_faults, ref_faults):
            with pytest.raises(ValueError):
                mod.FaultRule.parse(entry)
    # sites the port does not thread are rejected, not silently ignored
    for site in ("rpc.heartbeat", "device.compile", "aot.load"):
        ref_faults.FaultRule.parse(f"{site}=once")
        with pytest.raises(ValueError, match="unknown fault site"):
            port_faults.FaultRule.parse(f"{site}=once")


def _visit_script(seed: int, n: int = 400) -> list:
    rng = np.random.default_rng(seed)
    sites = RAISING + DROP
    return [sites[i] for i in rng.integers(0, len(sites), n)]


def _replay(pkg: str, spec: str, seed: int, script: list) -> tuple:
    faults = PACKAGES[pkg][0]
    inj = faults.FaultInjector()
    inj.configure(_config(pkg, spec, seed))
    outcome = []
    for site in script:
        if site in DROP:
            outcome.append(inj.check(site))
            continue
        try:
            inj.fire(site)
            outcome.append(False)
        except faults.InjectedFault as e:
            outcome.append((e.site, e.visit, e.transient, e.poison))
    log = [(e["site"], e["visit"], e["transient"], e["poison"],
            e["hang_ms"]) for e in inj.events]
    snap = inj.snapshot()
    return outcome, log, snap["visits"], snap["trips"]


def test_trip_log_equals_reference_over_scripted_visits():
    specs = [
        "device.execute=p0.2,transfer.d2h=every@7,sink.invoke=once@5",
        "channel.backpressure=p0.5,checkpoint.corrupt=every@3,"
        "checkpoint.truncate=once@2",
        "device.execute=once@4!persistent,device.execute=every@9!poison,"
        "tier.evict=p0.1,tier.prefetch=always",
        "transfer.h2d=p0.05!persistent,channel.send=p0.3,"
        "checkpoint.write=once@1,checkpoint.load=every@2",
        "device.execute=off,transfer.d2h=off",
    ]
    for i, spec in enumerate(specs):
        for seed in (0, 7, 123):
            script = _visit_script(seed + i)
            got = _replay("port", spec, seed, script)
            assert got == _replay("ref", spec, seed, script), (spec, seed)
            if "off" not in spec:
                assert got[1], (spec, seed)


def test_hang_trips_log_and_return_alike():
    """A hang trip sleeps (briefly here) and reports nothing raised, in
    both packages, with the same log."""
    spec = "transfer.d2h=once@2!hang@5,channel.backpressure=once@1!hang@5"
    for pkg in PACKAGES:
        faults = PACKAGES[pkg][0]
        faults.FAULTS.configure(_config(pkg, spec))
        faults.FAULTS.fire("transfer.d2h")
        faults.FAULTS.fire("transfer.d2h")
        assert faults.FAULTS.check("channel.backpressure") is False
    logs = [[(e["site"], e["visit"], e["hang_ms"])
             for e in PACKAGES[p][0].FAULTS.events] for p in PACKAGES]
    assert logs[0] == logs[1] == [("transfer.d2h", 2, 5),
                                  ("channel.backpressure", 1, 5)]


def test_configure_is_idempotent_and_suppression_stops_trips():
    for pkg in PACKAGES:
        faults = PACKAGES[pkg][0]
        conf = _config(pkg, "sink.invoke=once@2!persistent")
        faults.FAULTS.configure(conf)
        faults.FAULTS.fire("sink.invoke")
        # a redeploy of the same job keeps its counters: no re-arm
        faults.FAULTS.configure(conf)
        with pytest.raises(faults.InjectedFault):
            faults.FAULTS.fire("sink.invoke")
        faults.FAULTS.configure(conf)
        faults.FAULTS.fire("sink.invoke")
        assert faults.FAULTS.snapshot()["visits"] == {"sink.invoke": 3}
        faults.FAULTS.configure(_config(pkg, "device.execute=always"))
        with faults.FAULTS.suppressed():
            faults.FAULTS.fire("device.execute")
        with pytest.raises(faults.InjectedFault):
            faults.FAULTS.fire("device.execute")
        faults.FAULTS.configure(_config(pkg, "device.execute=always",
                                        **{"faults.enabled": False}))
        faults.FAULTS.fire("device.execute")
        assert faults.FAULTS.enabled is False


def test_fire_with_retries_equals_reference():
    cases = [("transfer.d2h=every@2", 6), ("sink.invoke=once@1!persistent", 1),
             ("channel.send=always", 1), ("tier.evict=p0.5", 20),
             ("sink.invoke=once@2!poison", 3)]
    for spec, calls in cases:
        seen = []
        for pkg in PACKAGES:
            faults = PACKAGES[pkg][0]
            faults.FAULTS.reset()
            faults.FAULTS.configure(_config(pkg, spec, seed=3))
            site = spec.split("=")[0]
            out = []
            for _ in range(calls):
                try:
                    out.append(faults.fire_with_retries(site, scope="t"))
                except faults.InjectedFault as e:
                    out.append(("raised", e.transient, e.poison))
            seen.append((out, faults.FAULTS.snapshot()["visits"]))
        assert seen[0] == seen[1], spec


def _guard_trial(pkg: str, spec: str, calls: int, max_retries: int = 2,
                 deadline: float = 0.0) -> tuple:
    faults, watchdog, _c = PACKAGES[pkg]
    extra = {"device.failover.max-retries": max_retries,
             "device.failover.retry-backoff": 0.001,
             "device.failover.retry-backoff-max": 0.002}
    conf = _config(pkg, spec, seed=11, **extra)
    if deadline:
        conf.set("watchdog.device.execute-timeout", deadline)
    faults.FAULTS.configure(conf)
    watchdog.WATCHDOG.configure(conf)
    guard = faults.DeviceGuard("trial", conf)
    ran, out = [], []
    for i in range(calls):
        try:
            out.append(guard.run(lambda i=i: ran.append(i) or i))
        except faults.DeviceSegmentError as e:
            out.append(("segment", e.poison, type(e.cause).__name__))
    return (out, ran, guard.retries, guard.failures, guard.stalls,
            faults.FAULTS.snapshot()["visits"])


def test_device_guard_equals_reference():
    schedules = [("device.execute=every@3", 8), ("device.execute=p0.4", 12),
                 ("device.execute=once@2!persistent", 4),
                 ("device.execute=once@3!poison", 5),
                 ("device.execute=always", 2),
                 ("device.execute=every@2!persistent", 6)]
    for spec, calls in schedules:
        got = _guard_trial("port", spec, calls)
        assert got == _guard_trial("ref", spec, calls), spec
    # an injected hang past the deadline is a stall: retried, the hang
    # sleeps before the dispatch, which runs once, on the retry
    for spec, calls in (("device.execute=once@2!hang@5000", 3),
                        ("device.execute=always!hang@5000", 1)):
        got = _guard_trial("port", spec, calls, deadline=0.25)
        want = _guard_trial("ref", spec, calls, deadline=0.25)
        assert got == want, spec
        assert got[4] >= 1


def test_only_injected_faults_and_stalls_are_classified():
    """A CUDA error out of a kernel wrapper, or a programming error,
    propagates untouched: no retry, no DeviceSegmentError, in either
    package (the reference retries only its XLA runtime errors)."""
    errors = [RuntimeError("hash_table kernel launch failed: CUDA error: "
                           "an illegal memory access was encountered"),
              ValueError("bad shape"), KeyError("plane")]
    for err in errors:
        for pkg in PACKAGES:
            faults = PACKAGES[pkg][0]
            guard = faults.DeviceGuard("cls", None)

            def boom(err=err):
                raise err

            with pytest.raises(type(err)) as ei:
                guard.run(boom)
            assert ei.value is err
            assert (guard.retries, guard.failures) == (0, 0)
    # the port: what the dispatch raises is never classified, an injected
    # fault or a stall of a nested region included, with faults armed
    port_faults.FAULTS.configure(_config("port", "device.execute=every@99"))
    nested = [port_faults.InjectedFault("tier.evict", 1),
              port_faults.InjectedFault("tier.evict", 1, transient=False),
              port_watchdog.StallError("tier.evict", 0.05)]
    for err in nested:
        guard, ran = port_faults.DeviceGuard("cls", None), []

        def fold_then_raise(err=err):
            ran.append(1)
            raise err

        with pytest.raises(type(err)) as ei:
            guard.run(fold_then_raise)
        assert ei.value is err and ran == [1]
        assert (guard.retries, guard.failures, guard.stalls) == (0, 0, 0)


def test_inactive_guard_is_a_passthrough():
    for pkg in PACKAGES:
        faults = PACKAGES[pkg][0]
        faults.FAULTS.configure(_config(pkg, "device.execute=always"))
        guard = faults.DeviceGuard("off", None)
        guard.active = False
        assert guard.run(lambda: 5) == 5
        assert faults.FAULTS.snapshot()["visits"] == {}


def _batch(n: int, base: int = 0) -> RecordBatch:
    schema = Schema([("k", np.int64)])
    return RecordBatch(schema, {"k": np.arange(base, base + n)},
                       np.arange(base, base + n))


def test_channel_and_sink_sites():
    port_faults.FAULTS.configure(_config(
        "port", "channel.backpressure=every@2,channel.send=every@3"))
    ch = LocalChannel(64)
    w = RecordWriter([ch], ForwardPartitioner(), 0, put_timeout=0.001)
    retries0 = DEVICE_STATS.retries
    for i in range(6):
        w.emit(_batch(3, 3 * i))
    got = []
    while (e := ch.poll()) is not None:
        got.extend(e.column("k").tolist())
    assert got == list(range(18))        # nothing lost, nothing doubled
    assert DEVICE_STATS.retries - retries0 == 2
    assert port_faults.FAULTS.snapshot()["trips"]["channel.backpressure"] > 0
    # a persistent send trip raises out of the writer
    port_faults.FAULTS.configure(_config("port",
                                         "channel.send=once@1!persistent"))
    with pytest.raises(port_faults.InjectedFault):
        w.emit(_batch(1))
    # the sink: a transient trip retried, a persistent one raised
    port_faults.FAULTS.configure(_config(
        "port", "sink.invoke=once@1,sink.invoke=once@4!persistent"))
    seen = []
    op = SinkOperator(seen.append)
    from flink_tpu_torch.runtime.operators.base import CollectingOutput, \
        OperatorContext
    op.setup(OperatorContext("s", 0, 1, 128), CollectingOutput())
    op.open()
    op.process_batch(_batch(2))
    op.process_batch(_batch(2))
    with pytest.raises(port_faults.InjectedFault):
        op.process_batch(_batch(2))
    op.process_watermark(Watermark(5))
    assert len(seen) == 2


def _checkpoint(cid: int) -> CompletedCheckpoint:
    keys = np.arange(4096, dtype=np.int64)
    snap = {"kind": "tpu", "keys": keys,
            "key_groups": np.sort(keys % 128).astype(np.int64),
            "max_parallelism": 128,
            "states": {"acc": {"kind": "sum", "dtype": "int64", "ring": 0,
                               "values": keys * cid}}}
    return CompletedCheckpoint(cid, 0.0, {"v0#0": {"chain": {"0:w": {
        "keyed": {"backend": snap}}}}})


def test_checkpoint_storage_sites(tmp_path):
    port_faults.FAULTS.configure(_config(
        "port", "checkpoint.write=once@2!persistent"))
    mem = MemoryCheckpointStorage()
    mem.store(_checkpoint(1))
    with pytest.raises(port_faults.InjectedFault):
        mem.store(_checkpoint(2))
    mem.store(_checkpoint(3))
    for mutation in ("checkpoint.corrupt", "checkpoint.truncate"):
        port_faults.FAULTS.configure(_config("port", f"{mutation}=once@1"))
        fs = FsCheckpointStorage(str(tmp_path / mutation))
        cp = fs.store(_checkpoint(1))
        with pytest.raises(CorruptArtifactError):
            load_checkpoint(cp.external_path)
        port_faults.FAULTS.reset()
        # (a fresh directory: chunks are content-addressed, and a later
        # checkpoint would share the damaged one)
        cp2 = FsCheckpointStorage(str(tmp_path / f"{mutation}_ok")).store(
            _checkpoint(2))
        loaded = load_checkpoint(cp2.external_path)
        snap = loaded.task_snapshots["v0#0"]["chain"]["0:w"]["keyed"][
            "backend"]
        assert np.array_equal(snap["states"]["acc"]["values"],
                              np.arange(4096) * 2)
    # a load visits checkpoint.load once per attempt
    port_faults.FAULTS.configure(_config("port",
                                         "checkpoint.load=once@1!persistent"))
    with pytest.raises(port_faults.InjectedFault):
        load_checkpoint(cp2.external_path)
    assert load_checkpoint(cp2.external_path).checkpoint_id == 2
