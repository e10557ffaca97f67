"""Port parity: causal tracing, the flight recorder and the Perfetto
export (flink_tpu_torch/metrics/tracing.py and the span sites) against
flink_tpu/metrics/tracing.py and its sites.

* The tracer's unit behaviour, case for case on both packages: nested
  spans share a tree, ``use_context`` adopts a foreign parent, a
  backwards end clamps, the bounded ring evicts and counts drops,
  ``configure`` applies ``traces.*``, the dump is rate-limited and the
  ring bounded, a transfer note is an H2D/D2H span, a verify failure
  dumps ``corrupt-artifact``, and ``chrome_trace_events`` of spans built
  from the same fixed dicts is the same JSON.
* A wire context written by one package parents a span in the other.
* A tiny Q5 with a savepoint mid-run, aligned and unaligned, in both
  packages: one ``Checkpoint`` root, Align, Snapshot, Store and Notify
  each parented on it, one Snapshot a task.
* The multiset of (scope, name, parent's scope and name) over a whole
  tiny Q5 run equals the reference's but for two named differences.
* A region restart, a stall and a supervisor restart each leave a dump
  whose tail holds their span.
* A traced tiny Q5 runs in a process where jax and flink_tpu cannot be
  imported, and its Perfetto export parses with every parent resolved.

Ids, timestamps and durations are not compared; names, attributes,
structure and counts are. The tracer, the flight recorder, DEVICE_STATS
and DEVICE_LEDGER are process-global in both packages: the autouse
fixture resets them (and the injector and watchdog) after every test and
points both flight recorders at the test's ``tmp_path``.
"""

import collections
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from flink_tpu.checkpoint.coordinator import \
    CheckpointCoordinator as RefCoordinator  # noqa: E402
from flink_tpu.cluster.scheduler import JobSupervisor as RefSupervisor  # noqa: E402
from flink_tpu.connectors.core import CollectSink as RefCollectSink  # noqa: E402
from flink_tpu.core.config import Configuration as RefConfiguration  # noqa: E402
from flink_tpu.metrics import device as ref_device  # noqa: E402
from flink_tpu.metrics import profiler as ref_profiler  # noqa: E402
from flink_tpu.metrics import tracing as ref_tracing  # noqa: E402
from flink_tpu.runtime import faults as ref_faults  # noqa: E402
from flink_tpu.runtime import watchdog as ref_watchdog  # noqa: E402
from flink_tpu_torch.checkpoint.coordinator import CheckpointCoordinator  # noqa: E402
from flink_tpu_torch.core import Configuration  # noqa: E402
from flink_tpu_torch.metrics import device as port_device  # noqa: E402
from flink_tpu_torch.metrics import profiler as port_profiler  # noqa: E402
from flink_tpu_torch.metrics import tracing as port_tracing  # noqa: E402
from flink_tpu_torch.runtime import faults as port_faults  # noqa: E402
from flink_tpu_torch.runtime import watchdog as port_watchdog  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_checkpoint as q5  # noqa: E402
import test_torch_failover as fo  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = {"tracing": ref_tracing, "device": ref_device,
       "profiler": ref_profiler, "faults": ref_faults,
       "watchdog": ref_watchdog, "Configuration": RefConfiguration}
PORT = {"tracing": port_tracing, "device": port_device,
        "profiler": port_profiler, "faults": port_faults,
        "watchdog": port_watchdog, "Configuration": Configuration}
SIDES = (REF, PORT)


def _reset(side, tmp_path=None):
    t = side["tracing"]
    t.TRACER.reset()
    t.TRACER.configure(side["Configuration"]())
    t.FLIGHT_RECORDER.dump_dir = str(tmp_path) if tmp_path else None
    side["device"].DEVICE_STATS.reset()
    side["device"].set_compile_tracer(None)
    side["profiler"].DEVICE_LEDGER.reset()
    side["profiler"].DEVICE_LEDGER.configure(side["Configuration"]())
    side["faults"].FAULTS.reset()
    side["watchdog"].WATCHDOG.reset()


@pytest.fixture(autouse=True)
def _clean(tmp_path):
    for side in SIDES:
        _reset(side, tmp_path)
    yield
    for side in SIDES:
        _reset(side)


def _shape(span) -> tuple:
    """A span without its ids and times."""
    return (span.scope, span.name, tuple(sorted(
        (k, repr(v)) for k, v in span.attributes.items())))


# -- the tracer's unit behaviour, case for case ---------------------------
def _nested(side, tmp_path):
    t = side["tracing"]
    mem = t.InMemoryTraceReporter()
    tr = t.Tracer([mem])
    with tr.span("unit", "Outer"):
        with tr.span("unit", "Inner"):
            pass
    (inner,), (outer,) = mem.by_name("Inner"), mem.by_name("Outer")
    return (inner.trace_id == outer.trace_id,
            inner.parent_id == outer.span_id, outer.parent_id,
            t.current_context(), [_shape(s) for s in mem.snapshot()])


def _use_context(side, tmp_path):
    t = side["tracing"]
    mem = t.InMemoryTraceReporter()
    with t.use_context(t.TraceContext("t" * 16, "s" * 16)):
        t.Tracer([mem]).span("unit", "Adopted").finish()
    (sp,) = mem.by_name("Adopted")
    return sp.trace_id, sp.parent_id, t.current_context()


def _clamp(side, tmp_path):
    t = side["tracing"]
    mem = t.InMemoryTraceReporter()
    sb = t.Tracer([mem]).span("unit", "Clamp")
    sp = sb.finish(end_ms=sb._start_ms - 500)
    again = sb.finish()          # a second finish reports nothing
    return (sp.end_ms == sp.start_ms, sp.duration_ms,
            len(mem.snapshot()), again.name,
            abs(t.now_ms() - time.time() * 1000.0) < 5000)


def _eviction(side, tmp_path):
    t = side["tracing"]
    mem = t.InMemoryTraceReporter(max_retained=8)
    tr = t.Tracer([mem])
    for i in range(20):
        tr.span("unit", "Evict").set_attribute("i", i).finish()
    return (len(mem.snapshot()), mem.dropped,
            side["device"].DEVICE_STATS.spans_dropped,
            [s.attributes["i"] for s in mem.snapshot()])


def _configure(side, tmp_path):
    t = side["tracing"]
    cfg = side["Configuration"]()
    for k, v in (("traces.enabled", False), ("traces.max-retained", 7),
                 ("traces.flight-recorder.capacity", 9),
                 ("traces.flight-recorder.dir", str(tmp_path)),
                 ("traces.flight-recorder.min-interval", 0.5)):
        cfg.set(k, v)
    t.TRACER.configure(cfg)
    t.TRACER.span("unit", "Dark").finish()
    dark = (t.TRACER.retained_spans(), t.FLIGHT_RECORDER.capacity,
            t.FLIGHT_RECORDER.dump_dir == str(tmp_path),
            t.FLIGHT_RECORDER.min_dump_interval_s, t.TRACER.enabled)
    t.TRACER.reset()
    t.TRACER.configure(side["Configuration"]())
    return dark, t.FLIGHT_RECORDER.capacity, t.FLIGHT_RECORDER.dump_dir


def _dump_rate_limit(side, tmp_path):
    t = side["tracing"]
    rec = t.FLIGHT_RECORDER
    rec.min_dump_interval_s = 10.0
    rec.set_capacity(4)
    for i in range(10):
        rec.record_event("tick", i=i)
    ring = [e["i"] for e in rec.snapshot()]
    first = t.dump_flight_recorder("unit-reason", job="j")
    second = t.dump_flight_recorder("unit-reason", job="j")
    with open(first) as f:
        payload = json.load(f)
    return (ring, first.startswith(str(tmp_path)), second,
            [(d["reason"], d["entry_count"], d["job"]) for d in rec.dumps],
            payload["reason"], payload["context"],
            [e.get("kind") for e in payload["entries"]],
            os.path.basename(first).split("-")[:3])


def _transfers(side, tmp_path):
    t, d = side["tracing"], side["device"]
    d.set_compile_tracer(t.TRACER)
    d.DEVICE_STATS.note_h2d(4096, records=512, ms=3.0)
    d.DEVICE_STATS.note_d2h(1024, records=64)
    spans = t.TRACER.retained_spans()
    return ([_shape(s) for s in spans], [s.duration_ms for s in spans],
            [s.parent_id for s in spans])


def _corrupt_artifact(side, tmp_path):
    t = side["tracing"]
    side["device"].DEVICE_STATS.note_verify_failure("aot.artifact")
    return [(x["reason"], x["scope"], x["path"].startswith(str(tmp_path)))
            for x in t.FLIGHT_RECORDER.dumps]


#: fixed span dicts: the same Span objects in both packages
FIXED = [
    dict(scope="checkpoint", name="Checkpoint", start_ms=1_000,
         end_ms=1_050, attributes={"checkpointId": 1, "savepoint": False},
         trace_id="a" * 16, span_id="b" * 16, parent_id=""),
    dict(scope="device", name="Execute", start_ms=1_010, end_ms=1_012,
         attributes={"scope": "device_window", "attempt": 0,
                     "obj": ("not", "primitive")},
         trace_id="a" * 16, span_id="c" * 16, parent_id="b" * 16),
    dict(scope="task", name="SourceBatch", start_ms=1_020, end_ms=1_019,
         attributes={"records": 8, "read_ms": 0.25},
         trace_id="d" * 16, span_id="e" * 16, parent_id=""),
]
COUNTERS = [{"ts_ms": 1_011, "site": "device_window.step", "ms": 0.123456},
            {"ts_ms": 1_030, "site": "transfer.d2h", "ms": 2}]


def _chrome(side, tmp_path):
    t = side["tracing"]
    spans = [t.Span(**d) for d in FIXED]
    return json.dumps(t.chrome_trace_events(spans, pid=3,
                                            counters=COUNTERS),
                      sort_keys=True)


UNIT_CASES = {"nested": _nested, "use_context": _use_context,
              "clamp": _clamp, "eviction": _eviction,
              "configure": _configure, "dump_rate_limit": _dump_rate_limit,
              "transfers": _transfers,
              "corrupt_artifact": _corrupt_artifact, "chrome": _chrome}


@pytest.mark.parametrize("case", sorted(UNIT_CASES))
def test_tracer_unit_cases_equal_reference(case, tmp_path):
    got = []
    for side in SIDES:
        _reset(side, tmp_path)
        got.append(UNIT_CASES[case](side, tmp_path))
    assert got[1] == got[0]


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_wire_context_crosses_packages(direction):
    src, dst = (PORT, REF) if direction == "port_to_reference" \
        else (REF, PORT)
    root = src["tracing"].TRACER.span("unit", "Root")
    wire = json.loads(json.dumps(root.context.to_wire()))
    assert set(wire) == {"trace_id", "span_id"}
    ctx = dst["tracing"].TraceContext.from_wire(wire)
    dst["tracing"].TRACER.span("unit", "Remote", parent=ctx).finish()
    root.finish()
    (remote,) = [s for s in dst["tracing"].TRACER.retained_spans()
                 if s.name == "Remote"]
    assert (remote.trace_id, remote.parent_id) == (
        root.context.trace_id, root.context.span_id)
    for side in SIDES:
        tc = side["tracing"].TraceContext
        assert tc.from_wire(None) is None
        assert tc.from_wire({"junk": 1}) is None


def test_span_inventory_is_the_references_less_the_cluster():
    ref = {(s, n) for s, n, _w in ref_tracing.SPAN_INVENTORY}
    port = [(s, n) for s, n, _w in port_tracing.SPAN_INVENTORY]
    cluster = {("ha", "Takeover"), ("net", "Fence"), ("net", "Reconnect"),
               ("sched", "Admit"), ("sched", "Shed")}
    assert port == sorted(port) and len(port) == 20
    assert set(port) == ref - cluster


# -- a checkpoint's tree ---------------------------------------------------
def _port_savepoint(settings: dict):
    env = q5._port_q5(settings, [], rate=q5.RATE)
    job = env.execute_async("trace-tree")
    coord = CheckpointCoordinator(job, env.config,
                                  tracer=port_tracing.TRACER)
    (src,) = job.source_tasks.values()
    deadline = time.time() + 10
    while src.records_in < 2 * q5.BATCH and time.time() < deadline:
        time.sleep(0.002)
    cp = coord.trigger_savepoint(timeout=30)
    job.wait(60)
    return cp.checkpoint_id, len(job.tasks)


def _ref_savepoint(settings: dict):
    sink = RefCollectSink()
    env = q5._ref_q5(sink, rate=q5.RATE)
    for k, v in settings.items():
        env.config.set(k, v)
    job = env.execute_async("trace-tree")
    coord = RefCoordinator(job, env.config, tracer=ref_tracing.TRACER)
    (src,) = job.source_tasks.values()
    deadline = time.time() + 10
    while src.reader._next < 2 * q5.BATCH and time.time() < deadline:
        time.sleep(0.002)
    cp = coord.trigger_savepoint(timeout=30)
    job.wait(60)
    return cp.checkpoint_id, len(job.tasks)


def _tree(spans, cid) -> dict:
    (root,) = [s for s in spans if s.name == "Checkpoint"
               and s.attributes.get("checkpointId") == cid]
    assert root.parent_id == ""
    tree = [s for s in spans if s.trace_id == root.trace_id]
    for s in tree:
        if s is not root:
            assert s.parent_id == root.span_id, (s.name, s.parent_id)
    names = collections.Counter(s.name for s in tree)
    snaps = [s.attributes["task"] for s in tree if s.name == "Snapshot"]
    return {"names": dict(names), "snapshot_tasks": len(set(snaps)),
            "root": _shape(root)[2]}


@pytest.mark.parametrize("mode", ["aligned", "unaligned"])
def test_checkpoint_forms_one_tree_as_reference(mode, tmp_path):
    settings = {"execution.checkpointing.unaligned": mode == "unaligned",
                "traces.flight-recorder.dir": str(tmp_path)}
    got = {}
    for name, run, tr in (("port", _port_savepoint, port_tracing),
                          ("ref", _ref_savepoint, ref_tracing)):
        cid, tasks = run(settings)
        tree = _tree(tr.TRACER.retained_spans(), cid)
        assert tree["snapshot_tasks"] == tree["names"]["Snapshot"] == tasks
        for n in ("Align", "Snapshot", "Store", "Notify"):
            assert tree["names"].get(n), (name, n, tree)
        got[name] = tree
    root = dict(got["port"].pop("root"))
    ref_root = dict(got["ref"].pop("root"))
    assert got["port"] == got["ref"]
    for k in ("checkpointId", "savepoint", "tasks"):
        assert root[k] == ref_root[k]


# -- a whole run's spans ---------------------------------------------------
#: (scope, name) pairs whose counts may differ from the reference's, and
#: why: the port's kernels are nvcc builds (none on the CPU) where the
#: reference compiles XLA programs; the port's device source makes each
#: batch on the device, where the reference's datagen uploads it
NAMED_DIFFERENCES = {("device", "Compile"): "nvcc build vs XLA compile",
                     ("device", "H2D"): "device source: no upload"}


def _multiset(spans) -> collections.Counter:
    by_id = {s.span_id: s for s in spans}
    out = collections.Counter()
    for s in spans:
        p = by_id.get(s.parent_id)
        out[(s.scope, s.name, (p.scope, p.name) if p else None)] += 1
    return out


def test_run_span_multiset_equals_reference_but_named(tmp_path):
    """An unpaced tiny Q5 run (its batches, steps, fires and drains) and
    the checkpoint spans of a savepoint taken mid-run: a paced source
    reads batches as they come due, which no two runs share, and an
    unpaced run ends before a checkpoint could complete."""
    settings = {"traces.flight-recorder.dir": str(tmp_path)}
    got = {}
    for name, side, savepoint in (("port", PORT, _port_savepoint),
                                  ("ref", REF, _ref_savepoint)):
        tr = side["tracing"].TRACER
        if name == "port":
            q5._port_q5(settings, []).execute("q5-traced")
        else:
            renv = q5._ref_q5(RefCollectSink())
            renv.config.set("traces.flight-recorder.dir", str(tmp_path))
            renv.execute("q5-traced")
        run = _multiset(tr.retained_spans())
        tr.reset()
        savepoint(settings)
        run.update(_multiset([s for s in tr.retained_spans()
                              if s.scope == "checkpoint"]))
        got[name] = run
    port, ref = ({k: v for k, v in got[n].items()
                  if k[:2] not in NAMED_DIFFERENCES} for n in ("port", "ref"))
    assert port == ref
    assert port[("checkpoint", "Snapshot", ("checkpoint", "Checkpoint"))] \
        == 2
    assert got["port"][("device", "H2D", None)] == 0 \
        < got["ref"][("device", "H2D", None)]
    assert got["port"][("device", "Compile", None)] == 0   # no nvcc here


# -- dumps at the fault chokepoints ----------------------------------------
def _tail_holds(path: str, scope: str, name: str, tail: int = 8) -> dict:
    with open(path) as f:
        payload = json.load(f)
    spans = [e for e in payload["entries"][-tail:]
             if e.get("type") == "span" and e.get("scope") == scope
             and e.get("name") == name]
    assert spans, f"the dump's tail holds no {scope}.{name}"
    return spans[-1]["attributes"]


def _stall(side, tmp_path):
    f, w, t = side["faults"].FAULTS, side["watchdog"], side["tracing"]
    f.configure_spec("device.execute=once@1!hang@200")
    with pytest.raises(w.StallError):
        w.WATCHDOG.run("device.execute", lambda: f.fire("device.execute"),
                       deadline=0.02, scope="unit")
    (dump,) = [d for d in t.FLIGHT_RECORDER.dumps if d["reason"] == "stall"]
    attrs = _tail_holds(dump["path"], "watchdog", "Stall")
    return dump["path"], {k: attrs[k] for k in ("site", "scope")}


def _restart(ref: bool, pipelines: int, tmp_path, reason: str):
    fo.SETTINGS["traces.flight-recorder.dir"] = str(tmp_path)
    try:
        fo._run(ref, "sink.invoke=once@9!persistent", pipelines)
    finally:
        del fo.SETTINGS["traces.flight-recorder.dir"]
    t = ref_tracing if ref else port_tracing
    return [d for d in t.FLIGHT_RECORDER.dumps if d["reason"] == reason]


@pytest.mark.parametrize("kind", ["stall", "region_restart",
                                  "supervisor_restart"])
def test_fault_leaves_a_dump_holding_its_span(kind, tmp_path):
    if kind == "stall":
        got = [_stall(side, tmp_path) for side in SIDES]
        assert got[1][1] == got[0][1] == {"site": "device.execute",
                                          "scope": "unit"}
        assert all(p.startswith(str(tmp_path)) for p, _a in got)
        return
    pipelines, reason, name = {
        "region_restart": (2, "region-restart", "RegionRestart"),
        "supervisor_restart": (1, "job-restart", "JobRestart")}[kind]
    ref_dumps = _restart(True, pipelines, tmp_path, reason)
    port_dumps = _restart(False, pipelines, tmp_path, reason)
    assert len(port_dumps) == len(ref_dumps) == 1
    assert port_dumps[0]["path"].startswith(str(tmp_path))
    with open(ref_dumps[0]["path"]) as f:
        assert json.load(f)["entries"]   # the reference's: a non-empty ring
    attrs = _tail_holds(port_dumps[0]["path"], "restart", name)
    assert attrs["job"] == "recover"
    # the reference reports its restart span too, after its dump
    assert [s.attributes["job"] for s in ref_tracing.TRACER.retained_spans()
            if s.name == name] == ["recover"]


# -- a traced run without jax ---------------------------------------------
_BLOCKED = """
import json, sys
sys.modules["jax"] = None
sys.modules["flink_tpu"] = None
sys.path.insert(0, {root!r})
import numpy as np
from flink_tpu_torch.api import StreamExecutionEnvironment
from flink_tpu_torch.core import Configuration, Schema, WatermarkStrategy
from flink_tpu_torch.metrics import DEVICE_LEDGER, TRACER, chrome_trace_events
from flink_tpu_torch.runtime.operators import AggSpec
from flink_tpu_torch.window import SlidingEventTimeWindows
N = 8192
def gen(idx):
    return {{"auction": idx * 7919 % 300, "price": idx % 997 + 1,
            "ts": idx * 16000 // N}}
env = StreamExecutionEnvironment(Configuration({{
    "pipeline.micro-batch-size": 1024, "profiler.enabled": True,
    "execution.checkpointing.interval": 0.05,
    "traces.flight-recorder.dir": {tmp!r}}}), device="cpu")
ws = WatermarkStrategy.for_monotonous_timestamps().with_timestamp_column("ts")
schema = Schema([("auction", np.int64), ("price", np.int64), ("ts", np.int64)])
(env.datagen(gen, schema, count=N, rate_per_sec=N / 0.8,
             timestamp_column="ts", watermark_strategy=ws, device=True)
    .key_by("auction").window(SlidingEventTimeWindows.of(5000, 1000))
    .device_aggregate([AggSpec("count", out_name="bids", value_bits=31),
                       AggSpec("sum", "price", out_name="revenue")],
                      capacity=1 << 10, ring_size=32, defer_overflow=True,
                      async_fire=True)
    .add_sink(lambda b: None, "Collect"))
env.execute("q5-blocked")
spans = TRACER.retained_spans()
doc = json.loads(json.dumps(chrome_trace_events(
    spans, counters=DEVICE_LEDGER.trace_counters())))
ids = {{e["args"]["span_id"] for e in doc["traceEvents"] if e["ph"] == "X"}}
parents = [e["args"]["parent_id"] for e in doc["traceEvents"]
           if e["ph"] == "X" and "parent_id" in e["args"]]
assert parents and all(p in ids for p in parents), parents
counters = sorted({{e["name"] for e in doc["traceEvents"] if e["ph"] == "C"}})
print(json.dumps({{"scopes": sorted({{s.scope for s in spans}}),
                  "counters": counters}}))
"""


def test_traced_q5_runs_without_jax_and_exports(tmp_path):
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED.format(
            root=str(ROOT), tmp=str(tmp_path))],
        capture_output=True, text=True, timeout=240, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["scopes"] == ["checkpoint", "device", "task"]
    assert "device_ms:device_window.step" in got["counters"]
