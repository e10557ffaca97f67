"""Port parity: the device-time ledger (flink_tpu_torch/metrics/profiler.py)
against flink_tpu/metrics/profiler.py.

* The same ``record`` / ``note_build`` calls, under the same thread-local
  dispatch context, give equal ``snapshot()`` and ``profile()`` in both
  packages: every field but the timestamps (``ts_ms`` and the EWMA rate
  derived from them) and the cost fields (the reference traces a jaxpr,
  the port reads the site's shape-only cost function).
* The recompile diff names the same changed dimension for the same
  builder arguments; ``configure`` applies the same keys and defaults and
  rejects what the reference rejects.
* The site inventory is sorted and unique, a subset of the reference's;
  each missing name is listed with its reason.
* A tiny Q5 run in both packages with ``profiler.enabled`` gives the same
  (job, operator, site) keys and dispatches (count + compiles, summed over
  shape signatures) at the step, the fire sites, ``state.reset_row`` and
  the transfer sites. Where a count cannot match the test says why: on
  the CPU the reference folds a batch through its native index
  (``device_window.native_fold``, uploading the batch: ``transfer.h2d``)
  where the port runs its step on the device batch; the reference's Q5
  fire ranks inside the fire program, so ``ops.pallas_topk`` is the
  port's alone.
* One batch through a window -> sink chain: the reference charges what
  the window dispatches after it emits to the sink, the port to the
  window (ROADMAP Queue 3, a kept difference); the tiny Q5's counts are
  compared with that charge moved.
* A disabled ledger records nothing; the CPU timing, the cost model and
  the context hop to the watchdog's worker behave as documented. The CUDA
  event timing runs on the card only (``cuda`` marker).

Tolerance: exact (counts, keys, fields); durations only where both sides
are given the same numbers.
"""

import importlib.util
import pathlib
import threading

import numpy as np
import pytest
import torch

from flink_tpu_torch.core import Configuration
from flink_tpu_torch.metrics import profiler as port_prof
from flink_tpu_torch.runtime.aot import AOT
from flink_tpu_torch.runtime.faults import FAULTS
from flink_tpu_torch.runtime.watchdog import WATCHDOG

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: reference sites with no port counterpart, and why
NOT_PORTED = {
    "device_window.native_fold": "the CPU fallback's native index, which "
                                 "the port does not have (ROADMAP Queue 2)",
    "sched.throttle": "the admission gate of multi-job isolation, left out "
                      "of the runtime's port",
}
#: per-entry fields compared across packages (timestamps and cost aside)
ENTRY_FIELDS = ("job", "operator", "site", "shape_signature", "count",
                "compiles", "self_ms", "compile_ms", "total_ms", "mean_ms",
                "p50_ms", "p95_ms", "max_ms", "ewma_ms", "bytes", "share")


@pytest.fixture
def ref():
    """The reference's profiler, config and watchdog (imports JAX)."""
    pytest.importorskip("jax")
    from flink_tpu.core import config as ref_config
    from flink_tpu.metrics import profiler as ref_prof
    from flink_tpu.runtime import watchdog as ref_watchdog
    return ref_prof, ref_config, ref_watchdog


@pytest.fixture(autouse=True)
def _reset():
    yield
    port_prof.DEVICE_LEDGER.reset()
    port_prof.DEVICE_LEDGER.enabled = False
    port_prof.clear_dispatch_context()
    AOT.reset()
    FAULTS.reset()
    WATCHDOG.reset()
    try:
        from flink_tpu.metrics.profiler import DEVICE_LEDGER, \
            clear_dispatch_context
        from flink_tpu.runtime.aot import AOT as REF_AOT
        from flink_tpu.runtime.faults import FAULTS as REF_FAULTS
        from flink_tpu.runtime.watchdog import WATCHDOG as REF_WATCHDOG
    except ImportError:
        return
    DEVICE_LEDGER.reset()
    DEVICE_LEDGER.enabled = False
    clear_dispatch_context()
    REF_AOT.reset()
    REF_FAULTS.reset()
    REF_WATCHDOG.reset()


def _ledgers(ref, settings: dict):
    ref_prof, ref_config, _w = ref
    r, p = ref_prof.DeviceLedger(), port_prof.DeviceLedger()
    rc = ref_config.Configuration()
    for k, v in {"profiler.enabled": True, **settings}.items():
        rc.set(k, v)
    r.configure(rc)
    p.configure(Configuration({"profiler.enabled": True, **settings}))
    return r, p


def _script(seed: int, n: int = 300) -> list:
    """A scripted call sequence: (context, call, args)."""
    rng = np.random.default_rng(seed)
    sites = ["device_window.step", "device_window.fire", "ops.pallas_topk",
             "transfer.d2h", "mesh.step"]
    ctxs = [("job-a", "0:Window"), ("job-b", "1:Session"), ("", "")]
    out = []
    for i in range(n):
        ctx = ctxs[rng.integers(len(ctxs))]
        site = sites[rng.integers(len(sites))]
        sig = f"(({int(rng.integers(1, 4)) * 1024},),)"
        if rng.random() < 0.1:
            out.append((ctx, "build", (site, f"k{i}", (
                int(rng.integers(1, 3)) * 64, ("int64", int(rng.integers(2))),
                bool(rng.integers(2))))))
        else:
            kind = "compile" if rng.random() < 0.05 else "dispatch"
            ms = float(rng.gamma(2.0, 0.5)) - (0.2 if rng.random() < 0.02
                                               else 0.0)
            extra = {}
            if rng.random() < 0.1:
                extra = {"job": "explicit", "operator": "op-x"}
            nbytes = int(rng.integers(0, 4096)) if site.startswith(
                "transfer.") else 0
            out.append((ctx, "record", (site, ms, sig, kind, nbytes, extra)))
    return out


def _builder(capacity, dtypes, donate=False):
    """A builder whose parameters the recompile diff names."""


def _replay(ledger, mod, script: list) -> None:
    for (job, op), call, args in script:
        mod.set_dispatch_context(job, op)
        if call == "build":
            site, key, (cap, dtypes, donate) = args
            ledger.note_build(site, key, _builder, (cap, dtypes),
                              {"donate": donate})
        else:
            site, ms, sig, kind, nbytes, extra = args
            ledger.record(site, ms, shape_sig=sig, kind=kind, nbytes=nbytes,
                          **extra)
    mod.clear_dispatch_context()


def _strip_profile(prof: dict) -> dict:
    return {"job": prof["job"], "enabled": prof["enabled"],
            "total_device_ms": prof["total_device_ms"],
            "total_compile_ms": prof["total_compile_ms"],
            "programs": [{k: r[k] for k in ENTRY_FIELDS}
                         for r in prof["programs"]],
            "operators": prof["operators"],
            "recompiles": [{k: v for k, v in r.items() if k != "ts_ms"}
                           for r in prof["recompiles"]]}


SETTINGS = {"defaults": {},
            "small_windows": {"profiler.reservoir": 8,
                              "profiler.recompile-history": 4,
                              "profiler.ewma-alpha": 0.5,
                              "profiler.trace-samples": 16}}


@pytest.mark.parametrize("case", sorted(SETTINGS))
def test_same_calls_give_the_reference_snapshot_and_profile(ref, case):
    r, p = _ledgers(ref, SETTINGS[case])
    script = _script(seed=len(case))
    _replay(r, ref[0], script)
    _replay(p, port_prof, script)
    assert p.snapshot() == r.snapshot()
    for job in (None, "job-a", "explicit", "nosuch"):
        for top in (3, 1000):
            assert _strip_profile(p.profile(job=job, top=top)) == \
                _strip_profile(r.profile(job=job, top=top))
    assert [(c["site"], c["ms"]) for c in p.trace_counters()] == \
        [(c["site"], c["ms"]) for c in r.trace_counters()]
    # the cost fields exist on every row (None without a cost source)
    for row in p.profile(top=1000)["programs"]:
        assert {"est_flops", "est_bytes", "est_ms",
                "achieved_vs_estimated"} <= set(row)
    p.reset()
    r.reset()
    assert p.snapshot() == r.snapshot()


def test_recompile_diff_names_the_same_dimension(ref):
    r, p = _ledgers(ref, {})
    calls = [((64, ("int64", 0)), {}), ((128, ("int64", 0)), {}),
             ((128, ("int32", 0)), {"donate": True}),
             ((64, ("int64", 1)), {"donate": False}),
             ((64, ("int64", 0), True), {})]
    for led, mod in ((r, ref[0]), (p, port_prof)):
        mod.set_dispatch_context("job", "op")
        for i, (args, kwargs) in enumerate(calls):
            led.note_build("device_window.step", f"key{i}", _builder, args,
                           kwargs)
        # an unbindable call falls back to positional names
        led.note_build("device_window.fire", "x", _builder, (1, 2, 3, 4), {})
        led.note_build("device_window.fire", "y", _builder, (1, 2, 5, 4), {})
    got = [{k: v for k, v in c.items() if k != "ts_ms"}
           for c in p.profile()["recompiles"]]
    want = [{k: v for k, v in c.items() if k != "ts_ms"}
            for c in r.profile()["recompiles"]]
    assert got == want
    assert got[0]["changed"] == ["capacity: 64 -> 128"]
    assert "dtypes[0]: 'int64' -> 'int32'" in got[1]["changed"]


def test_configure_applies_the_same_keys_and_defaults(ref):
    _rp, ref_config, _w = ref
    keys = {"profiler.enabled": ("ENABLED", True),
            "profiler.reservoir": ("RESERVOIR", 7),
            "profiler.recompile-history": ("RECOMPILE_HISTORY", 5),
            "profiler.ewma-alpha": ("EWMA_ALPHA", 0.75),
            "profiler.trace-samples": ("TRACE_SAMPLES", 9),
            "profiler.cost-model.gflops": ("COST_GFLOPS", 123.0),
            "profiler.cost-model.gbps": ("COST_GBPS", 3350.0)}
    from flink_tpu_torch.core.config import DEFAULTS, AotOptions, \
        ProfilerOptions, WatchdogOptions
    for key, (attr, _v) in keys.items():
        assert getattr(ProfilerOptions, attr) == key
        opt = getattr(ref_config.ProfilerOptions, attr)
        assert opt.key == key and opt.default == DEFAULTS[key]
    for cls, rcls in ((AotOptions, ref_config.AotOptions),
                      (WatchdogOptions, None)):
        for attr in [a for a in vars(cls) if a.isupper()]:
            opt = getattr(rcls or ref_config.WatchdogOptions, attr)
            assert opt.key == getattr(cls, attr)
            assert opt.default == DEFAULTS[opt.key]
    r, p = _ledgers(ref, {k: v for k, (_a, v) in keys.items()})
    for attr in ("enabled", "reservoir", "recompile_history", "ewma_alpha",
                 "trace_samples", "cost_gflops", "cost_gbps"):
        assert getattr(p, attr) == getattr(r, attr), attr
    assert p._samples.maxlen == r._samples.maxlen == 9
    assert p._recompiles.maxlen == r._recompiles.maxlen == 5
    # a value neither package can parse raises in both
    for key in ("profiler.reservoir", "profiler.ewma-alpha",
                "watchdog.device.compile-timeout",
                "aot.in-memory-max-programs"):
        rc = ref_config.Configuration()
        rc.set(key, "not-a-number")
        opt = next(o for c in (ref_config.ProfilerOptions,
                               ref_config.AotOptions,
                               ref_config.WatchdogOptions)
                   for o in vars(c).values()
                   if getattr(o, "key", None) == key)
        with pytest.raises(ValueError):
            rc.get(opt)
        with pytest.raises(ValueError):
            Configuration({key: "not-a-number"})


def test_inventory_is_sorted_unique_and_a_subset_of_the_reference(ref):
    names = [s for s, _w in port_prof.LEDGER_SITE_INVENTORY]
    assert names == sorted(names) and len(set(names)) == len(names)
    ref_names = {s for s, _w in ref[0].LEDGER_SITE_INVENTORY}
    assert set(names) <= ref_names
    assert ref_names - set(names) == set(NOT_PORTED)
    for _site, where in port_prof.LEDGER_SITE_INVENTORY:
        cited = where.split()[0]
        assert (ROOT / "flink_tpu_torch" / cited).is_file(), cited


# -- a tiny Q5 in both packages ------------------------------------------------
N_EVENTS, N_KEYS, SPAN, BATCH = 8192, 300, 16_000, 1024
MULT = 0x9E3779B97F4A7C15


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _numpy_gen(idx):
    u = idx.astype(np.uint64) * np.uint64(MULT)
    return {"auction": (u % np.uint64(N_KEYS)).astype(np.int64),
            "price": (idx % 997) + 1, "ts": (idx * SPAN) // N_EVENTS}


def _q5(ref_pkg: bool, settings: dict):
    """Q5 with a top-10 fire through env.execute() in one package."""
    fields = [("auction", np.int64), ("price", np.int64), ("ts", np.int64)]
    if ref_pkg:
        from flink_tpu.api import StreamExecutionEnvironment as Env
        from flink_tpu.core import Schema, WatermarkStrategy
        from flink_tpu.runtime.operators.device_window import AggSpec
        from flink_tpu.window import SlidingEventTimeWindows
        env = Env()
        env.set_state_backend("tpu")
        env.config.set("pipeline.micro-batch-size", BATCH)
        for k, v in settings.items():
            env.config.set(k, v)
        gen = _numpy_gen
    else:
        from flink_tpu_torch.api import StreamExecutionEnvironment as Env
        from flink_tpu_torch.core import Schema, WatermarkStrategy
        from flink_tpu_torch.runtime.operators import AggSpec
        from flink_tpu_torch.window import SlidingEventTimeWindows
        env = Env(Configuration({"pipeline.micro-batch-size": BATCH,
                                 **settings}), device="cpu")
        gen = _smoke().q5_gen(N_KEYS, N_EVENTS, SPAN)
    ws = WatermarkStrategy.for_monotonous_timestamps() \
        .with_timestamp_column("ts")
    rows = (env.datagen(gen, Schema(fields), count=N_EVENTS,
                        timestamp_column="ts", watermark_strategy=ws,
                        device=True)
            .key_by("auction")
            .window(SlidingEventTimeWindows.of(5000, 1000))
            .device_aggregate([AggSpec("count", out_name="bids",
                                       value_bits=31),
                               AggSpec("sum", "price", out_name="revenue")],
                              capacity=1 << 10, ring_size=32, emit_topk=10,
                              defer_overflow=True, async_fire=True)
            .execute_and_collect("q5-ledger"))
    return rows


def _dispatches(profile: dict) -> dict:
    out: dict = {}
    for r in profile["programs"]:
        k = (r["job"], r["operator"], r["site"])
        out[k] = out.get(k, 0) + r["count"] + r["compiles"]
    return out


def _charge_sink_work_to_window(dispatches: dict,
                                sink: str = "1:Collect",
                                window: str = "0:DeviceWindowAgg") -> dict:
    """The reference's dispatch counts with what it charged to the sink
    moved to the window (a sink dispatches no device work of its own)."""
    out: dict = {}
    for (job, op, site), n in dispatches.items():
        k = (job, window if op == sink else op, site)
        out[k] = out.get(k, 0) + n
    return out


@pytest.mark.parametrize("incremental", [False, True])
def test_tiny_q5_gives_the_reference_sites_and_counts(ref, incremental):
    from flink_tpu.metrics.profiler import DEVICE_LEDGER as REF_LEDGER
    settings = {"profiler.enabled": True,
                "window.fire.incremental": incremental}
    ref_rows = _q5(True, settings)
    port_rows = _q5(False, settings)
    assert len(port_rows) == len(ref_rows)
    got = _dispatches(port_prof.DEVICE_LEDGER.profile(top=10_000))
    want = _dispatches(REF_LEDGER.profile(top=10_000))
    # the CPU reference folds a batch through its native index (and
    # uploads it for that); the port steps the device batch in place
    for (job, op, site), n in list(want.items()):
        if site == "device_window.native_fold":
            del want[(job, op, site)]
            k = (job, op, "device_window.step")
            want[k] = want.get(k, 0) + n
    want = {k: n for k, n in want.items() if k[2] != "transfer.h2d"}
    # the reference charges the window's device work after an emit to the
    # chained sink (the sink's context stays pinned); the port gives the
    # pin back to the window (ROADMAP Queue 3, a kept difference): the
    # same sites and counts, every one the window's
    want = _charge_sink_work_to_window(want)
    # the reference's Q5 fire ranks inside its fire program: the select
    # site is the port's alone (one a fire)
    selects = {k: n for k, n in got.items() if k[2] == "ops.pallas_topk"}
    got = {k: n for k, n in got.items() if k[2] != "ops.pallas_topk"}
    assert got == want
    fire = "device_window.fire_inc" if incremental else "device_window.fire"
    fires = sum(n for k, n in got.items() if k[2] == fire)
    assert sum(selects.values()) == fires > 0
    assert {k[2] for k in got} >= {"device_window.step", fire,
                                   "state.reset_row", "transfer.d2h"}
    # every kernel site carries its shape-only cost
    for row in port_prof.DEVICE_LEDGER.profile(top=10_000)["programs"]:
        if not row["site"].startswith("transfer."):
            assert row["est_bytes"] > 0 and row["est_ms"] > 0, row


def test_fused_q5_times_one_chain_step_a_micro_batch(ref):
    from flink_tpu.metrics.profiler import DEVICE_LEDGER as REF_LEDGER
    settings = {"profiler.enabled": True, "pipeline.fusion.enabled": True}
    assert len(_q5(False, settings)) == len(_q5(True, settings))
    got = _dispatches(port_prof.DEVICE_LEDGER.profile(top=10_000))
    want = _charge_sink_work_to_window(
        _dispatches(REF_LEDGER.profile(top=10_000)))
    steps = {k: n for k, n in got.items() if k[2] == "chain.fused_step"}
    assert steps == {k: n for k, n in want.items()
                     if k[2] == "chain.fused_step"}
    assert sum(steps.values()) == N_EVENTS // BATCH
    # the CPU chain runs eagerly: no graph is captured, so no prelude
    # marker (the card records one a capture)
    assert not any(k[2] == "chain.fused_prelude" for k in got)
    assert any(k[2] == "chain.fused_prelude" for k in want)


def test_a_window_keeps_the_device_work_it_dispatches_after_an_emit(ref):
    """ROADMAP Queue 3, a kept difference: one batch through a window ->
    sink chain in both packages, the window dispatching once after it
    emits. The reference's chained call leaves the sink pinned, so the
    dispatch is charged to the sink; the port's gives the pin back, so it
    is the window's."""
    from flink_tpu.core.config import Configuration as RefConfiguration
    from flink_tpu.core.records import RecordBatch as RefBatch
    from flink_tpu.core.records import Schema as RefSchema
    from flink_tpu.runtime.operators import base as ref_base
    from flink_tpu_torch.core.records import RecordBatch, Schema
    from flink_tpu_torch.runtime.operators import base as port_base
    ref_prof = ref[0]
    charged = {}
    for side, base, prof, conf, batch_cls, schema_cls in (
            ("ref", ref_base, ref_prof, RefConfiguration, RefBatch,
             RefSchema),
            ("port", port_base, port_prof, Configuration, RecordBatch,
             Schema)):
        config = conf()
        config.set("profiler.enabled", True)
        prof.DEVICE_LEDGER.configure(config)
        ledger = prof.DEVICE_LEDGER

        class Window(base.OneInputOperator):
            def process_batch(self, batch):
                self.output.emit(batch)
                ledger.record("device_window.fire", 1.0)

        class Sink(base.OneInputOperator):
            def process_batch(self, batch):
                pass

        ctx = base.OperatorContext("task", 0, 1, 128, config=config)
        chain = base.OperatorChain([Window("Window"), Sink("Sink")], ctx,
                                   base.CollectingOutput())
        chain.process_batch(batch_cls.from_rows(
            schema_cls([("v", np.int64)]), [1, 2]))
        charged[side] = {(r["operator"], r["site"], r["count"])
                         for r in ledger.profile(top=100)["programs"]}
    assert charged["ref"] == {("1:Sink", "device_window.fire", 1)}
    assert charged["port"] == {("0:Window", "device_window.fire", 1)}


def test_a_disabled_ledger_records_nothing():
    led = port_prof.DEVICE_LEDGER
    _q5(False, {"profiler.enabled": False})
    assert not led.enabled
    assert led.snapshot()["entries"] == 0 and not led.trace_counters()
    led.record("device_window.step", 1.0)
    led.note_build("device_window.step", "k", _builder, (1, 2), {})
    assert led.profile()["programs"] == [] and \
        led.profile()["recompiles"] == []


def test_cpu_site_timing_first_dispatch_and_cost_model():
    led = port_prof.DeviceLedger()
    led.configure(Configuration({"profiler.enabled": True,
                                 "profiler.cost-model.gflops": 2.0,
                                 "profiler.cost-model.gbps": 4.0}))
    led._seen.clear()

    def cost(n, itemsize):
        return n, n * itemsize

    port_prof.set_dispatch_context("job", "op")
    for _ in range(3):
        tok = led.begin("ops.pallas_topk", torch.device("cpu"))
        torch.ones(1000).sum()
        led.end(tok, (1 << 20, 8), cost)
    rows = led.profile()["programs"]
    assert len(rows) == 1
    row = rows[0]
    assert (row["job"], row["operator"], row["count"], row["compiles"]) == \
        ("job", "op", 2, 1)
    assert row["shape_signature"] == repr((1 << 20, 8))
    assert (row["est_flops"], row["est_bytes"]) == (1 << 20, 8 << 20)
    want = max((1 << 20) / 2e6, (8 << 20) / 4e6)
    assert row["est_ms"] == pytest.approx(want)
    assert row["achieved_vs_estimated"] == pytest.approx(
        row["mean_ms"] / want)


def test_dispatch_context_hops_to_the_watchdog_worker():
    WATCHDOG.configure(Configuration({"watchdog.transfer-timeout": 5.0}))
    port_prof.set_dispatch_context("job-z", "3:Op")
    seen = WATCHDOG.run("transfer.d2h", lambda: (
        port_prof.dispatch_context(), threading.current_thread().name))
    assert seen[0] == ("job-z", "3:Op")
    assert seen[1] != threading.current_thread().name


def test_ledger_is_configured_on_the_deploy_path():
    _q5(False, {"profiler.enabled": True,
                "profiler.cost-model.gbps": 3350.0})
    led = port_prof.DEVICE_LEDGER
    assert led.enabled and led.cost_gbps == 3350.0
    snap = led.snapshot()
    assert set(snap["jobs"]) == {"q5-ledger"} and snap["dispatches_total"]


@pytest.mark.cuda
def test_cuda_events_time_a_site_without_a_host_wait():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    led = port_prof.DeviceLedger()
    led.configure(Configuration({"profiler.enabled": True}))
    x = torch.ones(1 << 24, device=dev)
    for _ in range(5):
        tok = led.begin("device_window.step", dev)
        x.mul_(1.0)
        led.end(tok, (1 << 24,), lambda n: (n, 8 * n))
    torch.cuda.set_sync_debug_mode("error")
    try:
        tok = led.begin("device_window.step", dev)
        x.mul_(1.0)
        led.end(tok, (1 << 24,), lambda n: (n, 8 * n))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    row = led.profile()["programs"][0]
    assert row["count"] + row["compiles"] == 6 and row["self_ms"] > 0
    assert not led._pending and led.forced_waits == 0
