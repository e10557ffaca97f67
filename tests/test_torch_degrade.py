"""Port parity: the window operator's device guard, degrade ladder and
dead-letter output (flink_tpu_torch/runtime/operators/device_window.py)
against flink_tpu/runtime/operators/device_window.py, both through their
OneInputOperatorTestHarness on the same numpy-seeded Q5-shaped stream
(sliding window, a count and a sum, top k).

* Under transient, persistent and poison ``device.execute`` specs and
  ``transfer.d2h`` faults, for device and host batches and both fire
  modes: the same rows (under the tie rule of top k), trip log, visits,
  degrades and quarantined batches.
* ``faults.validate-batches`` sends the same NaN and Inf rows to the
  ``dead-letter`` side output.
* With ``device.failover.degradation`` off a persistent fault fails the
  task in both.
* An injected hang past the deadline is a stall that retries; hangs that
  outlast the retries degrade, with the same rows.
* A degrade under an HBM budget retires the residency and gives the
  reference's rows.
* A transient ``tier.evict`` fault leaves the boundaries' evictions and
  promotions equal to the reference's.
* A CUDA error out of the step (the kernel wrapper's) is neither retried
  nor degraded: it fails the task as it is. So does a stall inside the
  step, after its fold (a region nested in the dispatch that passes its
  deadline), and the batch is folded once.
* Through ``env.execute()`` with the fused chain, a persistent fault
  degrades mid-stream and the windows equal the oracle.

Tolerance: exact (integer aggregates); top-k rows under the ROADMAP tie
rule (each window's values, and the keys above its k-th value with their
aggregates). The injector and the watchdog are process-global in both
packages: the autouse fixture resets them after every test.
"""

import importlib.util
import pathlib
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from flink_tpu.core.config import Configuration as RefConfiguration  # noqa: E402
from flink_tpu.core.device_records import \
    DeviceRecordBatch as RefDeviceBatch  # noqa: E402
from flink_tpu.core.records import RecordBatch as RefBatch  # noqa: E402
from flink_tpu.core.records import Schema as RefSchema  # noqa: E402
from flink_tpu.ops.hash_table import ensure_x64  # noqa: E402
from flink_tpu.runtime import faults as ref_faults  # noqa: E402
from flink_tpu.runtime import watchdog as ref_watchdog  # noqa: E402
from flink_tpu.runtime.harness import \
    OneInputOperatorTestHarness as RefHarness  # noqa: E402
from flink_tpu.runtime.operators import device_window as ref_dw  # noqa: E402
from flink_tpu.window import SlidingEventTimeWindows as RefSliding  # noqa: E402
from flink_tpu_torch.core import Configuration, Schema  # noqa: E402
from flink_tpu_torch.core.device_records import DeviceRecordBatch  # noqa: E402
from flink_tpu_torch.core.records import RecordBatch  # noqa: E402
from flink_tpu_torch.metrics import DEVICE_STATS  # noqa: E402
from flink_tpu_torch.runtime import faults as port_faults  # noqa: E402
from flink_tpu_torch.runtime import watchdog as port_watchdog  # noqa: E402
from flink_tpu_torch.runtime.harness import OneInputOperatorTestHarness  # noqa: E402
from flink_tpu_torch.runtime.operators import device_window as port_dw  # noqa: E402
from flink_tpu_torch.state.tiering import residency_table  # noqa: E402
from flink_tpu_torch.window import SlidingEventTimeWindows  # noqa: E402

ensure_x64()
ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

PANE, W, TOPK = 1000, 3, 8
FIELDS = [("k", np.int64), ("v", np.int64)]
PACKAGES = {"ref": (ref_faults, ref_watchdog), "port": (port_faults,
                                                         port_watchdog)}


@pytest.fixture(autouse=True)
def _reset_both():
    for f, w in PACKAGES.values():
        f.FAULTS.reset()
        w.WATCHDOG.reset()
    yield
    for f, w in PACKAGES.values():
        f.FAULTS.reset()
        w.WATCHDOG.reset()


def _config(pkg: str, settings: dict):
    if pkg == "ref":
        conf = RefConfiguration()
        conf.set("state.backend.tpu.host-index", False)  # the device path
    else:
        conf = Configuration()
    for k, v in settings.items():
        conf.set(k, v)
    return conf


def _stream(seed: int, batches: int = 6, n: int = 256, n_keys: int = 40,
            fields=FIELDS):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, batches * n).astype(np.int64)
    vals = rng.integers(1, 50, batches * n).astype(fields[1][1])
    ts = np.sort(rng.integers(0, 8 * PANE, batches * n)).astype(np.int64)
    return keys, vals, ts


def _operator(pkg: str, defer: bool, incremental: bool, topk=TOPK, **kw):
    if pkg == "ref":
        return ref_dw.DeviceWindowAggOperator(
            RefSliding.of(W * PANE, PANE), "k",
            [ref_dw.AggSpec("count", out_name="bids", value_bits=31),
             ref_dw.AggSpec("sum", "v", out_name="revenue")],
            capacity=1 << 10, ring_size=8, emit_window_bounds=False,
            emit_topk=topk, defer_overflow=defer,
            fire_incremental=incremental, **kw)
    return port_dw.DeviceWindowAggOperator(
        SlidingEventTimeWindows.of(W * PANE, PANE), "k",
        [port_dw.AggSpec("count", out_name="bids", value_bits=31),
         port_dw.AggSpec("sum", "v", out_name="revenue", dtype=torch.int64)],
        capacity=1 << 10, ring_size=8, emit_window_bounds=False,
        emit_topk=topk, defer_overflow=defer, fire_incremental=incremental,
        device="cpu", **kw)


def _batch(pkg: str, device: bool, keys, vals, ts, fields=FIELDS):
    names = [f for f, _d in fields]
    if pkg == "ref":
        schema = RefSchema(fields)
        if device:
            return RefDeviceBatch(schema, {names[0]: jnp.asarray(keys),
                                           names[1]: jnp.asarray(vals)},
                                  jnp.asarray(ts), int(ts.min()),
                                  int(ts.max()))
        return RefBatch(schema, {names[0]: keys, names[1]: vals}, ts)
    schema = Schema(fields)
    if device:
        return DeviceRecordBatch(schema, {
            names[0]: torch.from_numpy(keys), names[1]: torch.from_numpy(vals)},
            torch.from_numpy(ts), int(ts.min()), int(ts.max()))
    return RecordBatch(schema, {names[0]: keys, names[1]: vals}, ts)


def _windows(h) -> list:
    """[(window end - 1, keys, bids, revenue)] in emission order."""
    return [(int(b.timestamps[0]), np.asarray(b.column("k")),
             np.asarray(b.column("bids")), np.asarray(b.column("revenue")))
            for b in h.output.batches]


def _trial(pkg: str, settings: dict, device: bool = True,
           incremental: bool = False, seed: int = 0, op_kw=None,
           batches: int = 6) -> dict:
    faults, watchdog = PACKAGES[pkg]
    conf = _config(pkg, settings)
    faults.FAULTS.configure(conf)
    watchdog.WATCHDOG.configure(conf)
    op = _operator(pkg, device, incremental, **(op_kw or {}))
    h = (RefHarness if pkg == "ref" else OneInputOperatorTestHarness)(
        op, (RefSchema if pkg == "ref" else Schema)(FIELDS), config=conf)
    keys, vals, ts = _stream(seed, batches)
    n = len(keys) // batches
    for b in range(batches):
        sl = slice(b * n, (b + 1) * n)
        h.process_batch(_batch(pkg, device, keys[sl], vals[sl], ts[sl]))
        h.process_watermark(int(ts[sl][-1]) - PANE)
    h.process_watermark(1 << 40)
    h.close()
    return {"windows": _windows(h),
            "log": [(e["site"], e["visit"], e["transient"], e["poison"])
                    for e in faults.FAULTS.events],
            "visits": faults.FAULTS.snapshot()["visits"],
            "degraded": op._degraded,
            "quarantined": op.quarantined_batches,
            "dead_letter": sorted(h.get_side_output("dead-letter")),
            "stalls": op._guard.stalls, "op": op}


def _assert_same(got: dict, want: dict, what) -> None:
    for f in ("log", "visits", "degraded", "quarantined", "dead_letter",
              "stalls"):
        assert got[f] == want[f], (what, f, got[f], want[f])
    cs.rows_equal_under_tie_rule(got["windows"], want["windows"])


SPECS = ["device.execute=p0.3,transfer.d2h=p0.3",
         "device.execute=once@2!persistent",
         "device.execute=once@9!persistent",
         "device.execute=once@3!poison",
         "device.execute=every@4!poison,transfer.h2d=every@3"]


@pytest.mark.parametrize("device,incremental", [(True, False), (True, True),
                                                (False, False),
                                                (False, True)])
def test_window_faults_equal_reference(device, incremental):
    clean = _trial("port", {}, device, incremental)
    for spec in SPECS:
        settings = {"faults.enabled": True, "faults.seed": 5,
                    "faults.spec": spec}
        got = _trial("port", settings, device, incremental)
        want = _trial("ref", settings, device, incremental)
        _assert_same(got, want, spec)
        assert got["log"], spec
        if not got["quarantined"]:
            # a retry or a degrade changes no window
            cs.rows_equal_under_tie_rule(got["windows"], clean["windows"])


def test_validate_batches_quarantines_nonfinite_rows_alike():
    fields = [("k", np.int64), ("x", np.float64)]
    out = {}
    for pkg in PACKAGES:
        conf = _config(pkg, {"faults.validate-batches": True})
        if pkg == "ref":
            op = ref_dw.DeviceWindowAggOperator(
                RefSliding.of(2 * PANE, PANE), "k",
                [ref_dw.AggSpec("sum", "x", out_name="sx")],
                capacity=1 << 8, ring_size=8, emit_window_bounds=False)
            h = RefHarness(op, RefSchema(fields), config=conf)
        else:
            op = port_dw.DeviceWindowAggOperator(
                SlidingEventTimeWindows.of(2 * PANE, PANE), "k",
                [port_dw.AggSpec("sum", "x", out_name="sx",
                                 dtype=torch.float64)],
                capacity=1 << 8, ring_size=8, emit_window_bounds=False,
                device="cpu")
            h = OneInputOperatorTestHarness(op, Schema(fields), config=conf)
        rng = np.random.default_rng(3)
        before = DEVICE_STATS.dead_letter_records
        for b in range(4):
            keys = rng.integers(0, 6, 64).astype(np.int64)
            xs = rng.integers(0, 9, 64).astype(np.float64)
            xs[rng.random(64) < 0.1] = np.nan
            xs[rng.random(64) < 0.05] = np.inf
            ts = np.sort(rng.integers(b * PANE, (b + 1) * PANE, 64))
            h.process_batch(_batch(pkg, False, keys, xs, ts, fields))
            h.process_watermark(int(ts[-1]) - PANE)
        h.process_watermark(1 << 40)
        h.close()
        out[pkg] = (sorted(h.get_output()),
                    sorted(h.get_side_output("dead-letter"), key=str),
                    op.quarantined_batches)
        if pkg == "port":
            assert DEVICE_STATS.dead_letter_records - before == \
                len(out[pkg][1]) > 0
    assert out["port"][0] == out["ref"][0]
    # (as strings: a NaN row equals its twin)
    assert [tuple(map(str, r)) for r in out["port"][1]] == \
        [tuple(map(str, r)) for r in out["ref"][1]]
    assert out["port"][2] == out["ref"][2] > 0


def test_degradation_off_fails_the_task_alike():
    settings = {"faults.enabled": True,
                "faults.spec": "device.execute=once@2!persistent",
                "device.failover.degradation": False}
    for pkg in PACKAGES:
        with pytest.raises(Exception, match="device segment"):
            _trial(pkg, settings)


def test_hangs_retry_then_degrade_alike():
    once = {"faults.enabled": True,
            "faults.spec": "device.execute=once@4!hang@5000",
            "watchdog.device.execute-timeout": 0.25}
    got, want = _trial("port", once), _trial("ref", once)
    _assert_same(got, want, "once")
    assert got["stalls"] == 1 and not got["degraded"]
    trips = [PACKAGES[p][1].WATCHDOG.trips.get("device.execute", 0)
             for p in PACKAGES]
    always = {"faults.enabled": True,
              "faults.spec": "device.execute=every@1!hang@5000",
              "watchdog.device.execute-timeout": 0.25,
              "device.failover.max-retries": 1,
              "device.failover.retry-backoff": 0.001}
    got, want = _trial("port", always), _trial("ref", always)
    _assert_same(got, want, "always")
    assert got["degraded"] and got["stalls"] == 2
    assert trips[0] == trips[1] == 1


def test_degrade_under_a_budget_retires_the_residency():
    settings = {"faults.enabled": True,
                "faults.spec": "device.execute=once@7!persistent",
                "state.tiering.async-prefetch": False}
    kw = {"op_kw": {"hbm_budget_slots": 64, "topk": None},
          "batches": 8}
    got = _trial("port", settings, device=False, **kw)
    want = _trial("ref", settings, device=False, **kw)
    assert got["degraded"] and want["degraded"]
    assert got["log"] == want["log"]
    assert [(t, k.tolist(), b.tolist(), r.tolist())
            for t, k, b, r in got["windows"]] == \
        [(t, k.tolist(), b.tolist(), r.tolist())
         for t, k, b, r in want["windows"]]
    op = got["op"]
    assert not op.backend.tiering_active and op.backend.device.type == "cpu"
    assert "harness/0" not in residency_table()
    assert op.degrade_s is not None and op.degrade_s >= 0


def test_tier_evict_transient_keeps_the_reference_evictions():
    settings = {"faults.enabled": True, "faults.spec": "tier.evict=every@2",
                "state.tiering.async-prefetch": False}
    runs = {}
    for pkg in PACKAGES:
        faults, watchdog = PACKAGES[pkg]
        conf = _config(pkg, settings)
        faults.FAULTS.configure(conf)
        watchdog.WATCHDOG.configure(conf)
        op = _operator(pkg, False, False, topk=None, hbm_budget_slots=64)
        h = (RefHarness if pkg == "ref" else OneInputOperatorTestHarness)(
            op, (RefSchema if pkg == "ref" else Schema)(FIELDS), config=conf)
        keys, vals, ts = _stream(9, batches=10, n=128, n_keys=400)
        boundaries = []
        for b in range(10):
            sl = slice(b * 128, (b + 1) * 128)
            h.process_batch(_batch(pkg, False, keys[sl], vals[sl], ts[sl]))
            h.process_watermark(int(ts[sl][-1]) - PANE)
            backend = op._backend
            res = backend.residency
            boundaries.append((res.evicted_groups, res.promoted_groups,
                               backend.host_tier.spilled_mask.tolist()
                               if backend.host_tier is not None else None))
        h.process_watermark(1 << 40)
        h.close()
        runs[pkg] = (boundaries, [(t, k.tolist(), r.tolist()) for t, k, _b, r
                                  in _windows(h)],
                     faults.FAULTS.snapshot()["trips"])
    assert runs["port"] == runs["ref"]
    assert runs["port"][2].get("tier.evict", 0) > 0
    assert runs["port"][0][-1][0] > 0


def test_a_cuda_error_is_neither_retried_nor_degraded(monkeypatch):
    conf = Configuration()
    op = _operator("port", True, False)
    h = OneInputOperatorTestHarness(op, Schema(FIELDS), config=conf)
    keys, vals, ts = _stream(1, batches=2)
    h.process_batch(_batch("port", True, keys[:256], vals[:256], ts[:256]))
    err = RuntimeError("hash_table kernel launch failed: CUDA error: an "
                       "illegal memory access was encountered")

    def broken(*a, **k):
        raise err

    monkeypatch.setattr(op._backend, "ingest_deferred", broken)
    retries0, degraded0 = DEVICE_STATS.retries, DEVICE_STATS.degraded
    with pytest.raises(RuntimeError) as ei:
        h.process_batch(_batch("port", True, keys[256:], vals[256:],
                               ts[256:]))
    assert ei.value is err
    assert not op._degraded and op._guard.retries == 0
    assert (DEVICE_STATS.retries, DEVICE_STATS.degraded) == (retries0,
                                                             degraded0)


def test_a_stall_inside_the_step_fails_the_task_and_folds_once(monkeypatch):
    """The step folds, then blocks in a supervised region nested in it
    past that region's deadline: the StallError reaches the task as it
    is, with no retry and no degrade, and the batch is in the count plane
    once. The gate opens only after the error, so no timing decides it."""
    conf = _config("port", {"faults.enabled": True,
                            "faults.spec": "device.execute=every@1000"})
    port_faults.FAULTS.configure(conf)
    port_watchdog.WATCHDOG.configure(conf)
    op = _operator("port", True, False)
    h = OneInputOperatorTestHarness(op, Schema(FIELDS), config=conf)
    keys, vals, ts = _stream(3, batches=2)
    h.process_batch(_batch("port", True, keys[:256], vals[:256], ts[:256]))
    fold = op._backend.ingest_deferred
    gate, ran = threading.Event(), []

    def fold_then_stall(*a, **k):
        fold(*a, **k)
        ran.append(1)
        port_watchdog.WATCHDOG.run("tier.evict", gate.wait, deadline=0.05,
                                   scope="test")

    monkeypatch.setattr(op._backend, "ingest_deferred", fold_then_stall)
    retries0, degraded0 = DEVICE_STATS.retries, DEVICE_STATS.degraded
    try:
        with pytest.raises(port_watchdog.StallError):
            h.process_batch(_batch("port", True, keys[256:], vals[256:],
                                   ts[256:]))
    finally:
        gate.set()
    assert ran == [1] and not op._degraded
    assert (op._guard.retries, op._guard.stalls) == (0, 0)
    assert (DEVICE_STATS.retries, DEVICE_STATS.degraded) == (retries0,
                                                             degraded0)
    assert port_watchdog.WATCHDOG.trips == {"tier.evict": 1}
    assert int(op._backend.get_array("__count__").sum()) == 512


def test_fused_chain_degrades_mid_stream_through_execute():
    """Through ``env.execute()`` with the fused chain: a persistent fault
    at the fourth dispatch degrades the window, the remaining lazy
    batches decode and fold on the CPU rung, and every window equals the
    numpy oracle."""
    degraded0 = DEVICE_STATS.degraded
    job, got, span = cs.run_q5(
        torch, torch.device("cpu"), 3000, 1 << 14, 1 << 13, batch=1 << 10,
        topk=20, fused=True,
        settings={"faults.enabled": True,
                  "faults.spec": "device.execute=once@4!persistent"})
    op = job.operators[0]
    assert op._degraded and DEVICE_STATS.degraded == degraded0 + 1
    assert op.fused_chain is None and not job.fusion_declined
    assert cs.q5_oracle_check(3000, 1 << 14, span, got, topk=20) == len(got)
