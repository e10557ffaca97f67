"""Port parity of the session path below and around the operator:

* ``session_step_plain`` and ``session_fire_plain``
  (flink_tpu_torch/ops/session.py) against the reference programs
  ``_sess_step`` and ``_sess_fire``
  (flink_tpu/runtime/operators/device_session.py) on the same inputs:
  planes mapped through each table to keys, emitted and fired rows,
  counters;
* snapshots equal to the reference's field by field, restores across the
  two packages both ways, and a checkpoint taken after a fire that must
  not bring the fired windows back;
* the session job through ``env.execute()`` (chip_smoke.py's own path and
  oracle, at a tiny size), also in a process that cannot import jax or
  flink_tpu; the route's rejections and lanes; the fusion category.

The ``cuda``-marked tests hold the kernels of csrc/session_window.cu
against the plain versions on the card and skip without one. The
reference is imported by a fixture, so on a machine with PyTorch alone
the parity tests skip and the card tests run:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_session_state.py
"""

import importlib.util
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches
from flink_tpu_torch.api import StreamExecutionEnvironment
from flink_tpu_torch.core import Configuration, Schema
from flink_tpu_torch.core.records import RecordBatch
from flink_tpu_torch.graph.fusion import _classify_operator
from flink_tpu_torch.ops.hash_table import EMPTY_KEY, lookup_or_insert, \
    make_table, sanitize_keys_device
from flink_tpu_torch.ops.segment_ops import make_accumulator
from flink_tpu_torch.ops.session import session_fire, session_fire_plain, \
    session_step, session_step_plain
from flink_tpu_torch.runtime import OneInputOperatorTestHarness
from flink_tpu_torch.runtime.operators import AggSpec, \
    DeviceSessionWindowOperator
from flink_tpu_torch.window import EventTimeSessionWindows

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIELDS = [("k", np.int64), ("v", np.int64)]
AGGS = [("sum", "v", "total"), ("count", None, "cnt"), ("min", "v", "lo"),
        ("max", "v", "hi"), ("avg", "v", "mean")]
#: (fold kind, plane name, plane dtype) of AGGS, as both operators name them
FOLDS = [("sum", "total", np.int64), ("min", "lo", np.int64),
         ("max", "hi", np.int64), ("sum", "mean.sum", np.float32)]
OUTS = [("sum", "total", "total"), ("count", "cnt", "__count__"),
        ("min", "lo", "lo"), ("max", "hi", "hi"),
        ("avg", "mean", "mean.sum")]
DIRTY_SHIFT = 6


@pytest.fixture(scope="module")
def ref():
    """The reference's modules, with 64-bit types on."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from flink_tpu.core.records import RecordBatch as RefBatch
    from flink_tpu.core.records import Schema as RefSchema
    from flink_tpu.ops import hash_table
    from flink_tpu.runtime import OneInputOperatorTestHarness as RefHarness
    from flink_tpu.runtime.operators import device_session, device_window

    hash_table.ensure_x64()
    return types.SimpleNamespace(jax=jax, jnp=jnp, ht=hash_table,
                                 ds=device_session, dw=device_window,
                                 Batch=RefBatch, Schema=RefSchema,
                                 Harness=RefHarness)


# -- the programs ------------------------------------------------------------
def _stream(seed, steps=6, n=64, keys=24, gap=30):
    """[(keys, ts, values, boundary)]: batches sorted by (key, ts), with
    disorder, and the fire boundary after each; the next batch reaches
    behind it (late rows)."""
    rng = np.random.default_rng(seed)
    out, t0 = [], 0
    for _ in range(steps):
        k = rng.integers(0, keys, n).astype(np.int64)
        ts = (t0 + np.sort(rng.integers(0, 300, n))
              + rng.integers(-60, 60, n)).astype(np.int64)
        v = rng.integers(-20, 20, n).astype(np.int64)
        order = np.lexsort((ts, k))
        t0 += 200
        out.append((k[order], ts[order], v[order], t0 + 100))
    return out


def _ref_state(r, cap, L, shift):
    jnp = r.jnp
    planes = {"__start__": jnp.full((L, cap), np.iinfo(np.int64).max,
                                    jnp.int64),
              "__end__": jnp.full((L, cap), np.iinfo(np.int64).min,
                                  jnp.int64),
              "__open__": jnp.full((L, cap), -128, jnp.int8),
              "__count__": jnp.zeros((L, cap), jnp.int64)}
    for kind, name, dt in FOLDS:
        planes[name] = jnp.full((L, cap), _init(kind, dt), dt)
    return {"table": r.ht.make_table(cap), "planes": planes,
            "cur_lane": jnp.zeros(cap, jnp.int32),
            "dropped": jnp.zeros((), jnp.int64),
            "late": jnp.zeros((), jnp.int64),
            "dirty": jnp.zeros(cap >> shift, bool)}


def _init(kind, dt):
    if kind == "sum":
        return 0
    info = np.finfo(dt) if np.issubdtype(dt, np.floating) else np.iinfo(dt)
    return info.max if kind == "min" else info.min


def _port_state(cap, L, shift=DIRTY_SHIFT):
    t = torch.from_numpy
    return {"table": make_table(cap, "cpu"),
            "start": make_accumulator("min", (L, cap), torch.int64, "cpu"),
            "end": make_accumulator("max", (L, cap), torch.int64, "cpu"),
            "open": make_accumulator("max", (L, cap), torch.int8, "cpu"),
            "count": torch.zeros((L, cap), dtype=torch.int64),
            "cur_lane": torch.zeros(cap, dtype=torch.int32),
            "folds": [(kind, t(np.full((L, cap), _init(kind, dt), dt)))
                      for kind, _n, dt in FOLDS],
            "dropped": torch.zeros((), dtype=torch.int64),
            "late": torch.zeros((), dtype=torch.int64),
            "dirty": torch.zeros((cap >> shift) + 1, dtype=torch.uint8)}


def _by_key(table, planes):
    """{key: tuple of every plane's [..., slot] values}."""
    table = np.asarray(table)
    slots = np.flatnonzero(table != EMPTY_KEY)
    return {int(table[s]): tuple(np.asarray(p)[..., s].tolist()
                                 for p in planes) for s in slots}


def _ref_views(rs):
    p = rs["planes"]
    return rs["table"], [p["__start__"], p["__end__"], p["__open__"],
                         p["__count__"], rs["cur_lane"]] + \
        [p[name] for _k, name, _d in FOLDS]


def _port_views(ps):
    return ps["table"].numpy(), [ps["start"], ps["end"], ps["open"],
                                 ps["count"], ps["cur_lane"]] + \
        [p for _k, p in ps["folds"]]


def _port_outs(ps):
    planes = {"total": ps["folds"][0][1], "lo": ps["folds"][1][1],
              "hi": ps["folds"][2][1], "mean.sum": ps["folds"][3][1],
              "__count__": ps["count"]}
    return [(kind, planes[plane]) for kind, _o, plane in OUTS]


def _rows(*cols):
    return sorted(zip(*[np.asarray(c).tolist() for c in cols]))


@pytest.mark.parametrize("seed", [1, 2])
def test_step_and_fire_plain_equal_reference_programs(ref, seed):
    """Six batches with disorder and late rows, each followed by fire
    rounds whose buffer (capacity 16) overflows: after every call the
    planes, mapped through each table to keys, and the counters are equal;
    emitted and fired rows are equal."""
    cap, L, gap, shift = 16, 4, 30, 2
    jnp = ref.jnp
    rs, ps = _ref_state(ref, cap, L, shift), _port_state(cap, L, shift)
    fold_sig = tuple((kind, name, "v") for kind, name, _d in FOLDS)
    step = ref.ds._sess_step(fold_sig, L, gap, 1 << shift)
    fire = ref.ds._sess_fire(tuple(OUTS), L, gap)
    overflowed, fb = 0, -(1 << 62)
    for keys, ts, v, boundary in _stream(seed, keys=12, gap=gap):
        (rs["table"], rs["planes"], rs["cur_lane"], rs["dropped"],
         rs["late"], rs["dirty"], n_emit, ekey, estart, eend, ecount,
         evals) = step(rs["table"], rs["planes"], rs["cur_lane"],
                       rs["dropped"], rs["late"], rs["dirty"],
                       jnp.asarray(keys), jnp.asarray(ts),
                       {"v": jnp.asarray(v)}, np.int64(len(keys)),
                       np.int64(fb))
        got = session_step_plain(
            ps["table"], ps["start"], ps["end"], ps["open"], ps["count"],
            [(kind, p, torch.from_numpy(v).to(p.dtype))
             for kind, p in ps["folds"]], ps["cur_lane"],
            torch.from_numpy(keys), torch.from_numpy(ts), gap, fb,
            ps["dropped"], ps["late"], ps["dirty"], shift)
        assert _by_key(*_ref_views(rs)) == _by_key(*_port_views(ps))
        g = int(n_emit)
        assert int(got.n) == g
        assert _rows(ekey[:g], estart[:g], eend[:g], ecount[:g]) == \
            _rows(got.key[:g], got.start[:g], got.end[:g], got.count[:g])
        assert int(rs["dropped"]) == int(ps["dropped"])
        assert int(rs["late"]) == int(ps["late"])
        # the reference marks every row's block; the port the blocks of
        # the slots it touched: both cover every block written
        rslots = {s >> shift for s in np.flatnonzero(
            np.asarray(rs["table"]) != EMPTY_KEY)}
        assert set(np.flatnonzero(ps["dirty"].numpy()[:-1])) <= rslots
        while True:
            new, okeys, ostart, oend, outs, fired, overflow = fire(
                rs["table"], rs["planes"], np.int64(boundary))
            rs["planes"] = new
            pgot = session_fire_plain(
                ps["table"], ps["start"], ps["end"], ps["open"], ps["count"],
                ps["folds"], _port_outs(ps), gap, boundary, ps["dirty"],
                shift)
            f, o = int(fired), int(overflow)
            assert pgot.counts.tolist() == [f, o]
            want = [okeys[:f], ostart[:f], oend[:f]] + \
                [np.asarray(outs[out])[:f] for _k, out, _p in OUTS]
            assert _rows(*want) == _rows(pgot.key[:f], pgot.start[:f],
                                         pgot.end[:f],
                                         *[x[:f] for x in pgot.values])
            assert _by_key(*_ref_views(rs)) == _by_key(*_port_views(ps))
            overflowed += o > 0
            if f == 0 or o == 0:
                break
        fb = boundary
    assert int(ps["late"]) > 0 and overflowed


# -- operators: snapshots, restores, the fault after a fire -----------------
def _ops(r, gap=40, lanes=8, capacity=1 << 10):
    ref_op = r.ds.DeviceSessionWindowOperator(
        gap, "k", [r.dw.AggSpec(kind, field, out_name=out)
                   for kind, field, out in AGGS],
        capacity=capacity, lanes=lanes)
    port_op = DeviceSessionWindowOperator(
        gap, "k", [AggSpec(kind, field, out_name=out)
                   for kind, field, out in AGGS],
        capacity=capacity, lanes=lanes, device="cpu")
    return ref_op, port_op


def _harness(r, pkg, op):
    return (r.Harness(op, schema=r.Schema(FIELDS)) if pkg == "ref"
            else OneInputOperatorTestHarness(op, schema=Schema(FIELDS)))


def _batches(seed=9, n=6, rows=48):
    rng = np.random.default_rng(seed)
    out, t = [], 0
    for _ in range(n):
        ts = (t + np.sort(rng.integers(0, 400, rows))
              + rng.integers(-30, 30, rows))
        out.append((list(zip(rng.integers(0, 16, rows).tolist(),
                             rng.integers(-9, 9, rows).tolist())),
                    ts.tolist(), t + 250))
        t += 300
    return out


def _feed(r, pkg, h, batches):
    Batch, schema = ((r.Batch, r.Schema(FIELDS)) if pkg == "ref"
                     else (RecordBatch, Schema(FIELDS)))
    for rows, ts, wm in batches:
        h.process_batch(Batch.from_rows(schema, rows, ts))
        h.process_watermark(wm)


def _rows_of(h):
    out = []
    for b in h.output.batches:
        cols = [np.asarray(b.column(c)) for c in
                ["k", "window_start", "window_end"] + [o for *_, o in AGGS]]
        out += [tuple(c[i].item() for c in cols) for i in range(b.n)]
    return out


def _assert_snapshots_equal(a, b):
    assert a["meta"] == b["meta"]
    assert len(a["pending"]) == len(b["pending"])
    for ca, cb in zip(a["pending"], b["pending"]):
        assert set(ca) == set(cb)
        for k in ca:
            np.testing.assert_array_equal(ca[k], cb[k])
    sa, sb = a["backend"], b["backend"]
    assert sa["kind"] == sb["kind"] == "tpu"
    assert sa["max_parallelism"] == sb["max_parallelism"]
    np.testing.assert_array_equal(sa["keys"], sb["keys"])
    np.testing.assert_array_equal(sa["key_groups"], sb["key_groups"])
    assert set(sa["states"]) == set(sb["states"])
    for name, st in sa["states"].items():
        other = sb["states"][name]
        assert (st["kind"], st["dtype"], st["ring"]) == \
            (other["kind"], other["dtype"], other["ring"]), name
        assert np.asarray(st["values"]).dtype == \
            np.asarray(other["values"]).dtype, name
        np.testing.assert_array_equal(st["values"], other["values"], name)


def test_snapshots_equal_reference_field_by_field(ref):
    """After the same batches and fires (fired lanes, merged lanes, lanes
    never used), both snapshots hold the same keys in canonical (group,
    key) order and the same states, dtypes and values."""
    batches = _batches()
    snaps = {}
    for pkg, op in zip(("ref", "port"), _ops(ref)):
        h = _harness(ref, pkg, op)
        _feed(ref, pkg, h, batches)
        snaps[pkg] = op.snapshot_state(1)["keyed"]
        h.close()
    _assert_snapshots_equal(snaps["ref"], snaps["port"])
    assert snaps["port"]["backend"]["states"]["__open__"]["dtype"] == "int8"


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_restore_across_packages(ref, direction):
    """A snapshot after three batches, restored into the other package's
    operator, which takes the other three: the rows before and after equal
    the uninterrupted run's."""
    batches = _batches()
    ref_op, _ = _ops(ref)
    h = _harness(ref, "ref", ref_op)
    _feed(ref, "ref", h, batches)
    h.process_watermark(1 << 40)
    h.close()
    want = sorted(_rows_of(h))
    src_pkg, dst_pkg = direction.split("_to_")
    ops = dict(zip(("ref", "port"), _ops(ref)))
    h1 = _harness(ref, src_pkg, ops[src_pkg])
    _feed(ref, src_pkg, h1, batches[:3])
    snap = ops[src_pkg].snapshot_state(1)["keyed"]
    h1.close()
    dst = dict(zip(("ref", "port"), _ops(ref)))[dst_pkg]
    h2 = _harness(ref, dst_pkg, dst)
    h2.open(keyed_snapshots=[snap])
    _feed(ref, dst_pkg, h2, batches[3:])
    h2.process_watermark(1 << 40)
    h2.close()
    assert sorted(_rows_of(h1) + _rows_of(h2)) == want


def _two_checkpoints_around_a_fire(r, pkg):
    """Batch, checkpoint 1, a fire of both sessions, checkpoint 2, then a
    restore from checkpoint 2 that takes a batch of another key and the
    last watermark. Returns (rows before, rows after the restore)."""
    make = {"ref": lambda: r.ds.DeviceSessionWindowOperator(
                100, "k", [r.dw.AggSpec("sum", "v", out_name="total"),
                           r.dw.AggSpec("count", out_name="cnt")],
                capacity=1 << 12),
            "port": lambda: DeviceSessionWindowOperator(
                100, "k", [AggSpec("sum", "v", out_name="total"),
                           AggSpec("count", out_name="cnt")],
                capacity=1 << 12, device="cpu")}[pkg]
    Batch, schema = ((r.Batch, r.Schema(FIELDS)) if pkg == "ref"
                     else (RecordBatch, Schema(FIELDS)))
    op = make()
    h = _harness(r, pkg, op)
    h.process_batch(Batch.from_rows(schema, [(1, 5), (2, 6)], [100, 110]))
    op.snapshot_state(1)
    h.process_watermark(300)
    snap = op.snapshot_state(2)["keyed"]
    h.close()
    op2 = make()
    h2 = _harness(r, pkg, op2)
    h2.open(keyed_snapshots=[snap])
    h2.process_batch(Batch.from_rows(schema, [(3, 7)], [1000]))
    h2.process_watermark(1 << 40)
    h2.close()

    def rows(hh):
        return sorted((int(b.column("k")[i]), int(b.column("window_start")[i]),
                       int(b.column("window_end")[i]))
                      for b in hh.output.batches for i in range(b.n))

    return rows(h), rows(h2)


def test_checkpoint_after_a_fire_does_not_repeat_the_fired_windows(ref):
    """The port's fire marks the dirty blocks of the lanes it resets, so
    checkpoint 2 holds them closed and the restored run emits only the new
    key's window. The reference's fire marks nothing
    (device_session.py:560, tpu_backend.py:970-971): its checkpoint 2
    patches no block, keeps both lanes open, and the restored run fires
    both windows a second time (ROADMAP, Queue 3)."""
    fired = [(1, 100, 200), (2, 110, 210)]
    before, after = _two_checkpoints_around_a_fire(ref, "port")
    assert before == fired and after == [(3, 1000, 1100)]
    ref_before, ref_after = _two_checkpoints_around_a_fire(ref, "ref")
    assert ref_before == fired
    assert ref_after == fired + [(3, 1000, 1100)]


# -- the job, the route, fusion -------------------------------------------------
def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: tiny forms of the two session cells of chip_smoke.py
TINY = {"Q11-10M": {"keys": 3000, "events": 1 << 14, "batch": 1 << 10,
                    "capacity": 1 << 13},
        "session-100K": {"keys": 2000, "events": 1 << 14, "batch": 1 << 10,
                         "capacity": 1 << 13, "span": 20_000, "gap": 500}}


@pytest.mark.parametrize("cell", sorted(TINY))
def test_session_job_through_execute_equals_oracle(cell):
    """chip_smoke.py's session cells at a tiny size on the CPU, through
    ``env.execute()`` on the graph runtime: every window equals the numpy
    oracle; no event is late; the source and the window run as two tasks
    even with fusion on."""
    cs = _smoke()
    c = cs.session_config(cell, **TINY[cell])
    reset_launches()
    job, got = cs.run_session(torch, torch.device("cpu"), c,
                              settings={"pipeline.fusion.enabled": True})
    assert cs.session_check(cs.session_expected(c), got) > 1000
    assert job.operators[0].late_dropped == 0
    assert len(job.job_graph.vertices) == 2
    assert KERNEL_LAUNCHES["ingest_step"] == 0
    got[0] = (got[0][0], got[0][1], got[0][2], got[0][3] + 1)
    with pytest.raises(AssertionError, match="numpy oracle"):
        cs.session_check(cs.session_expected(c), got)


_BLOCKED_RUN = """
import sys
sys.modules["jax"] = None
sys.modules["flink_tpu"] = None
sys.path.insert(0, {root!r})
import importlib.util
import torch
spec = importlib.util.spec_from_file_location("chip_smoke",
                                              {root!r} + "/chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
c = cs.session_config("Q11-10M", keys=3000, events=1 << 14, batch=1 << 10,
                      capacity=1 << 13)
job, got = cs.run_session(torch, torch.device("cpu"), c,
                          rate=(1 << 14) / 1.0,
                          settings={{"execution.checkpointing.interval":
                                     0.02}})
n = cs.session_check(cs.session_expected(c), got)
assert sys.modules["jax"] is None and sys.modules["flink_tpu"] is None
assert "flink_tpu_torch.runtime.operators.device_session" in sys.modules
assert "flink_tpu_torch.ops.session" in sys.modules
print("windows", n, "checkpoints", int(len(job.coordinator.stats) > 0))
"""


def test_session_job_runs_with_jax_and_flink_tpu_blocked():
    out = subprocess.run([sys.executable, "-c",
                          _BLOCKED_RUN.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=240,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    words = out.stdout.split()
    assert words[0] == "windows" and int(words[1]) > 1000
    assert words[2:] == ["checkpoints", "1"]


def _windowed(ring_size=64, **kw):
    env = StreamExecutionEnvironment(Configuration(), device="cpu")
    ds = env.from_collection([(1, 2)], Schema(FIELDS), timestamps=[0])
    stream = ds.key_by("k").window(EventTimeSessionWindows.with_gap(10)) \
        .device_aggregate([AggSpec("count", out_name="cnt")],
                          ring_size=ring_size, **kw)
    return stream.transformation.operator_factory()


@pytest.mark.parametrize("kw", [{"emit_topk": 5}, {"defer_overflow": True},
                                {"async_fire": True},
                                {"hbm_budget_slots": 1 << 10}])
def test_route_rejects_what_sessions_do_not_take(kw):
    with pytest.raises(ValueError, match="not supported"):
        _windowed(**kw)


def test_route_takes_the_session_operator_and_its_lanes():
    """max(4, min(ring_size, 16)) lanes, as the reference's route gives."""
    for ring, lanes in ((64, 16), (8, 8), (2, 4)):
        op = _windowed(ring_size=ring)
        assert isinstance(op, DeviceSessionWindowOperator)
        assert op._lanes == lanes and op._device.type == "cpu"


def test_fusion_classifies_the_session_operator_keyed_device():
    op = DeviceSessionWindowOperator(10, "k", [AggSpec("count")],
                                     device="cpu")
    assert _classify_operator(op)[0] == "keyed-device"


def test_session_operator_needs_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceSessionWindowOperator(10, "k", [AggSpec("count")])


# -- the kernels, on the card ----------------------------------------------
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_state(dev, cap, L):
    st = _port_state(cap, L)
    return {k: ([(kind, p.to(dev)) for kind, p in v] if k == "folds"
                else v.to(dev)) for k, v in st.items()}


def _cpu(st):
    return {k: ([(kind, p.cpu()) for kind, p in v] if k == "folds"
                else v.cpu()) for k, v in st.items()}


def _clone(st):
    return {k: ([(kind, p.clone()) for kind, p in v] if k == "folds"
                else v.clone()) for k, v in st.items()}


def _step(fn, st, keys, ts, v, gap, boundary):
    return fn(st["table"], st["start"], st["end"], st["open"], st["count"],
              [(kind, p, v.to(p.dtype)) for kind, p in st["folds"]],
              st["cur_lane"], keys, ts, gap, boundary, st["dropped"],
              st["late"], st["dirty"], DIRTY_SHIFT)


def _fire(fn, st, gap, boundary):
    return fn(st["table"], st["start"], st["end"], st["open"], st["count"],
              st["folds"], _port_outs(st), gap, boundary, st["dirty"],
              DIRTY_SHIFT)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [4, 8, 16, 64])
def test_kernels_equal_plain_on_a_shared_table(dev, lanes):
    """Every template of the step (4, 8, 16 and 64 lanes) and the fire:
    the batch's keys are put in one table first, so kernel and plain
    version find the same slots and every plane, the dirty bitmap, the
    counters and the fired rows (in lane-major order) are equal exactly;
    one launch each."""
    gap, cap = 30, 256
    kst = _card_state(dev, cap, lanes)
    fb = -(1 << 62)
    for keys, ts, v, boundary in _stream(lanes, steps=8, n=512, keys=60,
                                         gap=gap):
        keys, ts, v = (torch.from_numpy(a).to(dev) for a in (keys, ts, v))
        lookup_or_insert(kst["table"], sanitize_keys_device(keys))
        pst = _clone(kst)
        reset_launches()
        got = _step(session_step, kst, keys, ts, v, gap, fb)
        assert KERNEL_LAUNCHES["session_step"] == 1
        want = _step(session_step_plain, pst, keys, ts, v, gap, fb)
        torch.cuda.synchronize()
        assert int(got.n) == int(want.n) == 0
        while True:
            a = _fire(session_fire, kst, gap, boundary)
            b = _fire(session_fire_plain, pst, gap, boundary)
            f = int(b.counts[0])
            assert torch.equal(a.counts, b.counts)
            for x, y in zip([a.key, a.start, a.end, a.count, *a.values],
                            [b.key, b.start, b.end, b.count, *b.values]):
                assert torch.equal(x[:f], y[:f])
            if int(b.counts[1]) == 0:
                break
        fb = boundary
        for k in ("table", "start", "end", "open", "count", "cur_lane",
                  "dirty", "dropped", "late"):
            assert torch.equal(kst[k], pst[k]), k
        for (_k, x), (_k2, y) in zip(kst["folds"], pst["folds"]):
            assert torch.equal(x, y)
    assert int(kst["late"]) > 0


@pytest.mark.cuda
def test_step_kernel_equals_plain_on_new_keys(dev):
    """Keys new to the table: the kernel's CAS claims and the plain
    version's scatter-min claims give other slots, so the states are equal
    key by key, and the dirty bytes are the blocks of each table's slots."""
    gap, cap, L = 30, 1 << 12, 4
    kst = _card_state(dev, cap, L)
    pst = _clone(kst)
    fb = -(1 << 62)
    for keys, ts, v, boundary in _stream(7, steps=8, n=2048, keys=900,
                                         gap=gap):
        keys, ts, v = (torch.from_numpy(a).to(dev) for a in (keys, ts, v))
        _step(session_step, kst, keys, ts, v, gap, fb)
        _step(session_step_plain, pst, keys, ts, v, gap, fb)
        fb = boundary
        for st in (kst, pst):
            while int(_fire(session_fire if st is kst else
                            session_fire_plain, st, gap,
                            boundary).counts[1]):
                pass
        torch.cuda.synchronize()
        assert _by_key(*_port_views(_cpu(kst))) == \
            _by_key(*_port_views(_cpu(pst)))
        for st in (kst, pst):
            table = st["table"].cpu().numpy()
            blocks = set((np.flatnonzero(table != EMPTY_KEY)
                          >> DIRTY_SHIFT).tolist())
            assert set(np.flatnonzero(
                st["dirty"].cpu().numpy()).tolist()) == blocks
        assert int(kst["dropped"]) == int(pst["dropped"])
        assert int(kst["late"]) == int(pst["late"])
