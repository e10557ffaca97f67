"""Port parity: the incremental fire engine and coalesced ingest of the
device window operator (flink_tpu_torch/runtime/operators/device_window.py
with ``window.fire.incremental``, slice_control.py::CoalescingIngest)
against the reference operator
(flink_tpu/runtime/operators/device_window.py), the cases of
tests/test_incremental_fire.py: every aggregate kind, top-k, the
min/max-only tree path, checkpoint and restore mid-window in both fire
modes and across the two packages, config enabling, and coalesced ingest.

Both operators run through their OneInputOperatorTestHarness on the same
seeded stream: integer values (every sum exact in any order, so ``==``),
out-of-order timestamps that dip behind the watermark (late rows, and
late-but-open rows that write into sealed panes: the rebuild trigger), and
an 8-row ring that wraps several times. Rows without top-k must equal the
reference's, order and column dtypes included; with top-k the tie rule
holds (values equal, keys above the k-th value equal, keys at it from its
tie class). The device counters of both packages must move by the same
amounts on the same stream, which holds the seal/rebuild decisions to the
reference's trigger logic.

The reference's degraded-rung case (``_degrade`` mid-stream) waits for the
port's degrade ladder, a later slice.
"""

import importlib.util
import pathlib
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from flink_tpu.core.config import Configuration as RefConfig  # noqa: E402
from flink_tpu.core.records import Schema as RefSchema  # noqa: E402
from flink_tpu.metrics import DEVICE_STATS as REF_STATS  # noqa: E402
from flink_tpu.runtime import OneInputOperatorTestHarness as RefHarness  # noqa: E402
from flink_tpu.runtime.operators import device_window as ref_dw  # noqa: E402
from flink_tpu.window import SlidingEventTimeWindows as RefSliding  # noqa: E402
from flink_tpu_torch.core import Configuration, Schema  # noqa: E402
from flink_tpu_torch.metrics import DEVICE_STATS  # noqa: E402
from flink_tpu_torch.runtime import OneInputOperatorTestHarness  # noqa: E402
from flink_tpu_torch.runtime.operators import device_window as port_dw  # noqa: E402
from flink_tpu_torch.window import SlidingEventTimeWindows  # noqa: E402

FIELDS = [("k", np.int64), ("v", np.int64)]
ALL = [("sum", "v", None), ("count", None, None), ("min", "v", None),
       ("max", "v", None), ("avg", "v", None)]
TOPK = [("count", None, 31), ("sum", "v", None)]
MINMAX = [("min", "v", None), ("max", "v", None)]
COUNTERS = ("panes_sealed_total", "fire_merge_rows_read",
            "batches_coalesced_total")


def _stream(seed=7, steps=40, keys=9):
    """[("batch", rows, ts) | ("wm", t)]: the stream of
    tests/test_incremental_fire.py with batch lengths from {4, 8, 16} (the
    reference compiles once per length) and rows behind every open window
    every 10 steps."""
    rng = np.random.default_rng(seed)
    ops, t = [], 0
    for step in range(steps):
        n = int(rng.choice([4, 8, 16]))
        ks = rng.integers(0, keys, n)
        vs = rng.integers(-50, 50, n)
        ts = rng.integers(max(0, t - 1500), t + 900, n)
        ops.append(("batch", list(zip(ks.tolist(), vs.tolist())),
                    ts.tolist()))
        t += 700
        if step % 3 == 2:
            ops.append(("wm", t))
        if step % 10 == 9:
            ops.append(("batch", [(1, 5), (2, 7)], [max(0, t - 9000)] * 2))
    ops.append(("wm", t + 20000))
    return ops


OPS = _stream()
CUT = len(OPS) // 2


def _ref_op(aggs, inc, topk=None):
    specs = [ref_dw.AggSpec(kind, field, dtype=jnp.int64, value_bits=vb)
             for kind, field, vb in aggs]
    return ref_dw.DeviceWindowAggOperator(
        RefSliding.of(5000, 1000), "k", specs, capacity=128, ring_size=8,
        emit_topk=topk, fire_incremental=inc)


def _port_op(aggs, inc, topk=None):
    specs = [port_dw.AggSpec(kind, field, dtype=torch.int64, value_bits=vb)
             for kind, field, vb in aggs]
    return port_dw.DeviceWindowAggOperator(
        SlidingEventTimeWindows.of(5000, 1000), "k", specs, capacity=128,
        ring_size=8, emit_topk=topk, fire_incremental=inc, device="cpu")


def _ref_harness(op, settings=None, snapshot=None):
    cfg = RefConfig()
    for k, v in (settings or {}).items():
        cfg.set(k, v)
    if snapshot is not None:
        return RefHarness.restored(lambda: op, snapshot,
                                   schema=RefSchema(FIELDS), config=cfg)
    return RefHarness(op, schema=RefSchema(FIELDS), config=cfg)


def _port_harness(op, settings=None, snapshot=None):
    cfg = Configuration(settings or {})
    if snapshot is not None:
        return OneInputOperatorTestHarness.restored(
            lambda: op, snapshot, schema=Schema(FIELDS), config=cfg)
    return OneInputOperatorTestHarness(op, schema=Schema(FIELDS), config=cfg)


def _feed(h, ops):
    for op in ops:
        if op[0] == "batch":
            h.process_elements(op[1], op[2])
        else:
            h.process_watermark(op[1])


def _batches(h):
    """[(window end timestamp, schema [(name, dtype)], rows)] per fire."""
    return [(int(b.timestamps[0]),
             [(f.name, np.dtype(f.dtype)) for f in b.schema.fields],
             [tuple(v.item() for v in r)
              for r in zip(*[b.column(f.name) for f in b.schema.fields])])
            for b in h.output.batches]


def _run(make_harness, stats, ops=OPS):
    """(fires, counter deltas, operator) of one whole run."""
    before = stats.snapshot()
    h = make_harness()
    _feed(h, ops)
    h.close()
    after = stats.snapshot()
    return (_batches(h), {c: after.get(c, 0) - before.get(c, 0)
                          for c in COUNTERS}, h.operator)


#: name -> (aggs, top k, fire_incremental kwarg, config settings)
CASES = {
    "all_aggs": (ALL, None, True, {}),
    "topk": (TOPK, 3, True, {}),
    "minmax_tree_only": (MINMAX, None, True, {}),
    "config_enables": (ALL, None, None, {"window.fire.incremental": True}),
    "coalesced": (ALL, None, None, {"window.fire.incremental": True,
                                    "task.coalesce.target-records": 4096}),
}


@pytest.fixture(scope="module")
def reference():
    """The reference's runs, shared by the tests of this module: {case:
    (fires, counter deltas)} and {("full", aggs): (fires, counter
    deltas)}, the full-merge emission of every window."""
    out = {}
    for name, (aggs, topk, inc, settings) in CASES.items():
        fires, deltas, _op = _run(
            lambda: _ref_harness(_ref_op(aggs, inc, topk), settings),
            REF_STATS)
        out[name] = (fires, deltas)
        key = ("full", tuple(aggs))
        if key not in out:
            out[key] = _run(lambda: _ref_harness(_ref_op(aggs, False)),
                            REF_STATS)[:2]
    return out


def _assert_topk_rule(got, want, full):
    """Per fire: the same windows and schemas, equal ranked values, equal
    keys above the k-th value, the keys at it from its tie class, and
    every winner's row equal to its row in the full emission ``full`` of
    the same window (rows: key, start, end, ranked, other aggregate)."""
    assert [(e, s) for e, s, _r in got] == [(e, s) for e, s, _r in want]
    windows = {end: {r[0]: r for r in rows} for end, _s, rows in full}
    for (end, _s, prows), (_e, _s2, rrows) in zip(got, want):
        assert [r[3] for r in prows] == [r[3] for r in rrows]
        kth = prows[-1][3]
        assert {r[0] for r in prows if r[3] > kth} == \
            {r[0] for r in rrows if r[3] > kth}
        window = windows[end]
        assert {r[0] for r in prows if r[3] == kth} <= \
            {k for k, row in window.items() if row[3] == kth}
        assert all(window[r[0]] == r for r in prows)


@pytest.mark.parametrize("case", sorted(CASES))
def test_rows_and_counters_equal_reference(case, reference):
    aggs, topk, inc, settings = CASES[case]
    want, want_deltas = reference[case]
    got, deltas, op = _run(
        lambda: _port_harness(_port_op(aggs, inc, topk), settings),
        DEVICE_STATS)
    assert op._inc_enabled
    assert len(want) > 10
    if topk is None:
        assert got == want
        assert got == reference[("full", tuple(aggs))][0]
    else:
        _assert_topk_rule(got, want, reference[("full", tuple(aggs))][0])
        # the port's own full merge ranks the same slots: rows equal
        full, _d, _o = _run(lambda: _port_harness(_port_op(aggs, False,
                                                           topk)),
                            DEVICE_STATS)
        assert got == full
    assert deltas == want_deltas
    assert deltas["panes_sealed_total"] > 0
    # the stream writes into sealed panes: seals and rebuilds both ran
    assert op.inc_rebuilds.get("first fire") == 1
    assert op.inc_rebuilds.get("write into a sealed pane", 0) > 0
    if case == "coalesced":
        assert deltas["batches_coalesced_total"] > 0


def test_full_mode_counts_merge_rows_like_reference(reference):
    got, deltas, _op = _run(lambda: _port_harness(_port_op(ALL, False)),
                            DEVICE_STATS)
    want, want_deltas = reference[("full", tuple(ALL))]
    assert got == want
    assert deltas == want_deltas and deltas["panes_sealed_total"] == 0


#: (writer, writer incremental, reader incremental)
RESTORES = [(w, a, b) for w in ("port", "reference")
            for a, b in ((True, True), (True, False), (False, True))]


@pytest.mark.parametrize("writer,write_inc,read_inc", RESTORES)
def test_snapshot_restores_mid_window(writer, write_inc, read_inc,
                                      reference):
    """Snapshot mid-stream (open windows, sealed panes) in one package
    and fire mode, restore into the other package (or the port, from the
    port) and the other mode, replay the tail: the rows before plus the
    rows after equal the reference's uninterrupted full-merge run. The
    derived window planes never ride in a snapshot, so the restored
    incremental operator rebuilds at its first fire."""
    whole = reference[("full", tuple(ALL))][0]
    if writer == "port":
        first = _port_harness(_port_op(ALL, write_inc))
        readers = [lambda snap: _port_harness(_port_op(ALL, read_inc),
                                              snapshot=snap),
                   lambda snap: _ref_harness(_ref_op(ALL, read_inc),
                                             snapshot=snap)]
    else:
        first = _ref_harness(_ref_op(ALL, write_inc))
        readers = [lambda snap: _port_harness(_port_op(ALL, read_inc),
                                              snapshot=snap)]
    _feed(first, OPS[:CUT])
    head = _batches(first)
    snap = first.snapshot(1)
    assert all("__win__" not in n and "__tree__" not in n
               for n in snap["keyed"]["backend"]["states"])
    for resume in readers:
        second = resume(snap)
        _feed(second, OPS[CUT:])
        tail = _batches(second)
        second.close()
        assert head and tail
        assert head + tail == whole
        op = second.operator
        if read_inc and isinstance(op, port_dw.DeviceWindowAggOperator):
            assert op.inc_rebuilds.get("restore") == 1


def test_incremental_snapshot_equals_reference_field_by_field():
    """Mid-stream in incremental mode, the port's snapshot equals the
    reference's: the same pane planes, no window planes."""
    ref_h = _ref_harness(_ref_op(ALL, True))
    port_h = _port_harness(_port_op(ALL, True))
    _feed(ref_h, OPS[:CUT])
    _feed(port_h, OPS[:CUT])
    want, got = ref_h.snapshot(3)["keyed"], port_h.snapshot(3)["keyed"]
    assert got["meta"] == want["meta"]
    rb, pb = want["backend"], got["backend"]
    for field in ("keys", "key_groups"):
        np.testing.assert_array_equal(pb[field], rb[field])
    assert sorted(pb["states"]) == sorted(rb["states"])
    for name, rs in rb["states"].items():
        ps = pb["states"][name]
        assert (ps["kind"], ps["dtype"], ps["ring"]) == \
            (rs["kind"], rs["dtype"], rs["ring"])
        np.testing.assert_array_equal(ps["values"], rs["values"])
    # the port's backend holds the window planes all the same
    assert port_h.operator.backend.has_array("__count__.__win__")
    assert port_h.operator.backend.has_array("max_v.__tree__")


def test_window_planes_follow_a_rehash():
    """A table that doubles mid-stream re-keys the window planes too: the
    incremental rows still equal the reference's full merge."""
    ops = _stream(keys=40)

    def port_op():
        specs = [port_dw.AggSpec(k, f, dtype=torch.int64, value_bits=vb)
                 for k, f, vb in ALL]
        return port_dw.DeviceWindowAggOperator(
            SlidingEventTimeWindows.of(5000, 1000), "k", specs, capacity=4,
            ring_size=8, fire_incremental=True, device="cpu")

    got, _d, op = _run(lambda: _port_harness(port_op()), DEVICE_STATS, ops)
    want, _d2, _o = _run(lambda: _ref_harness(_ref_op(ALL, False)),
                         REF_STATS, ops)
    assert op.backend.capacity > 4
    assert got == want


def test_coalescing_flushes_at_deadline_and_watermark():
    """The buffer flushes at its age deadline (checked at the next
    admit) and at every watermark; the rows equal an uncoalesced run."""
    ops = [("batch", [(1, 2), (3, 4)], [10, 20]), ("sleep",),
           ("batch", [(1, 2)], [30]), ("batch", [(5, 6)], [40]),
           ("wm", 5000)]
    op = _port_op(ALL, True)
    h = _port_harness(op, {"task.coalesce.target-records": 1 << 20,
                           "task.coalesce.timeout-ms": 2})
    buffered = []
    for step in ops:
        if step[0] == "sleep":
            time.sleep(0.01)
            continue
        _feed(h, [step])
        buffered.append(len(op._co_buf))
    h.close()
    # buffered; past the deadline at the next admit: flushed; buffered
    # anew; flushed by the watermark
    assert buffered == [1, 0, 1, 0]
    plain = _port_harness(_port_op(ALL, True))
    _feed(plain, [s for s in ops if s[0] != "sleep"])
    plain.close()
    assert _batches(h) == _batches(plain) and len(_batches(h)) == 5


def _smoke():
    root = pathlib.Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("mode", ["full", "incremental"])
@pytest.mark.parametrize("window_panes", [5, 20])
def test_smoke_q5_in_both_modes_passes_its_oracle(mode, window_panes):
    """chip_smoke.py's Q5 at W = 5 and at W = 20 (ring 46, bench.py's
    --window-panes sweep), tiny, on the CPU: every window passes the
    numpy oracle, and the incremental run rebuilds at its first fire
    only, then seals once per fire."""
    cs = _smoke()
    before = DEVICE_STATS.snapshot()["panes_sealed_total"]
    job, got, span = cs.run_q5(torch, torch.device("cpu"), 3000, 1 << 14,
                               1 << 13, batch=1 << 10, topk=20,
                               fire_mode=mode, window_panes=window_panes)
    n = cs.q5_oracle_check(3000, 1 << 14, span, got, topk=20,
                           window_panes=window_panes)
    op = job.operators[0]
    assert op._ring == cs.ring_for(window_panes)
    assert n == {5: 13, 20: 16 + 20 - 1}[window_panes]
    sealed = DEVICE_STATS.snapshot()["panes_sealed_total"] - before
    if mode == "incremental":
        assert op.inc_rebuilds == {"first fire": 1}
        assert sealed == n   # the first fire's window holds one pane
    else:
        assert op.inc_rebuilds == {} and sealed == 0


def test_smoke_coalesced_q5_passes_its_oracle():
    """chip_smoke.py's coalesced ingest, tiny, on the CPU: device batches
    of 256 rows gather to 2048 records (one step per 8 batches, joined
    with torch.cat), a watermark every 8 batches, every window equal to
    the oracle."""
    cs = _smoke()
    before = DEVICE_STATS.snapshot()["batches_coalesced_total"]
    op, got, span = cs.run_coalesced_q5(
        torch, torch.device("cpu"), 3000, 1 << 14, 1 << 13, batch=1 << 8,
        target=1 << 11, wm_every=8, topk=20)
    assert cs.q5_oracle_check(3000, 1 << 14, span, got, topk=20) == \
        len(got) > 0
    assert DEVICE_STATS.snapshot()["batches_coalesced_total"] - before == 64
