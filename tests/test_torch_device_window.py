"""Port parity: the device window operator
(flink_tpu_torch/runtime/operators/device_window.py vs
flink_tpu/runtime/operators/device_window.py), both driven through their
OneInputOperatorTestHarness with the same batches and watermarks.

The stream is seeded, uses integer values (so sums and avg = sum/count in
float32 are exact and comparisons are ``==``), dips up to 1.5 panes behind
the watermark (late rows and late-but-open panes) and wraps an 8-row
ring several times. The reference runs with its native host index on and
off (off = its XLA probe path). Rows without top-k must be equal, order
and column types included; with top-k the tie rule holds per window
against the reference's full emission of the same stream."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from flink_tpu.core.config import Configuration as RefConfig  # noqa: E402
from flink_tpu.core.records import Schema as RefSchema  # noqa: E402
from flink_tpu.runtime import OneInputOperatorTestHarness as RefHarness  # noqa: E402
from flink_tpu.runtime.operators import device_window as ref_dw  # noqa: E402
from flink_tpu.window import SlidingEventTimeWindows as RefSliding  # noqa: E402
from flink_tpu_torch.core import Schema  # noqa: E402
from flink_tpu_torch.runtime import OneInputOperatorTestHarness  # noqa: E402
from flink_tpu_torch.runtime.operators import device_window as port_dw  # noqa: E402
from flink_tpu_torch.window import SlidingEventTimeWindows  # noqa: E402

FIELDS = [("k", np.int64), ("v", np.int64)]
ALL = [("sum", "v", None), ("count", None, None), ("min", "v", None),
       ("max", "v", None), ("avg", "v", None)]


def _stream(seed=7, steps=30, keys=9):
    """[("batch", rows, ts) | ("wm", t)]: the stream of
    tests/test_incremental_fire.py with batch lengths from {4, 8, 16} (the
    reference's XLA path compiles once per length) plus rows behind every
    open window, as data so it can be split."""
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
        if step % 10 == 9:   # rows behind every open window: late
            ops.append(("batch", [(1, 5), (2, 7)], [max(0, t - 9000)] * 2))
    ops.append(("wm", t + 20000))
    return ops


def _feed(h, ops):
    for op in ops:
        if op[0] == "batch":
            h.process_elements(op[1], op[2])
        else:
            h.process_watermark(op[1])


def _ref_op(aggs, **kw):
    specs = [ref_dw.AggSpec(kind, field, dtype=jnp.int64, value_bits=vb)
             for kind, field, vb in aggs]
    return ref_dw.DeviceWindowAggOperator(
        RefSliding.of(5000, 1000), "k", specs, fire_incremental=False, **kw)


def _port_op(aggs, **kw):
    specs = [port_dw.AggSpec(kind, field, dtype=torch.int64, value_bits=vb)
             for kind, field, vb in aggs]
    return port_dw.DeviceWindowAggOperator(
        SlidingEventTimeWindows.of(5000, 1000), "k", specs, device="cpu",
        **kw)


def _ref_harness(op, host_index, snapshot=None):
    cfg = RefConfig().set("state.backend.tpu.host-index", host_index)
    if snapshot is not None:
        return RefHarness.restored(lambda: op, snapshot,
                                   schema=RefSchema(FIELDS), config=cfg)
    return RefHarness(op, schema=RefSchema(FIELDS), config=cfg)


def _port_harness(op, snapshot=None):
    if snapshot is not None:
        return OneInputOperatorTestHarness.restored(
            lambda: op, snapshot, schema=Schema(FIELDS))
    return OneInputOperatorTestHarness(op, schema=Schema(FIELDS))


def _batches(h):
    """[(window end timestamp, schema [(name, dtype)], rows)] per fire."""
    return [(int(b.timestamps[0]),
             [(f.name, np.dtype(f.dtype)) for f in b.schema.fields],
             [tuple(v.item() for v in r)
              for r in zip(*[b.column(f.name) for f in b.schema.fields])])
            for b in h.output.batches]


def _run(make_harness, ops):
    """Feed ``ops``, then close: ``finish`` drains fires still in flight
    (``async_fire``) before the output is read."""
    h = make_harness()
    _feed(h, ops)
    h.close()
    return _batches(h)


CASES = {
    "all_aggs": dict(aggs=ALL, kw=dict(capacity=128, ring_size=8)),
    "no_bounds": dict(aggs=ALL, kw=dict(capacity=128, ring_size=8,
                                        emit_window_bounds=False)),
    "rehash_growth": dict(aggs=ALL, kw=dict(capacity=4, ring_size=8),
                          keys=40),
    "deferred_async": dict(aggs=ALL, kw=dict(capacity=256, ring_size=8,
                                             defer_overflow=True,
                                             async_fire=True)),
    # 40 keys pass 0.6 x 64 slots: the table doubles at a fire boundary
    "deferred_growth": dict(aggs=ALL, kw=dict(capacity=64, ring_size=8,
                                              defer_overflow=True),
                            keys=40),
}


@pytest.mark.parametrize("host_index", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_rows_equal_reference(case, host_index):
    c = CASES[case]
    ops = _stream(keys=c.get("keys", 9))
    want = _run(lambda: _ref_harness(_ref_op(c["aggs"], **c["kw"]),
                                     host_index), ops)
    got = _run(lambda: _port_harness(_port_op(c["aggs"], **c["kw"])), ops)
    assert len(want) > 5
    assert got == want


_FULL: dict = {}


def _full_windows(ops):
    """The reference's full emission per window end, {end: {key: row}}
    (rows: key, start, end, sum, count, min, max, avg)."""
    if not _FULL:
        full = _run(lambda: _ref_harness(_ref_op(ALL, capacity=128,
                                                 ring_size=8), True), ops)
        _FULL.update({end: {r[0]: r for r in rows}
                      for end, _s, rows in full})
    return _FULL


FULL_COL = {"sum": 3, "count": 4, "min": 5, "max": 6, "avg": 7}
#: ranked aggregate first, then one gathered at the winners
TOPK_CASES = {
    "count_rank": [("count", None, 31), ("sum", "v", None)],
    "sum_rank": [("sum", "v", None), ("max", "v", None)],
    "avg_rank": [("avg", "v", None), ("count", None, None)],
    "max_rank": [("max", "v", None), ("min", "v", None)],
    "min_rank": [("min", "v", None), ("avg", "v", None)],
}


@pytest.mark.parametrize("host_index", [True, False])
@pytest.mark.parametrize("case", sorted(TOPK_CASES))
def test_topk_rows_follow_tie_rule(case, host_index):
    aggs = TOPK_CASES[case]
    ops = _stream()
    full = _full_windows(ops)
    kw = dict(capacity=128, ring_size=8, emit_topk=3)
    want = _run(lambda: _ref_harness(_ref_op(aggs, **kw), host_index), ops)
    got = _run(lambda: _port_harness(_port_op(aggs, **kw)), ops)
    assert [(e, s) for e, s, _r in got] == [(e, s) for e, s, _r in want]
    full_col = FULL_COL[aggs[0][0]]
    for (end, _s, prows), (_e, _s2, rrows) in zip(got, want):
        window = full[end]
        pv, rv = [r[3] for r in prows], [r[3] for r in rrows]
        assert pv == rv
        kth = pv[-1]
        assert {r[0] for r in prows if r[3] > kth} == \
            {r[0] for r in rrows if r[3] > kth}
        ties = {k for k, row in window.items() if row[full_col] == kth}
        assert {r[0] for r in prows if r[3] == kth} <= ties
        for r in prows:   # every column of a winner equals the full merge
            for j, (kind, _f, _vb) in enumerate(aggs):
                assert r[3 + j] == window[r[0]][FULL_COL[kind]]


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
@pytest.mark.parametrize("host_index", [True, False])
def test_snapshot_restores_across_packages(direction, host_index):
    """Snapshot mid-stream in one package, restore in the other, replay
    the tail: the rows before plus the rows after equal the reference's
    uninterrupted run."""
    ops = _stream()
    cut = len(ops) // 2
    kw = dict(capacity=128, ring_size=8)
    whole = _run(lambda: _ref_harness(_ref_op(ALL, **kw), host_index), ops)
    if direction == "reference_to_port":
        first = _ref_harness(_ref_op(ALL, **kw), host_index)
        resume = lambda snap: _port_harness(_port_op(ALL, **kw), snap)  # noqa: E731
    else:
        first = _port_harness(_port_op(ALL, **kw))
        resume = lambda snap: _ref_harness(_ref_op(ALL, **kw), host_index,  # noqa: E731
                                           snap)
    _feed(first, ops[:cut])
    head = _batches(first)
    snap = first.snapshot(1)
    second = resume(snap)
    _feed(second, ops[cut:])
    tail = _batches(second)
    second.close()
    assert head and tail
    assert head + tail == whole


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_snapshot_restores_under_another_ring_size(direction):
    """A checkpoint taken under ring 8 restores into ring 12 (and back):
    the live pane rows are re-seated (``conform_ring``)."""
    ops = _stream()
    cut = len(ops) // 2
    small, big = dict(capacity=128, ring_size=8), dict(capacity=128,
                                                       ring_size=12)
    whole = _run(lambda: _ref_harness(_ref_op(ALL, **small), False), ops)
    if direction == "reference_to_port":
        first = _ref_harness(_ref_op(ALL, **small), False)
        resume = lambda snap: _port_harness(_port_op(ALL, **big), snap)  # noqa: E731
    else:
        first = _port_harness(_port_op(ALL, **big))
        resume = lambda snap: _ref_harness(_ref_op(ALL, **small), False,  # noqa: E731
                                           snap)
    _feed(first, ops[:cut])
    head = _batches(first)
    second = resume(first.snapshot(1))
    _feed(second, ops[cut:])
    tail = _batches(second)
    second.close()
    assert head + tail == whole


@pytest.mark.parametrize("host_index", [True, False])
def test_backend_snapshot_equals_reference_field_by_field(host_index):
    ops = _stream()[:30]
    kw = dict(capacity=128, ring_size=8)
    ref_h = _ref_harness(_ref_op(ALL, **kw), host_index)
    port_h = _port_harness(_port_op(ALL, **kw))
    _feed(ref_h, ops)
    _feed(port_h, ops)
    want, got = ref_h.snapshot(3)["keyed"], port_h.snapshot(3)["keyed"]
    assert got["meta"] == want["meta"]
    rb, pb = want["backend"], got["backend"]
    assert pb["kind"] == rb["kind"] == "tpu"
    assert pb["max_parallelism"] == rb["max_parallelism"]
    for field in ("keys", "key_groups"):
        assert pb[field].dtype == rb[field].dtype
        np.testing.assert_array_equal(pb[field], rb[field])
    assert sorted(pb["states"]) == sorted(rb["states"])
    for name, rs in rb["states"].items():
        ps = pb["states"][name]
        assert (ps["kind"], ps["dtype"], ps["ring"]) == \
            (rs["kind"], rs["dtype"], rs["ring"])
        assert ps["values"].dtype == rs["values"].dtype
        np.testing.assert_array_equal(ps["values"], rs["values"])


def test_late_rows_are_counted_like_reference():
    ops = _stream()
    ref_h = _ref_harness(_ref_op(ALL, capacity=128, ring_size=8), False)
    port_h = _port_harness(_port_op(ALL, capacity=128, ring_size=8))
    _feed(ref_h, ops)
    _feed(port_h, ops)
    assert port_h.operator.late_dropped == ref_h.operator.late_dropped > 0


def test_operator_without_device_argument_needs_cuda():
    """The operator runs on the card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_dw.DeviceWindowAggOperator(SlidingEventTimeWindows.of(5000, 1000),
                                        "k", [port_dw.AggSpec("count")])
