"""Port parity: the device session-window operator
(flink_tpu_torch/runtime/operators/device_session.py vs
flink_tpu/runtime/operators/device_session.py), both driven through their
OneInputOperatorTestHarness with the same batches and watermarks.

The cases are those of tests/test_device_session.py. Streams are made
with numpy from seeds; values are integers, so every sum is exact and
avg = sum / count in float32 is the same in both packages. Each harness is
closed before its rows are read, and the rows (key, window_start,
window_end, aggregates) must be equal as sets, exactly. The port runs on
the CPU, where its kernels' plain versions run."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from flink_tpu.core.records import RecordBatch as RefBatch  # noqa: E402
from flink_tpu.core.records import Schema as RefSchema  # noqa: E402
from flink_tpu.runtime import OneInputOperatorTestHarness as RefHarness  # noqa: E402
from flink_tpu.runtime.operators import device_session as ref_ds  # noqa: E402
from flink_tpu.runtime.operators import device_window as ref_dw  # noqa: E402
from flink_tpu_torch.core.records import RecordBatch, Schema  # noqa: E402
from flink_tpu_torch.runtime import OneInputOperatorTestHarness  # noqa: E402
from flink_tpu_torch.runtime.operators import AggSpec, \
    DeviceSessionWindowOperator  # noqa: E402

FIELDS = [("k", np.int64), ("v", np.int64)]
SUM_COUNT = [("sum", "v", "total"), ("count", None, "cnt")]
ALL_KINDS = [("sum", "v", "total"), ("count", None, "cnt"),
             ("min", "v", "lo"), ("max", "v", "hi"), ("avg", "v", "mean")]


def ref_op(gap, aggs=SUM_COUNT, capacity=1 << 10, lanes=4):
    return ref_ds.DeviceSessionWindowOperator(
        gap, "k", [ref_dw.AggSpec(kind, field, out_name=out)
                   for kind, field, out in aggs],
        capacity=capacity, lanes=lanes)


def port_op(gap, aggs=SUM_COUNT, capacity=1 << 10, lanes=4):
    return DeviceSessionWindowOperator(
        gap, "k", [AggSpec(kind, field, out_name=out)
                   for kind, field, out in aggs],
        capacity=capacity, lanes=lanes, device="cpu")


def harness(pkg, op):
    if pkg == "ref":
        return RefHarness(op, schema=RefSchema(FIELDS))
    return OneInputOperatorTestHarness(op, schema=Schema(FIELDS))


def feed(pkg, h, batches, wms, final=True):
    Batch, schema = ((RefBatch, RefSchema(FIELDS)) if pkg == "ref"
                     else (RecordBatch, Schema(FIELDS)))
    for (rows, ts), wm in zip(batches, wms):
        h.process_batch(Batch.from_rows(schema, list(rows), list(ts)))
        h.process_watermark(wm)
    if final:
        h.process_watermark(1 << 40)


def rows_of(h, aggs=SUM_COUNT) -> set:
    """Close the harness, then its rows as a set of int tuples (avg in
    float, exact for these streams)."""
    h.close()
    out = set()
    for b in h.output.batches:
        cols = [np.asarray(b.column(c)) for c in
                ["k", "window_start", "window_end"] + [o for *_, o in aggs]]
        for i in range(b.n):
            out.add(tuple(c[i].item() for c in cols))
    return out


def run_both(gap, batches, wms, aggs=SUM_COUNT, **kw):
    """(reference rows, port rows, reference op, port op)."""
    got = {}
    for pkg, make in (("ref", ref_op), ("port", port_op)):
        op = make(gap, aggs, **kw)
        h = harness(pkg, op)
        feed(pkg, h, batches, wms)
        got[pkg] = (rows_of(h, aggs), op)
    return got["ref"][0], got["port"][0], got["ref"][1], got["port"][1]


def test_basic_sessions():
    batches = [([(1, 10), (1, 20), (2, 5)], [100, 150, 120]),
               ([(1, 7)], [400]),
               ([(2, 3)], [180])]
    ref, port, _, _ = run_both(100, batches, [200, 500, 1000])
    assert port == ref and len(port) >= 3


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_inorder_stream(seed):
    rng = np.random.default_rng(seed)
    n = 600
    ts = np.cumsum(rng.integers(0, 40, n)).tolist()
    rows = list(zip(rng.integers(0, 12, n).tolist(),
                    rng.integers(1, 10, n).tolist()))
    batches, wms = [], []
    for i in range(0, n, 49):
        batches.append((rows[i:i + 49], ts[i:i + 49]))
        wms.append(max(ts[i:i + 49]) - 25)
    ref, port, _, _ = run_both(250, batches, wms, lanes=8)
    assert port == ref and len(port) > 100


def test_gap_bounded_disorder():
    batches = [([(7, 1)], [1000]), ([(7, 2)], [950]), ([(7, 4)], [1080])]
    ref, port, _, _ = run_both(100, batches, [500, 500, 500])
    assert port == ref == {(7, 950, 1180, 7, 3)}


def test_late_events_dropped_like_reference():
    batches = [([(3, 1)], [100]), ([(3, 9)], [10])]
    ref, port, rop, pop = run_both(50, batches, [200, 300])
    assert port == ref
    assert pop.late_dropped == rop.late_dropped == 1


def test_multiple_open_sessions_one_key():
    batches = [([(5, 1), (5, 2)], [100, 101]),
               ([(5, 4), (5, 8)], [200, 201])]
    ref, port, _, _ = run_both(10, batches, [50, 50])
    assert port == ref and len(port) == 2


def test_lane_overflow_raises():
    """Six concurrently open sessions of one key on two lanes: both
    packages raise at the next fire."""
    batches = [([(9, 1)], [i * 1000]) for i in range(6)]
    for pkg, make in (("ref", ref_op), ("port", port_op)):
        h = harness(pkg, make(10, lanes=2))
        with pytest.raises(RuntimeError, match="session"):
            feed(pkg, h, batches, [1] * 6)


def test_event_merges_into_segment_closed_in_batch():
    gap = 50
    batches = [([(7, 1)] * 4, [100, 110, 200, 210]), ([(7, 1)], [130])]
    ref, port, _, _ = run_both(gap, batches, [0, 0])
    assert port == ref
    assert (7, 100, 130 + gap, 3, 3) in port


def test_random_gap_bounded_disorder_parity():
    rng = np.random.default_rng(17)
    n = 400
    keys = rng.integers(0, 12, n)
    base = np.sort(rng.integers(0, 4000, n))
    ts = np.maximum(base + rng.integers(-35, 35, n), 0)
    rows = [(int(k), 1) for k in keys]
    half = n // 2
    batches = [(rows[:half], ts[:half].tolist()),
               (rows[half:], ts[half:].tolist())]
    wms = [int(ts[:half].max()) - 200, int(ts.max())]
    ref, port, _, _ = run_both(40, batches, wms, lanes=64)
    assert port == ref


@pytest.mark.parametrize("seed", [5, 6])
def test_every_aggregate_kind_with_disorder_and_late_rows(seed):
    """sum, count, min, max and avg over a stream with disorder up to twice
    the gap (so late rows, merges of out-of-order events and several open
    lanes per key), negative values, and a watermark at each batch's
    largest timestamp."""
    rng = np.random.default_rng(seed)
    n, gap = 700, 60
    ts = (np.sort(rng.integers(0, 9000, n))
          + rng.integers(-2 * gap, 2 * gap, n)).tolist()
    rows = list(zip(rng.integers(0, 20, n).tolist(),
                    rng.integers(-50, 50, n).tolist()))
    batches, wms = [], []
    for i in range(0, n, 37):
        batches.append((rows[i:i + 37], ts[i:i + 37]))
        wms.append(max(ts[i:i + 37]))
    ref, port, rop, pop = run_both(gap, batches, wms, ALL_KINDS, lanes=16)
    assert port == ref and len(port) > 50
    assert pop.late_dropped == rop.late_dropped > 0
