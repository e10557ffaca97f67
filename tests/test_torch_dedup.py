"""Port parity: flink_tpu_torch/sql/dedup.py::DeduplicateOperator against
flink_tpu/sql/dedup.py on the same seeded input, through both packages'
OneInputOperatorTestHarness.

The device plane (``state.backend.type`` tpu, an integer key, keep-first:
the row plane's ``dedup_first``, its plain version here) and the host
plane (hashmap, keep-last) emit the reference's rows in the reference's
order, with and without a TTL and with retractions in the input.
Snapshots restore within and across the packages: the device plane's
``{"kind": "tpu"}``, the host plane's ``dedup2`` and the legacy ``dedup``;
host state migrates onto the device plane; a checkpoint before the first
batch keeps restored state; a TTL added over a snapshot without a clock
expires none of the restored keys; a run that cannot use the device plane
refuses device state. Tolerance: exact (integer columns). The cases
mirror tests/test_device_sql_state.py and tests/test_join.py (dedup).
A batch of device columns is compacted on the device; chip_smoke.py's
keep-first job (the dedup_10m cell's, at a tiny size) runs through
``env.execute()`` against its numpy oracle, and across a checkpoint and a
restore.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from flink_tpu_torch.core import Configuration, Schema
from flink_tpu_torch.core.device_records import DeviceRecordBatch
from flink_tpu_torch.core.records import RecordBatch
from flink_tpu_torch.runtime.harness import OneInputOperatorTestHarness
from flink_tpu_torch.sql import rowkind as rk
from flink_tpu_torch.sql.dedup import DeduplicateOperator

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

FIELDS = [("k", np.int64), ("v", np.int64)]
CL_FIELDS = FIELDS + [(rk.ROWKIND_COLUMN, np.int8)]
TINY = dict(keys=3000, events=1 << 14, batch=1 << 10, span_ms=3000,
            ttl_ms=1000, capacity=64, retract_batch=5)


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import types

    from flink_tpu.core.config import Configuration as RefConfig
    from flink_tpu.core.config import StateOptions
    from flink_tpu.core.records import Schema as RefSchema
    from flink_tpu.runtime.harness import OneInputOperatorTestHarness as H
    from flink_tpu.sql.dedup import DeduplicateOperator as Op
    return types.SimpleNamespace(Config=RefConfig, State=StateOptions,
                                 Schema=RefSchema, Harness=H, Op=Op)


def _port(backend="tpu", fields=FIELDS, **kw):
    op = DeduplicateOperator(0, device="cpu", **kw)
    return OneInputOperatorTestHarness(
        op, Schema(fields), Configuration({"state.backend.type": backend})), op


def _ref(ref, backend="tpu", fields=FIELDS, **kw):
    cfg = ref.Config()
    cfg.set(ref.State.BACKEND, backend)
    op = ref.Op(0, **kw)
    return ref.Harness(op, schema=ref.Schema(fields), config=cfg), op


def _rows(h) -> list:
    return [tuple(r) for r in h.get_output()]


def _data(seed, n=300, n_keys=40, span=1000, retract=0.0):
    """(rows, ts) with keys drawn from a pool, ascending ts and, with
    ``retract``, a share of UPDATE_BEFORE and DELETE rows."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_keys, n)
    vals = rng.integers(0, 4, n)         # repeats: keep-last sees no change
    ts = np.sort(rng.integers(0, span, n))
    if not retract:
        return [(int(k), int(v)) for k, v in zip(keys, vals)], ts.tolist()
    kinds = np.where(rng.random(n) < retract,
                     rng.choice([rk.UPDATE_BEFORE, rk.DELETE], n), rk.INSERT)
    return ([(int(k), int(v), int(c)) for k, v, c in zip(keys, vals, kinds)],
            ts.tolist())


def _feed(h, rows, ts, batch=7):
    for lo in range(0, len(rows), batch):
        h.process_elements(rows[lo:lo + batch], ts[lo:lo + batch])


CASES = [  # (keep, ttl_ms, retraction share, rows a batch)
    ("first", None, 0.0, 7), ("first", 120, 0.0, 7), ("first", 60, 0.0, 1),
    ("first", 120, 0.2, 9), ("last", None, 0.0, 7), ("last", 80, 0.0, 5),
    ("last", None, 0.25, 6), ("last", 100, 0.25, 1)]


@pytest.mark.parametrize("backend", ["tpu", "hashmap"])
def test_rows_equal_the_reference_in_order(ref, backend):
    for i, (keep, ttl, retract, batch) in enumerate(CASES):
        fields = CL_FIELDS if retract else FIELDS
        rows, ts = _data(i, retract=retract)
        hp, op = _port(backend, fields, keep=keep, ttl_ms=ttl)
        hr, _ = _ref(ref, backend, fields, keep=keep, ttl_ms=ttl)
        _feed(hp, rows, ts, batch)
        _feed(hr, rows, ts, batch)
        got, want = _rows(hp), _rows(hr)
        assert got == want, (keep, ttl, retract, batch)
        assert len(got) > 10
        on_device = backend == "tpu" and keep == "first"
        assert (op.backend is not None) == on_device


def _split_run(first, second, rows, ts, half):
    """Feed the first half to harness ``first``, snapshot, restore into
    ``second`` (a factory of a fresh harness), feed the rest; returns the
    rows of both and the snapshot."""
    h1 = first()
    _feed(h1, rows[:half], ts[:half])
    snap = h1.snapshot(1)
    h2 = second()
    h2.open(keyed_snapshots=[snap["keyed"]])
    _feed(h2, rows[half:], ts[half:])
    return _rows(h1) + _rows(h2), snap


@pytest.mark.parametrize("backend", ["tpu", "hashmap"])
def test_checkpoint_restore_within_and_across_packages(ref, backend):
    rows, ts = _data(21, n=240, retract=0.1)
    kw = dict(keep="first", ttl_ms=150)
    full = _rows(_full(ref, backend, rows, ts, **kw))
    port = lambda: _port(backend, CL_FIELDS, **kw)[0]      # noqa: E731
    refh = lambda: _ref(ref, backend, CL_FIELDS, **kw)[0]  # noqa: E731
    for a, b in ((port, port), (port, refh), (refh, port)):
        got, snap = _split_run(a, b, rows, ts, 133)
        assert got == full
        backend_snap = snap["keyed"]["backend"]
        assert ("kind" in backend_snap) == (backend == "tpu")


def _full(ref, backend, rows, ts, **kw):
    h, _ = _ref(ref, backend, CL_FIELDS, **kw)
    _feed(h, rows, ts)
    return h


def test_device_snapshot_equals_reference_field_by_field(ref):
    rows, ts = _data(4, n=200)
    hp, op = _port(ttl_ms=90)
    hr, _ = _ref(ref, ttl_ms=90)
    _feed(hp, rows, ts)
    _feed(hr, rows, ts)
    a, b = hp.snapshot(3)["keyed"]["backend"], hr.snapshot(3)["keyed"][
        "backend"]
    assert np.array_equal(a["keys"], b["keys"])
    assert np.array_equal(a["key_groups"], b["key_groups"])
    assert a["states"].keys() == b["states"].keys() == {
        "__seen__", "__seen__.__set__", "__seen__.__ts__"}
    for name in a["states"]:
        for f in ("kind", "dtype", "ring"):
            assert a["states"][name][f] == b["states"][name][f]
        assert np.array_equal(a["states"][name]["values"],
                              b["states"][name]["values"])


def test_checkpoint_before_first_batch_keeps_restored_state(ref):
    rows = [(int(k), int(k)) for k in range(30)]
    for make in (lambda: _port()[0], lambda: _ref(ref)[0]):
        h1 = make()
        h1.process_elements(rows, list(range(30)))
        snap1 = h1.snapshot(1)
        h2 = _port()[0]
        h2.open(keyed_snapshots=[snap1["keyed"]])
        snap2 = h2.snapshot(2)          # before any batch
        assert len(snap2["keyed"]["backend"]["keys"]) == 30
        h3 = make()
        h3.open(keyed_snapshots=[snap2["keyed"]])
        h3.process_elements(rows + [(99, 99)], list(range(31)))
        assert _rows(h3) == [(99, 99)]


def test_ttl_clock_added_over_a_no_ttl_snapshot(ref):
    rows = [(int(k), int(k)) for k in range(10)]
    outs = []
    for make in (lambda **kw: _port(**kw)[0], lambda **kw: _ref(ref, **kw)[0]):
        h1 = make()
        h1.process_elements(rows, list(range(10)))
        snap = h1.snapshot(1)
        for restore_into in (lambda: _port(ttl_ms=100)[0],
                             lambda: _ref(ref, ttl_ms=100)[0]):
            h2 = restore_into()
            h2.open(keyed_snapshots=[snap["keyed"]])
            h2.process_elements(rows + [(50, 50)], [10 ** 6] * 11)
            outs.append(_rows(h2))
    assert outs == [[(50, 50)]] * 4


def test_host_state_migrates_to_the_device_plane(ref):
    rows = [(int(k), int(k)) for k in range(20)]
    h1, _ = _port("hashmap")
    h1.process_elements(rows, list(range(20)))
    snap = h1.snapshot(1)
    assert "dedup2" in snap["keyed"]["backend"]
    hr, _ = _ref(ref, "hashmap")
    hr.process_elements(rows, list(range(20)))
    assert hr.snapshot(1) == snap
    legacy = {"dedup": {kg: {k: True for k in m}
                        for kg, m in snap["keyed"]["backend"]["dedup2"]
                        .items()}}
    for keyed in (snap["keyed"], {"backend": legacy}):
        outs = []
        for h, op in (_port(), _ref(ref)):
            h.open(keyed_snapshots=[keyed])
            h.process_elements(rows + [(77, 77)], list(range(21)))
            outs.append(_rows(h))
            assert op._backend is not None
        assert outs == [[(77, 77)]] * 2


def test_device_state_refuses_a_run_off_the_device_plane(ref):
    rows = [(int(k), int(k)) for k in range(5)]
    h, _ = _port()
    h.process_elements(rows, list(range(5)))
    keyed = h.snapshot(1)["keyed"]
    for backend, keep in (("hashmap", "first"), ("tpu", "last")):
        h2, _ = _port(backend, keep=keep)
        with pytest.raises(RuntimeError, match="tpu backend"):
            h2.open(keyed_snapshots=[keyed])
    h3, _ = _port(fields=[("k", np.float64), ("v", np.int64)])
    h3.open(keyed_snapshots=[keyed])
    with pytest.raises(RuntimeError, match="not integer"):
        h3.process_elements([(1.5, 1)], [0])
    with pytest.raises(ValueError, match="keep"):
        DeduplicateOperator(0, keep="middle", device="cpu")


def test_device_batches_compact_on_the_device():
    """A batch of device columns (a rowkind column among them) admits the
    same rows as the same batch on the host, and leaves as device
    columns."""
    rows, ts = _data(8, n=400, retract=0.15)
    arr = np.asarray(rows, np.int64)
    schema = Schema(CL_FIELDS)
    outs = []
    for device_batch in (False, True):
        h, _ = _port(fields=CL_FIELDS, ttl_ms=200)
        for lo in range(0, 400, 64):
            cols = {"k": arr[lo:lo + 64, 0], "v": arr[lo:lo + 64, 1],
                    rk.ROWKIND_COLUMN: arr[lo:lo + 64, 2].astype(np.int8)}
            t = np.asarray(ts[lo:lo + 64], np.int64)
            if device_batch:
                h.process_batch(DeviceRecordBatch(
                    schema, {n: torch.from_numpy(c) for n, c in cols.items()},
                    torch.from_numpy(t), int(t.min()), int(t.max())))
            else:
                h.process_batch(RecordBatch(schema, cols, t))
        assert all(getattr(b, "is_device", False) == device_batch
                   for b in h.output.batches)
        outs.append((_rows(h), np.concatenate(
            [b.timestamps for b in h.output.batches])))
    assert outs[0][0] == outs[1][0] and len(outs[0][0]) > 20
    assert np.array_equal(outs[0][1], outs[1][1])


def test_keep_first_job_equals_the_oracle_and_restores():
    c = cs.dedup_config(**TINY)
    expected = cs.dedup_expected(c)
    job, got = cs.run_dedup(torch, torch.device("cpu"), c)
    assert cs.dedup_check(expected, got) == len(expected) > 1000
    op = cs.dedup_operator(job)
    assert op.stats["batches"] == c["events"] // c["batch"]
    assert op.backend.capacity > c["capacity"]      # grown by rehash
    rec = cs.dedup_checkpoint(torch, torch.device("cpu"), c, expected)
    assert rec["rows_before"] and rec["rows_after_restore"]
