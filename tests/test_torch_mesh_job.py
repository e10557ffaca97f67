"""Port parity: the mesh window operator inside the framework
(flink_tpu_torch/runtime/operators/mesh_window.py, the builtin aggregates'
mesh route and ``mesh_aggregate``, ``cluster/local.py::live_rescale``)
against flink_tpu's MeshWindowAggOperator on the 8 virtual CPU devices of
tests/conftest.py.

Both operators run through their OneInputOperatorTestHarness on the same
seeded streams, or both packages' ``env.execute()`` on the same pipeline.
Rows without top-k compare as sorted rows (the reference emits in slot
order, the port in key order); top-k fires under the tie rule. Integer
values, so sums and averages compare with ``==`` (tolerance 0). Snapshots
compare field by field with the reference's rows put in canonical (group,
key) order, and restore across the two packages, across mesh sizes
(8 -> 4 -> 8) and to and from the single-device operator. Each test
resets both packages' ``MESH_RUNTIME``.
"""

import importlib.util
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from flink_tpu.core.records import Schema as RefSchema  # noqa: E402
from flink_tpu.parallel import MESH_RUNTIME as REF_MESH  # noqa: E402
from flink_tpu.runtime import OneInputOperatorTestHarness as RefHarness  # noqa: E402
from flink_tpu.runtime.operators import device_window as ref_dw  # noqa: E402
from flink_tpu.runtime.operators.mesh_window import (  # noqa: E402
    MeshWindowAggOperator as RefMesh)
from flink_tpu.window import (  # noqa: E402
    SlidingEventTimeWindows as RefSliding,
    TumblingEventTimeWindows as RefTumbling)
from flink_tpu_torch.core import Configuration, Schema  # noqa: E402
from flink_tpu_torch.core.device_records import DeviceRecordBatch  # noqa: E402
from flink_tpu_torch.metrics import DEVICE_STATS  # noqa: E402
from flink_tpu_torch.parallel import MESH_RUNTIME  # noqa: E402
from flink_tpu_torch.runtime import OneInputOperatorTestHarness  # noqa: E402
from flink_tpu_torch.runtime.operators import device_window as port_dw  # noqa: E402
from flink_tpu_torch.runtime.operators.mesh_window import (  # noqa: E402
    MeshWindowAggOperator)
from flink_tpu_torch.window import (  # noqa: E402
    SlidingEventTimeWindows, TumblingEventTimeWindows)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIELDS = [("key", np.int64), ("v", np.int64)]
SUM = [("sum", "v", None)]
MULTI = [("sum", "v", None), ("count", None, 31), ("max", "v", None),
         ("min", "v", None), ("avg", "v", None)]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


@pytest.fixture(autouse=True)
def _reset_mesh_runtime():
    yield
    MESH_RUNTIME.reset()
    REF_MESH.reset()


def _gen(seed, n, n_keys=50, t_max=10_000, late=False):
    rng = np.random.default_rng(seed)
    elements = [(int(k), int(v)) for k, v in
                zip(rng.integers(-n_keys, n_keys, n), rng.integers(1, 10, n))]
    ts = sorted(rng.integers(0, t_max, n).tolist())
    return elements, ts


def _assigners(kind):
    return {"tumbling": (RefTumbling.of(1000), TumblingEventTimeWindows.of(
        1000)),
            "sliding": (RefSliding.of(1000, 250),
                        SlidingEventTimeWindows.of(1000, 250))}[kind]


def _ref_op(w, aggs=SUM, n=8, **kw):
    kw.setdefault("capacity", 1 << 10)
    kw.setdefault("device_batch", 64)
    specs = [ref_dw.AggSpec(k, f, out_name=("result" if aggs is SUM
                                            else None), dtype=jnp.int64,
                            value_bits=vb) for k, f, vb in aggs]
    return RefMesh(w, "key", specs, n_devices=n, emit_window_bounds=False,
                   **kw)


def _port_op(w, aggs=SUM, n=8, **kw):
    kw.setdefault("capacity", 1 << 10)
    kw.setdefault("device_batch", 64)
    specs = [port_dw.AggSpec(k, f, out_name=("result" if aggs is SUM
                                             else None), dtype=torch.int64,
                             value_bits=vb) for k, f, vb in aggs]
    return MeshWindowAggOperator(w, "key", specs, n_devices=n,
                                 emit_window_bounds=False, device="cpu",
                                 **kw)


def _rows(h):
    return sorted(tuple(v.item() if hasattr(v, "item") else v for v in r)
                  for r in h.get_output())


def _run(h, elements, ts, wm_every=None):
    if wm_every is None:
        h.process_elements(elements, ts)
    else:
        for i in range(0, len(elements), wm_every):
            h.process_elements(elements[i:i + wm_every], ts[i:i + wm_every])
            h.process_watermark(ts[min(i + wm_every, len(ts)) - 1] - 300)
    h.process_watermark(10**9)
    h.operator.finish()
    return _rows(h)


def _both(w_kind, elements, ts, aggs=SUM, wm_every=None, settings=None,
          **kw):
    rw, pw = _assigners(w_kind)
    cfg = Configuration(settings or {})
    rh = RefHarness(_ref_op(rw, aggs, **kw), schema=RefSchema(FIELDS))
    ph = OneInputOperatorTestHarness(_port_op(pw, aggs, **kw),
                                     schema=Schema(FIELDS), config=cfg)
    return _run(rh, elements, ts, wm_every), _run(ph, elements, ts,
                                                  wm_every), ph


def test_tumbling_and_sliding_parity_with_reference():
    for w, seed in (("tumbling", 11), ("sliding", 12)):
        elements, ts = _gen(seed, 700, t_max=6000)
        for aggs in (SUM, MULTI):
            want, got, _h = _both(w, elements, ts, aggs, wm_every=97)
            assert got == want, (w, aggs)


def test_fire_modes_and_async_parity():
    """Full and incremental fires, sync and async, with watermarks
    between batches: every mode equals the reference's rows; the
    incremental engine seals one pane a fire."""
    elements, ts = _gen(13, 900, n_keys=80, t_max=8000)
    want = None
    for inc in (False, True):
        for async_fire in (False, True):
            before = DEVICE_STATS.snapshot()["panes_sealed_total"]
            ref_rows, got, _h = _both(
                "sliding", elements, ts, MULTI, wm_every=50,
                fire_incremental=inc, async_fire=async_fire)
            want = want or ref_rows
            assert ref_rows == want and got == want, (inc, async_fire)
            sealed = DEVICE_STATS.snapshot()["panes_sealed_total"] - before
            assert (sealed > 0) == inc


def test_topk_ranks_across_shards_under_the_tie_rule():
    elements, ts = _gen(9, 3000, n_keys=300, t_max=8000)
    for inc in (False, True):
        rw, pw = _assigners("sliding")
        rh = RefHarness(_ref_op(rw, MULTI[:2], emit_topk=13,
                                async_fire=True, fire_incremental=inc),
                        schema=RefSchema(FIELDS))
        ph = OneInputOperatorTestHarness(
            _port_op(pw, MULTI[:2], emit_topk=13, async_fire=True,
                     fire_incremental=inc), schema=Schema(FIELDS))
        for h in (rh, ph):
            for i in range(0, 3000, 300):
                h.process_elements(elements[i:i + 300], ts[i:i + 300])
                h.process_watermark(ts[i + 299] - 200)
            h.process_watermark(10**9)
            h.operator.finish()
        rb, pb = rh.output.batches, ph.output.batches
        assert [int(b.timestamps[0]) for b in pb] == \
            [int(b.timestamps[0]) for b in rb]
        for r, p in zip(rb, pb):
            rv, pv = r.column("sum_v"), p.column("sum_v")
            np.testing.assert_array_equal(pv, rv)
            kth = rv[-1]
            rk, pk = r.column("key"), p.column("key")
            assert set(pk[pv > kth].tolist()) == set(rk[rv > kth].tolist())
            full = {}
            for (k, v), t in zip(elements, ts):
                end = int(r.timestamps[0]) + 1
                if end - 1000 <= t < end:
                    full[k] = full.get(k, 0) + v
            assert all(full[int(k)] == v for k, v in zip(pk, pv))


def test_late_rows_host_and_device():
    """Host batches drop late rows on the host; device batches count them
    in the step's kernel: the same rows and the same late count."""
    for device_batch in (False, True):
        op = _port_op(TumblingEventTimeWindows.of(100))
        h = OneInputOperatorTestHarness(op, schema=Schema(FIELDS))
        rh = RefHarness(_ref_op(RefTumbling.of(100)),
                        schema=RefSchema(FIELDS))
        for hh in (h, rh):
            hh.process_elements([(1, 5)], [10])
            hh.process_watermark(299)
        if device_batch:
            h.process_batch(DeviceRecordBatch(
                Schema(FIELDS), {"key": torch.tensor([1, 2]),
                                 "v": torch.tensor([9, 4])},
                torch.tensor([20, 350]), 20, 350))
        else:
            h.process_elements([(1, 9), (2, 4)], [20, 350])
        rh.process_elements([(1, 9), (2, 4)], [20, 350])
        for hh in (h, rh):
            hh.process_watermark(399)
            hh.operator.finish()
        assert _rows(h) == _rows(rh) == [(1, 5), (2, 4)]
        assert op.late_dropped == rh.operator.late_dropped == 1


def test_device_batches_equal_host_batches():
    """Device batches of one whole block (used as they are) and of odd
    sizes (gathered on the device) give the host path's rows."""
    elements, ts = _gen(17, 1024, n_keys=40, t_max=4000)
    keys = torch.tensor([k for k, _ in elements])
    vals = torch.tensor([v for _, v in elements])
    tst = torch.tensor(ts)
    _r, want, _h = _both("sliding", elements, ts, MULTI, wm_every=256)
    for sizes in ((512, 512), (100, 300, 124, 256, 216, 28)):
        op = _port_op(SlidingEventTimeWindows.of(1000, 250), MULTI)
        h = OneInputOperatorTestHarness(op, schema=Schema(FIELDS))
        pos = 0
        for n in sizes:
            sl = slice(pos, pos + n)
            h.process_batch(DeviceRecordBatch(
                Schema(FIELDS), {"key": keys[sl], "v": vals[sl]}, tst[sl],
                int(tst[sl].min()), int(tst[sl].max())))
            pos += n
            if pos % 256 == 0:
                h.process_watermark(ts[pos - 1] - 300)
        h.process_watermark(10**9)
        h.operator.finish()
        assert _rows(h) == want, sizes
        assert (op.zero_copy_blocks > 0) == (sizes[0] == 512)


def test_auto_grow_capacity():
    """600 keys against 8 shards of 64 slots: the probe grows the mesh at
    watermarks, nothing is dropped, in both packages."""
    outs = []
    for pkg in ("ref", "port"):
        op = (_ref_op(RefTumbling.of(1_000_000), capacity=64,
                      device_batch=32) if pkg == "ref" else
              _port_op(TumblingEventTimeWindows.of(1_000_000), capacity=64,
                       device_batch=32))
        h = (RefHarness(op, schema=RefSchema(FIELDS)) if pkg == "ref" else
             OneInputOperatorTestHarness(op, schema=Schema(FIELDS)))
        for lot in range(6):
            ks = range(lot * 100, lot * 100 + 100)
            h.process_elements([(int(k), 1) for k in ks], [lot + 1] * 100)
            h.process_watermark(lot + 1)
        h.process_watermark(10**9)
        outs.append(_rows(h))
    assert outs[0] == outs[1] and len(outs[1]) == 600
    assert op._agg.capacity > 64


def test_rows_dropped_before_a_grow_fail_the_task():
    """Rows a full shard dropped after the last pressure read are not
    carried into the grown mesh: the reference grows past them and loses
    them silently; the port fails the task (ROADMAP Queue 3)."""
    first = [(int(k), 1) for k in range(200)]
    second = [(int(k), 1) for k in range(1000, 2024)]
    lost = None
    for pkg in ("ref", "port"):
        op = (_ref_op(RefTumbling.of(1_000_000), capacity=64,
                      device_batch=32) if pkg == "ref" else
              _port_op(TumblingEventTimeWindows.of(1_000_000), capacity=64,
                       device_batch=32))
        h = (RefHarness(op, schema=RefSchema(FIELDS)) if pkg == "ref" else
             OneInputOperatorTestHarness(op, schema=Schema(FIELDS)))
        h.process_elements(first, [1] * len(first))
        h.process_watermark(1)
        h.process_elements(second, [2] * len(second))
        if pkg == "ref":
            h.process_watermark(2)
            h.process_watermark(10**9)
            lost = len(first) + len(second) - len(_rows(h))
        else:
            with pytest.raises(RuntimeError, match="overflow"):
                h.process_watermark(2)
    assert lost > 0


def _canonical(snap):
    """A reference mesh snapshot in (group, key) order."""
    order = np.lexsort((snap["keys"], snap["key_groups"]))
    return {"kind": snap["kind"], "keys": snap["keys"][order],
            "key_groups": snap["key_groups"][order],
            "max_parallelism": snap["max_parallelism"],
            "states": {n: {**s, "values": np.asarray(s["values"])[:, order]}
                       for n, s in snap["states"].items()}}


def _assert_snapshots_equal(a, b):
    assert a["kind"] == b["kind"] == "tpu"
    assert a["max_parallelism"] == b["max_parallelism"]
    np.testing.assert_array_equal(a["keys"], b["keys"])
    np.testing.assert_array_equal(a["key_groups"], b["key_groups"])
    assert a["keys"].dtype == b["keys"].dtype
    assert set(a["states"]) == set(b["states"])
    for n, s in a["states"].items():
        t = b["states"][n]
        assert (s["kind"], s["dtype"], s["ring"]) == \
            (t["kind"], t["dtype"], t["ring"])
        np.testing.assert_array_equal(s["values"], t["values"])
        assert np.asarray(s["values"]).dtype == np.asarray(t["values"]).dtype


def test_snapshots_equal_field_by_field():
    elements, ts = _gen(21, 600, n_keys=60, t_max=5000)
    for aggs in (SUM, MULTI[:4]):
        rw, pw = _assigners("sliding")
        rh = RefHarness(_ref_op(rw, aggs), schema=RefSchema(FIELDS))
        ph = OneInputOperatorTestHarness(_port_op(pw, aggs),
                                         schema=Schema(FIELDS))
        for h in (rh, ph):
            h.process_elements(elements[:300], ts[:300])
            h.process_watermark(ts[299] - 500)
        r = rh.operator.snapshot_state(1)["keyed"]
        p = ph.operator.snapshot_state(1)["keyed"]
        _assert_snapshots_equal(p["backend"], _canonical(r["backend"]))
        assert p["meta"] == r["meta"]


def _split_run(first, second, elements, ts, cut=300):
    """first's harness on elements[:cut], a snapshot, second's harness
    restored from it on the rest: the rows of both, sorted."""
    h1 = first()
    h1.process_elements(elements[:cut], ts[:cut])
    h1.process_watermark(ts[cut - 1])
    snap = h1.operator.snapshot_state(1)["keyed"]
    h2 = second()
    h2.open(keyed_snapshots=[snap])
    h2.process_elements(elements[cut:], ts[cut:])
    h2.process_watermark(10**9)
    h2.operator.finish()
    return sorted(_rows(h1) + _rows(h2))


def test_restores_across_packages_mesh_sizes_and_operators():
    """8 -> 4 -> 8 shards, port <-> reference both ways, mesh <-> the
    single-device operator both ways, onto another ring: every split run
    gives the unsplit run's rows."""
    elements, ts = _gen(22, 600, n_keys=40)
    w = ("tumbling",)
    rw, pw = _assigners(w[0])
    oracle = _both(w[0], elements, ts)[1]

    def port_mesh(n=8, ring=64):
        return lambda: OneInputOperatorTestHarness(
            _port_op(pw, n=n, ring_size=ring), schema=Schema(FIELDS))

    def ref_mesh(n=8):
        return lambda: RefHarness(_ref_op(rw, n=n), schema=RefSchema(FIELDS))

    def port_single():
        return OneInputOperatorTestHarness(port_dw.DeviceWindowAggOperator(
            pw, "key", [port_dw.AggSpec("sum", "v", out_name="result")],
            capacity=1 << 10, emit_window_bounds=False, device="cpu"),
            schema=Schema(FIELDS))

    def ref_single():
        return RefHarness(ref_dw.DeviceWindowAggOperator(
            rw, "key", [ref_dw.AggSpec("sum", "v", out_name="result")],
            capacity=1 << 10, emit_window_bounds=False),
            schema=RefSchema(FIELDS))

    pairs = {"8->4": (port_mesh(8), port_mesh(4)),
             "4->8": (port_mesh(4), port_mesh(8)),
             "ring 64->16": (port_mesh(8), port_mesh(8, 16)),
             "port->ref": (port_mesh(8), ref_mesh(4)),
             "ref->port": (ref_mesh(8), port_mesh(4)),
             "mesh->single": (port_mesh(8), port_single),
             "single->mesh": (port_single, port_mesh(8)),
             "ref single->port mesh": (ref_single, port_mesh(8))}
    for name, (a, b) in pairs.items():
        assert _split_run(a, b, elements, ts) == oracle, name
    # 8 -> 4 -> 8 in one chain
    h1 = port_mesh(8)()
    h1.process_elements(elements[:200], ts[:200])
    h1.process_watermark(ts[199])
    s1 = h1.operator.snapshot_state(1)["keyed"]
    h2 = port_mesh(4)()
    h2.open([s1])
    h2.process_elements(elements[200:400], ts[200:400])
    h2.process_watermark(ts[399])
    s2 = h2.operator.snapshot_state(2)["keyed"]
    h3 = port_mesh(8)()
    h3.open([s2])
    h3.process_elements(elements[400:], ts[400:])
    h3.process_watermark(10**9)
    assert sorted(_rows(h1) + _rows(h2) + _rows(h3)) == oracle


def test_live_rescale_at_the_barrier_exactly_once():
    """request_rescale applies at the next snapshot: rows equal an
    unrescaled run, the epoch moves, pages moved, no kernel built."""
    from flink_tpu_torch.ops import kernels
    elements, ts = _gen(31, 600, n_keys=40)
    oracle = _both("tumbling", elements, ts)[1]
    for n0, n1 in ((4, 8), (8, 4), (8, 2)):
        for inc in (False, True):
            op = _port_op(TumblingEventTimeWindows.of(1000), n=n0,
                          fire_incremental=inc)
            h = OneInputOperatorTestHarness(op, schema=Schema(FIELDS))
            h.process_elements(elements[:300], ts[:300])
            h.process_watermark(ts[299])
            builds, before = kernels.builds(), DEVICE_STATS.rescales
            op.request_rescale(n1)
            op.snapshot_state(7)
            assert op._n_devices == n1 and op._rescale_epoch == 1
            st = op._last_rescale_stats
            assert st["keygroups_migrated"] > 0 and st["bytes_moved"] > 0
            assert DEVICE_STATS.rescales == before + 1
            assert kernels.builds() == builds
            h.process_elements(elements[300:], ts[300:])
            h.process_watermark(10**9)
            assert _rows(h) == oracle, (n0, n1, inc)


def test_scale_in_past_one_shards_capacity_matches_reference():
    """4 shards of 128 slots hold 240 keys; rescaling to 1 shard brings
    that shard more keys than its old capacity. Both packages size the new
    shard for 2x headroom (512 slots) and emit the unrescaled rows; back to
    4 shards, capacity never shrinks."""
    rng = np.random.default_rng(41)
    keys = rng.permutation(np.arange(-120, 120))
    elements = [(int(k), int(v)) for k, v in
                zip(np.concatenate([keys, keys]), rng.integers(1, 10, 480))]
    ts = sorted(rng.integers(0, 3000, 480).tolist())
    oracle = _both("tumbling", elements, ts, capacity=1 << 10)[1]
    caps = []
    for pkg in ("ref", "port"):
        w = RefTumbling.of(1000) if pkg == "ref" else \
            TumblingEventTimeWindows.of(1000)
        make = _ref_op if pkg == "ref" else _port_op
        op = make(w, n=4, capacity=128)
        h = (RefHarness(op, schema=RefSchema(FIELDS)) if pkg == "ref" else
             OneInputOperatorTestHarness(op, schema=Schema(FIELDS)))
        h.process_elements(elements[:240], ts[:240])
        assert 240 > op._agg.capacity == 128
        for n in (1, 4):
            op.rescale_live(n)
            caps.append(op._agg.capacity)
        h.process_elements(elements[240:], ts[240:])
        h.process_watermark(10**9)
        h.operator.finish()
        assert _rows(h) == oracle, pkg
    assert caps == [512, 512] * 2


def test_async_fire_that_grows_emits_before_later_watermarks():
    """Async fires queued behind one watermark, the first carrying an
    occupancy past 0.6: its grow drains the later fires and the held
    watermark, so the port emits its rows first. Every window comes out
    in order and before the watermark that passes it, with the
    reference's rows."""
    elements = [(int(k), 1) for k in range(-160, 160)]
    ts = [10 + 100 * (i % 4) for i in range(len(elements))]
    want = _both("tumbling", elements, ts, capacity=1 << 10)[1]
    op = _port_op(TumblingEventTimeWindows.of(100), capacity=64,
                  async_fire=True)
    h = OneInputOperatorTestHarness(op, schema=Schema(FIELDS))
    events = []
    emit, emit_wm = h.output.emit, h.output.emit_watermark
    h.output.emit = lambda b: (events.append(("rows", int(b.timestamps[0]))),
                               emit(b))
    h.output.emit_watermark = lambda wm: (
        events.append(("wm", wm.timestamp)), emit_wm(wm))
    h.process_elements(elements, ts)
    h.process_watermark(1000)
    assert len(op._pending) == 5          # 4 fires and the watermark
    op.finish()
    assert op._agg.capacity > 64          # a fire's scalars grew the mesh
    assert events == [("rows", 99), ("rows", 199), ("rows", 299),
                      ("rows", 399), ("wm", 1000)]
    assert _rows(h) == want


def test_rescale_disabled_by_config_and_errors():
    from flink_tpu_torch.cluster.local import live_rescale
    MESH_RUNTIME.configure(Configuration({"mesh.rescale.enabled": False}))
    op = _port_op(TumblingEventTimeWindows.of(1000), n=2)
    OneInputOperatorTestHarness(op, schema=Schema(FIELDS))
    with pytest.raises(RuntimeError, match="disabled"):
        op.request_rescale(4)
    with pytest.raises(RuntimeError, match="disabled"):
        live_rescale(object(), 4)
    MESH_RUNTIME.reset()
    op = _port_op(TumblingEventTimeWindows.of(1000), n=2)
    h = OneInputOperatorTestHarness(op, schema=Schema(FIELDS),
                                    max_parallelism=4)
    h.process_elements([(1, 1)], [10])
    with pytest.raises(ValueError, match="max-parallelism"):
        op.rescale_live(8)


def _q5ish(env_mod, cfg, ws_mod, schema, windows, n, mesh_devices, dev):
    """Both packages' builtin sum route on the same pipeline."""
    def gen(idx):
        return {"auction": idx % 97, "price": (idx * 7) % 100 + 1,
                "ts": idx * 3}

    env = (env_mod.StreamExecutionEnvironment(cfg, device=dev)
           if dev is not None else
           env_mod.StreamExecutionEnvironment.get_execution_environment())
    if dev is None and mesh_devices:
        env.config.set("state.backend.tpu.mesh-devices", mesh_devices)
    ws = ws_mod.WatermarkStrategy.for_monotonous_timestamps() \
        .with_timestamp_column("ts")
    out = (env.datagen(gen, schema, count=n, timestamp_column="ts",
                       watermark_strategy=ws)
           .key_by("auction")
           .window(windows.SlidingEventTimeWindows.of(1000, 500))
           .sum("price")
           .execute_and_collect())
    return env, sorted((int(k), int(v)) for k, v in out)


def test_env_execute_builtin_sum_on_the_mesh_matches_reference():
    import flink_tpu.api as rapi
    import flink_tpu.core as rcore
    import flink_tpu.window as rwin
    import flink_tpu_torch.api as papi
    import flink_tpu_torch.core as pcore
    import flink_tpu_torch.window as pwin
    rschema = rcore.Schema([("auction", np.int64), ("price", np.int64),
                            ("ts", np.int64)])
    pschema = Schema([("auction", np.int64), ("price", np.int64),
                      ("ts", np.int64)])
    _e, want = _q5ish(rapi, None, rcore, rschema, rwin, 3000, 8, None)
    env, got = _q5ish(papi, Configuration(
        {"state.backend.tpu.mesh-devices": 8}), pcore, pschema, pwin, 3000,
        8, "cpu")
    assert got == want
    ops = env.last_job.operators
    assert any(isinstance(o, MeshWindowAggOperator) and o._n_devices == 8
               for o in ops)
    _e, single = _q5ish(papi, Configuration(), pcore, pschema, pwin, 3000,
                        0, "cpu")
    assert single == want


def test_mesh_aggregate_with_avg_and_bounds_matches_reference():
    import flink_tpu.api as rapi
    import flink_tpu.core as rcore
    import flink_tpu_torch.api as papi
    import flink_tpu_torch.core as pcore

    def run(api, core, AggSpec, dt, **kw):
        schema = core.Schema([("k", np.int64), ("v", np.int64),
                              ("ts", np.int64)])

        def gen(idx):
            return {"k": idx % 5 - 2, "v": idx % 11, "ts": idx * 2}

        env = (api.StreamExecutionEnvironment(**kw) if kw else
               api.StreamExecutionEnvironment.get_execution_environment())
        ws = core.WatermarkStrategy.for_monotonous_timestamps() \
            .with_timestamp_column("ts")
        win = (TumblingEventTimeWindows if api is papi
               else RefTumbling).of(400)
        rows = (env.datagen(gen, schema, count=1000, timestamp_column="ts",
                            watermark_strategy=ws)
                .key_by("k").window(win)
                .mesh_aggregate(
                    [AggSpec("sum", "v", out_name="total", dtype=dt),
                     AggSpec("count", out_name="cnt"),
                     AggSpec("max", "v", out_name="hi", dtype=dt),
                     AggSpec("avg", "v", out_name="mean")],
                    n_devices=8, capacity=1 << 8, device_batch=64)
                .execute_and_collect())
        return sorted(tuple(float(x) for x in r) for r in rows)

    want = run(rapi, rcore, ref_dw.AggSpec, jnp.int64)
    got = run(papi, pcore, port_dw.AggSpec, torch.int64, device="cpu")
    assert got == want and len(got) > 0
    with pytest.raises(ValueError, match="emit_topk with parallelism"):
        papi.StreamExecutionEnvironment(device="cpu").from_collection(
            [(1, 1)], Schema([("k", np.int64), ("v", np.int64)])) \
            .key_by("k").window(TumblingEventTimeWindows.of(10)) \
            .mesh_aggregate([port_dw.AggSpec("sum", "v")], emit_topk=3,
                            parallelism=2)


def test_live_rescale_of_a_running_job_exactly_once():
    """live_rescale 4 -> 8 -> 4 on a running job: every window once, equal
    to an unrescaled run's; the operators' epochs move."""
    from flink_tpu_torch.cluster.local import live_rescale
    c = dict(keys=3000, events=1 << 15, batch=1 << 11, shards=4,
             device_batch=1 << 9, capacity=1 << 10)
    want = cs.mesh_q5_expected(c)
    env, got, source = cs.mesh_q5_env(torch, torch.device("cpu"), c,
                                      rate=(1 << 15) / 2.0)
    job = env.execute_async("mesh-rescale")
    try:
        op = cs.mesh_operator(job)
        stats = []
        for n in (8, 4):
            deadline = time.monotonic() + 30
            while op._agg is None and time.monotonic() < deadline:
                time.sleep(0.01)
            stats.append(live_rescale(job, n, timeout=60))
            assert op._n_devices == n
        job.wait(120)
    finally:
        job.cancel()
    assert [s["epoch"] for s in stats] == [1, 2]
    assert cs.q5_check(want, got) == len(want)


def test_mesh_q5_runs_without_jax():
    """The smoke's mesh cell, tiny, in a process where neither jax nor
    flink_tpu can be imported: both fire modes against the oracle."""
    c = dict(keys=3000, events=1 << 15, batch=1 << 11, shards=4,
             device_batch=1 << 9, capacity=1 << 10)
    code = (
        "import sys; sys.modules['jax'] = None; "
        "sys.modules['flink_tpu'] = None\n"
        "import importlib.util, torch\n"
        "spec = importlib.util.spec_from_file_location('cs', "
        "'chip_smoke.py'); cs = importlib.util.module_from_spec(spec); "
        "spec.loader.exec_module(cs)\n"
        f"c = {c!r}\n"
        "want = cs.mesh_q5_expected(c)\n"
        "for mode in ('full', 'incremental'):\n"
        "    job, got = cs.run_mesh_q5(torch, torch.device('cpu'), c, "
        "fire_mode=mode)\n"
        "    print(cs.q5_check(want, got))\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'flink_tpu.')) "
        "for m in sys.modules if sys.modules[m] is not None)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    n = len(cs.mesh_q5_expected(c))
    assert [int(x) for x in out.stdout.split()[-2:]] == [n, n]


def test_supervisor_rescale_resplits_mesh_state_and_fusion_cuts_chain():
    """JobSupervisor.rescale(mesh_devices=...) re-shards a mesh job's
    state from its savepoint; the mesh operator heads its own chain."""
    from flink_tpu_torch.graph.fusion import _classify_operator
    op = _port_op(TumblingEventTimeWindows.of(1000), n=2)
    assert _classify_operator(op)[0] == "keyed-device"
    from flink_tpu_torch.cluster.scheduler import JobSupervisor
    c = dict(keys=3000, events=1 << 15, batch=1 << 11, shards=2,
             device_batch=1 << 10, capacity=1 << 10)
    from flink_tpu_torch.connectors.core import TransactionalCollectSink
    want = cs.mesh_q5_expected(c)
    sink = TransactionalCollectSink()
    env, _got, _src = cs.mesh_q5_env(torch, torch.device("cpu"), c,
                                     rate=(1 << 15) / 2.0,
                                     settings={"execution.checkpointing."
                                               "interval": 0.2}, sink=sink)
    sup = JobSupervisor(env.get_job_graph("mesh-sup"), env.config,
                        env.device)
    import threading
    t = threading.Thread(target=sup.run, kwargs={"timeout": 120})
    t.start()
    deadline = time.monotonic() + 30
    while (sup.current_job is None or not sup.current_job.coordinator
           .latest_checkpoint()) and time.monotonic() < deadline:
        time.sleep(0.02)
    sup.rescale({}, mesh_devices=4)
    t.join(150)
    op = cs.mesh_operator(sup.current_job)
    assert op._n_devices == 4
    got = [(int(b.timestamps[0]), b.column("auction"), b.column("bids"),
            b.column("revenue")) for b in sink.batches]
    assert cs.q5_check(want, got) == len(want)
