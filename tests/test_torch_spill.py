"""Port parity: the HBM budget and the host spill tier
(flink_tpu_torch/state/spill.py, the budget in
flink_tpu_torch/state/device_backend.py, the spill split of the ingest
step in flink_tpu_torch/ops/hash_table.py and the operator's staging,
drains and two-tier fires) against flink_tpu/state/spill.py,
flink_tpu/state/tpu_backend.py and
flink_tpu/runtime/operators/device_window.py on the same numpy input.

Keys are seeded, values small integers (float sums exact). Tolerance:
exact everywhere. Rows without top-k are equal, order and dtypes
included; top-k rows follow the tie rule (values equal, keys strictly
above the k-th value equal, keys at it from its tie class). Snapshots are
compared field by field. The staging of the spill split is compared in
the reference's batch order on the CPU, and position by position between
the kernel and its plain version on the card (the ``cuda`` case): both
stage in batch order.

The reference package is imported inside the ``ref`` fixture, so the
card-only case runs where JAX is not installed."""

import types

import numpy as np
import pytest
import torch

from flink_tpu_torch.core import KeyGroupRange, Schema
from flink_tpu_torch.core.keygroups import hash_batch, key_groups_device, \
    key_groups_for_hash_batch
from flink_tpu_torch.ops import hash_table as port_ht
from flink_tpu_torch.ops.segment_ops import make_accumulator
from flink_tpu_torch.runtime import OneInputOperatorTestHarness
from flink_tpu_torch.runtime.operators import device_window as port_dw
from flink_tpu_torch.state.device_backend import DeviceKeyedStateBackend
from flink_tpu_torch.state.spill import HostTier
from flink_tpu_torch.window import SlidingEventTimeWindows, \
    TumblingEventTimeWindows

EMPTY = int(np.iinfo(np.int64).max)
FIELDS = [("key", np.int64), ("v", np.int64)]
MAXP = 128


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from flink_tpu.core.config import Configuration
    from flink_tpu.core.records import Schema as RefSchema
    from flink_tpu.ops.hash_table import ensure_x64
    from flink_tpu.parallel.mesh import key_groups_device as mesh_kg
    from flink_tpu.runtime import OneInputOperatorTestHarness as Harness
    from flink_tpu.runtime.operators import device_window as dw
    from flink_tpu.state.spill import HostTier as RefHostTier
    from flink_tpu.state.tpu_backend import TpuKeyedStateBackend
    from flink_tpu.window import SlidingEventTimeWindows as Sliding
    from flink_tpu.window import TumblingEventTimeWindows as Tumbling
    ensure_x64()
    return types.SimpleNamespace(
        jnp=jnp, Configuration=Configuration, Schema=RefSchema,
        mesh_kg=mesh_kg, Harness=Harness, dw=dw, HostTier=RefHostTier,
        Backend=TpuKeyedStateBackend, Sliding=Sliding, Tumbling=Tumbling)


def _snap_equal(a: dict, b: dict) -> None:
    """Field by field: keys, key groups, max parallelism, and each
    state's kind, dtype, ring and values (dtype and bytes)."""
    assert a["kind"] == b["kind"] == "tpu"
    assert a["max_parallelism"] == b["max_parallelism"]
    for f in ("keys", "key_groups"):
        x, y = np.asarray(a[f]), np.asarray(b[f])
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a["states"].keys() == b["states"].keys()
    for name, sa in a["states"].items():
        sb = b["states"][name]
        assert (sa["kind"], sa["dtype"], sa["ring"]) == \
            (sb["kind"], sb["dtype"], sb["ring"]), name
        x, y = np.asarray(sa["values"]), np.asarray(sb["values"])
        assert x.dtype == y.dtype and np.array_equal(x, y), name


def test_key_groups_device_bit_equal(ref):
    """Against the reference's device twin (JAX on the CPU) and the host
    map, over negative, huge and zero keys."""
    rng = np.random.default_rng(0)
    keys = np.concatenate([
        rng.integers(-(1 << 63), (1 << 63) - 1, 4096, dtype=np.int64),
        np.array([0, -1, 1, EMPTY, -EMPTY - 1, 1 << 32, -(1 << 32),
                  (1 << 31) - 1, -(1 << 31)], np.int64)])
    for maxp in (1, 7, 128, 32768):
        want = key_groups_for_hash_batch(hash_batch(keys), maxp)
        mesh = np.asarray(ref.mesh_kg(ref.jnp.asarray(keys), maxp))
        got = key_groups_device(torch.from_numpy(keys), maxp).numpy()
        assert got.dtype == want.dtype == np.int32
        assert np.array_equal(got, want) and np.array_equal(got, mesh)


def test_host_tier_equals_reference(ref):
    """Dense first-seen slots, folds, fires, peeks, drops and the
    snapshot parts of the port's HostTier against the reference's (whose
    index is the native HostHashIndex)."""
    rng = np.random.default_rng(1)
    tiers = [HostTier(MAXP), ref.HostTier(MAXP)]
    for t in tiers:
        t.register("c", "count", np.int64, 4)
        t.register("m", "max", np.int32, 4)
        t.register("s", "sum", np.float64, None)
    for _ in range(6):
        keys = rng.integers(-5000, 5000, 700)
        vals = rng.integers(-40, 40, 700)
        ring = rng.integers(0, 4, 700)
        got = []
        for t in tiers:
            slots = t.slots_for(keys)
            t.fold("c", slots, np.ones(700, np.int64), ring)
            t.fold("m", slots, vals.astype(np.int32), ring)
            t.fold("s", slots, vals.astype(np.float64), None)
            got.append(slots)
        assert np.array_equal(got[0], got[1])
    for t in tiers:
        t.spilled_mask[:64] = True
        t.reset_ring_row(2)
    a, b = tiers
    assert np.array_equal(a.keys(), b.keys())
    assert np.array_equal(a.key_groups(), b.key_groups())
    assert np.array_equal(a.group_counts(), b.group_counts())
    for name in ("c", "m", "s"):
        assert np.array_equal(a.fire(name, np.array([0, 1, 3])),
                              b.fire(name, np.array([0, 1, 3])))
    groups = np.arange(0, 128, 3)
    ka, va = a.peek_groups(groups)
    kb, vb = b.peek_groups(groups)
    assert np.array_equal(ka, kb) and all(np.array_equal(va[n], vb[n])
                                          for n in va)
    assert a.drop_groups(groups) == b.drop_groups(groups)
    assert np.array_equal(a.spilled_mask, b.spilled_mask)
    (ka, va), (kb, vb) = a.snapshot_parts(), b.snapshot_parts()
    assert np.array_equal(ka, kb) and all(np.array_equal(va[n], vb[n])
                                          for n in va)
    keys = rng.integers(-6000, 6000, 300)
    assert np.array_equal(a.slots_for(keys), b.slots_for(keys))


def _fold_both(port_b, ref_b, keys, vals, ring):
    slots = port_b.slots_for_batch(torch.from_numpy(keys))
    port_b.fold_batch("acc", slots, torch.from_numpy(vals), slots >= 0)
    port_b.fold_batch("cnt", slots, torch.ones(len(keys), dtype=torch.int32),
                      slots >= 0, torch.from_numpy(ring))
    rs = ref_b.slots_for_batch(keys)
    ref_b.fold_batch("acc", rs, vals, rs >= 0)
    ref_b.fold_batch("cnt", rs, np.ones(len(keys), np.int32), rs >= 0,
                     ring_idx=ring)


def _backends(ref, budget, capacity=64):
    pb = DeviceKeyedStateBackend(KeyGroupRange(0, MAXP - 1), MAXP,
                                 capacity=capacity, device="cpu",
                                 hbm_budget_slots=budget)
    rb = ref.Backend(KeyGroupRange(0, MAXP - 1), MAXP, capacity=capacity,
                     hbm_budget_slots=budget)
    for b, acc_dt, cnt_dt in ((pb, torch.float64, torch.int32),
                              (rb, ref.jnp.float64, ref.jnp.int32)):
        b.register_array_state("acc", "sum", acc_dt)
        b.register_array_state("cnt", "count", cnt_dt, ring=4)
    return pb, rb


def test_backend_evicts_and_keeps_folding(ref):
    """More keys than the budget: the port evicts, folds on both tiers,
    and its snapshot equals the reference's field by field and the
    expected totals."""
    pb, rb = _backends(ref, budget=256)
    rng = np.random.default_rng(0)
    expect: dict[int, float] = {}
    for _ in range(8):
        keys = rng.integers(0, 2000, 256)
        vals = rng.integers(1, 9, 256).astype(np.float64)
        for k, v in zip(keys.tolist(), vals.tolist()):
            expect[k] = expect.get(k, 0.0) + v
        _fold_both(pb, rb, keys, vals, keys % 4)
    assert pb.capacity <= 256 and pb.host_tier.evicted_keys > 0
    assert pb.evictions["calls"] > 0 and pb.spill_active
    snap = pb.snapshot(1)
    _snap_equal(snap, rb.snapshot(1))
    _snap_equal(snap, pb.snapshot_plain(1))
    got = dict(zip(snap["keys"].tolist(),
                   snap["states"]["acc"]["values"].tolist()))
    assert got == expect


def test_budget_caps_capacity(ref):
    """The largest power of two under the budget caps the capacity, as
    in the reference."""
    for cap, budget in ((1 << 12, 1 << 10), (1 << 12, 1000), (64, 1 << 10),
                        (1 << 10, 0), (100, 100)):
        pb = DeviceKeyedStateBackend(KeyGroupRange(0, 127), 128,
                                     capacity=cap, device="cpu",
                                     hbm_budget_slots=budget)
        rb = ref.Backend(KeyGroupRange(0, 127), 128, capacity=cap,
                         hbm_budget_slots=budget)
        assert (pb.capacity, pb.hbm_budget) == (rb.capacity, rb.hbm_budget)


def _spill_batches(seed, n=300, count=3, distinct=400):
    rng = np.random.default_rng(seed)
    pool = rng.integers(-(10 ** 12), 10 ** 12, distinct)
    pool[:2] = [EMPTY, EMPTY - 1]
    return [(pool[rng.integers(0, distinct, n)],
             rng.integers(-700, 300, n) + 150 * b,
             rng.integers(-50, 50, n)) for b in range(count)]


RING, PANE, OFFSET, FIRST_OPEN, BLOCK = 4, 100, -37, -4, 8


def _port_spill_step(step, spilled, batches, cap, S, dev="cpu",
                     dtype=torch.int64):
    table = port_ht.make_table(cap, dev)
    count = make_accumulator("count", (RING, cap), torch.int32, dev)
    plane = make_accumulator("max", (RING, cap), dtype, dev)
    late = torch.zeros((), dtype=torch.int64, device=dev)
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    dirty = torch.zeros(cap // BLOCK + 1, dtype=torch.uint8, device=dev)
    spill = port_ht.StepSpill(
        torch.from_numpy(spilled).to(dev),
        torch.zeros(MAXP, dtype=torch.int64, device=dev), 0,
        torch.zeros((), dtype=torch.int64, device=dev),
        torch.zeros(S, dtype=torch.int64, device=dev),
        torch.zeros(S, dtype=torch.int32, device=dev),
        [None, torch.zeros(S, dtype=dtype, device=dev)])
    for b, (keys, ts, vals) in enumerate(batches):
        spill.batch_no = b + 1
        step(table, [("count", count, None),
                     ("max", plane, torch.from_numpy(vals).to(dev))],
             torch.from_numpy(ts).to(dev), torch.from_numpy(keys).to(dev),
             PANE, OFFSET, FIRST_OPEN, late, dropped, dirty, 3, spill)
    return table, count, plane, late, dropped, dirty, spill


def test_spill_step_matches_reference_step_body(ref):
    """``ingest_step_plain`` with the spill split against ``_step_body``
    with ``spill_maxp``: table, planes, late and dropped, the staged rows
    (in batch order, with and without a stage overflow), the stage count,
    the touch clock; the dirty blocks cover every slot folded and lie
    within the reference's (which also marks block 0)."""
    jnp = ref.jnp
    rng = np.random.default_rng(5)
    spilled = rng.random(MAXP) < 0.5
    batches = _spill_batches(3)
    for cap, S in ((1024, 4096), (1024, 100), (64, 4096)):
        step = ref.dw._step_body((("max", "p", "v"),), RING, PANE, OFFSET,
                                 BLOCK, spill_maxp=MAXP)
        table = jnp.full(cap, EMPTY, jnp.int64)
        arrays = {"__count__": jnp.zeros((RING, cap), jnp.int32),
                  "p": jnp.full((RING, cap), np.iinfo(np.int64).min,
                                jnp.int64)}
        stage = {"keys": jnp.zeros(S, jnp.int64),
                 "ring": jnp.zeros(S, jnp.int32),
                 "count": jnp.zeros((), jnp.int64),
                 "p": jnp.zeros(S, jnp.int64)}
        dropped = late = jnp.int64(0)
        dirty = jnp.zeros(cap // BLOCK + 1, bool)
        touch = jnp.zeros(MAXP, jnp.int64)
        for b, (keys, ts, vals) in enumerate(batches):
            table, arrays, dropped, late, dirty, stage, touch, _ = step(
                table, arrays, dropped, late, dirty, stage, touch,
                jnp.asarray(keys), jnp.asarray(ts), {"v": jnp.asarray(vals)},
                jnp.asarray(spilled), np.int64(b + 1), FIRST_OPEN, len(keys))
        pt, pc, pp, pl, pd, pdirty, sp = _port_spill_step(
            port_ht.ingest_step, spilled, batches, cap, S)
        assert np.array_equal(pt.numpy(), np.asarray(table))
        assert np.array_equal(pc.numpy(), np.asarray(arrays["__count__"]))
        assert np.array_equal(pp.numpy(), np.asarray(arrays["p"]))
        assert (int(pl), int(pd)) == (int(late), int(dropped))
        n = min(int(stage["count"]), S)
        assert int(sp.count) == int(stage["count"]) > 0
        for got, want in ((sp.keys, stage["keys"]), (sp.ring, stage["ring"]),
                          (sp.values[1], stage["p"])):
            assert np.array_equal(got.numpy()[:n], np.asarray(want)[:n])
        assert np.array_equal(sp.touch.numpy(), np.asarray(touch))
        folded = np.flatnonzero((pc.numpy() > 0).any(0)) // BLOCK
        mine = np.flatnonzero(pdirty.numpy()[:cap // BLOCK])
        theirs = np.flatnonzero(np.asarray(dirty)[:cap // BLOCK])
        assert set(folded.tolist()) == set(mine.tolist())
        assert set(mine.tolist()) <= set(theirs.tolist())
    assert int(pd) == 0    # the last case stages failed inserts, no drop


@pytest.mark.cuda
def test_spill_step_kernel_equals_plain():
    """On the card: the spill form of the kernel against its plain
    version; staged rows equal position by position (both stage in batch
    order, with and without a stage that overflows), everything else
    equal, drops equal as a count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    spilled = np.random.default_rng(5).random(MAXP) < 0.5
    batches = _spill_batches(3, n=5000, distinct=3000)
    # tables that hold every key: with a full table, which keys win slots
    # (and so which rows stage) follows the order of the claims
    for cap, S, dtype in ((1 << 12, 1 << 14, torch.int64),
                          (1 << 12, 1000, torch.int32),
                          (1 << 13, 1 << 14, torch.float32)):
        k = _port_spill_step(port_ht.ingest_step, spilled, batches, cap, S,
                             dev, dtype)
        p = _port_spill_step(port_ht.ingest_step_plain, spilled, batches,
                             cap, S, dev, dtype)
        torch.cuda.synchronize()
        kt, pt = k[0].cpu().numpy(), p[0].cpu().numpy()
        assert sorted(kt[kt != EMPTY]) == sorted(pt[pt != EMPTY])
        ks, ps = np.argsort(kt), np.argsort(pt)
        for a, b in ((k[1], p[1]), (k[2], p[2])):
            assert np.array_equal(a.cpu().numpy()[:, ks],
                                  b.cpu().numpy()[:, ps])
        assert [int(t) for t in k[3:5]] == [int(t) for t in p[3:5]]
        assert int(k[6].count) == int(p[6].count)
        n = min(int(k[6].count), S)
        for a, b in ((k[6].keys, p[6].keys), (k[6].ring, p[6].ring),
                     (k[6].values[1], p[6].values[1])):
            assert torch.equal(a[:n], b[:n])
        assert torch.equal(k[6].touch, p[6].touch)
        folded = set(np.flatnonzero((k[1].cpu().numpy() > 0).any(0))
                     // BLOCK)
        assert folded <= set(np.flatnonzero(k[5].cpu().numpy()).tolist())


def _stream(seed=31, steps=24, keys=900, n=128, t_step=400):
    """[("batch", rows, ts) | ("wm", t)]: integer values, timestamps a
    little out of order, a watermark every third batch."""
    rng = np.random.default_rng(seed)
    ops, t = [], 0
    for step in range(steps):
        ks = rng.integers(0, keys, n)
        vs = rng.integers(1, 10, n)
        ts = rng.integers(max(0, t - 300), t + 300, n)
        ops.append(("batch", list(zip(ks.tolist(), vs.tolist())),
                    ts.tolist()))
        t += t_step
        if step % 3 == 2:
            ops.append(("wm", t - 400))
    ops.append(("wm", t + 20000))
    return ops


def _feed(h, ops):
    for op in ops:
        if op[0] == "batch":
            h.process_elements(op[1], op[2])
        else:
            h.process_watermark(op[1])
    h.close()


def _rows(h):
    return [(int(b.timestamps[0]), [(f.name, np.dtype(f.dtype))
                                    for f in b.schema.fields],
             [tuple(v.item() for v in r)
              for r in zip(*[b.column(f.name) for f in b.schema.fields])])
            for b in h.output.batches]


AGGS = (("sum", "v"), ("count", None), ("max", "v"))
#: case -> (window, operator keywords)
SPILL_CASES = {
    "tumbling": ("tumbling", dict(capacity=64, hbm_budget_slots=256)),
    "sliding": ("sliding", dict(capacity=64, hbm_budget_slots=256)),
    "deferred": ("tumbling", dict(capacity=64, hbm_budget_slots=256,
                                  defer_overflow=True, async_fire=True,
                                  spill_staging_slots=1 << 10)),
    "deferred_sliding": ("sliding", dict(capacity=64, hbm_budget_slots=256,
                                         defer_overflow=True,
                                         spill_staging_slots=1 << 10)),
}


def _ops_pair(ref, window, aggs, kw, fire_incremental, topk=None):
    if window == "tumbling":
        rw, pw = ref.Tumbling.of(1000), TumblingEventTimeWindows.of(1000)
    else:
        rw, pw = ref.Sliding.of(3000, 1000), SlidingEventTimeWindows.of(
            3000, 1000)
    rop = ref.dw.DeviceWindowAggOperator(
        rw, "key", [ref.dw.AggSpec(k, f, dtype=ref.jnp.int64)
                    for k, f in aggs], ring_size=8, emit_topk=topk,
        fire_incremental=fire_incremental, **kw)
    pop = port_dw.DeviceWindowAggOperator(
        pw, "key", [port_dw.AggSpec(k, f, dtype=torch.int64)
                    for k, f in aggs], ring_size=8, emit_topk=topk,
        fire_incremental=fire_incremental, device="cpu", **kw)
    rh = ref.Harness(rop, schema=ref.Schema(FIELDS))
    ph = OneInputOperatorTestHarness(pop, schema=Schema(FIELDS))
    return rop, rh, pop, ph


@pytest.mark.parametrize("fire_incremental", [False, True])
@pytest.mark.parametrize("case", sorted(SPILL_CASES))
def test_rows_beyond_budget_equal_reference(ref, case, fire_incremental):
    """900 keys against a 256-slot budget: the port's windows equal the
    reference's, with keys on both tiers."""
    window, kw = SPILL_CASES[case]
    ops = _stream()
    rop, rh, pop, ph = _ops_pair(ref, window, AGGS, kw, fire_incremental)
    _feed(rh, ops)
    _feed(ph, ops)
    assert pop.backend.spill_active and pop.backend.host_tier.evicted_keys
    want, got = _rows(rh), _rows(ph)
    assert len(want) > 5 and got == want
    if kw.get("defer_overflow"):
        assert pop.spill_rows_drained > 0


@pytest.mark.parametrize("deferred", [False, True])
def test_topk_across_tiers_follows_tie_rule(ref, deferred):
    """Top 5 by sum, ranked across both tiers: per window the values are
    equal, keys strictly above the 5th value equal, and keys at it come
    from its tie class in the reference's full emission."""
    kw = dict(capacity=64, hbm_budget_slots=256)
    if deferred:
        kw.update(defer_overflow=True, spill_staging_slots=1 << 10)
    ops = _stream(seed=3)
    aggs = (("sum", "v"), ("count", None))
    _r, rh, pop, ph = _ops_pair(ref, "tumbling", aggs, kw, False, topk=5)
    _f, fh, _p, _ph = _ops_pair(ref, "tumbling", aggs,
                                dict(capacity=1 << 12), False)
    _feed(rh, ops)
    _feed(ph, ops)
    _feed(fh, ops)
    assert pop.backend.spill_active
    full = {end: rows for end, _s, rows in _rows(fh)}
    want, got = _rows(rh), _rows(ph)
    assert [w[0] for w in want] == [g[0] for g in got] and len(got) > 5
    for (end, schema, wrows), (_e, gschema, grows) in zip(want, got):
        assert schema == gschema
        assert [r[3] for r in grows] == [r[3] for r in wrows]
        kth = grows[-1][3]
        by_key = {r[0]: r for r in full[end]}
        assert {r[0] for r in grows if r[3] > kth} == \
            {r[0] for r in wrows if r[3] > kth}
        for r in grows:
            assert by_key[r[0]] == r


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_budgeted_snapshot_equals_unbudgeted_twin(ref, direction):
    """A budgeted operator's snapshot equals its unbudgeted twin's, field
    by field, and restores across packages: each package's budgeted
    snapshot restores into the other's unbudgeted operator (and the
    reverse budget), whose snapshot is the same again and whose rows
    after the restore equal an uninterrupted run's."""
    ops = _stream(seed=9)
    cut = len(ops) // 2
    head, tail = ops[:cut], ops[cut:]
    spill_kw = dict(capacity=64, hbm_budget_slots=256, defer_overflow=True,
                    spill_staging_slots=1 << 10)
    flat_kw = dict(capacity=1 << 11, defer_overflow=True)
    src_kw, dst_kw = ((spill_kw, flat_kw) if direction == "port_to_reference"
                      else (flat_kw, spill_kw))
    _r, rh, _p, ph = _ops_pair(ref, "sliding", AGGS, spill_kw, False)
    _r2, rh2, _p2, ph2 = _ops_pair(ref, "sliding", AGGS, flat_kw, False)
    for h in (rh, ph, rh2, ph2):
        for op in head:
            if op[0] == "batch":
                h.process_elements(op[1], op[2])
            else:
                h.process_watermark(op[1])
    snaps = {name: h.snapshot(1) for name, h in
             (("ref_spill", rh), ("port_spill", ph), ("ref_flat", rh2),
              ("port_flat", ph2))}
    keyed = {n: s["keyed"][0]["backend"] if isinstance(s["keyed"], list)
             else s["keyed"]["backend"] for n, s in snaps.items()}
    assert _p.backend.spill_active and _r._backend.spill_active
    for n in ("ref_spill", "ref_flat", "port_flat"):
        _snap_equal(keyed["port_spill"], keyed[n])
    # restore across packages and across budgets, then finish the run
    if direction == "port_to_reference":
        src_snap = snaps["port_spill"]
        restored = ref.Harness.restored(
            lambda: ref.dw.DeviceWindowAggOperator(
                ref.Sliding.of(3000, 1000), "key",
                [ref.dw.AggSpec(k, f, dtype=ref.jnp.int64) for k, f in AGGS],
                ring_size=8, fire_incremental=False, **dst_kw),
            src_snap, schema=ref.Schema(FIELDS))
    else:
        src_snap = snaps["ref_flat"]
        restored = OneInputOperatorTestHarness.restored(
            lambda: port_dw.DeviceWindowAggOperator(
                SlidingEventTimeWindows.of(3000, 1000), "key",
                [port_dw.AggSpec(k, f, dtype=torch.int64) for k, f in AGGS],
                ring_size=8, fire_incremental=False, device="cpu", **dst_kw),
            src_snap, schema=Schema(FIELDS))
    _feed(restored, tail)
    _feed(rh2, tail)
    want = [b for b in _rows(rh2) if b[0] >= _first_end(restored)]
    assert _rows(restored) == want and len(want) > 2
    if direction == "reference_to_port":
        assert restored.operator.backend.spill_active


def _first_end(h) -> int:
    return int(h.output.batches[0].timestamps[0])
