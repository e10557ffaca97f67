"""Port parity: tiered state residency (flink_tpu_torch/state/tiering/:
the 2Q heat policy, the residency manager and its registry, the prefetch
pipeline; the backend's tier_boundary, staging and apply_promotion in
flink_tpu_torch/state/device_backend.py; the window operator's boundary
hook) against flink_tpu/state/tiering/, flink_tpu/state/tpu_backend.py and
flink_tpu/runtime/operators/device_window.py on the same seeded numpy
input.

Tolerance: exact everywhere. The policy's heat is float64 arithmetic in
the reference's order and compares bit for bit; keys, groups, counts and
values are integers (float sums of small integers are exact). Rows
without top-k are equal, order and dtypes included; snapshots are
compared field by field. Deterministic runs use synchronous staging
(``state.tiering.async-prefetch`` false) in both packages.

The reference package is imported inside the ``ref`` fixture, so the
port-side helpers run where JAX is not installed (the subprocess case)
and the card-only case runs on the card."""

import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from flink_tpu_torch.core import Configuration, KeyGroupRange, Schema
from flink_tpu_torch.metrics import DEVICE_STATS
from flink_tpu_torch.ops.hash_table import EMPTY_KEY, MAX_PROBES, \
    hash_keys_device, ordered_table
from flink_tpu_torch.runtime import OneInputOperatorTestHarness
from flink_tpu_torch.runtime.operators import device_window as port_dw
from flink_tpu_torch.state.device_backend import DeviceKeyedStateBackend
from flink_tpu_torch.state.tiering import PrefetchPipeline, \
    ResidencyManager, TieringPolicy, hit_ratio_series, register_residency, \
    residency_table, unregister_residency
from flink_tpu_torch.window import SlidingEventTimeWindows, \
    TumblingEventTimeWindows

ROOT = Path(__file__).resolve().parents[1]
MAXP = 128
FIELDS = [("key", np.int64), ("v", np.int64)]
SYNC = {"state.tiering.async-prefetch": False}
AGGS = (("sum", "v"), ("count", None), ("max", "v"))


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from flink_tpu.core import KeyGroupRange as RefKGR
    from flink_tpu.core.config import Configuration as RefConfiguration
    from flink_tpu.core.config import TieringOptions
    from flink_tpu.core.records import Schema as RefSchema
    from flink_tpu.ops.hash_table import ensure_x64
    from flink_tpu.runtime import OneInputOperatorTestHarness as Harness
    from flink_tpu.runtime.operators import device_window as dw
    from flink_tpu.state import tiering
    from flink_tpu.state.tiering import policy as ref_policy
    from flink_tpu.state.tpu_backend import TpuKeyedStateBackend
    from flink_tpu.window import SlidingEventTimeWindows as Sliding
    from flink_tpu.window import TumblingEventTimeWindows as Tumbling
    ensure_x64()

    def config(async_prefetch=False):
        return RefConfiguration().set(TieringOptions.ASYNC_PREFETCH,
                                      async_prefetch)

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, KGR=RefKGR, config=config, Schema=RefSchema,
        Harness=Harness, dw=dw, tiering=tiering, policy=ref_policy,
        Backend=TpuKeyedStateBackend, Sliding=Sliding, Tumbling=Tumbling)


# -- comparisons ---------------------------------------------------------
def _policy_equal(a, b) -> None:
    for f in ("heat", "last_touch", "first_touch", "stage"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert (a._boundaries, a.decays) == (b._boundaries, b.decays)


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


def _residency_equal(pb, rb) -> None:
    """The same groups demoted and promoted so far, the same groups on the
    host, and the same policy state."""
    pm, rm = pb.residency, rb.residency
    assert (pm.evicted_groups, pm.promoted_groups, pm.boundaries) == \
        (rm.evicted_groups, rm.promoted_groups, rm.boundaries)
    _policy_equal(pm.policy, rm.policy)
    ph, rh = pb.host_tier, rb.host_tier
    assert (ph is None) == (rh is None)
    if ph is not None:
        assert np.array_equal(ph.spilled_mask, rh.spilled_mask)
        assert sorted(ph.keys().tolist()) == sorted(rh.keys().tolist())
        assert ph.promoted_keys == rh.promoted_keys
    assert pm.hit_ratio_series() == rm.hit_ratio_series()


# -- the policy and the manager -------------------------------------------
def _policy_steps(seed: int, steps: int = 48):
    """Seeded observations: touches with and without counts, a merged
    device clock, boundaries, demotions and promotions, and candidate
    sets to order, step by step."""
    rng = np.random.default_rng(seed)
    clock = np.zeros(MAXP, np.int64)
    for b in range(1, steps + 1):
        touched = rng.integers(0, MAXP, rng.integers(1, 40))
        counts = None
        if b % 3 == 0:
            touched = np.unique(touched)
            counts = rng.integers(1, 30, len(touched)).astype(np.float64)
        adv = rng.random(MAXP) < 0.2
        clock[adv] = 2 * b
        yield {"touch": (touched, b, counts), "clock": clock.copy(),
               "demote": rng.integers(0, MAXP, rng.integers(0, 6)),
               "promote": rng.integers(0, MAXP, rng.integers(0, 3)),
               "cands": rng.choice(MAXP, rng.integers(0, MAXP),
                                   replace=False),
               "min_heat": float(rng.integers(0, 5))}


@pytest.mark.parametrize("seed, interval, factor", [(7, 8, 0.5),
                                                    (24243, 3, 0.25)])
def test_policy_replays_reference(ref, seed, interval, factor):
    """Heat, stages, first and last touch, decays, and every eviction and
    promotion order equal the reference's, step by step, bit for bit."""
    pp = TieringPolicy(MAXP, seed=seed, decay_interval=interval,
                       decay_factor=factor)
    rp = ref.policy.TieringPolicy(MAXP, seed=seed, decay_interval=interval,
                                  decay_factor=factor)
    assert np.array_equal(pp._tiebreak, rp._tiebreak)
    for st in _policy_steps(seed):
        for p in (pp, rp):
            p.touch(*st["touch"])
        assert np.array_equal(pp.adopt_clock(st["clock"]),
                              rp.adopt_clock(st["clock"]))
        assert pp.on_boundary() == rp.on_boundary()
        for p in (pp, rp):
            p.demote(st["demote"])
            p.promote(st["promote"])
        _policy_equal(pp, rp)
        assert np.array_equal(pp.eviction_order(st["cands"]),
                              rp.eviction_order(st["cands"]))
        assert np.array_equal(
            pp.promotion_order(st["cands"], st["min_heat"]),
            rp.promotion_order(st["cands"], st["min_heat"]))
    assert pp.decays > 0


def test_residency_manager_replays_reference(ref):
    """Observations of both paths, boundaries, demotions and promotions:
    the policy, the promotion candidates at several resident counts (the
    headroom's greedy fill and the per-boundary cap of 16), the hit-ratio
    series and the table rows equal the reference's."""
    kw = dict(seed=5, decay_interval=4, decay_factor=0.5,
              promote_headroom=0.5, promote_min_heat=2.0)
    pm, rm = ResidencyManager(MAXP, 4096, **kw), \
        ref.tiering.ResidencyManager(MAXP, 4096, **kw)
    rng = np.random.default_rng(3)
    spilled = np.zeros(MAXP, bool)
    warm = np.zeros(MAXP, np.int64)
    for b, st in enumerate(_policy_steps(11, 40), start=1):
        groups = rng.integers(0, MAXP, 300)
        mask = spilled if b % 2 else None
        for m in (pm, rm):
            m.observe(groups, b, mask)
            m.adopt_clock(st["clock"], spilled)
            m.on_boundary()
        demote = np.unique(st["demote"])
        promote = np.unique(st["promote"])
        spilled[demote] = True
        warm[demote] = rng.integers(1, 60, len(demote))
        spilled[promote] = False
        warm[promote] = 0
        for m in (pm, rm):
            m.note_demoted(demote)
            m.note_promoted(promote)
            m.update_view(spilled, warm)
        for resident, cap in ((0, 4096), (1900, 4096), (2040, 4096),
                              (0, 1 << 20)):
            got = pm.promotion_candidates(spilled, warm, resident, cap)
            want = rm.promotion_candidates(spilled, warm, resident, cap)
            assert got.dtype == want.dtype and np.array_equal(got, want)
            assert len(got) <= 16
            assert warm[got].sum() <= max(0, cap // 2 - resident)
        _policy_equal(pm.policy, rm.policy)
    assert pm.hit_ratio_series() == rm.hit_ratio_series()
    assert len(pm.hit_ratio_series()) == 40
    for cold in (False, True):
        assert pm.table_rows(cold) == rm.table_rows(cold)
    assert (pm.evicted_groups, pm.promoted_groups) == \
        (rm.evicted_groups, rm.promoted_groups)
    assert len(pm.promotion_candidates(spilled, warm, 0, 1 << 20)) == 16


def test_registry_tables_equal_reference(ref):
    """register / residency_table (substring match, and every manager
    when nothing matches) / hit_ratio_series / unregister."""
    names = ("jobA/window/0", "jobA/window/1", "jobB/agg/0")
    managers = {}
    for i, name in enumerate(names):
        pair = (ResidencyManager(MAXP, 256, seed=i),
                ref.tiering.ResidencyManager(MAXP, 256, seed=i))
        spilled = np.arange(MAXP) % (i + 2) == 0
        for m in pair:
            m.observe(np.arange(i, MAXP, 3), 1, spilled)
            m.on_boundary()
            m.note_demoted(np.flatnonzero(spilled))
            m.update_view(spilled, spilled.astype(np.int64) * (i + 1))
        managers[name] = pair
        register_residency(name, pair[0])
        ref.tiering.register_residency(name, pair[1])
    try:
        for q in ("jobA", "window/1", "jobB/agg", "nothing-matches", None):
            want = [r for r in ref.tiering.residency_table(q)
                    if r["operator"] in names]
            got = [r for r in residency_table(q) if r["operator"] in names]
            assert got == want and got
            assert {k: v for k, v in hit_ratio_series(q).items()
                    if k in names} == {
                k: v for k, v in ref.tiering.hit_ratio_series(q).items()
                if k in names}
    finally:
        for name in names:
            unregister_residency(name)
            ref.tiering.unregister_residency(name)
    assert not any(r["operator"] in names for r in residency_table())


# -- the prefetch pipeline --------------------------------------------------
def _stage_fn(log):
    def stage(groups):
        log.append(threading.current_thread().name)
        if int(groups[0]) == 99:
            return None     # the groups left the warm tier
        return {"groups": groups, "n": int(groups.sum())}
    return stage


def _poll_until(pipe, timeout=5.0):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        p = pipe.poll()
        if p is not None or pipe.idle:
            return p
        time.sleep(0.001)
    raise AssertionError("the prefetch pipeline staged nothing in time")


def test_prefetch_async_payloads_equal_sync(ref):
    """The same requests staged inline and on the worker thread give the
    same payloads in the same order, as the reference's inline pipeline;
    queued or staged groups are not requested twice; the worker ends when
    its queue is empty; a closed pipeline takes nothing."""
    steps = [[[3, 4], [4, 5]], [[99]], [[7], [3]], [[8, 9, 10]]]
    runs = {}
    for mode, pipe_cls, asynchronous in (
            ("port_sync", PrefetchPipeline, False),
            ("port_async", PrefetchPipeline, True),
            ("ref_sync", ref.tiering.PrefetchPipeline, False)):
        log = []
        pipe = pipe_cls(_stage_fn(log), asynchronous=asynchronous)
        out = []
        for step in steps:
            accepted = [pipe.request(np.asarray(r, np.int64)) for r in step]
            payloads = []
            while (p := _poll_until(pipe)) is not None:
                payloads.append((p["groups"].tolist(), p["n"]))
            out.append((accepted, payloads))
        runs[mode] = out
        if mode == "port_async":
            # staged on the pipeline thread's supervised worker (the
            # watchdog's tier.prefetch bound)
            assert set(log) == {"watchdog:tier-prefetch"}
            t0 = time.perf_counter()
            while pipe._thread is not None and time.perf_counter() - t0 < 5:
                time.sleep(0.001)
            assert pipe._thread is None      # idle: no thread held
        pipe.close()
        assert pipe.request(np.asarray([1], np.int64)) == 0
    assert runs["port_sync"] == runs["port_async"] == runs["ref_sync"]
    assert runs["port_sync"][0] == ([2, 1], [([3, 4], 7), ([5], 5)])
    assert runs["port_sync"][1] == ([1], [])


def test_prefetch_cancel_forget_and_error(ref):
    """cancel() bumps the epoch: a staging in flight when it is called
    never reaches poll(); forget() lets pending groups be requested
    again; a staging failure is raised at the next poll, on the caller's
    thread, in both modes, once."""
    gate, started = threading.Event(), threading.Event()

    def slow(groups):
        started.set()
        gate.wait(5.0)
        return {"groups": groups, "n": len(groups)}

    pipe = PrefetchPipeline(slow, asynchronous=True)
    assert pipe.request(np.asarray([1, 2], np.int64)) == 2
    assert started.wait(5.0)
    assert pipe.request(np.asarray([1, 2], np.int64)) == 0   # pending
    pipe.cancel()
    gate.set()
    t0 = time.perf_counter()
    while pipe._thread is not None and time.perf_counter() - t0 < 5:
        time.sleep(0.001)
    assert pipe.poll() is None and pipe.cancelled_total == 1 and pipe.idle
    gate.clear()
    started.clear()
    assert pipe.request(np.asarray([1, 2], np.int64)) == 2
    assert started.wait(5.0)
    pipe.forget([1])
    assert pipe.request(np.asarray([1], np.int64)) == 1
    gate.set()
    pipe.close()

    def boom(groups):
        raise RuntimeError(f"gather of {groups.tolist()} failed")

    for pipe in (PrefetchPipeline(boom, asynchronous=False),
                 PrefetchPipeline(boom, asynchronous=True),
                 ref.tiering.PrefetchPipeline(boom, asynchronous=False)):
        pipe.request(np.asarray([6], np.int64))
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match=r"gather of \[6\] failed"):
            while time.perf_counter() - t0 < 5:
                pipe.poll()
                time.sleep(0.001)
        assert pipe.poll() is None
        assert pipe.request(np.asarray([6], np.int64)) == 1
        pipe.close()


# -- the backend -------------------------------------------------------------
def port_backend(budget=256, capacity=64, settings=None, device="cpu"):
    b = DeviceKeyedStateBackend(
        KeyGroupRange(0, MAXP - 1), MAXP, capacity=capacity, device=device,
        hbm_budget_slots=budget,
        config=Configuration(SYNC if settings is None else settings))
    b.register_array_state("acc", "sum", torch.float64)
    b.register_array_state("cnt", "count", torch.int32, ring=4)
    return b


def _ref_backend(ref, budget=256, capacity=64):
    b = ref.Backend(ref.KGR(0, MAXP - 1), MAXP, capacity=capacity,
                    hbm_budget_slots=budget, config=ref.config())
    b.register_array_state("acc", "sum", ref.jnp.float64)
    b.register_array_state("cnt", "count", ref.jnp.int32, ring=4)
    return b


def drive_lots(seed: int, lots: int = 12, n_keys: int = 2000,
               size: int = 256):
    """Seeded batches (keys, values, ring rows); the second half shifts
    most keys to a quarter of the key space, so groups that went cold
    heat up again."""
    rng = np.random.default_rng(seed)
    for lot in range(lots):
        hi = n_keys if lot < lots // 2 else n_keys // 4
        keys = rng.integers(0, hi, size)
        yield keys, rng.integers(1, 9, size).astype(np.float64), keys % 4


def port_fold(b, keys, vals, ring) -> None:
    dev = b.device
    slots = b.slots_for_batch(torch.from_numpy(keys).to(dev))
    b.fold_batch("acc", slots, torch.from_numpy(vals).to(dev), slots >= 0)
    b.fold_batch("cnt", slots, torch.ones(len(keys), dtype=torch.int32,
                                          device=dev),
                 slots >= 0, torch.from_numpy(ring).to(dev))


def _ref_fold(b, keys, vals, ring) -> None:
    s = b.slots_for_batch(keys)
    b.fold_batch("acc", s, vals, s >= 0)
    b.fold_batch("cnt", s, np.ones(len(keys), np.int32), s >= 0,
                 ring_idx=ring)


def _partition(b, inserted: set) -> None:
    """Device keys and host keys are disjoint and together every key."""
    t = b.table.cpu().numpy()
    dev = set(t[t != EMPTY_KEY].tolist())
    host = set(b.host_tier.keys().tolist()) if b.host_tier else set()
    assert dev.isdisjoint(host) and dev | host == inserted


def test_backend_boundaries_equal_reference(ref):
    """Host-batch folds and a boundary after each: at every boundary the
    port demotes and promotes the same groups as the reference (policy,
    spilled groups, host keys, counts), each key lives on exactly one
    tier, and promotions land; the snapshot equals the reference's and
    the unbudgeted twin's field by field."""
    pb, rb, flat = port_backend(), _ref_backend(ref), port_backend(0, 4096)
    inserted: set = set()
    landed = 0
    for keys, vals, ring in drive_lots(17):
        inserted.update(keys.tolist())
        port_fold(pb, keys, vals, ring)
        _ref_fold(rb, keys, vals, ring)
        port_fold(flat, keys, vals, ring)
        a, b = pb.tier_boundary(), rb.tier_boundary()
        assert a == b
        landed += a
        _residency_equal(pb, rb)
        _partition(pb, inserted)
    assert landed >= 2 and pb.evictions["groups"] > 0
    assert pb.promotions["applied"] == landed
    snap = pb.snapshot(1)
    _snap_equal(snap, rb.snapshot(1))
    _snap_equal(snap, flat.snapshot(1))
    _snap_equal(snap, pb.snapshot_plain(1))


def test_async_staging_equals_sync_and_restore_cancels():
    """Staging on the prefetch thread lands promotions at boundaries
    only: the snapshot equals the synchronous run's. A restore cancels
    what is queued, and nothing staged before it applies after it."""
    pa = port_backend(settings={})
    ps = port_backend()
    for keys, vals, ring in drive_lots(71):
        for b in (pa, ps):
            port_fold(b, keys, vals, ring)
            b.tier_boundary()
    pa.prefetch_pipeline.close()
    _snap_equal(pa.snapshot(1), ps.snapshot(1))
    pipe = ps.prefetch_pipeline
    warm = np.flatnonzero(ps.host_tier.spilled_mask)[:3]
    assert len(warm) and pipe.request(warm) == len(warm)
    snap = ps.snapshot(2)
    ps.restore([snap])
    assert pipe.cancelled_total >= 1 and pipe.poll() is None
    _snap_equal(ps.snapshot(3), snap)


def _warm_pair(ref):
    """A port and a reference backend driven alike, a boundary's clock and
    decay after each batch (no promotion), up to the first boundary with
    promotion candidates; returns them and the candidates."""
    pb, rb = port_backend(), _ref_backend(ref)
    for keys, vals, ring in drive_lots(23):
        port_fold(pb, keys, vals, ring)
        _ref_fold(rb, keys, vals, ring)
        for b in (pb, rb):
            b.residency.on_boundary()
        if pb.host_tier is None:
            continue
        host = pb.host_tier
        cands = pb.residency.promotion_candidates(
            host.spilled_mask, host.group_counts(), pb.num_keys,
            pb.capacity)
        assert np.array_equal(cands, rb.residency.promotion_candidates(
            rb.host_tier.spilled_mask, rb.host_tier.group_counts(),
            rb._num_keys, rb.capacity))
        if len(cands):
            return pb, rb, cands
    raise AssertionError("no promotion candidates")


def _state_of(b) -> tuple:
    t = b.table.cpu().numpy() if isinstance(b.table, torch.Tensor) \
        else np.asarray(b.table)
    return (t.copy(), sorted(b.host_tier.keys().tolist()),
            b.host_tier.spilled_mask.copy(), b.residency.promoted_groups)


@pytest.mark.parametrize("refusal", ["headroom", "table_full"])
def test_apply_promotion_refusals_move_nothing(ref, refusal):
    """A staged promotion refused because promoted and resident keys
    would pass 0.6 of capacity, or because the table cannot admit every
    key, leaves the table, the host tier and the residency as they were,
    its groups warm and requestable again, as the reference does."""
    pb, rb, cands = _warm_pair(ref)
    if refusal == "headroom":
        pb._num_keys = rb._num_keys = int(0.6 * pb.capacity)
    else:
        t = pb.table.cpu().numpy()
        free = t == EMPTY_KEY
        t[free] = -(np.arange(int(free.sum())) + 10 ** 12)
        pb.table.copy_(torch.from_numpy(t))
        rb.table = ref.jnp.asarray(t)
    outcome = []
    for b in (pb, rb):
        before = _state_of(b)
        b.prefetch_pipeline.request(cands)
        payload = b.prefetch_pipeline.poll()
        assert payload["n"] > 0
        outcome.append(b.apply_promotion(payload))
        after = _state_of(b)
        for x, y in zip(before, after):
            assert np.array_equal(x, y)
        assert b.prefetch_pipeline.idle
        assert b.prefetch_pipeline.request(cands) == len(cands)
    assert outcome == [False, False]
    assert pb.promotions["refused"] == 1
    _snap_equal(pb.snapshot(1), rb.snapshot(1))


def test_raced_payload_is_gathered_again(ref):
    """A host-tier fold between staging and applying bumps the version:
    the payload is gathered again, and the promoted rows carry the fold,
    as in the reference."""
    pb, rb, cands = _warm_pair(ref)
    g = int(cands[0])
    key = int(pb.host_tier.keys()[pb.host_tier.key_groups() == g][0])
    for b in (pb, rb):
        b.prefetch_pipeline.request(cands)
        payload = b.prefetch_pipeline.poll()
        v0 = b.host_tier.version
        hs = b.host_tier.slots_for(np.asarray([key], np.int64))
        b.host_tier.fold("acc", hs, np.asarray([1000.0]), None)
        assert b.host_tier.version > v0 == payload["version"]
        assert b.apply_promotion(payload)
        assert not b.host_tier.spilled_mask[g]
    assert pb.promotions["regathered"] == 1
    snap = pb.snapshot(1)
    _snap_equal(snap, rb.snapshot(1))
    at = int(np.flatnonzero(snap["keys"] == key)[0])
    assert snap["states"]["acc"]["values"][at] >= 1000.0


def test_forced_spill_the_probe_cannot_fit_evicts_the_coldest(monkeypatch):
    """A forced spill whose remaining keys the probe cannot place in a
    table of the same capacity (the card's layout at a high load: its
    probe claims in thread order) takes the coldest resident groups too,
    in the policy's order, down to 0.4 of the capacity; every key stays on
    exactly one tier and the state is unchanged."""
    b, twin = port_backend(), port_backend(0, 4096)
    inserted: set = set()
    for keys, vals, ring in drive_lots(5, lots=3):
        inserted.update(keys.tolist())
        port_fold(b, keys, vals, ring)
        port_fold(twin, keys, vals, ring)
    real, calls = b._fresh_table, []

    def first_fails(keys, capacity):
        calls.append(int(keys.numel()))
        return None if len(calls) == 1 else real(keys, capacity)

    monkeypatch.setattr(b, "_fresh_table", first_fails)
    t = b.table.numpy()
    groups = np.unique(b._device_resident()[2])
    order = b.residency.eviction_order(groups)
    forced = int(order[-1])            # the hottest: the coldest go with it
    demoted = b.residency.evicted_groups
    b._force_spill_groups(np.asarray([forced]))
    extra = b.residency.evicted_groups - demoted - 1
    assert len(calls) == 2 and extra >= 1
    assert b.evictions["forced_fallback"] == extra
    assert b.num_keys <= 0.4 * b.capacity < calls[0]
    assert b.host_tier.spilled_mask[[forced, *order[:extra]]].all()
    assert not b.host_tier.spilled_mask[order[extra:-1]].any()
    assert len(t[t != EMPTY_KEY]) > b.num_keys
    _partition(b, inserted)
    _snap_equal(b.snapshot(1), twin.snapshot(1))


def adversarial_probe(real):
    """A stand-in for the card's thread order: into an empty table (a
    rebuild) keys claim one after another in descending order of their
    home slot, the order that pushes each cluster's earliest homes
    furthest, and a key finding no free slot within the window (the card's
    128 slots scaled to 1/32 of these small tables) fails. Every
    other probe is the plain version. Returns the probe and its tally."""
    tally = {"rebuilds": 0, "stranded": 0}

    def probe(table, keys, valid=None):
        if valid is not None or bool((table != EMPTY_KEY).any()):
            return real(table, keys, valid)
        cap = table.numel()
        window = min(MAX_PROBES, cap // 32)
        home = (hash_keys_device(keys) & (cap - 1)).tolist()
        kl = keys.tolist()
        t = table.tolist()
        slots = [-1] * len(kl)
        for i in sorted(range(len(kl)), key=lambda j: -home[j]):
            for d in range(window):
                s = (home[i] + d) & (cap - 1)
                if t[s] == EMPTY_KEY:
                    t[s], slots[i] = kl[i], s
                    break
        table.copy_(torch.tensor(t, dtype=torch.int64))
        slots = torch.tensor(slots, dtype=torch.int32)
        tally["rebuilds"] += 1
        tally["stranded"] += int((slots < 0).sum())
        return table, slots, slots >= 0

    return probe, tally


@pytest.mark.parametrize("form", ["deferred", "deferred_incremental"])
def test_forced_spill_under_an_adversarial_claim_order_equals_reference(
        ref, monkeypatch, form):
    """With rebuilds probed in an adversarial claim order that strands
    keys, every forced spill still evicts exactly the groups the
    reference evicts, boundary by boundary: the stranded rebuilds are laid
    out in home-slot order instead (``ordered_rebuilds``), no group is
    taken beyond those asked for (``forced_fallback`` 0), every key stays
    on one tier, and the rows and the final snapshot equal the
    reference's. The home-slot layout displaces no key further than the
    adversary's layout would, and every key is found."""
    from flink_tpu_torch.state import device_backend as port_db
    probe, tally = adversarial_probe(port_db.lookup_or_insert)
    monkeypatch.setattr(port_db, "lookup_or_insert", probe)
    window, kw = FORMS[form]
    pop, ph = port_operator(window, kw)
    rop, rh = _ref_operator(ref, window, kw)
    for op in shift_stream(seed=13):
        for h in (ph, rh):
            apply_op(h, op)
        if op[0] == "wm":
            _residency_equal(pop.backend, rop._backend)
    b = pop.backend
    assert tally["stranded"] > 0 and b.evictions["ordered_rebuilds"] > 0
    assert b.evictions["forced_fallback"] == 0 and b.evictions["groups"] > 0
    t = b.table.numpy()
    live = torch.from_numpy(t[t != EMPTY_KEY])
    assert torch.equal(port_db.lookup(b.table, live).long(),
                       torch.from_numpy(np.flatnonzero(t != EMPTY_KEY)))
    rsnap = rh.snapshot(1)["keyed"]
    rsnap = (rsnap[0] if isinstance(rsnap, list) else rsnap)["backend"]
    _snap_equal(ph.snapshot(1)["keyed"]["backend"], rsnap)
    for h in (ph, rh):
        h.close()
    want = rows_of(rh)
    assert len(want) > 5 and rows_of(ph) == want
    # the home-slot layout of the live keys displaces none further than
    # the table they sit in now does
    mask = b.capacity - 1
    home = hash_keys_device(live) & mask
    now = (torch.from_numpy(np.flatnonzero(t != EMPTY_KEY)) - home) & mask
    got = ordered_table(live, b.capacity)
    assert got is not None
    assert int(((got[1] - home) & mask).max()) <= int(now.max())


# -- the window operator through the harness ----------------------------------
def shift_stream(seed=31, steps=30, n=160, t_step=400, keys=900):
    """[("batch", rows, ts) | ("wm", t)]: integer values, timestamps a
    little out of order, a watermark every second batch; after a third of
    the steps most rows move to the first fifth of the keys, whose groups
    the first third drove to the host."""
    rng = np.random.default_rng(seed)
    ops, t = [], 0
    for step in range(steps):
        hot = keys if step < steps // 3 else keys // 5
        ks = np.where(rng.random(n) < 0.8, rng.integers(0, hot, n),
                      rng.integers(0, keys, n))
        vs = rng.integers(1, 10, n)
        ts = rng.integers(max(0, t - 300), t + 300, n)
        ops.append(("batch", list(zip(ks.tolist(), vs.tolist())),
                    ts.tolist()))
        t += t_step
        if step % 2 == 1:
            ops.append(("wm", t - 400))
    ops.append(("wm", t + 20000))
    return ops


#: form -> (window, operator keywords)
FORMS = {
    "host_batch": ("sliding", dict(capacity=64, hbm_budget_slots=256)),
    "deferred": ("sliding", dict(capacity=64, hbm_budget_slots=256,
                                 defer_overflow=True,
                                 spill_staging_slots=1 << 10)),
    "deferred_incremental": ("tumbling", dict(
        capacity=64, hbm_budget_slots=256, defer_overflow=True,
        spill_staging_slots=1 << 10, fire_incremental=True)),
}


def port_operator(window: str, kw: dict, settings=None):
    pw = (TumblingEventTimeWindows.of(1000) if window == "tumbling"
          else SlidingEventTimeWindows.of(3000, 1000))
    kw = {"fire_incremental": False, **kw}
    op = port_dw.DeviceWindowAggOperator(
        pw, "key", [port_dw.AggSpec(k, f, dtype=torch.int64)
                    for k, f in AGGS], ring_size=8, device="cpu", **kw)
    h = OneInputOperatorTestHarness(
        op, schema=Schema(FIELDS),
        config=Configuration(SYNC if settings is None else settings))
    return op, h


def _ref_operator(ref, window: str, kw: dict):
    rw = (ref.Tumbling.of(1000) if window == "tumbling"
          else ref.Sliding.of(3000, 1000))
    kw = {"fire_incremental": False, **kw}
    op = ref.dw.DeviceWindowAggOperator(
        rw, "key", [ref.dw.AggSpec(k, f, dtype=ref.jnp.int64)
                    for k, f in AGGS], ring_size=8, **kw)
    return op, ref.Harness(op, schema=ref.Schema(FIELDS),
                           config=ref.config())


def apply_op(h, op) -> None:
    if op[0] == "batch":
        h.process_elements(op[1], op[2])
    else:
        h.process_watermark(op[1])


def rows_of(h) -> list:
    return [(int(b.timestamps[0]), [(f.name, np.dtype(f.dtype))
                                    for f in b.schema.fields],
             [tuple(v.item() for v in r)
              for r in zip(*[b.column(f.name) for f in b.schema.fields])])
            for b in h.output.batches]


@pytest.mark.parametrize("form", sorted(FORMS))
def test_operator_boundaries_equal_reference(ref, form):
    """Through the harness: after every watermark the port has demoted and
    promoted the same key groups as the reference, promotions land, the
    rows equal the reference's and the unbudgeted twin's, and a snapshot
    after the run equals the reference's and the twin's."""
    window, kw = FORMS[form]
    pop, ph = port_operator(window, kw)
    rop, rh = _ref_operator(ref, window, kw)
    flat = {k: v for k, v in kw.items() if k != "hbm_budget_slots"}
    _fop, fh = port_operator(window, {**flat, "capacity": 1 << 11})
    promoted = []
    for op in shift_stream():
        for h in (ph, rh, fh):
            apply_op(h, op)
        if op[0] == "wm":
            _residency_equal(pop.backend, rop._backend)
            promoted.append(pop.backend.residency.promoted_groups)
    assert promoted[-1] > 0 and pop.backend.evictions["groups"] > 0
    assert pop.backend.promotions["applied"] > 1
    if kw.get("fire_incremental"):
        assert pop.inc_rebuilds.get("promotion", 0) > 0
    snaps = [h.snapshot(1)["keyed"]["backend"] for h in (ph, fh)]
    rsnap = rh.snapshot(1)["keyed"]
    rsnap = (rsnap[0] if isinstance(rsnap, list) else rsnap)["backend"]
    _snap_equal(snaps[0], rsnap)
    _snap_equal(snaps[0], snaps[1])
    for h in (ph, rh, fh):
        h.close()
    want = rows_of(rh)
    assert len(want) > 5 and rows_of(ph) == want == rows_of(fh)


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_checkpoint_after_promotion_restores_across_packages(ref,
                                                             direction):
    """A checkpoint taken after the first promotion equals the
    reference's and the unbudgeted twin's, field by field; each
    package's checkpoint restores into the other's operator (unbudgeted
    one way, budgeted the other), snapshots the same again, and its rows
    to the end equal an uninterrupted run's."""
    window, kw = FORMS["deferred"]
    flat = {k: v for k, v in kw.items() if k != "hbm_budget_slots"}
    flat["capacity"] = 1 << 11
    pop, ph = port_operator(window, kw)
    rop, rh = _ref_operator(ref, window, kw)
    _fop, fh = port_operator(window, flat)
    ops = shift_stream(seed=9)
    cut = 0
    while cut < len(ops):
        for h in (ph, rh, fh):
            apply_op(h, ops[cut])
        cut += 1
        if ops[cut - 1][0] == "wm" and pop.backend.promotions["applied"]:
            break
    assert pop.backend.promotions["applied"] and cut < len(ops) - 4
    snaps = {"port": ph.snapshot(1), "ref": rh.snapshot(1),
             "flat": fh.snapshot(1)}
    keyed = {n: (s["keyed"][0] if isinstance(s["keyed"], list)
                 else s["keyed"])["backend"] for n, s in snaps.items()}
    _snap_equal(keyed["port"], keyed["ref"])
    _snap_equal(keyed["port"], keyed["flat"])
    if direction == "port_to_reference":
        restored = ref.Harness.restored(
            lambda: _ref_operator(ref, window, flat)[0], snaps["port"],
            schema=ref.Schema(FIELDS))
        twin = restored.snapshot(2)["keyed"]
        twin = (twin[0] if isinstance(twin, list) else twin)["backend"]
    else:
        restored = OneInputOperatorTestHarness.restored(
            lambda: port_operator(window, kw)[0], snaps["ref"],
            schema=Schema(FIELDS), config=Configuration(SYNC))
        twin = restored.snapshot(2)["keyed"]["backend"]
        assert restored.operator.backend.spill_active
    _snap_equal(twin, keyed["port"])
    tail = ops[cut:]
    for op in tail:
        apply_op(restored, op)
        apply_op(fh, op)
    restored.close()
    fh.close()
    first = int(restored.output.batches[0].timestamps[0])
    want = [r for r in rows_of(fh) if r[0] >= first]
    assert len(want) > 2 and rows_of(restored) == want


def test_tier_metrics_and_registry_of_an_operator():
    """The tier counters move with evictions and promotions, the hit
    ratio is a share, the bytes in use are the backend's; the operator
    registers its residency as task/subtask while open and unregisters
    it at close."""
    before = DEVICE_STATS.snapshot()
    window, kw = FORMS["host_batch"]
    op, h = port_operator(window, kw)
    h.ctx.task_name = "tiering-metrics-job"
    for o in shift_stream(seed=4):
        apply_op(h, o)
    after = DEVICE_STATS.snapshot()
    b = op.backend
    assert after["tier_evictions_total"] - before["tier_evictions_total"] \
        == b.evictions["groups"] > 0
    assert after["tier_evicted_keys_total"] \
        - before["tier_evicted_keys_total"] == b.evictions["keys"]
    assert after["tier_prefetches_total"] - before["tier_prefetches_total"] \
        == b.residency.promoted_groups > 0
    assert after["tier_promoted_keys_total"] \
        - before["tier_promoted_keys_total"] == b.host_tier.promoted_keys
    assert 0.0 < after["tier_hot_hit_ratio"] <= 1.0
    assert after["tier_hbm_bytes_in_use"] == b.state_nbytes
    rows = residency_table("tiering-metrics-job")
    assert rows and {r["operator"] for r in rows} == \
        {"tiering-metrics-job/0"}
    assert {r["tier"] for r in rows} == {"hot", "warm"}
    assert hit_ratio_series("tiering-metrics-job")["tiering-metrics-job/0"]
    h.close()
    assert not [r for r in residency_table()
                if r["operator"] == "tiering-metrics-job/0"]
    assert b.prefetch_pipeline.request(np.asarray([1], np.int64)) == 0


def port_side_digest() -> dict:
    """The port's side alone: a budgeted deferred operator over the
    shifting stream with asynchronous staging, and the unbudgeted twin;
    the rows, the snapshot and the promotions, for a process without
    JAX."""
    window, kw = FORMS["deferred"]
    op, h = port_operator(window, kw, settings={})
    _f, fh = port_operator(window, {**{k: v for k, v in kw.items()
                                       if k != "hbm_budget_slots"},
                                    "capacity": 1 << 11})
    for o in shift_stream():
        apply_op(h, o)
        apply_op(fh, o)
    snap = h.snapshot(1)["keyed"]["backend"]
    _snap_equal(snap, fh.snapshot(1)["keyed"]["backend"])
    h.close()
    fh.close()
    assert rows_of(h) == rows_of(fh)
    return {"rows": len(rows_of(h)), "keys": int(len(snap["keys"])),
            "evicted": op.backend.evictions["groups"],
            "applied": op.backend.promotions["applied"]}


def test_port_side_runs_without_jax():
    """The port's side of this file in a process where neither jax nor
    flink_tpu can be imported: budgeted rows equal the twin's, with
    evictions and promotions."""
    code = (
        "import sys; sys.modules['jax'] = None; "
        "sys.modules['flink_tpu'] = None\n"
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location('t', "
        "'tests/test_torch_tiering.py'); t = "
        "importlib.util.module_from_spec(spec); "
        "spec.loader.exec_module(t)\n"
        "print(t.port_side_digest())\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'flink_tpu.')) "
        "for m in sys.modules if sys.modules[m] is not None)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = eval(out.stdout.strip().splitlines()[-1])
    assert got["rows"] > 5 and got["evicted"] > 0 and got["applied"] > 0


@pytest.mark.cuda
def test_async_staging_on_a_side_stream_equals_sync():
    """On the card: promotions staged on the prefetch thread's own CUDA
    stream (pinned gathers, event-ordered) give the synchronous run's
    snapshot, with promotions landing and their device ms recorded."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    runs = {}
    for mode, settings in (("async", {}), ("sync", SYNC)):
        b = port_backend(settings=settings, device="cuda")
        for keys, vals, ring in drive_lots(71, lots=16):
            port_fold(b, keys, vals, ring)
            b.tier_boundary()
        b.prefetch_pipeline.close()
        torch.cuda.synchronize()
        runs[mode] = (b.snapshot(1), b)
    _snap_equal(runs["async"][0], runs["sync"][0])
    for _s, b in runs.values():
        assert b.promotions["applied"] > 0
        assert len(b.promotion_events) == b.promotions["applied"]
        assert all(s.elapsed_time(e) >= 0 for s, e in b.promotion_events)
