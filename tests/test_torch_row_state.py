"""Port parity: the row plane (flink_tpu_torch/ops/row_state.py and
DeviceKeyedStateBackend's rows_* / dedup_first_batch / ValueState) against
flink_tpu/state/tpu_backend.py on the same seeded numpy input.

The plain versions of dedup_first, row_set, row_get and row_unset run
chip_smoke.py's adversarial sequences (``ROW_EDGE_CASES``) beside the
reference's jitted ``_dedup_first``, ``_rows_set``, ``_rows_get`` and
``_rows_unset`` on JAX's CPU backend: fresh masks, presence, clocks,
values and tables equal exactly after every operation (the plain probe is
the reference's, so even the slot layouts agree). Where a dedup overflows,
the port leaves presence and clock as they were and keeps the table's
claims (the reference's program returns the same table; its backend
discards it): the retry after the growth admits the same rows.

Then the backends: the port's row plane against TpuKeyedStateBackend's
(built with ``host_index=False``, the reference's device path) through
upserts, lookups, clears, TTL expiry and keep-first batches that grow the
table by overflow and by the 0.6 rule: the same rehash points, fresh masks
and snapshots field by field; snapshots restore across the two packages
in both directions. The ``cuda`` cases hold the kernels
(csrc/row_state.cu) against the plain versions on the same sequences and
a backend on the card against one on the CPU; they skip without a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_row_state.py
"""

import importlib.util
import pathlib
import time

import numpy as np
import pytest
import torch

from flink_tpu_torch.core import KeyGroupRange
from flink_tpu_torch.state.descriptors import StateTtlConfig, \
    ValueStateDescriptor
from flink_tpu_torch.state.device_backend import DeviceKeyedStateBackend

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

I64_MAX = np.iinfo(np.int64).max


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import types

    import jax.numpy as jnp

    from flink_tpu.core import KeyGroupRange as RefRange
    from flink_tpu.ops import hash_table as ht
    from flink_tpu.state import tpu_backend as tb
    from flink_tpu.state.descriptors import StateTtlConfig as RefTtl
    from flink_tpu.state.descriptors import ValueStateDescriptor as RefDesc
    return types.SimpleNamespace(jnp=jnp, ht=ht, tb=tb, Range=RefRange,
                                 Ttl=RefTtl, Desc=RefDesc)


def _sanitise(keys: np.ndarray) -> np.ndarray:
    return np.where(keys == I64_MAX, I64_MAX - 1, keys).astype(np.int64)


def _ref_run(ref, c: dict) -> tuple:
    """A ``row_edge_configs`` sequence through the reference's programs,
    with the port's handling around them: a dedup whose overflow flag is
    set keeps only its table (the keys it claimed, with presence 0, as the
    port's ``dedup_first`` leaves them; the reference's backend discards
    them, and its occupancy after the retry is the same)."""
    jnp, ht, tb = ref.jnp, ref.ht, ref.tb
    cap, ttl = c["cap"], c["ttl"]
    st = {"table": ht.make_table(cap),
          "vals": jnp.zeros(cap, np.dtype(c["dtype"])),
          "presence": jnp.zeros(cap, jnp.int8),
          "last_ts": jnp.zeros(cap, jnp.int64) if ttl else None}
    outs, states = [], []
    for op in c["ops"]:
        kind, out = op[0], {}
        if kind == "dedup":
            _, keys, valid, ts = op
            n = len(keys)
            occ0 = int((np.asarray(st["table"]) != I64_MAX).sum())
            table, pres, last, fresh, _sc, overflow, occ = tb._dedup_first(
                st["table"], st["presence"], st["last_ts"],
                jnp.asarray(_sanitise(keys)),
                jnp.asarray(np.ones(n, bool) if valid is None else valid),
                jnp.asarray(ts), np.int64(ttl))
            if bool(overflow):
                # the port's contract: presence and clock as they were,
                # the failed attempt's claims kept (absent to every reader)
                st["table"] = table
                out = {"fresh": np.zeros(n, bool), "failed": True}
            else:
                st.update(table=table, presence=pres, last_ts=last)
                fresh = np.asarray(fresh)
                out = {"fresh": fresh, "failed": False,
                       "claims": int(occ) - occ0, "n_fresh": int(fresh.sum())}
        elif kind == "set":
            _, keys, vals, now = op
            table, slots, ok = ht.lookup_or_insert(
                st["table"], jnp.asarray(_sanitise(keys)))
            assert bool(ok.all())
            v, p, last = tb._rows_set(st["vals"], st["presence"],
                                      st["last_ts"], slots,
                                      jnp.asarray(vals),
                                      jnp.asarray(np.asarray(now, np.int64)))
            st.update(table=table, vals=v, presence=p, last_ts=last)
        elif kind == "get":
            v, p = tb._rows_get(st["table"], st["vals"], st["presence"],
                                st["last_ts"], jnp.asarray(_sanitise(op[1])),
                                np.int64(op[2]), np.int64(ttl))
            out = {"vals": np.asarray(v), "present": np.asarray(p)}
        elif kind == "unset":
            keys = jnp.asarray(_sanitise(op[1]))
            found = np.asarray(ht.lookup(st["table"], keys)) >= 0
            p, _sc = tb._rows_unset(st["table"], st["presence"], keys)
            st["presence"] = p
            out = {"found": found}
        elif kind == "grow":
            table = np.asarray(st["table"])
            old = np.flatnonzero(table != I64_MAX)
            new, slots, ok = ht.lookup_or_insert(ht.make_table(2 * cap),
                                                 jnp.asarray(table[old]))
            assert bool(ok.all())
            cap *= 2
            for name in ("vals", "presence", "last_ts"):
                if st[name] is not None:
                    a = st[name]
                    st[name] = jnp.zeros(cap, a.dtype).at[slots].set(a[old])
            st["table"] = new
        elif kind == "fill_clock":
            st["last_ts"] = jnp.full(cap, op[1], jnp.int64)
        outs.append(out)
        states.append(cs.row_state_by_key(
            np.asarray(st["table"]),
            {n: np.asarray(st[n]) for n in ("presence", "last_ts", "vals")
             if st[n] is not None}))
    return outs, states, st


@pytest.mark.parametrize("case", cs.ROW_EDGE_CASES)
def test_plain_programs_equal_reference_on_edge_cases(ref, case):
    for c in cs.row_edge_configs(case):
        st = cs.row_state_new(torch, torch.device("cpu"), c)
        want, want_st, ref_st = _ref_run(ref, c)
        for i, op in enumerate(c["ops"]):
            got = cs.apply_row_op(torch, st, op, c["ttl"])
            w = want[i]
            what = f"{case} op {i} ({op[0]})"
            if op[0] == "dedup":
                assert got["failed"] == w["failed"], what
                assert np.array_equal(got["fresh"], w["fresh"]), what
                if not w["failed"]:
                    assert (got["claims"], got["n_fresh"]) == \
                        (w["claims"], w["n_fresh"]), what
            else:
                assert got.keys() == w.keys(), what
                for k in got:   # values too: slot 0 of an absent key agrees
                    assert np.array_equal(got[k], w[k]), (what, k)
            assert cs.states_by_key_equal(cs.row_state_host(st),
                                          want_st[i]), what
        if not any(o[0] == "dedup" and w.get("failed")
                   for o, w in zip(c["ops"], want)):
            # one slot layout: the tables and planes equal slot by slot
            assert np.array_equal(st["table"].numpy(),
                                  np.asarray(ref_st["table"]))
            for name in ("vals", "presence", "last_ts"):
                if st[name] is not None:
                    assert np.array_equal(st[name].numpy(),
                                          np.asarray(ref_st[name])), name
    if case == "overflow":
        assert any(w.get("failed") for w in want)


def _backends(ref, capacity=64, budget=0):
    r = ref.tb.TpuKeyedStateBackend(ref.Range(0, 127), 128,
                                    capacity=capacity, host_index=False)
    p = DeviceKeyedStateBackend(KeyGroupRange(0, 127), 128,
                                capacity=capacity, device="cpu")
    return r, p


def _assert_snapshots_equal(a: dict, b: dict) -> None:
    assert a["kind"] == b["kind"] == "tpu"
    assert np.array_equal(a["keys"], b["keys"])
    assert np.array_equal(a["key_groups"], b["key_groups"])
    assert a["max_parallelism"] == b["max_parallelism"]
    assert a["states"].keys() == b["states"].keys()
    for name, sa in a["states"].items():
        sb = b["states"][name]
        assert (sa["kind"], sa["dtype"], sa["ring"]) == \
            (sb["kind"], sb["dtype"], sb["ring"]), name
        assert np.array_equal(np.asarray(sa["values"]),
                              np.asarray(sb["values"])), name


def _dedup_batches(seed: int, n_batches=8, n=300, pool=2000, span=400,
                   p_retract=0.1):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        keys = rng.integers(0, pool, n).astype(np.int64)
        ts = np.sort(rng.integers(b * span, (b + 1) * span, n)).astype(
            np.int64)
        out.append((keys, ts, rng.random(n) >= p_retract))
    return out


def test_dedup_batches_grow_and_admit_as_reference(ref):
    """Keep-first batches that overflow a 64-slot table and pass 0.6
    occupancy: fresh masks, capacities after every batch and snapshots
    equal the reference's; the TTL re-admits expired keys."""
    r, p = _backends(ref)
    for b in (r, p):
        b.register_row_state("seen", np.int8, ttl_ms=700)
    caps = []
    for keys, ts, valid in _dedup_batches(3):
        fr = r.dedup_first_batch("seen", keys, ts, valid=valid)
        fp = p.dedup_first_batch("seen", keys, ts, valid=valid)
        assert np.array_equal(fr, fp)
        assert (r.capacity, r.num_keys) == (p.capacity, p.num_keys)
        caps.append(p.capacity)
    assert caps[0] > 64 and caps[-1] > caps[0]   # overflow, then 0.6 growth
    _assert_snapshots_equal(r.snapshot(1), p.snapshot(1))
    # the last batch again: only keys admitted more than the TTL ago
    keys, ts, _ = _dedup_batches(3)[-1]
    again = p.dedup_first_batch("seen", keys, ts + 1)
    assert np.array_equal(again, r.dedup_first_batch("seen", keys, ts + 1))
    assert 0 < again.sum() < len(np.unique(keys))


def test_row_plane_upsert_lookup_clear_ttl_as_reference(ref):
    r, p = _backends(ref, capacity=16)
    rng = np.random.default_rng(11)
    for b in (r, p):
        b.register_row_state("v", np.float64, ttl_ms=100)
        b.register_row_state("n", np.int32)
    for step in range(6):
        keys = rng.integers(0, 40, 30).astype(np.int64)
        vals = rng.integers(-50, 50, 30).astype(np.float64)
        now = np.sort(rng.integers(step * 60, step * 60 + 50, 30))
        probe = np.append(rng.integers(0, 50, 25), I64_MAX).astype(np.int64)
        for b in (r, p):
            b.rows_upsert("v", keys, vals, now_ms=now)
            b.rows_upsert("n", keys[::2], vals[::2].astype(np.int32),
                          now_ms=step)
            b.rows_clear("v", keys[:3])
        for name, t in (("v", step * 60 + 90), ("n", 0)):
            vr, pr = r.rows_lookup(name, probe, now_ms=t)
            vp, pp = p.rows_lookup(name, probe, now_ms=t)
            assert np.array_equal(pr, pp) and np.array_equal(vr[pr], vp[pp])
            assert vr.dtype == vp.dtype
        assert r.capacity == p.capacity
    _assert_snapshots_equal(r.snapshot(1), p.snapshot(1))


def test_snapshots_restore_across_packages_both_ways(ref):
    """The port's snapshot restores into the reference and the reference's
    into the port; each continues with the same admissions. A TTL added
    over a snapshot without a clock fills it with int64 max: no restored
    key expires."""
    batches = _dedup_batches(5, n_batches=6)
    r, p = _backends(ref)
    for b in (r, p):
        b.register_row_state("seen", np.int8, ttl_ms=500)
    for keys, ts, valid in batches[:3]:
        r.dedup_first_batch("seen", keys, ts, valid=valid)
        p.dedup_first_batch("seen", keys, ts, valid=valid)
    snap_r, snap_p = r.snapshot(1), p.snapshot(1)
    _assert_snapshots_equal(snap_r, snap_p)
    r2, p2 = _backends(ref)
    for b in (r2, p2):
        b.register_row_state("seen", np.int8, ttl_ms=500)
    r2.restore([snap_p])
    p2.restore([snap_r])
    for keys, ts, valid in batches[3:]:
        want = r.dedup_first_batch("seen", keys, ts, valid=valid)
        assert np.array_equal(want, p.dedup_first_batch("seen", keys, ts,
                                                        valid=valid))
        assert np.array_equal(want, r2.dedup_first_batch("seen", keys, ts,
                                                         valid=valid))
        assert np.array_equal(want, p2.dedup_first_batch("seen", keys, ts,
                                                         valid=valid))
    _assert_snapshots_equal(r2.snapshot(2), p2.snapshot(2))
    # a TTL over a snapshot without a clock
    r0, p0 = _backends(ref)
    for b in (r0, p0):
        b.register_row_state("seen", np.int8)
        b.dedup_first_batch("seen", np.arange(10, dtype=np.int64),
                            np.zeros(10, np.int64))
    snap = p0.snapshot(1)
    r3, p3 = _backends(ref)
    for b in (r3, p3):
        b.register_row_state("seen", np.int8, ttl_ms=100)
        b.restore([snap])
    keys = np.arange(12, dtype=np.int64)
    ts = np.full(12, 10 ** 9, np.int64)
    want = r3.dedup_first_batch("seen", keys, ts)
    assert want.tolist() == [False] * 10 + [True, True]
    assert np.array_equal(want, p3.dedup_first_batch("seen", keys, ts))
    _assert_snapshots_equal(r3.snapshot(3), p3.snapshot(3))


def test_value_state_handles_as_reference(ref, monkeypatch):
    """get_partitioned_state: a float64 handle (and an int64 one for a
    numpy integer default), update / value / clear for a few hundred keys,
    and TTL expiry under a clock the test moves."""
    clock = [1000.0]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    r, p = _backends(ref)
    rng = np.random.default_rng(2)
    hr = r.get_partitioned_state(ref.Desc("x", default=-1.0,
                                          ttl=ref.Ttl(0.5)))
    hp = p.get_partitioned_state(ValueStateDescriptor(
        "x", default=-1.0, ttl=StateTtlConfig(0.5)))
    cr = r.get_partitioned_state(ref.Desc("c", default=np.int64(0)))
    cp = p.get_partitioned_state(ValueStateDescriptor("c",
                                                      default=np.int64(0)))
    assert p.get_partitioned_state(ValueStateDescriptor("c")) is cp
    for i, key in enumerate(rng.integers(0, 200, 240).tolist()):
        clock[0] += 0.001
        for b, h, c in ((r, hr, cr), (p, hp, cp)):
            b.set_current_key(key)
            h.update(key * 0.5 + i)
            c.update(c.value() + 1)
            if i % 7 == 0:
                h.clear()
    seen = []
    for key in range(205):
        vals = []
        for b, h, c in ((r, hr, cr), (p, hp, cp)):
            b.set_current_key(key)
            vals.append((h.value(), c.value()))
        assert vals[0] == vals[1]
        assert [type(v) for v in vals[0]] == [type(v) for v in vals[1]]
        seen.append(vals[1][0] != -1.0)
    assert any(seen) and not all(seen)
    clock[0] += 1.0   # past the TTL of every write
    for b, h in ((r, hr), (p, hp)):
        b.set_current_key(5)
        assert h.value() == -1.0
    _assert_snapshots_equal(r.snapshot(1), p.snapshot(1))


def test_row_plane_refuses_a_budget_and_unknown_states():
    b = DeviceKeyedStateBackend(KeyGroupRange(0, 127), 128, capacity=64,
                                device="cpu", hbm_budget_slots=32)
    with pytest.raises(NotImplementedError, match="host tier"):
        b.register_row_state("seen", np.int8)
    b = DeviceKeyedStateBackend(KeyGroupRange(0, 127), 128, capacity=64,
                                device="cpu")
    with pytest.raises(RuntimeError, match="not registered"):
        b.dedup_first_batch("seen", np.arange(3), np.zeros(3))
    with pytest.raises(NotImplementedError, match="ValueState"):
        from flink_tpu_torch.state.descriptors import StateDescriptor
        b.get_partitioned_state(StateDescriptor("l", "list"))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_equal_plain_on_edge_cases(dev):
    for case in cs.ROW_EDGE_CASES:
        assert cs.check_row_edge(torch, dev, case)["ops"] > 0, case


@pytest.mark.cuda
def test_cuda_backend_equals_cpu_backend(dev):
    """Keep-first batches through a backend on the card and one on the
    CPU: fresh masks, capacities and snapshots equal."""
    got = cs.check_row_backend(torch, dev)
    assert got["rehashes"] >= 2
