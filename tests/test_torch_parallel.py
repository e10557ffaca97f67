"""Port parity: the multi-device window path's building blocks
(flink_tpu_torch/parallel/, ops/exchange.py) against flink_tpu.parallel on
the 8 virtual CPU devices of tests/conftest.py.

Inputs are made from numpy seeds. The port runs its plain versions here
(the exchange's stable argsort and scatter, the ingest step's probe rounds
and scatter folds). Comparisons follow ROADMAP's parity rules:

* routing is bit-exact (key groups, destinations, shard ranges);
* the exchange forms compare as multisets of routed rows per destination
  (the kernel's order within a bucket is its atomics', so order is not
  part of the contract);
* sharded state compares by key per shard, never by slot (a claim order
  lays slots out differently);
* top-k fires compare under the tie rule;
* float sums use exactly representable values (integers in float64), so
  every comparison is ``==``: the tolerance is 0, by construction.

The reference's overflow test depends on which keys claimed first; the
port is held to what claim order cannot change: folded + dropped = the
valid rows, and a key is either resident with all its rows or dropped.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from flink_tpu import parallel as ref  # noqa: E402
from flink_tpu.core.keygroups import (  # noqa: E402
    KeyGroupRange as RefRange, hash_batch, key_groups_for_hash_batch,
    operator_index_for_key_group)
from flink_tpu.ops.hash_table import ensure_x64  # noqa: E402
from flink_tpu.parallel.plan import shard_map_compat  # noqa: E402
from flink_tpu_torch import parallel as port  # noqa: E402
from flink_tpu_torch.core.config import Configuration  # noqa: E402
from flink_tpu_torch.core.keygroups import KeyGroupRange  # noqa: E402
from flink_tpu_torch.ops.exchange import (  # noqa: E402
    ExchangeBuffers, exchange_bucket)
from flink_tpu_torch.ops.hash_table import EMPTY_KEY  # noqa: E402

ensure_x64()
MP = 128
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _reset_mesh_runtime():
    yield
    ref.MESH_RUNTIME.reset()
    port.MESH_RUNTIME.reset()


def _keys(rng, n):
    """Negative, positive, huge and the sentinel keys."""
    return np.concatenate([
        np.array([0, 1, -1, EMPTY_KEY, EMPTY_KEY - 1, -(1 << 63)],
                 np.int64),
        rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)])


def test_key_groups_and_routing_match_reference():
    rng = np.random.default_rng(0)
    keys = _keys(rng, 2000)
    want = key_groups_for_hash_batch(hash_batch(keys), MP)
    got = port.key_groups_device(torch.from_numpy(keys), MP).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(ref.key_groups_device(jnp.asarray(keys), MP)))
    np.testing.assert_array_equal(
        port.murmur_mix_device(port.hash_int64_device(
            torch.from_numpy(keys))).numpy(),
        np.asarray(ref.murmur_mix_device(ref.hash_int64_device(
            jnp.asarray(keys)))))
    kg = np.arange(-3, MP + 3, dtype=np.int32)
    for n, start, length in ((8, 0, None), (3, 0, None), (5, 40, 50)):
        got = port.device_index_for_key_groups(
            torch.from_numpy(kg), n, MP, start, length).numpy()
        want = np.asarray(ref.device_index_for_key_groups(
            jnp.asarray(kg), n, MP, start, length))
        np.testing.assert_array_equal(got, want)
    host = [operator_index_for_key_group(MP, 8, g) for g in range(MP)]
    np.testing.assert_array_equal(port.device_index_for_key_groups(
        torch.arange(MP), 8, MP).numpy(), host)


def test_shard_ranges_match_reference():
    for maxp in (7, 100, 128, 4096):
        for n in (1, 2, 3, 8):
            if n > maxp:
                continue
            got = port.shard_ranges(maxp, n)
            assert [(r.start, r.end) for r in got] == [
                (r.start, r.end) for r in ref.shard_ranges(maxp, n)]
            assert got[0].start == 0 and got[-1].end == maxp - 1
            assert all(b.start == a.end + 1 for a, b in zip(got, got[1:]))
            for base in ((0, 63), (64, 127), (10, 20)):
                pb = port.shard_ranges(maxp, n, KeyGroupRange(*base))
                rb = ref.shard_ranges(maxp, n, RefRange(*base))
                assert [(r.start, r.end) for r in pb] == [
                    (r.start, r.end) for r in rb]
    with pytest.raises(ValueError, match="max-parallelism"):
        port.shard_ranges(4, 8)
    with pytest.raises(ValueError, match="max-parallelism"):
        port.shard_ranges(128, 8, KeyGroupRange(0, 3))
    with pytest.raises(ValueError, match="mesh size"):
        port.ShardedWindowAgg(port.make_mesh(8, device="cpu"),
                              [port.AggDef("v", "sum")], capacity=64,
                              ring=2, max_parallelism=4)


def test_mesh_plan_and_runtime_match_reference():
    assert port.make_mesh(4, device="cpu") == [CPU] * 4
    assert port.make_mesh(devices=["cpu", "cpu"]) == [CPU, CPU]
    with pytest.raises(ValueError, match="need 3 devices"):
        port.make_mesh(3, devices=["cpu"])
    assert port.DECLARED_AXES == ref.DECLARED_AXES
    for text in ("", "accs/.*=data;.*=*", "table=data; keys = replicated"):
        assert [tuple(r) for r in port.parse_axis_rules(text)] == [
            tuple(r) for r in ref.parse_axis_rules(text)]
    for bad, match in (("nope", "regex=axis"), ("t=model", "undeclared")):
        with pytest.raises(ValueError, match=match):
            port.parse_axis_rules(bad)
        with pytest.raises(ValueError, match=match):
            ref.parse_axis_rules(bad)
    port.MESH_RUNTIME.configure(Configuration({
        "mesh.rescale.enabled": False, "mesh.rescale.timeout": "2 s"}))
    assert not port.MESH_RUNTIME.rescale_enabled
    assert port.MESH_RUNTIME.rescale_timeout_ms == 2000
    # the port's layout is fixed: a rule set is refused, never ignored,
    # and a malformed one fails with the reference's parser error
    for text, match in (("table=data", "PartitionSpec"),
                        ("accs/.*=*", "PartitionSpec"),
                        ("t=model", "undeclared")):
        with pytest.raises(ValueError, match=match):
            port.MESH_RUNTIME.configure(Configuration({
                "mesh.axis-rules": text}))


def _routed_rows(keys, vals, ok, D, start=0, length=MP):
    """Per destination, the sorted (sanitised key, value) rows the
    reference's routing sends there."""
    kg = key_groups_for_hash_batch(hash_batch(keys), MP).astype(np.int64)
    rel = kg - start
    ok = ok & (rel >= 0) & (rel < length)
    dest = rel * D // length
    skeys = np.where(keys == EMPTY_KEY, EMPTY_KEY - 1, keys)
    return [sorted(zip(skeys[ok & (dest == d)].tolist(),
                       vals[ok & (dest == d)].tolist())) for d in range(D)]


def _bucket(keys, ts, vals, D, n_valid=None, valid=None, start=0,
            length=MP, pane=1, offset=0):
    S, B = keys.shape
    out = ExchangeBuffers.allocate(D, S, B, [torch.int32], CPU)
    exchange_bucket(torch.from_numpy(keys), torch.from_numpy(ts),
                    [torch.from_numpy(vals)], out, n_valid=n_valid,
                    valid=None if valid is None else torch.from_numpy(valid),
                    pane=pane, offset=offset, n_dest=D, max_parallelism=MP,
                    base_start=start, base_len=length)
    return out


def test_exchange_bucket_layout_and_edge_cases():
    """The plain version's layout: segment s of destination d holds, at
    its front, the rows of block s its key groups send to d, with their
    panes; counts[s, d] rows. Edge cases: every key to one shard, an empty
    block, EMPTY_KEY and negative keys, a base_range subset, a mask."""
    rng = np.random.default_rng(3)
    D, S, B = 4, 3, 40
    hot = np.full(S * B, 12345, np.int64)
    cases = {
        "random": (_keys(rng, S * B - 6), None, None, 0, MP),
        "one_shard": (hot, None, None, 0, MP),
        "empty": (_keys(rng, S * B - 6), 0, None, 0, MP),
        "ragged": (_keys(rng, S * B - 6), 77, None, 0, MP),
        "masked": (_keys(rng, S * B - 6), None, rng.random(S * B) < 0.5,
                   0, MP),
        "base_subset": (_keys(rng, S * B - 6), None, None, 32, 64),
    }
    for name, (flat, n_valid, mask, start, length) in cases.items():
        keys = flat.reshape(S, B)
        ts = rng.integers(-5000, 5000, (S, B)).astype(np.int64)
        vals = rng.integers(-9, 9, (S, B)).astype(np.int32)
        valid = None if mask is None else mask.reshape(S, B)
        out = _bucket(keys, ts, vals, D, n_valid, valid, start, length,
                      pane=1000, offset=7)
        ok = np.arange(S * B) < (S * B if n_valid is None else n_valid)
        if valid is not None:
            ok &= valid.reshape(-1)
        counts = out.counts.numpy()
        for s in range(S):
            rows = slice(s * B, (s + 1) * B)
            want = _routed_rows(keys[s], vals[s], ok[rows], D, start,
                                length)
            wpanes = _routed_rows(keys[s], np.floor_divide(
                ts[s] - 7, 1000), ok[rows], D, start, length)
            for d in range(D):
                c = counts[s, d]
                seg = slice(s * B, s * B + c)
                got = sorted(zip(out.keys[d][seg].tolist(),
                                 out.cols[0][d][seg].tolist()))
                assert got == want[d], (name, s, d)
                assert sorted(zip(out.keys[d][seg].tolist(),
                                  out.panes[d][seg].tolist())) == wpanes[d]
        if name == "one_shard":
            assert (counts > 0).sum() == S
        if name == "empty":
            assert counts.sum() == 0


def _ref_exchange(D, dest, keys, valid, cap=None):
    """The reference's exchange forms inside shard_map: per destination
    the routed valid keys (and the round count of the bounded form)."""
    mesh = ref.make_mesh(D)
    B = keys.shape[1]

    def body(dest, keys, valid):
        d, k, v = dest[0], keys[0], valid[0]
        if cap is None:
            routed, rvalid = ref.keyby_exchange("data", D, d, {"k": k}, v)
            return (jnp.where(rvalid, routed["k"], -1)[None],
                    jnp.ones(1, jnp.int32))
        plan = ref.plan_exchange(d, v, D, cap)
        ordered = {"k": k[plan.order]}
        n_rounds = jax.lax.pmax(plan.n_rounds, "data")
        out = jnp.full((D * B + D * cap,), -1, jnp.int64)

        def rnd(carry):
            r, out = carry
            routed, rvalid = ref.exchange_round("data", D, cap, plan,
                                                ordered, r)
            got = jnp.where(rvalid, routed["k"], -1)
            return r + 1, jax.lax.dynamic_update_slice(out, got,
                                                       (r * D * cap,))

        _, out = jax.lax.while_loop(lambda c: c[0] < n_rounds, rnd,
                                    (jnp.int32(0), out))
        return out[None], n_rounds[None].astype(jnp.int32)

    fn = shard_map_compat(body, mesh, in_specs=(P("data"),) * 3,
                          out_specs=(P("data"), P("data")))
    got, rounds = jax.jit(fn)(jnp.asarray(dest), jnp.asarray(keys),
                              jnp.asarray(valid))
    got = np.asarray(got)
    return ([sorted(g[g >= 0].tolist()) for g in got],
            int(np.asarray(rounds).max()))


def test_exchange_forms_are_permutations_of_valid_rows():
    """Both forms, D in {1, 2, 3, 8}, seeded: each destination receives
    exactly the valid rows its key groups own, as the reference's forms
    deliver them; nothing is lost or duplicated."""
    for D in (1, 2, 3, 8):
        for seed in (0, 1):
            rng = np.random.default_rng(100 * D + seed)
            B = 64
            keys = rng.integers(0, 1 << 40, (D, B)).astype(np.int64)
            valid = rng.random((D, B)) < 0.8
            kg = key_groups_for_hash_batch(hash_batch(keys.reshape(-1)), MP)
            dest = (kg.astype(np.int64) * D // MP).astype(np.int32).reshape(
                D, B)
            cap = ref.bucket_capacity(B, D)
            assert port.bucket_capacity(B, D) == cap
            for bounded in (False, True):
                want, want_rounds = _ref_exchange(
                    D, dest, keys, valid, cap if bounded else None)
                tk, tv = torch.from_numpy(keys), torch.from_numpy(valid)
                if not bounded:
                    routed, masks = port.keyby_exchange(tk, {}, tv, D, MP)
                    got = [sorted(r["__key__"][m].tolist())
                           for r, m in zip(routed, masks)]
                else:
                    plan = port.plan_exchange(tk, {}, tv, D, cap, MP)
                    got = [[] for _ in range(D)]
                    for r in range(int(plan.n_rounds)):
                        routed, masks = port.exchange_round(plan, r)
                        for d in range(D):
                            got[d] += routed[d]["__key__"][masks[d]].tolist()
                    got = [sorted(g) for g in got]
                    assert int(plan.n_rounds) <= want_rounds
                assert got == want, (D, seed, bounded)
                assert sum(map(len, got)) == int(valid.sum())


def test_bounded_exchange_skew_takes_extra_rounds_losslessly():
    D, B, cap = 4, 96, 16
    keys = np.full((D, B), 7, np.int64)   # every row to one shard
    plan = port.plan_exchange(torch.from_numpy(keys),
                              {"v": torch.arange(D * B).view(D, B)},
                              None, D, cap, MP)
    assert int(plan.n_rounds) == -(-B // cap)
    seen = []
    for r in range(int(plan.n_rounds)):
        routed, masks = port.exchange_round(plan, r)
        for d in range(D):
            seen += routed[d]["v"][masks[d]].tolist()
    assert sorted(seen) == list(range(D * B))
    for B_ in (32, 256, 4096):
        for D_ in (1, 2, 8, 64):
            assert port.bucket_capacity(B_, D_) == ref.bucket_capacity(B_, D_)


def _ref_agg(aggs, cap=1 << 12, ring=8, base=None):
    return ref.ShardedWindowAgg(
        ref.make_mesh(8), [ref.AggDef(n, k, jnp.dtype(dt))
                           for n, k, dt in aggs],
        capacity=cap, ring=ring, max_parallelism=MP,
        base_range=None if base is None else RefRange(*base))


def _port_agg(aggs, cap=1 << 12, ring=8, base=None):
    return port.ShardedWindowAgg(
        port.make_mesh(8, device="cpu"),
        [port.AggDef(n, k, getattr(torch, dt)) for n, k, dt in aggs],
        capacity=cap, ring=ring, max_parallelism=MP,
        base_range=None if base is None else KeyGroupRange(*base))


def _by_key_ref(table, planes, emit=None):
    """[{key: values}] per shard of the reference's [D, ...] arrays."""
    table = np.asarray(table)
    out = []
    for d in range(table.shape[0]):
        sel = table[d] != EMPTY_KEY
        if emit is not None:
            sel &= np.asarray(emit)[d]
        out.append({int(k): tuple(np.asarray(p)[d][..., i].tolist()
                                  for p in planes)
                    for i, k in zip(np.flatnonzero(sel), table[d][sel])})
    return out


def _by_key_port(tables, planes, emit=None):
    out = []
    for d, t in enumerate(tables):
        t = t.numpy()
        sel = t != EMPTY_KEY
        if emit is not None:
            sel &= emit[d].numpy()
        out.append({int(k): tuple(p[d].numpy()[..., i].tolist()
                                  for p in planes)
                    for i, k in zip(np.flatnonzero(sel), t[sel])})
    return out


def _step_both(ra, pa, rng, steps=5, B=64, n_keys=1000, base=None):
    rs, ps = ra.init_state(), pa.init_state()
    for _ in range(steps):
        keys = rng.integers(-n_keys, n_keys, (8, B)).astype(np.int64)
        vals = rng.integers(0, 100, (8, B)).astype(np.float64)
        panes = rng.integers(0, 4, (8, B)).astype(np.int64)
        valid = rng.random((8, B)) < 0.9
        rs, rp = ra.step(rs, jnp.asarray(keys), {"price": jnp.asarray(vals)},
                         jnp.asarray(panes), jnp.asarray(valid))
        ps, pp = pa.step(ps, keys, {"price": vals}, panes, valid)
        assert int(pp) == int(rp)
    return rs, ps


def test_sharded_step_matches_reference_by_key():
    """Five steps of [8, 64] rows: processed per step, dropped, and every
    shard's keys and [ring] pane rows equal key by key; with a base_range
    subset (the two-level split) rows outside it vanish in both."""
    aggs = [("price", "sum", "float64")]
    for base in (None, (32, 95)):
        ra, pa = _ref_agg(aggs, base=base), _port_agg(aggs, base=base)
        rs, ps = _step_both(ra, pa, np.random.default_rng(42), base=base)
        assert int(np.asarray(rs.dropped).sum()) == 0
        assert sum(int(t) for t in ps.dropped) == 0
        want = _by_key_ref(rs.table, [rs.accs["price"],
                                      rs.accs["__count__"]])
        got = _by_key_port(ps.table, [ps.accs["price"],
                                      ps.accs["__count__"]])
        assert got == want
        for d, rng_ in enumerate(pa.shard_ranges):
            keys = np.array(list(got[d]), np.int64)
            groups = key_groups_for_hash_batch(hash_batch(keys), MP)
            assert ((groups >= rng_.start) & (groups <= rng_.end)).all()


def test_fire_merges_panes_and_retire_match_reference():
    aggs = [("price", "sum", "float64")]
    ra, pa = _ref_agg(aggs), _port_agg(aggs)
    rs, ps = _step_both(ra, pa, np.random.default_rng(5), steps=4)
    for rows in ([0], [1, 2], [3, 0, 1]):
        ro, re_ = ra.fire(rs, np.array(rows, np.int32))
        po, pe = pa.fire(ps, np.array(rows))
        assert _by_key_port(ps.table, [po["price"], po["__count__"]], pe) \
            == _by_key_ref(rs.table, [ro["price"], ro["__count__"]], re_)
    rs = ra.retire_row(rs, 1)
    ps = pa.retire_row(ps, 1)
    ro, re_ = ra.fire(rs, np.array([0, 1], np.int32))
    po, pe = pa.fire(ps, np.array([0, 1]))
    assert _by_key_port(ps.table, [po["price"], po["__count__"]], pe) \
        == _by_key_ref(rs.table, [ro["price"], ro["__count__"]], re_)


def test_overflow_folded_plus_dropped_is_the_valid_rows():
    """capacity 8 a shard against 512 distinct keys: what claim order
    cannot change. folded + dropped = valid rows; every resident key holds
    all of its rows (a key is resident or dropped, never both)."""
    for seed in (1, 2):
        agg = port.ShardedWindowAgg(
            port.make_mesh(8, device="cpu"),
            [port.AggDef("v", "sum", torch.float64)], capacity=8, ring=2,
            max_parallelism=MP)
        rng = np.random.default_rng(seed)
        keys = rng.integers(0, 10**9, (8, 64)).astype(np.int64)
        keys[:, 32:] = keys[:, :32]          # every key twice
        valid = np.ones((8, 64), bool)
        state, processed = agg.step(agg.init_state(), keys,
                                    {"v": np.ones((8, 64))},
                                    np.zeros((8, 64), np.int64), valid)
        dropped = sum(int(t) for t in state.dropped)
        assert dropped > 0
        assert int(processed) + dropped == valid.sum()
        occ = np.unique(keys, return_counts=True)
        n_of = dict(zip(occ[0].tolist(), occ[1].tolist()))
        folded = 0
        for d in range(8):
            t = state.table[d].numpy()
            cnt = state.accs["__count__"][d][0].numpy()
            for s in np.flatnonzero(t != EMPTY_KEY):
                assert cnt[s] == n_of[int(t[s])]
                folded += cnt[s]
        assert folded == int(processed)


def test_global_topk_matches_reference():
    v = np.arange(64, dtype=np.float32).reshape(8, 8)
    m = np.ones((8, 8), bool)
    m[7, 7] = False
    pv, pi, po = port.global_topk(torch.from_numpy(v), torch.from_numpy(m),
                                  3)
    rv, ri, ro = ref.global_topk(jnp.asarray(v), jnp.asarray(m), 3)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    assert po.numpy().all() and np.asarray(ro).all()
    v2 = np.arange(16, dtype=np.int64).reshape(4, 4)
    m2 = np.zeros((4, 4), bool)
    m2[1, 2] = m2[2, 3] = True
    _pv, pi, po = port.global_topk(torch.from_numpy(v2),
                                   torch.from_numpy(m2), 5)
    assert sorted(pi.numpy()[po.numpy()].tolist()) == [6, 11]
    # ties across shards: values equal, indices above the k-th value
    # equal, at it from its tie class
    rng = np.random.default_rng(9)
    for k in (1, 5, 40):
        v3 = rng.integers(0, 6, (8, 32)).astype(np.int64)
        m3 = rng.random((8, 32)) < 0.7
        pv, pi, po = port.global_topk(torch.from_numpy(v3),
                                      torch.from_numpy(m3), k, 8)
        rv, ri, ro = ref.global_topk(jnp.asarray(v3), jnp.asarray(m3), k)
        rv, ri, ro = map(np.asarray, (rv, ri, ro))
        np.testing.assert_array_equal(pv.numpy()[po.numpy()], rv[ro])
        kth = rv[ro][-1]
        flat = v3.reshape(-1)
        assert set(pi.numpy()[po.numpy()][pv.numpy()[po.numpy()] > kth]
                   .tolist()) == set(ri[ro][rv[ro] > kth].tolist())
        tie = set(np.flatnonzero((flat == kth) & m3.reshape(-1)).tolist())
        assert set(pi.numpy()[po.numpy()][pv.numpy()[po.numpy()] == kth]
                   .tolist()) <= tie


def _topk_rows_equal(port_out, ref_out, rank):
    """(keys, ok, results) of a top-k fire under the tie rule."""
    pk, po, pres = port_out[0].numpy(), port_out[1].numpy(), port_out[2]
    rk, ro, rres = (np.asarray(ref_out[0]), np.asarray(ref_out[1]),
                    ref_out[2])
    pk, rk = pk[po], rk[ro]
    pv, rv = pres[rank].numpy()[po], np.asarray(rres[rank])[ro]
    np.testing.assert_array_equal(pv, rv)
    kth = rv[-1]
    assert set(pk[pv > kth].tolist()) == set(rk[rv > kth].tolist())
    by_key_r = {int(k): tuple(np.asarray(rres[n])[ro][i] for n in rres)
                for i, k in enumerate(rk)}
    for i, k in enumerate(pk):
        if int(k) in by_key_r:
            assert tuple(pres[n].numpy()[po][i] for n in rres) == \
                by_key_r[int(k)]
    return len(pk)


def test_fire_compact_and_topk_match_reference():
    aggs = [("price", "sum", "float64")]
    ra, pa = _ref_agg(aggs), _port_agg(aggs)
    rs, ps = _step_both(ra, pa, np.random.default_rng(11), steps=6,
                        n_keys=60)
    rows = np.array([0, 1, 2], np.int32)
    valid = np.array([True, True, False])
    for rank, k in (("__count__", 7), ("price", 20), ("__count__", 500)):
        ro = ra.fire_compact(rs, rows, valid, rank, k)
        po = pa.fire_compact(ps, rows, valid, rank, k)
        assert int(po[3]) == int(ro[3]) and int(po[4]) == int(ro[4])
        assert _topk_rows_equal(po, ro, rank) == int(np.asarray(ro[1]).sum())
    table, emit, out, dropped, occ = pa.fire_compact(ps, rows, valid, None,
                                                     None)
    rt, re_, rout, _d, rocc = ra.fire_compact(rs, rows, valid, None, None)
    assert int(occ) == int(rocc)
    assert _by_key_port(table, [out["price"], out["__count__"]], emit) == \
        _by_key_ref(rt, [rout["price"], rout["__count__"]], re_)


def test_incremental_programs_match_reference():
    """seal_inc / rebuild_inc / fire_inc against the reference's programs
    (sum, count and a min/max tree), views compared key by key."""
    aggs = [("price", "sum", "float64"), ("lo", "min", "float64"),
            ("hi", "max", "float64")]
    ra, pa = _ref_agg(aggs), _port_agg(aggs)
    rng = np.random.default_rng(13)
    rs, ps = ra.init_state(), pa.init_state()
    for _ in range(4):
        keys = rng.integers(0, 300, (8, 32)).astype(np.int64)
        vals = rng.integers(-50, 50, (8, 32)).astype(np.float64)
        panes = rng.integers(0, 5, (8, 32)).astype(np.int64)
        cols = {"price": vals, "lo": vals, "hi": vals}
        rs, _ = ra.step(rs, jnp.asarray(keys),
                        {n: jnp.asarray(v) for n, v in cols.items()},
                        jnp.asarray(panes), jnp.ones((8, 32), bool))
        ps, _ = pa.step(ps, keys, cols, panes, np.ones((8, 32), bool))
    names = ["price", "__count__", "lo", "hi"]
    ring, L = ra.ring, ra.tree_size
    rows = np.zeros(ring, np.int32)
    rows[:3] = [1, 2, 3]
    rvalid = np.zeros(ring, bool)
    rvalid[:3] = True
    leaves = np.full(ring, L, np.int32)
    leaves[:3] = [1, 2, 3]
    rview, rw, rt = ra.rebuild_inc(rs, rows, rvalid, leaves, 0, True)
    pview, pw, pt = pa.rebuild_inc(ps, rows, rvalid, leaves, 0, True)
    assert _by_key_port(ps.table, [pview[n] for n in names]) == \
        _by_key_ref(rs.table, [rview[n] for n in names])
    rview, rw, rt = ra.seal_inc(rs, rw, rt, 4, 1, True, 4, 1)
    pview, pw, pt = pa.seal_inc(ps, pw, pt, 4, 1, True, 4, 1)
    assert _by_key_port(ps.table, [pview[n] for n in names]) == \
        _by_key_ref(rs.table, [rview[n] for n in names])
    ro = ra.fire_inc(rs, rview, "price", 9)
    po = pa.fire_inc(ps, pview, "price", 9)
    _topk_rows_equal(po, ro, "price")


def test_rescale_pages_match_reference():
    from flink_tpu.parallel import rescale as rr
    from flink_tpu_torch.parallel import rescale as pr
    aggs = [("price", "sum", "float64")]
    pa = _port_agg(aggs)
    _rs, ps = _step_both(_ref_agg(aggs), pa, np.random.default_rng(21),
                         steps=3)
    snap = pa.snapshot(ps)
    old = port.shard_ranges(MP, 8)
    new = port.shard_ranges(MP, 4)
    pp = pr.plan_migration(snap, old, new)
    rp = rr.plan_migration(snap, [RefRange(r.start, r.end) for r in old],
                           [RefRange(r.start, r.end) for r in new])
    assert [p.digest for p in pp.pages] == [p.digest for p in rp.pages]
    assert (pp.moved_pages, pp.keygroups_migrated, pp.bytes_moved) == \
        (rp.moved_pages, rp.keygroups_migrated, rp.bytes_moved)
    back = pr.reassemble_pages(pp.pages, snap)
    np.testing.assert_array_equal(back["keys"], snap["keys"])
    bad = pp.pages[0].__class__(**{**pp.pages[0].__dict__,
                                   "digest": "0" * 32})
    with pytest.raises(RuntimeError, match="digest"):
        pr.reassemble_pages((bad,) + pp.pages[1:], snap)
