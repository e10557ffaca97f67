"""Port parity of the session programs on adversarial inputs:
``session_step_plain`` and ``session_fire_plain``
(flink_tpu_torch/ops/session.py) against the reference's ``_sess_step``
and ``_sess_fire`` (flink_tpu/runtime/operators/device_session.py), on the
cases that chip_smoke.py and tests/test_torch_session_kernels.py hold the
kernels to on the card (``EDGE_STEP_CASES``, ``EDGE_FIRE_CASES``): a hot
key whose run crosses the kernel's blocks, every lane of a key open at 1,
4, 16 and 64 lanes, no aggregate and 8 of every dtype; fires with exactly
capacity due, capacity + 1, none, every lane, and ragged entries.

After every call the planes, mapped through each table to keys, and the
counters are equal; emitted and fired rows are equal. And a property the
step's kernel rests on (it writes a free lane without reading it): after
any seeded sequence of steps and fires, every lane that is not open holds
its planes' identities.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from flink_tpu_torch.ops.hash_table import EMPTY_KEY
from flink_tpu_torch.ops.session import session_fire_plain, \
    session_step_plain

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from flink_tpu.ops import hash_table
    from flink_tpu.runtime.operators import device_session

    hash_table.ensure_x64()
    return jnp, device_session


def _ref_state(jnp, st):
    """The reference's state from the port's (numpy through both), copied:
    ``jnp.asarray`` of a tensor's numpy view shares its memory on the CPU,
    and the reference's programs run asynchronously while the plain
    versions write the port's state in place."""
    planes = {"__start__": st["start"], "__end__": st["end"],
              "__open__": st["open"], "__count__": st["count"]}
    planes.update({f"a{q}": p for q, (_k, p) in enumerate(st["folds"])})
    return {"table": jnp.array(st["table"].numpy()),
            "planes": {k: jnp.array(v.numpy()) for k, v in planes.items()},
            "cur_lane": jnp.array(st["cur_lane"].numpy()),
            "dropped": jnp.zeros((), jnp.int64),
            "late": jnp.zeros((), jnp.int64)}


def _by_key(table, planes):
    table = np.asarray(table)
    slots = np.flatnonzero(table != EMPTY_KEY)
    return {int(table[s]): tuple(np.asarray(p)[..., s].tolist()
                                 for p in planes) for s in slots}


def _ref_views(rs, n_folds):
    p = rs["planes"]
    return rs["table"], [p["__start__"], p["__end__"], p["__open__"],
                         p["__count__"], rs["cur_lane"]] + \
        [p[f"a{q}"] for q in range(n_folds)]


def _port_views(ps):
    return ps["table"].numpy(), [ps["start"], ps["end"], ps["open"],
                                 ps["count"], ps["cur_lane"]] + \
        [p for _k, p in ps["folds"]]


def _sorted(rows):
    return sorted(map(tuple, rows.tolist()))


def _fire_both(ref_fire, rs, ps, outs, gap, boundary, n_folds, exact):
    """Fire rounds until none overflows; rows and planes equal after
    each. Returns the rounds."""
    rounds = 0
    while True:
        new, okeys, ostart, oend, oo, fired, overflow = ref_fire(
            rs["table"], rs["planes"], np.int64(boundary))
        rs["planes"] = new
        got = session_fire_plain(ps["table"], ps["start"], ps["end"],
                                 ps["open"], ps["count"], ps["folds"],
                                 outs(ps), gap, boundary, ps["dirty"],
                                 cs.DIRTY_SHIFT)
        rounds += 1
        f, o = int(fired), int(overflow)
        assert got.counts.tolist() == [f, o]
        want = np.stack([np.asarray(c)[:f].astype(np.float64) for c in
                         [okeys, ostart, oend] + [oo[f"o{q}"] for q in
                                                  range(len(oo))]], 1)
        mine = np.stack([c[:f].double().numpy() for c in
                         [got.key, got.start, got.end, *got.values]], 1)
        if exact:
            np.testing.assert_array_equal(mine, want)
        else:
            assert _sorted(mine) == _sorted(want)
        assert _by_key(*_ref_views(rs, n_folds)) == \
            _by_key(*_port_views(ps))
        cs.assert_free_lanes_hold_identities(torch, ps, "fire")
        if o == 0:
            return rounds


@pytest.mark.parametrize("case", cs.EDGE_STEP_CASES)
def test_step_plain_equals_reference_on_edge_cases(ref, case):
    jnp, ds = ref
    c = cs.session_edge_steps(case)
    gap, L, q = cs.EDGE_GAP, c["lanes"], len(c["folds"])
    ps = cs.edge_state(torch, CPU, c)
    rs = _ref_state(jnp, ps)
    rs["dirty"] = jnp.zeros(c["cap"] >> cs.DIRTY_SHIFT, bool)
    step = ds._sess_step(tuple((kind, f"a{j}", f"v{j}")
                               for j, (kind, _d) in enumerate(c["folds"])),
                         L, gap, 1 << cs.DIRTY_SHIFT)
    agg_sig = (("count", "o0", "__count__"),) + tuple(
        (kind, f"o{j + 1}", f"a{j}") for j, (kind, _d) in
        enumerate(c["folds"]))
    fire = ds._sess_fire(agg_sig, L, gap)

    def outs(s):
        return [("count", s["count"])] + [(k, p) for k, p in s["folds"]]

    fb = cs.MIN_TIMESTAMP
    for keys, ts, vals, boundary in c["batches"]:
        (rs["table"], rs["planes"], rs["cur_lane"], rs["dropped"],
         rs["late"], rs["dirty"], n_emit, ekey, estart, eend, ecount,
         _evals) = step(rs["table"], rs["planes"], rs["cur_lane"],
                        rs["dropped"], rs["late"], rs["dirty"],
                        jnp.asarray(keys), jnp.asarray(ts),
                        {f"v{j}": jnp.asarray(v) for j, v in enumerate(vals)},
                        np.int64(len(keys)), np.int64(fb))
        b = cs.edge_batch_on(torch, CPU, (keys, ts, vals, boundary))
        got = cs.step_on(session_step_plain, ps, b, gap, fb)
        assert _by_key(*_ref_views(rs, q)) == _by_key(*_port_views(ps))
        assert int(rs["dropped"]) == int(ps["dropped"])
        assert int(rs["late"]) == int(ps["late"])
        g = int(n_emit)
        assert int(got.n) == g
        assert sorted(zip(*[np.asarray(x)[:g].tolist() for x in
                            (ekey, estart, eend, ecount)])) == \
            sorted(zip(*[x[:g].tolist() for x in
                         (got.key, got.start, got.end, got.count)]))
        cs.assert_free_lanes_hold_identities(torch, ps, f"{case} step")
        _fire_both(fire, rs, ps, outs, gap, boundary, q, exact=False)
        fb = boundary
    assert int(ps["late"]) > 0
    if case.startswith("lanes_"):
        assert int(ps["dropped"]) > 0


@pytest.mark.parametrize("case", cs.EDGE_FIRE_CASES)
def test_fire_plain_equals_reference_on_edge_cases(ref, case):
    jnp, ds = ref
    c = cs.session_edge_fire(case)
    ps = cs.edge_fire_state(torch, CPU, c)
    rs = _ref_state(jnp, ps)
    agg_sig = (("count", "o0", "__count__"), ("sum", "o1", "a0"),
               ("min", "o2", "a1"), ("max", "o3", "a2"),
               ("avg", "o4", "a3"))
    fire = ds._sess_fire(agg_sig, c["lanes"], cs.EDGE_GAP)
    rounds = _fire_both(fire, rs, ps, cs.edge_fire_outs, cs.EDGE_GAP,
                        c["boundary"], 4, exact=True)
    assert rounds == max(1, -(-c["due"] // c["cap"]))
    assert int((ps["open"] > 0).sum()) == \
        int((torch.from_numpy(c["open"]) > 0).sum()) - c["due"]


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 1 << 30))
def test_free_lanes_hold_identities_after_any_steps_and_fires(seed):
    """Seeded sequences of steps (disorder, late rows, lanes running out)
    and fires (the buffer overflowing) on the plain versions, with every
    fold kind in every dtype: after each call every lane that is not open
    holds its planes' identities and every empty slot is untouched."""
    rng = np.random.default_rng(seed)
    lanes = int(rng.choice([1, 2, 4, 8]))
    folds = tuple((kind, d) for kind in ("sum", "min", "max")
                  for d in ("int64", "int32", "float32", "float64")
                  if rng.random() < 0.5)[:8]
    c = {"cap": 1 << 7, "lanes": lanes, "folds": folds}
    state = cs.edge_state(torch, CPU, c)
    gap, fb, t0 = int(rng.integers(5, 60)), cs.MIN_TIMESTAMP, 0
    for _ in range(int(rng.integers(2, 7))):
        n = int(rng.integers(1, 300))
        keys = rng.integers(0, int(rng.integers(1, 90)), n)
        ts = t0 + rng.integers(-3 * gap, 200, n)
        vals = [rng.integers(-50, 50, n).astype(d) for _k, d in folds]
        boundary = t0 + int(rng.integers(-50, 250))
        b = cs.edge_batch_on(torch, CPU, cs._edge_batch(keys, ts, vals,
                                                        boundary))
        cs.step_on(session_step_plain, state, b, gap, fb)
        cs.assert_free_lanes_hold_identities(torch, state, "step")
        fb = max(fb, boundary)
        while True:
            got = session_fire_plain(
                state["table"], state["start"], state["end"], state["open"],
                state["count"], state["folds"], [("count", state["count"])],
                gap, fb, state["dirty"], cs.DIRTY_SHIFT)
            cs.assert_free_lanes_hold_identities(torch, state, "fire")
            if int(got.counts[1]) == 0:
                break
        t0 += 150
