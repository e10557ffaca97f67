"""Port parity of the device GROUP BY (``sql/device_group_agg.py`` and the
plain version of its step, ``ops/group_agg.py::group_agg_step_plain``)
with the reference's ``_gagg_program`` and ``DeviceGroupAggOperator`` on
the CPU.

* The plain step against the reference program on chip_smoke.py's
  adversarial batches (``GAGG_EDGE_CASES``: one key, drains within and
  across batches, +-inf, -0.0 and NaN, invalid rows beside slot 0, ragged
  and empty batches, 32 planes, composite keys) and on random batches:
  group count, row indices, PREV and NEW rows and every plane bit for bit
  (NaN where NaN). The port marks only the dirty blocks it writes; the
  reference also marks block 0 for invalid rows.
* The operator against the reference operator fed the same seeded numpy
  batches: insert, UPDATE_BEFORE and DELETE rows, drain and re-insert, MIN
  and MAX under retraction, composite keys, COUNT(col) as COUNT(*), growth
  by rehash. The full changelog (rows, kinds, order) must be equal, the
  snapshots equal field by field, and a snapshot of either restores into
  the other with equal changelogs after it. A float key is refused by
  both.

Values are integers or specials, so every sum is exact in any order:
tolerance exact.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from flink_tpu.core.records import RecordBatch as RefBatch  # noqa: E402
from flink_tpu.core.records import Schema as RefSchema  # noqa: E402
from flink_tpu.ops.hash_table import ensure_x64  # noqa: E402
from flink_tpu.runtime.harness import \
    OneInputOperatorTestHarness as RefHarness  # noqa: E402
from flink_tpu.sql.device_group_agg import \
    DeviceGroupAggOperator as RefOp  # noqa: E402
from flink_tpu.sql.device_group_agg import _gagg_program  # noqa: E402
from flink_tpu.sql.device_group_agg import \
    combine_key_columns as ref_combine  # noqa: E402
from flink_tpu.sql.group_agg import SqlAggSpec as RefSpec  # noqa: E402
from flink_tpu_torch.core.records import RecordBatch, Schema  # noqa: E402
from flink_tpu_torch.ops.group_agg import NO_ROW, group_agg_step_plain  # noqa: E402
from flink_tpu_torch.runtime.harness import \
    OneInputOperatorTestHarness  # noqa: E402
from flink_tpu_torch.sql.device_group_agg import (  # noqa: E402
    DeviceGroupAggOperator, combine_key_columns,
)
from flink_tpu_torch.sql.group_agg import SqlAggSpec  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

CPU = torch.device("cpu")
KIND = "__rowkind__"


# -- the step against _gagg_program ---------------------------------------
def _ref_run(c: dict, batches: list) -> list:
    """The reference program over the batches (with the port's slots);
    returns per batch (groups, row_idx, prev, new, planes, dirty)."""
    ensure_x64()
    names = [f"p{q}" for q in range(len(c["kinds"]))]
    names[0] = "__rc__"
    fold_sig = tuple((n, k, col) for n, k, col in
                     zip(names[1:], c["kinds"][1:], c["cols"][1:]))
    ident = {"sum": 0.0, "min": np.finfo(np.float64).max,
             "max": np.finfo(np.float64).min}
    planes = {n: jnp.full(c["cap"], ident[k], jnp.float64)
              for n, k in zip(names, c["kinds"])}
    dirty = jnp.zeros(c["cap"] // 8, bool)
    out = []
    for b in batches:
        n_cols = max(1, b["vals"].shape[0])
        vals = tuple(jnp.asarray(b["vals"][j]) if j < b["vals"].shape[0]
                     else jnp.zeros(len(b["slots"])) for j in range(n_cols))
        step = _gagg_program(fold_sig, 8)
        planes, dirty, g, row_idx, prev, new = step(
            planes, dirty, jnp.asarray(b["slots"]), jnp.asarray(b["sign"]),
            vals, np.int64(b["n_valid"]))
        g = int(g)
        out.append((g, np.asarray(row_idx)[:g],
                    np.stack([np.asarray(prev[n])[:g] for n in names], 1),
                    np.stack([np.asarray(new[n])[:g] for n in names], 1),
                    [np.asarray(planes[n]) for n in names],
                    np.asarray(dirty)))
    return out


def _port_run(c: dict, batches: list) -> list:
    st = cs.gagg_state(torch, CPU, c)
    out = []
    for b in batches:
        tb = {"slots": torch.from_numpy(b["slots"]),
              "sign": torch.from_numpy(b["sign"]),
              "vals": torch.from_numpy(b["vals"]), "n_valid": b["n_valid"]}
        step = cs.gagg_step_on(group_agg_step_plain, c, st, tb)
        g = int(step.n_groups[0])
        P = len(c["kinds"])
        comp = step.comp[:g].numpy()
        out.append((g, step.row_idx[:g].numpy(), comp[:, :P], comp[:, P:],
                    [p.numpy().copy() for p in st["planes"]],
                    st["dirty"].numpy()[:-1].copy()))
        assert bool((st["firstpos"] == NO_ROW).all())
    return out


def _with_slots(c: dict) -> list:
    """The case's batches with slots: ``keys`` batches probe one table."""
    st = cs.gagg_state(torch, CPU, c)
    return [{**b, "slots": cs.gagg_batch_on(torch, CPU, st, b)["slots"]
             .numpy()} for b in c["batches"]]


def _random_case(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    c = {"cap": 128, "kinds": cs.EDGE_KINDS, "cols": cs.EDGE_COLS,
         "batches": []}
    for _ in range(5):
        n = int(rng.integers(1, 600))
        s = rng.integers(-1, 40, n)
        c["batches"].append(cs._edge_rows(rng, n, s, retract=0.35,
                                          n_valid=int(rng.integers(0, n + 1))))
    return c


def _assert_same(port: list, ref: list) -> None:
    for j, (p, r) in enumerate(zip(port, ref)):
        assert p[0] == r[0], f"batch {j}: groups"
        assert np.array_equal(p[1], r[1]), f"batch {j}: row indices"
        assert cs.same_bits(p[2], r[2]), f"batch {j}: PREV rows"
        assert cs.same_bits(p[3], r[3]), f"batch {j}: NEW rows"
        for q, (a, b) in enumerate(zip(p[4], r[4])):
            assert cs.same_bits(a, b), f"batch {j}: plane {q}"
        # the port marks the blocks it writes; the reference marks those
        # and block 0 for every invalid row
        assert not (p[5].astype(bool) & ~r[5]).any(), f"batch {j}: dirty"
        extra = r[5] & ~p[5].astype(bool)
        assert not extra[1:].any(), f"batch {j}: dirty beyond block 0"


@pytest.mark.parametrize("case", cs.GAGG_EDGE_CASES)
def test_plain_step_equals_reference_on_edges(case):
    c = cs.gagg_edge_config(case)
    batches = _with_slots(c)
    _assert_same(_port_run(c, batches), _ref_run(c, batches))


def test_plain_step_equals_reference_on_random_batches():
    for seed in range(4):
        c = _random_case(seed)
        _assert_same(_port_run(c, c["batches"]), _ref_run(c, c["batches"]))


def test_drop_mode_leaves_slot_zero_alone():
    """Invalid rows fold nowhere: slot 0's cells hold what its own rows
    made them (the reference's mode="drop" folds at index capacity)."""
    c = cs.gagg_edge_config("invalid_rows")
    batches = _with_slots(c)
    port = _port_run(c, batches)
    valid0 = sum(int(((b["slots"] == 0)
                      & (np.arange(len(b["slots"])) < b["n_valid"])).sum())
                 for b in batches)
    signs0 = sum(float(b["sign"][(b["slots"] == 0) & (np.arange(len(
        b["slots"])) < b["n_valid"])].sum()) for b in batches)
    assert valid0 > 0
    planes = port[-1][4]
    assert planes[1][0] == signs0        # COUNT folds the sign
    assert planes[0][0] == signs0 or planes[0][0] == 0.0


def test_specials_follow_the_reference_order():
    """-0.0 is below +0.0 in MIN, NaN wins, a fresh slot's MIN of +inf
    stays at the backend identity (float64 max) while a reset one holds
    +inf."""
    c = cs.gagg_edge_config("specials")
    port = _port_run(c, _with_slots(c))
    mn, mx = port[0][4][3], port[0][4][4]
    assert mn[0] == np.finfo(np.float64).max       # MIN(+inf), fresh slot
    assert np.signbit(mn[1]) and not np.signbit(mx[1])   # -0.0 / +0.0
    assert np.isnan(mn[3]) and np.isnan(mx[3])
    after = port[-1][4][3]
    assert after[0] == -0.0 and np.signbit(after[0])  # reset, then -0.0


# -- the operator against the reference operator -----------------------------
SCHEMA = [("k", np.int64), ("v", np.int64), (KIND, np.int8)]
SCHEMA2 = [("k1", np.int64), ("k2", np.int64), ("v", np.int64),
           (KIND, np.int8)]
AGGS = [("sum", "v", "s"), ("count", None, "c"), ("avg", "v", "a"),
        ("min", "v", "mn"), ("max", "v", "mx"), ("count", "v", "cv")]


def _ops(keys, aggs=AGGS, capacity=16):
    return (DeviceGroupAggOperator(keys, [SqlAggSpec(*a) for a in aggs],
                                   capacity=capacity, device="cpu"),
            RefOp(keys, [RefSpec(*a) for a in aggs], capacity=capacity))


def _harnesses(fields, keys, **kw):
    port, ref = _ops(keys, **kw)
    return (OneInputOperatorTestHarness(port, Schema(fields)),
            RefHarness(ref, RefSchema(fields)))


def _feed(hs, fields, cols: dict, t: int) -> None:
    n = len(next(iter(cols.values())))
    ts = np.full(n, t, np.int64)
    hs[0].process_batch(RecordBatch(Schema(fields), cols, ts))
    hs[1].process_batch(RefBatch(RefSchema(fields), cols, ts))


def _rows(h) -> list:
    return [tuple(float(x) if isinstance(x, float) else int(x) for x in r)
            for b in h.output.batches for r in b.iter_rows()]


def _batch(rng, n, n_keys, retract=0.3, low=1):
    return {"k": rng.integers(0, n_keys, n), "v": rng.integers(low, 90, n),
            KIND: np.where(rng.random(n) < retract, 1,
                           0).astype(np.int8)}


def _assert_snap_equal(a: dict, b: dict) -> None:
    a, b = a["keyed"]["backend"], b["keyed"]["backend"]
    assert a["kind"] == b["kind"] == "tpu"
    assert a["max_parallelism"] == b["max_parallelism"]
    assert np.array_equal(np.asarray(a["keys"]), np.asarray(b["keys"]))
    assert np.array_equal(np.asarray(a["key_groups"]),
                          np.asarray(b["key_groups"]))
    assert sorted(a["states"]) == sorted(b["states"])
    for name, sa in a["states"].items():
        sb = b["states"][name]
        assert (sa["kind"], sa["dtype"], sa["ring"]) == \
            (sb["kind"], sb["dtype"], sb["ring"]), name
        assert cs.same_bits(np.asarray(sa["values"]),
                            np.asarray(sb["values"])), name


def test_changelog_inserts_retractions_and_deletes():
    hs = _harnesses(SCHEMA, ["k"])
    rng = np.random.default_rng(1)
    for t in range(8):
        cols = _batch(rng, 60, 9, retract=0.4)
        cols[KIND][rng.random(60) < 0.15] = 3     # DELETE rows
        _feed(hs, SCHEMA, cols, t)
    port, ref = _rows(hs[0]), _rows(hs[1])
    assert port == ref
    kinds = {r[-1] for r in port}
    assert kinds == {0, 1, 2, 3}
    _assert_snap_equal(hs[0].snapshot(), hs[1].snapshot())


def test_drain_and_reinsert_restarts_min_max():
    hs = _harnesses(SCHEMA, ["k"])
    seq = [([5, 5, 6], [9, 2, 4], [0, 0, 0]),
           ([5, 5], [9, 2], [1, 3]),            # 5 drains: DELETE
           ([5, 6, 5], [7, 8, 1], [0, 1, 0]),   # 5 restarts, 6 drains
           ([6, 5, 5], [3, 7, 7], [0, 1, 1])]   # 5 drains again
    for t, (k, v, kind) in enumerate(seq):
        _feed(hs, SCHEMA, {"k": np.array(k), "v": np.array(v),
                           KIND: np.array(kind, np.int8)}, t)
    port, ref = _rows(hs[0]), _rows(hs[1])
    assert port == ref
    restart = [r for r in port if r[0] == 5 and r[-1] == 0]
    assert [r[4] for r in restart] == [2.0, 1.0]  # MIN from identities
    _assert_snap_equal(hs[0].snapshot(), hs[1].snapshot())


def test_min_max_under_retraction_fold_append_only():
    """A retracted extremum stays (the documented degradation)."""
    hs = _harnesses(SCHEMA, ["k"])
    _feed(hs, SCHEMA, {"k": np.array([1, 1, 1]), "v": np.array([3, 50, 9]),
                       KIND: np.zeros(3, np.int8)}, 0)
    _feed(hs, SCHEMA, {"k": np.array([1]), "v": np.array([50]),
                       KIND: np.ones(1, np.int8)}, 1)
    port, ref = _rows(hs[0]), _rows(hs[1])
    assert port == ref
    assert port[-1][5] == 50.0 and port[-1][2] == 2.0


def test_composite_keys_bit_for_bit():
    rng = np.random.default_rng(4)
    cols = [rng.integers(-2**62, 2**62, 500), rng.integers(-9, 9, 500),
            rng.integers(0, 3, 500) * (1 << 40)]
    for k in range(1, 4):
        assert np.array_equal(combine_key_columns(cols[:k]),
                              ref_combine(cols[:k]))
    hs = _harnesses(SCHEMA2, ["k1", "k2"])
    for t in range(5):
        _feed(hs, SCHEMA2, {"k1": rng.integers(-3, 3, 80),
                            "k2": rng.integers(0, 4, 80) << 40,
                            "v": rng.integers(0, 50, 80),
                            KIND: np.where(rng.random(80) < 0.2, 1,
                                           0).astype(np.int8)}, t)
    assert _rows(hs[0]) == _rows(hs[1])
    _assert_snap_equal(hs[0].snapshot(), hs[1].snapshot())


def test_count_of_a_column_counts_rows():
    hs = _harnesses(SCHEMA, ["k"], aggs=[("count", "v", "cv"),
                                         ("count", None, "c")])
    _feed(hs, SCHEMA, {"k": np.array([1, 1, 2]), "v": np.array([0, 7, 3]),
                       KIND: np.zeros(3, np.int8)}, 0)
    port = _rows(hs[0])
    assert port == _rows(hs[1])
    assert [r[1] == r[2] for r in port] == [True] * len(port)


def test_float_key_is_refused_by_both():
    fields = [("k", np.float64), ("v", np.int64)]
    hs = _harnesses(fields, ["k"])
    for h, batch_t, schema_t in ((hs[0], RecordBatch, Schema),
                                 (hs[1], RefBatch, RefSchema)):
        with pytest.raises(TypeError):
            h.process_batch(batch_t(schema_t(fields),
                                    {"k": np.array([1.5]),
                                     "v": np.array([1])}))


def test_growth_by_rehash():
    hs = _harnesses(SCHEMA, ["k"], capacity=8)
    rng = np.random.default_rng(6)
    for t in range(6):
        _feed(hs, SCHEMA, _batch(rng, 200, 300, retract=0.1), t)
    assert _rows(hs[0]) == _rows(hs[1])
    port_op = hs[0].operator
    assert port_op.rehashes and port_op.backend.capacity >= 512
    _assert_snap_equal(hs[0].snapshot(), hs[1].snapshot())


@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_snapshot_restores_across_packages(direction):
    rng = np.random.default_rng(8)
    first = [_batch(rng, 70, 25) for _ in range(3)]
    after = [_batch(rng, 70, 25) for _ in range(3)]
    hs = _harnesses(SCHEMA, ["k"], capacity=16)
    for t, cols in enumerate(first):
        _feed(hs, SCHEMA, cols, t)
    src = hs[0] if direction == "port_to_ref" else hs[1]
    snap = src.snapshot()
    port = OneInputOperatorTestHarness.restored(
        lambda: _ops(["k"])[0], snap, schema=Schema(SCHEMA))
    ref = RefHarness.restored(lambda: _ops(["k"])[1], snap,
                              schema=RefSchema(SCHEMA))
    for t, cols in enumerate(after):
        _feed((port, ref), SCHEMA, cols, 10 + t)
    assert _rows(port) == _rows(ref)
    _assert_snap_equal(port.snapshot(), ref.snapshot())
