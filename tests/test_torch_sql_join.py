"""Port parity: the streaming, temporal and lookup joins and OVER
aggregation (flink_tpu_torch/sql/join.py, over_agg.py) and the planner's
join route (sql/planner.py::plan_join) against flink_tpu's.

The operators are driven through both packages' harnesses with the same
rows, retractions and watermarks, and emit the same rows in the same
order (host operators, deterministic); their snapshots restore across
the packages. The SQL queries of tests/test_join.py and
tests/test_temporal_join.py run through both TableEnvironments, at
parallelism 2, with equal final tables.
chip_smoke.py's sql_join phase (a Nexmark Q3-shaped join, a LEFT JOIN
under a GROUP BY, a temporal join over the datagen DDL) runs at a tiny
size against its dict oracle, and once more, with the dedup job, in a
process where JAX and the JAX package cannot be imported. Tolerance:
exact (NaN, the null of a padded numeric column, equals NaN).
"""

import importlib.util
import math
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import flink_tpu_torch.sql as port_sql
from flink_tpu_torch.api.environment import StreamExecutionEnvironment as \
    PortEnv
from flink_tpu_torch.core import Schema
from flink_tpu_torch.runtime.harness import OneInputOperatorTestHarness, \
    TwoInputOperatorTestHarness
from flink_tpu_torch.sql import rowkind as rk
from flink_tpu_torch.sql.group_agg import SqlAggSpec
from flink_tpu_torch.sql.join import LookupJoinOperator, \
    StreamingJoinOperator, TemporalJoinOperator
from flink_tpu_torch.sql.over_agg import OverAggOperator

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

L_FIELDS = [("lk", np.int64), ("lv", np.int64)]
R_FIELDS = [("rk_", np.int64), ("rv", np.int64)]
KIND = (rk.ROWKIND_COLUMN, np.int8)


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import types

    import flink_tpu.sql as ref_sql
    from flink_tpu.api.environment import StreamExecutionEnvironment
    from flink_tpu.core.records import Schema as RefSchema
    from flink_tpu.runtime import harness
    from flink_tpu.sql import join, over_agg
    from flink_tpu.sql.group_agg import SqlAggSpec as RefSpec
    return types.SimpleNamespace(
        sql=ref_sql, Env=StreamExecutionEnvironment, Schema=RefSchema,
        H1=harness.OneInputOperatorTestHarness,
        H2=harness.TwoInputOperatorTestHarness, join=join,
        Over=over_agg.OverAggOperator, Spec=RefSpec)


def _norm(rows) -> list:
    """Rows with NaN (a padded null) as a comparable marker."""
    def one(v):
        if isinstance(v, float) and math.isnan(v):
            return "NaN"
        return v
    return [tuple(one(v) for v in r) if isinstance(r, tuple) else one(r)
            for r in rows]


def _final(res) -> list:
    """The changelog of a result folded into its final rows, sorted, a
    null-padded NaN equal to another (``TableResult.collect_final`` keys
    rows by value, and NaN != NaN there)."""
    rows = _norm(res.collect())
    if rk.ROWKIND_COLUMN not in res.schema.names:
        return sorted(rows, key=repr)
    k = list(res.schema.names).index(rk.ROWKIND_COLUMN)
    alive: dict = {}
    for r in rows:
        data = r[:k] + r[k + 1:]
        step = -1 if r[k] in (int(rk.UPDATE_BEFORE), int(rk.DELETE)) else 1
        alive[data] = alive.get(data, 0) + step
    return sorted((d for d, m in alive.items() for _ in range(max(m, 0))),
                  key=repr)


def _join_out(join_type: str):
    lkt = np.float64 if join_type in ("right", "full") else np.int64
    rt = np.float64 if join_type in ("left", "full") else np.int64
    return [("lk", lkt), ("lv", lkt), ("rk_", rt), ("rv", rt), KIND]


def _pair(ref, make_port, make_ref, f1, f2, **kw):
    """(port harness, port op), (ref harness, ref op) of one two-input
    operator."""
    op_p, op_r = make_port(), make_ref()
    return ((TwoInputOperatorTestHarness(op_p, Schema(f1), Schema(f2), **kw),
             op_p),
            (ref.H2(op_r, schema1=ref.Schema(f1), schema2=ref.Schema(f2),
                    **kw), op_r))


def _stream_ops(ref, join_type):
    out = _join_out(join_type)
    return (lambda: StreamingJoinOperator(join_type, 0, 0, Schema(out), 2, 2),
            lambda: ref.join.StreamingJoinOperator(
                join_type, 0, 0, ref.Schema(out), 2, 2))


def _changelog(seed, n=160, n_keys=6):
    """(side, rows with rowkind, ts) events: inserts, and retractions of
    rows inserted earlier on the same side (some of rows never seen)."""
    rng = np.random.default_rng(seed)
    live = ([], [])
    out = []
    for t in range(n):
        side = int(rng.integers(0, 2))
        if live[side] and rng.random() < 0.3:
            row = live[side].pop(int(rng.integers(0, len(live[side]))))
            kind = int(rng.choice([rk.DELETE, rk.UPDATE_BEFORE]))
        elif rng.random() < 0.05:
            row, kind = (int(rng.integers(0, n_keys)), 999), int(rk.DELETE)
        else:
            row = (int(rng.integers(0, n_keys)), int(rng.integers(0, 3)))
            kind = int(rng.choice([rk.INSERT, rk.UPDATE_AFTER]))
            live[side].append(row)
        out.append((side, row + (kind,), t))
    return out


def _drive2(h, events, batch=3):
    i = 0
    while i < len(events):
        side = events[i][0]
        j = i
        while j < len(events) and j - i < batch and events[j][0] == side:
            j += 1
        rows = [e[1] for e in events[i:j]]
        ts = [e[2] for e in events[i:j]]
        (h.process_elements1 if side == 0 else h.process_elements2)(rows, ts)
        i = j


@pytest.mark.parametrize("join_type", ["inner", "left", "right", "full"])
def test_streaming_join_changelog_equals_reference(ref, join_type):
    """Random changelogs on both sides (inserts, UPDATE_AFTER, DELETE and
    UPDATE_BEFORE retractions, duplicates, retractions of unseen rows):
    rows equal in order; the snapshot after the first half restores in
    both directions and the second half's rows equal again."""
    f = [L_FIELDS + [KIND], R_FIELDS + [KIND]]
    for seed in range(3):
        events = _changelog(seed)
        (hp, _), (hr, _) = _pair(ref, *_stream_ops(ref, join_type), *f)
        _drive2(hp, events)
        _drive2(hr, events)
        assert _norm(hp.get_output()) == _norm(hr.get_output())
        half = len(events) // 2
        outs = []
        for first, second in ((0, 0), (0, 1), (1, 0)):
            pairs = [_pair(ref, *_stream_ops(ref, join_type), *f)
                     for _ in range(2)]
            h1 = pairs[0][first][0]
            _drive2(h1, events[:half])
            snap = h1.snapshot(1)
            h2 = pairs[1][second][0]
            h2.open(keyed_snapshots=[snap["keyed"]])
            _drive2(h2, events[half:])
            outs.append(_norm(h1.get_output()) + _norm(h2.get_output()))
        assert outs[0] == outs[1] == outs[2] == _norm(hr.get_output())


def test_streaming_join_cases_of_the_reference(ref):
    """tests/test_join.py's harness cases: inner, left padding and its
    revision, a retraction of the left row, full outer. (A residual filter
    is the planner's JoinFilter after the join: test_sql_joins_equal_the_
    reference.)"""
    steps = {
        "inner": [(0, (1, 10, 0)), (1, (1, 100, 0)), (0, (1, 11, 0))],
        "left": [(0, (5, 50, 0)), (1, (5, 500, 0)), (1, (5, 500, 3))],
        "full": [(0, (1, 10, 0)), (1, (2, 20, 0)), (1, (1, 99, 0)),
                 (0, (1, 10, 1))],
        "right": [(1, (7, 700, 0)), (0, (7, 70, 0)), (0, (7, 70, 3))],
    }
    f = [L_FIELDS + [KIND], R_FIELDS + [KIND]]
    for join_type, seq in steps.items():
        (hp, _), (hr, _) = _pair(ref, *_stream_ops(ref, join_type), *f)
        for t, (side, row) in enumerate(seq):
            for h in (hp, hr):
                (h.process_element1 if side == 0 else h.process_element2)(
                    row, t)
        assert _norm(hp.get_output()) == _norm(hr.get_output()), join_type


TEMPORAL_OUT = [("cur", np.int64), ("amount", np.int64),
                ("rcur", np.float64), ("rate", np.float64), KIND]
ORDERS = [("cur", np.int64), ("amount", np.int64)]
RATES = [("rcur", np.int64), ("rate", np.int64)]


def _temporal(ref, join_type="inner"):
    return _pair(
        ref,
        lambda: TemporalJoinOperator(join_type, 0, 0, Schema(TEMPORAL_OUT),
                                     2, 2),
        lambda: ref.join.TemporalJoinOperator(
            join_type, 0, 0, ref.Schema(TEMPORAL_OUT), 2, 2),
        ORDERS, RATES + [KIND])


def test_temporal_join_equals_reference(ref):
    """Versions by event time, out of order within the watermark, left
    rows waiting for it, a lagging input, DELETE tombstones and
    UPDATE_BEFORE rows, inner and left, history compaction, and a
    snapshot that restores across the packages."""
    rng = np.random.default_rng(5)
    for join_type in ("inner", "left"):
        (hp, op_p), (hr, op_r) = _temporal(ref, join_type)
        split = None
        for step in range(40):
            t0 = step * 10
            ver = [(int(rng.integers(0, 4)), int(rng.integers(1, 99)),
                    int(rng.choice([0, 0, 0, 1, 2, 3])))
                   for _ in range(3)]
            vts = (t0 + rng.integers(-15, 10, 3)).tolist()
            orders = [(int(rng.integers(0, 5)), int(rng.integers(1, 9)))
                      for _ in range(2)]
            ots = (t0 + rng.integers(0, 10, 2)).tolist()
            for h in (hp, hr):
                h.process_elements2(ver, vts)
                h.process_elements1(orders, ots)
                if step % 3 == 0:
                    h.process_watermark1(t0 - 5)
                if step % 4 == 0:
                    h.process_watermark2(t0 - 12)
            if step == 20:
                split = (hp.snapshot(1), hr.snapshot(1), len(hp.get_output()))
        for h in (hp, hr):
            h.process_watermark1(10 ** 6)
            h.process_watermark2(10 ** 6)
        assert _norm(hp.get_output()) == _norm(hr.get_output())
        assert len(hp.get_output()) > 20
        assert op_p._versions == op_r._versions
        assert op_p._left_buf == op_r._left_buf == {}
        # the snapshot at step 20 restores into the other package
        for snap in split[:2]:
            (h2, _), _unused = _temporal(ref, join_type)
            h2.open(keyed_snapshots=[snap["keyed"]])
            h2.process_watermark1(10 ** 6)
            h2.process_watermark2(10 ** 6)
            assert len(h2.get_output()) > 0
    (hp, _), (hr, _) = _temporal(ref)
    hp.schemas[0] = Schema(ORDERS + [KIND])
    with pytest.raises(ValueError, match="append-only"):
        hp.process_elements1([(1, 5, int(rk.UPDATE_AFTER))], [10])


def test_lookup_join_equals_reference(ref):
    dim = {1: [("one",)], 2: [("two",), ("deux",)]}
    calls = []

    def lookup(k):
        calls.append(k)
        return dim.get(k, [])

    out = [("k", np.int64), ("name", object)]
    for join_type in ("inner", "left"):
        got = []
        for op in (LookupJoinOperator(0, lookup, Schema(out), 1, join_type,
                                      cache_size=2),
                   ref.join.LookupJoinOperator(0, lookup, ref.Schema(out), 1,
                                               join_type, cache_size=2)):
            h = (OneInputOperatorTestHarness(op, Schema([("k", np.int64)]))
                 if isinstance(op, LookupJoinOperator)
                 else ref.H1(op, schema=ref.Schema([("k", np.int64)])))
            h.process_elements([1, 2, 3, 1, 2, 4], list(range(6)))
            got.append(h.get_output())
        assert got[0] == got[1]
    assert got[0] == [(1, "one"), (2, "two"), (2, "deux"), (3, None),
                      (1, "one"), (2, "two"), (2, "deux"), (4, None)]
    with pytest.raises(ValueError, match="inner"):
        LookupJoinOperator(0, lookup, Schema(out), 1, "full")


def test_over_aggregation_equals_reference(ref):
    """Unbounded running count/sum/avg/min/max and a ROWS window, batches
    of several keys out of ts order, state across batches and a snapshot
    restored across the packages."""
    rng = np.random.default_rng(9)
    kinds = [("count", None), ("sum", "v"), ("avg", "v"), ("min", "v"),
             ("max", "v")]
    fields = [("k", np.int64), ("v", np.int64)]
    for rows_window in (None, 3):
        def specs(Spec):
            return [Spec(k, f, f"o{i}") for i, (k, f) in enumerate(kinds)]

        ops = (OverAggOperator("k", specs(SqlAggSpec), rows_window),
               ref.Over("k", specs(ref.Spec), rows_window))
        hs = (OneInputOperatorTestHarness(ops[0], Schema(fields)),
              ref.H1(ops[1], schema=ref.Schema(fields)))
        snaps = []
        for b in range(6):
            rows = [(int(k), int(v)) for k, v in
                    zip(rng.integers(0, 4, 9), rng.integers(-20, 20, 9))]
            ts = rng.integers(b * 100, b * 100 + 100, 9).tolist()
            for h in hs:
                h.process_elements(rows, ts)
            if b == 2:
                snaps = [h.snapshot(1) for h in hs]
        assert hs[0].get_output() == hs[1].get_output()
        for snap in snaps:
            h2 = OneInputOperatorTestHarness(
                OverAggOperator("k", specs(SqlAggSpec), rows_window),
                Schema(fields))
            h2.open(keyed_snapshots=[snap["keyed"]])
            h2.process_elements([(1, 5)], [10 ** 6])
            assert len(h2.get_output()) == 1


# -- SQL through both TableEnvironments --------------------------------------
def _tables(env, mod, side: str = ""):
    """The orders and users views of tests/test_join.py."""
    orders = mod.Schema([("oid", np.int64), ("uid", np.int64),
                         ("amount", np.int64)])
    users = mod.Schema([("uid", np.int64), ("uname", object)])
    o_rows = [(100, 1, 10), (101, 2, 20), (102, 1, 30), (103, 9, 40)]
    u_rows = [(1, "alice"), (2, "bob"), (3, "carol")]
    return {"orders": (env.from_collection(o_rows, orders,
                                           timestamps=[0, 1, 2, 3]), orders),
            "users": (env.from_collection(u_rows, users,
                                          timestamps=[0, 1, 2]), users)}


def _sql_both(ref, sql: str, batch=None, parallelism=2):
    from flink_tpu_torch.core import records as port_records

    out = {}
    for side in ("ref", "port"):
        if side == "ref":
            env = ref.Env()
            env.set_state_backend("tpu")
            t_env, mod = ref.sql.TableEnvironment(env), ref
        else:
            env = PortEnv(device="cpu")
            t_env, mod = port_sql.TableEnvironment(env), port_records
        env.set_parallelism(parallelism)
        if batch is not None:
            env.config.set("pipeline.micro-batch-size", batch)
        for name, (ds, schema) in _tables(env, mod, side).items():
            t_env.create_temporary_view(name, ds, schema)
        out[side] = t_env.execute_sql(sql)
    return out


SQL_JOINS = [
    "SELECT o.oid, u.uname FROM orders o JOIN users u ON o.uid = u.uid",
    "SELECT o.oid, u.uname FROM orders o LEFT JOIN users u ON o.uid = u.uid",
    "SELECT o.oid, u.uname FROM orders o RIGHT JOIN users u "
    "ON o.uid = u.uid",
    "SELECT o.oid, u.uname FROM orders o FULL OUTER JOIN users u "
    "ON o.uid = u.uid",
    "SELECT u.uname, SUM(o.amount) AS total FROM orders o "
    "JOIN users u ON o.uid = u.uid GROUP BY u.uname",
    "SELECT u.uname, SUM(o.amount) AS total FROM orders o "
    "LEFT JOIN users u ON o.uid = u.uid GROUP BY u.uname",
    "SELECT o.uid, COUNT(*) AS c, SUM(o.amount) AS s FROM orders o "
    "LEFT JOIN users u ON o.uid = u.uid GROUP BY o.uid",
    "SELECT s.oid, u.uname FROM (SELECT oid, uid FROM orders "
    "WHERE amount > 15) s JOIN users u ON s.uid = u.uid",
    "SELECT o.oid FROM orders o JOIN users u "
    "ON o.uid = u.uid AND o.amount > 15",
    "SELECT * FROM orders o JOIN users u ON o.uid = u.uid",
]


def test_sql_joins_equal_the_reference(ref):
    """tests/test_join.py's SQL queries (inner, outer padding, a GROUP BY
    over a join and over a LEFT JOIN's changelog, on the host and on the
    device GROUP BY, a subquery, a residual condition, renamed columns)
    at batches of 2 and 4096: final tables equal, folded from each
    changelog with a padded NaN equal to another. (The changelogs depend
    on the order in which the two sources' batches meet, which two
    threads decide, in either package.)"""
    for batch in (2, None):
        for sql in SQL_JOINS:
            out = _sql_both(ref, sql, batch=batch)
            assert _final(out["ref"]) == _final(out["port"]), sql
            assert list(out["ref"].schema.names) == \
                list(out["port"].schema.names), sql
    got = _final(_sql_both(ref, SQL_JOINS[5], batch=2)["port"])
    final = {r[0]: r[1] for r in got}
    assert final == {"alice": 40.0, "bob": 20.0, None: 40.0}


def test_sql_temporal_join_equals_the_reference(ref):
    """tests/test_temporal_join.py's SQL enrichment: orders joined FOR
    SYSTEM_TIME AS OF their event time against versioned rates."""
    from flink_tpu_torch.core import records as port_records

    got = {}
    for side in ("ref", "port"):
        env = ref.Env() if side == "ref" else PortEnv(device="cpu")
        mod = ref if side == "ref" else port_records
        env.config.set("pipeline.micro-batch-size", 4)
        t_env = (ref.sql if side == "ref" else port_sql).TableEnvironment(env)
        orders = mod.Schema(ORDERS)
        rates = mod.Schema(RATES)
        t_env.create_temporary_view("orders", env.from_collection(
            [(1, 10), (1, 20), (2, 5)], orders, timestamps=[20, 40, 60]),
            orders)
        t_env.create_temporary_view("rates", env.from_collection(
            [(1, 100), (2, 7), (1, 200)], rates, timestamps=[0, 0, 50]),
            rates)
        res = t_env.execute_sql(
            "SELECT cur, amount, rate FROM orders o JOIN rates "
            "FOR SYSTEM_TIME AS OF o.ts AS r ON o.cur = r.rcur")
        got[side] = sorted(tuple(int(x) for x in row)
                           for row in res.collect_final())
    assert got["ref"] == got["port"] == [(1, 10, 100), (1, 20, 100),
                                         (2, 5, 7)]


PLAN_ERRORS = [
    "SELECT o.oid FROM orders o LEFT JOIN users u ON o.uid = u.uid "
    "AND o.amount > 15",
    "SELECT o.oid FROM orders o JOIN users u ON o.amount > 15",
    "SELECT o.oid FROM orders o RIGHT JOIN users FOR SYSTEM_TIME AS OF "
    "o.ts AS u ON o.uid = u.uid",
    "SELECT o.oid FROM orders o JOIN users FOR SYSTEM_TIME AS OF u.ts AS u "
    "ON o.uid = u.uid",
    "SELECT o.oid FROM orders o JOIN orders o ON o.uid = o.uid",
]


def test_join_plan_errors_equal_the_reference(ref):
    from flink_tpu_torch.core import records as port_records

    for sql in PLAN_ERRORS:
        msgs = []
        for env, mod, rec in ((ref.Env(), ref.sql, ref),
                              (PortEnv(device="cpu"), port_sql,
                               port_records)):
            t_env = mod.TableEnvironment(env)
            for name, (ds, schema) in _tables(env, rec, "").items():
                t_env.create_temporary_view(name, ds, schema)
            with pytest.raises(mod.PlanError) as e:
                t_env.execute_sql(sql)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], sql


def test_sql_join_cell_at_a_tiny_size():
    """chip_smoke.py's sql_join phase on the CPU: each query's final rows
    equal its dict oracle. (Whether the LEFT JOIN's changelog retracts
    padded rows depends on which source's batch the join meets first,
    which two threads decide: the GROUP BY's changelog holds at least its
    final rows either way.)"""
    out = cs.sql_join_phase(torch, torch.device("cpu"), auctions=1 << 11,
                            persons=1 << 9)
    assert out["q3"]["final_rows"] > 20
    assert out["left_agg"]["changelog_rows"] >= out["left_agg"]["final_rows"]
    assert out["left_agg"]["final_rows"] > 100
    assert out["temporal"]["final_rows"] > 100


_BLOCKED = """
import sys
sys.modules["jax"] = None
sys.modules["flink_tpu"] = None
sys.path.insert(0, {root!r})
import importlib.util
import torch
spec = importlib.util.spec_from_file_location("chip_smoke",
                                              {root!r} + "/chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
cpu = torch.device("cpu")
out = cs.sql_join_phase(torch, cpu, auctions=1 << 10, persons=1 << 8)
c = cs.dedup_config(keys=2000, events=1 << 13, batch=1 << 10, span_ms=3000,
                    ttl_ms=1000, capacity=64, retract_batch=3)
job, got = cs.run_dedup(torch, cpu, c)
n = cs.dedup_check(cs.dedup_expected(c), got)
from flink_tpu_torch.sql.over_agg import OverAggOperator
assert sys.modules["jax"] is None and sys.modules["flink_tpu"] is None
print("q3", int(out["q3"]["final_rows"] > 0), "dedup", int(n > 0))
"""


def test_slice_runs_with_jax_and_flink_tpu_blocked():
    out = subprocess.run([sys.executable, "-c",
                          _BLOCKED.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=240,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["q3", "1", "dedup", "1"]
