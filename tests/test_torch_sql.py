"""Port parity of the SQL layer (``flink_tpu_torch/sql``): the port's
``TableEnvironment`` against the reference's on the cases of
tests/test_sql.py, test_device_group_agg_sql.py, test_two_phase_agg.py
and the host cases of test_retract_minmax.py, on the CPU.

The reference runs with ``set_state_backend("tpu")``, the backend the
port always runs, so both plan the same routes: integer-keyed GROUP BY on
the device group aggregation, TUMBLE/HOP/SESSION on the device window
operators, other keys, DISTINCT and MIN/MAX over a changelog on the host
GroupAggOperator. At parallelism 1 the changelogs are compared row for
row (order included); at parallelism 2 the subtasks interleave, so rows
are compared as multisets and final tables exactly. Tolerance: exact
where every value is an integer; 1e-9 relative for the TPC-H sums of
non-representable decimals, whose host fold orders differ.

Also: parse trees equal the reference's, parse and plan errors, EXPLAIN
naming ``GroupAggregate(device)``, the DDL statements on the datagen
connector, MATCH_RECOGNIZE planned with rows equal to the reference's,
and the whole SQL path once in a subprocess that cannot import jax or
flink_tpu.
"""

import importlib.util
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import flink_tpu.sql as ref_sql  # noqa: E402
from flink_tpu.api.environment import \
    StreamExecutionEnvironment as RefEnv  # noqa: E402
from flink_tpu.core import records as ref_records  # noqa: E402
from flink_tpu.core import watermarks as ref_wm  # noqa: E402
from flink_tpu.runtime.harness import \
    OneInputOperatorTestHarness as RefHarness  # noqa: E402
from flink_tpu.sql.group_agg import GroupAggOperator as RefGroupAgg  # noqa: E402
from flink_tpu.sql.group_agg import SqlAggSpec as RefSpec  # noqa: E402
import flink_tpu_torch.sql as port_sql  # noqa: E402
from flink_tpu_torch.api.environment import \
    StreamExecutionEnvironment as PortEnv  # noqa: E402
from flink_tpu_torch.core import records as port_records  # noqa: E402
from flink_tpu_torch.core import watermarks as port_wm  # noqa: E402
from flink_tpu_torch.runtime.harness import \
    OneInputOperatorTestHarness as PortHarness  # noqa: E402
from flink_tpu_torch.sql.group_agg import GroupAggOperator, SqlAggSpec  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
KIND = "__rowkind__"
SIDES = {
    "ref": (RefEnv, ref_records, ref_wm, ref_sql),
    "port": (lambda: PortEnv(device="cpu"), port_records, port_wm,
             port_sql),
}
ORDERS = [(1, 10, "a"), (2, 20, "b"), (1, 5, "a"), (3, 7, "c"),
          (2, 1, "b"), (1, 2, "a")]
ORDERS_FIELDS = [("k", np.int64), ("v", np.int64), ("name", object)]
BIDS = [(1, 10, 1000), (2, 20, 2000), (1, 5, 4000), (1, 7, 6000),
        (2, 3, 7000), (1, 2, 9000), (1, 4, 22000), (2, 9, 30000)]
BIDS_FIELDS = [("k", np.int64), ("v", np.int64), ("ts", np.int64)]


def _env(side: str, parallelism=1, batch=None, two_phase=None):
    make, _rec, _wm, _sql = SIDES[side]
    env = make()
    env.set_parallelism(parallelism)
    if side == "ref":
        env.set_state_backend("tpu")
    if batch is not None:
        env.config.set("pipeline.micro-batch-size", batch)
    if two_phase is not None:
        env.config.set("sql.optimizer.agg-phase-strategy.two-phase",
                       two_phase)
    return env


def _query(side: str, sql, tables: dict, **env_kw):
    """Runs ``sql`` (a statement or a list) over the views ``tables``
    (name -> (rows, fields, event-time column or None)); returns the last
    result and the environment."""
    _make, rec, wm, sqlmod = SIDES[side]
    env = _env(side, **env_kw)
    t_env = sqlmod.TableEnvironment(env)
    for name, (rows, fields, ts_col) in tables.items():
        schema = rec.Schema(fields)
        if ts_col is None:
            ds = env.from_collection(rows, schema,
                                     timestamps=list(range(len(rows))))
        else:
            i = [f[0] for f in fields].index(ts_col)
            ds = env.from_collection(
                rows, schema, timestamps=[r[i] for r in rows],
                watermark_strategy=wm.WatermarkStrategy
                .for_monotonous_timestamps())
        t_env.create_temporary_view(name, ds, schema)
    res = None
    for stmt in ([sql] if isinstance(sql, str) else sql):
        res = t_env.execute_sql(stmt)
    return res, env


def _both(sql, tables, **env_kw):
    return {side: _query(side, sql, tables, **env_kw) for side in SIDES}


def _norm(rows):
    return [tuple(float(x) if isinstance(x, float) else x for x in r)
            if isinstance(r, tuple) else r for r in rows]


def _same(sql, tables, ordered=True, **env_kw):
    out = _both(sql, tables, **env_kw)
    ref, port = out["ref"][0], out["port"][0]
    a, b = _norm(ref.collect()), _norm(port.collect())
    if ordered:
        assert a == b
    else:
        assert sorted(a, key=repr) == sorted(b, key=repr)
    assert sorted(_norm(ref.collect_final()), key=repr) == \
        sorted(_norm(port.collect_final()), key=repr)
    return out


def _nested_equal(a, b) -> bool:
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_nested_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_nested_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and np.array_equal(a, b)
    return a == b


def _vertex_names(env) -> str:
    return " ".join(v.name for v in env.last_job.job_graph.vertices.values())


# -- parser ------------------------------------------------------------------
PARSE_CASES = [
    "SELECT a, b + 1 AS c FROM t WHERE a > 2",
    "SELECT k, SUM(v), COUNT(*) FROM t GROUP BY k HAVING SUM(v) > 10",
    "SELECT k, window_start, SUM(v) FROM TUMBLE(TABLE t, DESCRIPTOR(ts), "
    "INTERVAL '5' SECOND) GROUP BY k, window_start, window_end",
    "SELECT * FROM HOP(TABLE t, DESCRIPTOR(ts), INTERVAL '2' SECOND, "
    "INTERVAL '10' SECOND)",
    "SELECT k, COUNT(DISTINCT v) FROM SESSION(TABLE t, DESCRIPTOR(ts), "
    "INTERVAL '3' SECOND) GROUP BY k, window_start, window_end",
    "SELECT k, CASE WHEN v > 9 THEN 1 ELSE 0 END AS big, CAST(v AS DOUBLE)"
    " FROM (SELECT k, v FROM orders WHERE v > 5) s ORDER BY k DESC LIMIT 3",
    "SELECT a.k, b.v FROM a JOIN b ON a.k = b.k WHERE b.v <> 'x'",
]


def test_parse_trees_equal_the_reference():
    for sql in PARSE_CASES:
        assert repr(port_sql.parse(sql)) == repr(ref_sql.parse(sql)), sql
    for bad in ("SELECT FROM t", "SELECT a FROM t GROUP a",
                "SELECT a FROM TUMBLE(TABLE t)"):
        for mod in (ref_sql, port_sql):
            with pytest.raises(mod.SqlError):
                mod.parse(bad)


# -- calc --------------------------------------------------------------------
def test_where_projection_case_and_strings():
    tables = {"orders": (ORDERS, ORDERS_FIELDS, None)}
    _same("SELECT k, v * 2 AS dbl FROM orders WHERE v >= 7", tables,
          ordered=False, parallelism=2)
    _same("SELECT k, CASE WHEN v > 9 THEN 1 ELSE 0 END AS big FROM orders",
          tables)
    out = _same("SELECT UPPER(name) u FROM orders WHERE k = 3", tables)
    assert out["port"][0].collect() == ["C"]
    _same("SELECT k FROM (SELECT k, v FROM orders WHERE v > 5) WHERE k < 3",
          tables)


# -- unbounded group aggregation ----------------------------------------------
def test_group_agg_changelog_and_aggregates():
    tables = {"orders": (ORDERS, ORDERS_FIELDS, None)}
    out = _same("SELECT k, SUM(v) AS s, COUNT(*) AS c FROM orders "
                "GROUP BY k", tables, batch=2)
    kinds = {r[-1] for r in out["port"][0].collect()}
    assert {1, 2} <= kinds
    assert "GroupAggregate(device)" in _vertex_names(out["port"][1])
    out = _same("SELECT k, AVG(v) a, MIN(v) mn, MAX(v) mx FROM orders "
                "GROUP BY k", tables, ordered=False, parallelism=2, batch=2)
    final = {r[0]: r[1:] for r in out["port"][0].collect_final()}
    assert final[1] == (17.0 / 3, 2.0, 10.0)


def test_global_aggregate_and_having():
    tables = {"orders": (ORDERS, ORDERS_FIELDS, None)}
    out = _same("SELECT SUM(v) total, COUNT(*) c FROM orders", tables,
                batch=4)
    assert out["port"][0].collect_final() == [(45.0, 6.0)]
    out = _same("SELECT k, SUM(v) s FROM orders GROUP BY k "
                "HAVING SUM(v) > 10", tables, batch=2)
    assert sorted(r[0] for r in out["port"][0].collect_final()) == [1, 2]


def test_string_keys_take_the_host_route_in_two_phases():
    tables = {"orders": (ORDERS, ORDERS_FIELDS, None)}
    for two_phase in (True, False):
        out = _same("SELECT name, SUM(v) s, MIN(v) mn FROM orders "
                    "GROUP BY name", tables, batch=2, two_phase=two_phase)
        names = _vertex_names(out["port"][1])
        assert "GroupAggregate(device)" not in names
        assert ("LocalGroupAggregate" in names) == two_phase


def test_device_route_matches_reference_host_route():
    """test_device_group_agg_sql's shapes: single and composite keys at
    parallelism 1 and 2; the reference's host route gives the same final
    table."""
    rng = np.random.default_rng(5)
    rows = [(int(a), int(b), int(v)) for a, b, v in
            zip(rng.integers(0, 5, 150), rng.integers(0, 7, 150),
                rng.integers(1, 30, 150))]
    fields = [("k1", np.int64), ("k2", np.int64), ("v", np.int64)]
    tables = {"orders": (rows, fields, None)}
    for p in (1, 2):
        for sql in ("SELECT k1, SUM(v) s, COUNT(*) c, AVG(v) a, MIN(v) mn, "
                    "MAX(v) mx FROM orders GROUP BY k1",
                    "SELECT k1, k2, SUM(v) s, COUNT(*) c FROM orders "
                    "GROUP BY k1, k2"):
            out = _same(sql, tables, ordered=p == 1, parallelism=p,
                        batch=16)
            assert "GroupAggregate(device)" in _vertex_names(out["port"][1])
            host_env = RefEnv()
            host_env.set_parallelism(p)
            host_env.config.set("pipeline.micro-batch-size", 16)
            t_env = ref_sql.TableEnvironment(host_env)
            t_env.create_temporary_view(
                "orders", host_env.from_collection(
                    rows, ref_records.Schema(fields),
                    timestamps=list(range(len(rows)))),
                ref_records.Schema(fields))
            host = t_env.execute_sql(sql).collect_final()
            assert sorted(_norm(host)) == \
                sorted(_norm(out["port"][0].collect_final()))


def test_composite_exchange_hashes_the_combined_word():
    """At parallelism 2 the keyed exchange routes by the word the device
    backend stores: each subtask's state holds exactly its key groups."""
    from flink_tpu_torch.core.keygroups import hash_batch, \
        key_groups_for_hash_batch
    from flink_tpu_torch.sql.device_group_agg import combine_key_columns

    rng = np.random.default_rng(3)
    rows = [(int(a), int(b), 1) for a, b in
            zip(rng.integers(0, 9, 200), rng.integers(0, 9, 200))]
    fields = [("k1", np.int64), ("k2", np.int64), ("v", np.int64)]
    _res, env = _query("port", "SELECT k1, k2, COUNT(*) c FROM orders "
                       "GROUP BY k1, k2", {"orders": (rows, fields, None)},
                       parallelism=2, batch=16)
    jg = env.last_job.job_graph
    (edge,) = [e for e in jg.edges if e.partitioner_name == "hash"]
    part = edge.partitioner_factory()
    arr = np.array(rows, np.int64)
    batch = port_records.RecordBatch(
        port_records.Schema(fields),
        {"k1": arr[:, 0], "k2": arr[:, 1], "v": arr[:, 2]})
    got = {}
    for ch, b in part.route(batch, 2, 0):
        for r in b.iter_rows():
            got[r[:2]] = ch
    words = combine_key_columns([arr[:, 0], arr[:, 1]])
    groups = key_groups_for_hash_batch(hash_batch(words), 128)
    for (a, b, _v), g in zip(rows, groups):
        assert got[(a, b)] == g * 2 // 128


def test_changelog_input_retracts_and_nests():
    """A changelog table into the device route (no MIN/MAX), and the
    retract-exact host route of an outer MIN over an inner GROUP BY."""
    rows = [(1, 10, 0), (1, 20, 0), (2, 7, 0), (1, 10, 3), (2, 7, 1),
            (2, 8, 2), (3, 4, 0), (3, 4, 3)]
    fields = [("k", np.int64), ("v", np.int64), (KIND, np.int8)]
    out = _same("SELECT k, SUM(v) s, COUNT(*) c FROM t GROUP BY k",
                {"t": (rows, fields, None)}, batch=3)
    assert "GroupAggregate(device)" in _vertex_names(out["port"][1])
    rng = np.random.default_rng(9)
    rows = [(int(k), int(v)) for k, v in
            zip(rng.integers(0, 8, 120), rng.integers(1, 40, 120))]
    out = _same("SELECT grp, MIN(s) mn, MAX(s) mx FROM "
                "(SELECT k, k % 2 AS grp, SUM(v) AS s FROM t GROUP BY k) "
                "GROUP BY grp",
                {"t": (rows, [("k", np.int64), ("v", np.int64)], None)},
                batch=4, two_phase=True)
    names = _vertex_names(out["port"][1])
    assert "GroupAggregate(device)" in names and "Local" not in names


def test_retract_minmax_operator_matches_reference():
    """test_retract_minmax's random insert/retract interleavings through
    the host GroupAggOperator with count maps: changelogs equal, and a
    snapshot restores across the packages."""
    fields = [("k", np.int64), ("v", np.int64), (KIND, np.int8)]
    for seed in range(3):
        rng = np.random.default_rng(seed)
        live: dict = {}
        ev = []
        for _ in range(300):
            k = int(rng.integers(0, 6))
            vs = live.get(k, [])
            if vs and rng.random() < 0.45:
                ev.append((k, vs.pop(int(rng.integers(0, len(vs)))), 3))
            else:
                v = int(rng.integers(0, 50))
                live.setdefault(k, []).append(v)
                ev.append((k, v, 0))
        outs, snaps = [], []
        for Op, Spec, Harness, rec in (
                (RefGroupAgg, RefSpec, RefHarness, ref_records),
                (GroupAggOperator, SqlAggSpec, PortHarness, port_records)):
            aggs = [Spec("min", "v", "mn"), Spec("max", "v", "mx"),
                    Spec("sum", "v", "s")]
            h = Harness(Op(["k"], aggs, retract_minmax=True),
                        rec.Schema(fields))
            for lo in range(0, len(ev), 7):
                chunk = np.array(ev[lo:lo + 7], np.int64)
                h.process_batch(rec.RecordBatch(
                    rec.Schema(fields), {"k": chunk[:, 0], "v": chunk[:, 1],
                                         KIND: chunk[:, 2].astype(np.int8)},
                    np.arange(lo, lo + len(chunk), dtype=np.int64)))
            outs.append([r for b in h.output.batches for r in b.iter_rows()])
            snaps.append(h.snapshot())
        assert outs[0] == outs[1]
        assert _nested_equal(snaps[0], snaps[1])


# -- window TVFs on the device window operators --------------------------------
def test_tumble_hop_and_session_windows():
    tables = {"bids": (BIDS, BIDS_FIELDS, "ts")}
    out = _same("SELECT k, window_start, window_end, SUM(v) s, COUNT(*) c "
                "FROM TUMBLE(TABLE bids, DESCRIPTOR(ts), INTERVAL '5' "
                "SECOND) GROUP BY k, window_start, window_end", tables,
                ordered=False)
    assert (1, 0, 5000, 15.0, 2.0) in out["port"][0].collect()
    out = _same("SELECT k, window_start, SUM(v) s FROM HOP(TABLE bids, "
                "DESCRIPTOR(ts), INTERVAL '5' SECOND, INTERVAL '10' "
                "SECOND) GROUP BY k, window_start, window_end", tables,
                ordered=False)
    k1 = {r[1]: r[2] for r in out["port"][0].collect() if r[0] == 1}
    assert k1[-5000] == 15.0 and k1[0] == 24.0
    _same("SELECT k, window_start, SUM(v * 2) s FROM TUMBLE(TABLE bids, "
          "DESCRIPTOR(ts), INTERVAL '5' SECOND) GROUP BY k, window_start, "
          "window_end", tables, ordered=False)
    out = _same("SELECT k, window_start, window_end, COUNT(*) c, MAX(v) mx "
                "FROM SESSION(TABLE bids, DESCRIPTOR(ts), INTERVAL '3' "
                "SECOND) GROUP BY k, window_start, window_end", tables,
                ordered=False)
    assert "WindowAggregate" in _vertex_names(out["port"][1])


# -- ORDER BY ... LIMIT ---------------------------------------------------------
def test_order_by_limit_topn():
    tables = {"orders": (ORDERS, ORDERS_FIELDS, None)}
    out = _same("SELECT k, SUM(v) s FROM orders GROUP BY k "
                "ORDER BY SUM(v) DESC LIMIT 2", tables, batch=2)
    assert sorted(out["port"][0].collect_final(), key=lambda r: -r[1]) == \
        [(2, 21.0), (1, 17.0)]
    for mod in (ref_sql, port_sql):
        env = _env("ref" if mod is ref_sql else "port")
        t_env = mod.TableEnvironment(env)
        rec = ref_records if mod is ref_sql else port_records
        t_env.create_temporary_view("orders", env.from_collection(
            ORDERS, rec.Schema(ORDERS_FIELDS)), rec.Schema(ORDERS_FIELDS))
        with pytest.raises(mod.PlanError):
            t_env.execute_sql("SELECT k FROM orders LIMIT 2")


# -- TPC-H Q1 (test_two_phase_agg) ----------------------------------------------
def _lineitem(n=400, seed=3):
    rng = np.random.default_rng(seed)
    return [(str("ANR"[rng.integers(0, 3)]), str("FO"[rng.integers(0, 2)]),
             float(rng.integers(1, 51)), round(float(rng.random() * 1e4), 2),
             round(float(rng.random() * 0.1), 2),
             round(float(rng.random() * 0.08), 2),
             int(19980101 + rng.integers(0, 1400))) for _ in range(n)]


LINEITEM = [("l_returnflag", object), ("l_linestatus", object),
            ("l_quantity", np.float64), ("l_extendedprice", np.float64),
            ("l_discount", np.float64), ("l_tax", np.float64),
            ("l_shipdate", np.int64)]


def _close(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(sorted(a, key=repr), sorted(b, key=repr)):
        assert ra[:2] == rb[:2]
        for x, y in zip(ra[2:], rb[2:]):
            assert abs(x - y) <= 1e-9 * max(1.0, abs(y)), (ra, rb)


TPCH_Q1 = """
SELECT l_returnflag, l_linestatus, SUM(l_quantity) AS sum_qty,
  SUM(l_extendedprice) AS sum_base_price,
  SUM(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
  SUM(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
  AVG(l_quantity) AS avg_qty, AVG(l_extendedprice) AS avg_price,
  AVG(l_discount) AS avg_disc, COUNT(*) AS count_order
FROM lineitem WHERE l_shipdate <= 19980902
GROUP BY l_returnflag, l_linestatus
"""


def test_tpch_q1_string_keys_and_retractions():
    """test_two_phase_agg's TPC-H Q1 over string flags (the host route,
    one and two phases) and over a changelog that amends rows."""
    rows = _lineitem()
    tables = {"lineitem": (rows, LINEITEM, None)}
    for two_phase in (False, True):
        out = _both(TPCH_Q1, tables, batch=16, two_phase=two_phase)
        _close(out["ref"][0].collect_final(), out["port"][0].collect_final())
    rng = np.random.default_rng(6)
    stream, kinds = list(rows[:200]), [0] * 200
    for i in rng.choice(200, 40, replace=False):
        old = rows[i]
        stream += [old, (old[0], old[1], old[2] + 5.0, old[3] * 1.1)
                   + old[4:]]
        kinds += [1, 2]
    fields = LINEITEM + [(KIND, np.int8)]
    out = _both(TPCH_Q1, {"lineitem": ([r + (k,) for r, k in
                                        zip(stream, kinds)], fields, None)},
                batch=16)
    _close(out["ref"][0].collect_final(), out["port"][0].collect_final())


def test_tpch_q1_generator_on_the_device_route():
    """bench.py's TPC-H Q1 generator (integer flags: the device route)
    through chip_smoke.py's run at a tiny size: the changelog equals the
    reference's row for row, and the final groups its numpy oracle."""
    cs = _smoke()
    job, res = cs.run_tpch_q1(torch, torch.device("cpu"), 20_000, 2048)
    assert "GroupAggregate(device)" in " ".join(
        v.name for v in job.job_graph.vertices.values())
    check = cs.tpch_check(cs.tpch_expected(20_000), res)
    assert check["groups"] == 6
    env = RefEnv()
    env.set_state_backend("tpu")
    env.config.set("pipeline.micro-batch-size", 2048)
    t_env = ref_sql.TableEnvironment(env)
    schema = ref_records.Schema(cs.TPCH_FIELDS)
    t_env.create_temporary_view(
        "lineitem", env.datagen(cs.tpch_gen, schema, count=20_000), schema)
    ref = t_env.execute_sql(cs.TPCH_Q1_SQL)
    _close(ref.collect(), res.collect())
    assert [r[:2] + (r[-1],) for r in ref.collect()] == \
        [r[:2] + (r[-1],) for r in res.collect()]


def test_groupby_cell_with_retractions_at_a_tiny_size():
    """chip_smoke.py's GROUP BY cell at a tiny size: every final group
    against its oracle through the changelog replay, and the retraction
    batch's drained groups emitting DELETE; the same changelog as the
    reference's."""
    cs = _smoke()
    n_keys, n_rows = 3000, 1 << 14
    retract = cs.retraction_rows(n_keys, n_rows, 2048)
    for r in (None, retract):
        job, res = cs.run_groupby(torch, torch.device("cpu"), n_keys,
                                  n_rows, 2048, retract=r)
        check = cs.groupby_check(cs.groupby_expected(n_keys, n_rows, r),
                                 res, r)
        assert check["groups"] > 0
        if r is not None:
            assert check["deletes"] > 0 and check["drained"] > 0
        fields = [("auction", np.int64), ("price", np.int64)]
        count = n_rows
        if r is not None:
            fields.append((KIND, np.int8))
            count += len(r[0])
        env = RefEnv()
        env.set_state_backend("tpu")
        env.config.set("pipeline.micro-batch-size", 2048)
        t_env = ref_sql.TableEnvironment(env)
        schema = ref_records.Schema(fields)
        name = "bid" if r is None else "bid_cl"
        t_env.create_temporary_view(name, env.datagen(
            cs.bid_gen(n_keys, n_rows, r), schema, count=count), schema)
        ref = t_env.execute_sql(cs.GROUPBY_SQL if r is None
                                else cs.GROUPBY_RETRACT_SQL)
        assert _norm(ref.collect()) == _norm(res.collect())


# -- EXPLAIN, DDL and what the port does not plan ------------------------------
def test_explain_names_the_device_group_aggregate():
    tables = {"orders": (ORDERS, ORDERS_FIELDS, None)}
    out = _both("EXPLAIN SELECT k, SUM(v) s FROM orders GROUP BY k", tables)
    for side in SIDES:
        plan = "\n".join(r[0] for r in out[side][0].collect())
        assert "GroupAggregate(device)" in plan
        assert "[hash]" in plan


def test_ddl_on_the_datagen_connector():
    ddl = ("CREATE TABLE gen (k BIGINT, v BIGINT) WITH ('connector' = "
           "'datagen', 'number-of-rows' = '500', 'fields.k.kind' = "
           "'random', 'fields.k.min' = '0', 'fields.k.max' = '9')")
    stmts = [ddl, "CREATE TABLE sink (k BIGINT, s DOUBLE) WITH "
             "('connector' = 'blackhole')",
             "CREATE VIEW big AS SELECT k, v FROM gen WHERE v > 100"]
    results = {}
    for side, (make, _rec, _wm, mod) in SIDES.items():
        env = make()
        if side == "ref":
            env.set_state_backend("tpu")
        t_env = mod.TableEnvironment(env)
        for s in stmts:
            assert t_env.execute_sql(s).collect() == [("OK",)]
        results[side] = [
            t_env.execute_sql("SHOW TABLES").collect(),
            t_env.execute_sql("DESCRIBE gen").collect(),
            sorted(t_env.execute_sql(
                "SELECT k, SUM(v) s FROM big GROUP BY k").collect_final()),
            t_env.execute_sql("INSERT INTO sink SELECT k, v * 1.0 FROM gen "
                              "WHERE k < 5").collect(),
            t_env.execute_sql("SHOW CREATE TABLE gen").collect(),
            t_env.execute_sql("DROP VIEW big").collect(),
            t_env.execute_sql("SHOW VIEWS").collect()]
        with pytest.raises(mod.SqlError):
            t_env.execute_sql("CREATE TABLE gen (k BIGINT) WITH "
                              "('connector' = 'datagen')")
    assert results["ref"] == results["port"]


#: MATCH_RECOGNIZE raised PlanError until the port planned it; now its
#: rows equal the reference's (tests/test_torch_match_recognize.py holds
#: the clause's cases)
MATCH_ROUTES = [
    "SELECT * FROM bids MATCH_RECOGNIZE (PARTITION BY k ORDER BY ts "
    "MEASURES A.v AS av, B.v AS bv PATTERN (A B) DEFINE A AS A.v > 1, "
    "B AS B.v > 2)",
]
#: routes the host WindowOperator now plans (they raised before it was
#: ported); tests/test_torch_window_operator.py holds their rows to the
#: reference's
HOST_WINDOW_ROUTES = [
    "SELECT k, window_start, SUM(v) FROM CUMULATE(TABLE orders, "
    "DESCRIPTOR(v), INTERVAL '1' SECOND, INTERVAL '4' SECOND) GROUP BY k, "
    "window_start, window_end",
    "SELECT name, window_start, SUM(v) FROM TUMBLE(TABLE orders, "
    "DESCRIPTOR(v), INTERVAL '1' SECOND) GROUP BY name, window_start, "
    "window_end",
]


def test_unported_routes_raise_plan_error():
    env = PortEnv(device="cpu")
    t_env = port_sql.TableEnvironment(env)
    schema = port_records.Schema(ORDERS_FIELDS)
    t_env.create_temporary_view("orders", env.from_collection(
        ORDERS, schema), schema)
    for sql in MATCH_ROUTES:
        rows = {}
        for side in SIDES:
            _make, rec, _wm, sqlmod = SIDES[side]
            e = _env(side)
            t = sqlmod.TableEnvironment(e)
            bids = rec.Schema(BIDS_FIELDS)
            t.create_temporary_view("bids", e.from_collection(
                BIDS, bids, timestamps=[r[2] for r in BIDS]), bids)
            rows[side] = sorted(t.execute_sql(sql).collect_final())
        assert rows["port"] == rows["ref"] and rows["port"]
    for sql in HOST_WINDOW_ROUTES:
        assert t_env.execute_sql(sql).collect()
    # a filesystem table plans in both packages and fails as the
    # reference does when its path does not exist
    ref_env = RefEnv()
    for mod, env_ in ((ref_sql, ref_env), (port_sql, env)):
        t = mod.TableEnvironment(env_)
        t.execute_sql("CREATE TABLE f (k BIGINT) WITH ('connector' = "
                      "'filesystem', 'path' = '/nonexistent')")
        with pytest.raises(FileNotFoundError, match="/nonexistent"):
            t.execute_sql("SELECT k FROM f")


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_BLOCKED_SQL = """
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
job, res = cs.run_tpch_q1(torch, cpu, 20000, 2048)
q1 = cs.tpch_check(cs.tpch_expected(20000), res)
r = cs.retraction_rows(2000, 1 << 13, 1024)
job, res = cs.run_groupby(torch, cpu, 2000, 1 << 13, 1024, retract=r)
gb = cs.groupby_check(cs.groupby_expected(2000, 1 << 13, r), res, r)
from flink_tpu_torch.sql import TableEnvironment
from flink_tpu_torch.api import StreamExecutionEnvironment
t_env = TableEnvironment(StreamExecutionEnvironment(device="cpu"))
t_env.execute_sql("CREATE TABLE g (k BIGINT, v BIGINT) WITH ('connector' "
                  "= 'datagen', 'number-of-rows' = '100')")
plan = t_env.execute_sql("EXPLAIN SELECT k, COUNT(*) c FROM g GROUP BY k")
assert sys.modules["jax"] is None and sys.modules["flink_tpu"] is None
assert "flink_tpu_torch.sql.planner" in sys.modules
print("groups", q1["groups"], "deletes", int(gb["deletes"] > 0), "device",
      int(any("GroupAggregate(device)" in r[0] for r in plan.collect())))
"""


def test_sql_path_runs_with_jax_and_flink_tpu_blocked():
    out = subprocess.run([sys.executable, "-c",
                          _BLOCKED_SQL.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=240,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["groups", "6", "deletes", "1", "device",
                                  "1"]
