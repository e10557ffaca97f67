"""Port parity of MATCH_RECOGNIZE (``flink_tpu_torch/sql/match_recognize.py``
and the planner's route) against the reference's.

* The cases of tests/test_match_recognize.py, looped: each statement runs
  through both packages' ``TableEnvironment`` on the same rows and gives
  equal rows, or the same error; the parse errors are equal too.
* chip_smoke.py's part (a) at a small size: the V shape of Flink's
  documentation under the device GROUP BY, against the reference's
  TableEnvironment.
* The smoke's scan oracle (``mr_scan``), which the card's run is judged
  by, against the reference's rows for the same ticks.

Tolerance: exact (integer prices; COUNT, MIN and MAX compared as
numbers).
"""

import importlib.util
import pathlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import flink_tpu.sql as ref_sql  # noqa: E402
from flink_tpu.api.environment import \
    StreamExecutionEnvironment as RefEnv  # noqa: E402
from flink_tpu.core import records as ref_records  # noqa: E402
from flink_tpu.core import watermarks as ref_wm  # noqa: E402
import flink_tpu_torch.sql as port_sql  # noqa: E402
from flink_tpu_torch.api.environment import \
    StreamExecutionEnvironment as PortEnv  # noqa: E402
from flink_tpu_torch.core import records as port_records  # noqa: E402
from flink_tpu_torch.core import watermarks as port_wm  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
SIDES = {
    "ref": (RefEnv, ref_records, ref_wm, ref_sql),
    "port": (lambda: PortEnv(device="cpu"), port_records, port_wm,
             port_sql),
}
FIELDS = [("sym", np.int64), ("price", np.int64), ("ts", np.int64)]
V_SHAPE = [(1, 10, 1000), (1, 8, 2000), (1, 6, 3000), (1, 9, 4000),
           (2, 5, 1000), (2, 6, 2000), (2, 7, 3000), (2, 8, 4000)]
GREEDY = [(1, 10, 1000), (1, 8, 2000), (1, 9, 3000), (1, 11, 4000)]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(side: str, rows: list, sql: str):
    """Final rows of ``sql`` over the view ``ticks``, or the error's
    class name and message."""
    make, rec, _wm, sqlmod = SIDES[side]
    env = make()
    env.set_parallelism(1)
    t = sqlmod.TableEnvironment(env)
    schema = rec.Schema(FIELDS)
    t.create_temporary_view("ticks", env.from_collection(
        rows, schema, timestamps=[r[2] for r in rows]), schema)
    try:
        return sorted(t.execute_sql(sql).collect_final())
    except Exception as e:  # noqa: BLE001 - the error is the result
        return ("error", _root_message(e))


def _root_message(e: BaseException) -> str:
    """The innermost cause's class and message (a task's failure wraps
    the operator's error in both packages). The reference's unqualified
    MEASURES message prints a literal ``{col}`` in its example (ROADMAP
    Queue 3); the port names the column, so the example is cut."""
    while e.__cause__ is not None:
        e = e.__cause__
    msg = str(e).split(" (e.g. A.")[0]
    # a task failure names the task: keep the operator's own message
    return msg[msg.find("ValueError"):] if "ValueError" in msg else \
        f"{type(e).__name__}: {msg}"


MR = "SELECT {sel} FROM ticks MATCH_RECOGNIZE (PARTITION BY sym ORDER BY {o} "
CASES = {
    "v_shape": (V_SHAPE, MR.format(sel="*", o="ts") + (
        "MEASURES FIRST(A.price) AS start_p, LAST(B.price) AS bottom_p, "
        "C.price AS end_p PATTERN (A B+ C) DEFINE B AS B.price < A.price, "
        "C AS C.price > LAST(B.price))")),
    "cross_variable": ([(7, 100, 1000), (7, 150, 2000), (7, 90, 3000),
                        (7, 80, 4000), (7, 70, 5000), (7, 200, 6000)],
                       MR.format(sel="*", o="ts") + (
                           "MEASURES A.price AS a_p, B.price AS b_p "
                           "PATTERN (A B) "
                           "DEFINE B AS B.price > A.price + 10)")),
    "partitions": ([(1, 1, 1000), (2, 9, 1500), (1, 2, 2000), (2, 3, 2500)],
                   MR.format(sel="*", o="ts") + (
                       "MEASURES A.price AS a_p, B.price AS b_p PATTERN (A B) "
                       "DEFINE B AS B.price > A.price)")),
    "optional": ([(3, 1, 1000), (3, 5, 2000), (3, 2, 3000)],
                 MR.format(sel="*", o="ts") + (
                     "MEASURES A.price AS a_p, C.price AS c_p PATTERN "
                     "(A B? C) DEFINE A AS A.price < 2, B AS B.price > 4, "
                     "C AS C.price = 2)")),
    "projection": (V_SHAPE[:4], MR.format(sel="bottom_p, end_p - bottom_p",
                                          o="ts") + (
        "MEASURES LAST(B.price) AS bottom_p, C.price AS end_p PATTERN "
        "(A B+ C) DEFINE B AS B.price < A.price, C AS C.price > "
        "LAST(B.price))")),
    "within": ([(5, 10, 0), (5, 5, 100_000)], MR.format(sel="*", o="ts") + (
        "MEASURES A.price AS a_p, B.price AS b_p PATTERN (A B) WITHIN "
        "INTERVAL '10' SECOND DEFINE B AS B.price < A.price)")),
    "greedy": (GREEDY, MR.format(sel="*", o="ts") + (
        "MEASURES FIRST(B.price) AS first_b, LAST(B.price) AS last_b, "
        "C.price AS c_p PATTERN (A B+ C) DEFINE B AS B.price < 10, "
        "C AS C.price > 8)")),
    "skip_to_next_row": (GREEDY, MR.format(sel="*", o="ts") + (
        "MEASURES FIRST(B.price) AS first_b, LAST(B.price) AS last_b, "
        "C.price AS c_p AFTER MATCH SKIP TO NEXT ROW PATTERN (A B+ C) "
        "DEFINE B AS B.price < 10, C AS C.price > 8)")),
    "first_of_own": ([(1, 10, 1000), (1, 8, 2000), (1, 20, 3000),
                      (1, 5, 4000)], MR.format(sel="*", o="ts") + (
        "MEASURES FIRST(B.price) AS first_b, LAST(B.price) AS last_b "
        "PATTERN (A B+) DEFINE B AS B.price <= FIRST(B.price))")),
    "star_and_case": ([(4, 3, 1000), (4, 1, 2000), (4, 1, 3000),
                       (4, 7, 4000), (4, 2, 5000), (4, 9, 6000)],
                      MR.format(sel="*", o="ts") + (
        "MEASURES A.price AS a_p, CASE WHEN C.price > 8 THEN 1 ELSE 0 END "
        "AS big, -C.price AS neg ONE ROW PER MATCH PATTERN (A B* C) "
        "DEFINE B AS B.price < 2, C AS NOT C.price < A.price)")),
    "order_by_not_time": ([(1, 30, 1000), (1, 10, 2000), (1, 20, 3000)],
                          MR.format(sel="*", o="price") + (
        "MEASURES A.price AS a_p, B.price AS b_p PATTERN (A B) "
        "DEFINE B AS B.price > A.price)")),
    "unqualified_measure": (V_SHAPE[:4], MR.format(sel="*", o="ts") + (
        "MEASURES price AS p PATTERN (A B) DEFINE B AS B.price < A.price)")),
    "two_partition_columns": (V_SHAPE[:4], (
        "SELECT * FROM ticks MATCH_RECOGNIZE (PARTITION BY sym, price ORDER "
        "BY ts MEASURES A.price AS p PATTERN (A B) DEFINE B AS B.price > 0)")),
    "unknown_column": (V_SHAPE[:4], (
        "SELECT * FROM ticks MATCH_RECOGNIZE (PARTITION BY nope ORDER BY ts "
        "MEASURES A.price AS p PATTERN (A B) DEFINE B AS B.price > 0)")),
}


def test_reference_cases_give_equal_rows_and_errors():
    for name, (rows, sql) in CASES.items():
        ref, port = _run("ref", rows, sql), _run("port", rows, sql)
        assert ref == port, name
    # the cases that must give rows give some
    assert _run("port", V_SHAPE, CASES["v_shape"][1]) == [(1, 10, 6, 9)]
    assert _run("port", *CASES["order_by_not_time"])[0] == "error"


PARSE_ERRORS = [
    "SELECT * FROM t MATCH_RECOGNIZE (PARTITION BY k ORDER BY ts MEASURES "
    "A.v AS x PATTERN (A) DEFINE Z AS Z.v > 0)",
    "SELECT * FROM t MATCH_RECOGNIZE (PARTITION BY k ORDER BY ts MEASURES "
    "Z.price AS zp PATTERN (A B) DEFINE B AS B.price < A.price)",
    "SELECT * FROM t MATCH_RECOGNIZE (PARTITION BY k ORDER BY ts MEASURES "
    "A.v AS x PATTERN (A B) DEFINE B AS B.v > Z.v)",
    "SELECT * FROM t MATCH_RECOGNIZE (PARTITION BY k ORDER BY ts MEASURES "
    "A.v AS x AFTER MATCH SKIP TO LAST A PATTERN (A B) DEFINE B AS B.v > 0)",
    "SELECT * FROM t MATCH_RECOGNIZE (PARTITION BY k ORDER BY ts MEASURES "
    "A.v AS x PATTERN () DEFINE B AS B.v > 0)",
]


def test_parse_trees_and_parse_errors_equal():
    tree = CASES["v_shape"][1]
    assert repr(ref_sql.parse(tree)) == repr(port_sql.parse(tree))
    for sql in PARSE_ERRORS:
        got = []
        for mod in (ref_sql, port_sql):
            with pytest.raises(mod.SqlError) as e:
                mod.parse(sql)
            got.append(str(e.value))
        assert got[0] == got[1], sql


SMALL_A = {"ticks": 1 << 12, "symbols": 1 << 6, "batch": 1 << 9}


def _ticks_view(side: str, cs, c: dict):
    make, rec, wm, sqlmod = SIDES[side]
    env = make()
    env.config.set("pipeline.micro-batch-size", c["batch"])
    if side == "ref":
        env.set_state_backend("tpu")
    t = sqlmod.TableEnvironment(env)
    schema = rec.Schema(list(cs.TICK_FIELDS))
    ws = wm.WatermarkStrategy.for_monotonous_timestamps() \
        .with_timestamp_column("ts")
    t.create_temporary_view("ticks", env.datagen(
        cs.mr_ticks(c), schema, count=c["ticks"], timestamp_column="ts",
        watermark_strategy=ws), schema)
    return t


def test_part_a_group_by_and_its_scan_oracle_equal_the_reference():
    cs = _smoke()
    c = dict(cs.PATTERNS["mr"], **SMALL_A)
    got = {}
    for side in SIDES:
        t = _ticks_view(side, cs, c)
        matches = sorted(tuple(int(v) for v in r) for r in
                         t.execute_sql(cs.MR_MATCHES_SQL).collect_final())
        t = _ticks_view(side, cs, c)
        groups = sorted(tuple(int(v) for v in r) for r in
                        t.execute_sql(cs.MR_GROUP_SQL).collect_final())
        got[side] = (matches, groups)
    assert got["ref"] == got["port"]
    scan = cs.mr_scan(c)
    assert got["ref"][0] == scan and len(scan) > 100
    assert got["ref"][1] == sorted((s, *v)
                                   for s, v in cs.mr_groups(scan).items())


def test_part_a_runs_on_the_port_against_the_scan(monkeypatch):
    import torch

    cs = _smoke()
    # the smoke's memory records are the card's
    cs.fresh_memory = lambda torch: {}
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    out = cs.patterns_mr(torch, torch.device("cpu"), SMALL_A)
    assert out["matches"] > 100 and out["groups"] == SMALL_A["symbols"]
    assert set(out["documented_forms_refused"]) == set(cs.MR_DOC_FORMS)
