"""MATCH_RECOGNIZE onto the CEP NFA (port of
``flink_tpu/sql/match_recognize.py``).

Flink lowers the SQL:2016 clause to its CEP operator (StreamExecMatch ->
CepOperator); so does this module, onto ``cep/pattern.py`` and
``cep/operator.py``:

* each PATTERN variable is a stage with strict contiguity (a row pattern
  runs over consecutive rows of a partition); ``+`` and ``*`` are loops
  with strict inner contiguity, ``?`` an optional stage;
* a DEFINE is the stage's condition; one that names another variable
  (``B.v > A.v``) or FIRST of its own needs the partial's history and
  lowers to ``where_with_history``;
* MEASURES are evaluated over the finished match: ``FIRST(X.c)``,
  ``LAST(X.c)``, ``X.c`` (= LAST) and arithmetic; the output is the
  partition column and the measures;
* greediness: the NFA explores every take and proceed, and holds each
  start row's longest match back (``greedy_per_start``); AFTER MATCH
  SKIP PAST LAST ROW is its SKIP_PAST_LAST_EVENT, SKIP TO NEXT ROW its
  SKIP_TO_NEXT_ROW.

Expressions are evaluated a row at a time: a match is a handful of rows,
and pattern matching is sequential.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np

from ..cep import Pattern, PatternStream
from ..cep.nfa import SKIP_PAST_LAST_EVENT, SKIP_TO_NEXT_ROW
from ..core.records import Schema
from .expressions import BinaryOp, CaseWhen, Column, Expr, FuncCall, \
    Literal, UnaryOp
from .parser import MatchRecognize, SqlError

__all__ = ["plan_match_recognize"]

_COMPARE = {
    "=": lambda a, b: a == b, "<>": lambda a, b: a != b,
    "!=": lambda a, b: a != b, "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b, ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "+": lambda a, b: a + b, "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b if b else None,
    "%": lambda a, b: a % b if b else None,
    "AND": lambda a, b: bool(a) and bool(b),
    "OR": lambda a, b: bool(a) or bool(b),
}


def _raise(msg: str):
    raise SqlError(msg)


def _compile(e: Expr) -> Callable:
    """``e`` as a function of ``resolve(variable or None, column, "last" |
    "first")``, built once. It evaluates as the reference's interpreter
    does: both sides of an operator always, SQL's unknown (None) through
    any operator, and a construct it cannot evaluate raises when
    evaluated, not before."""
    if isinstance(e, Literal):
        v = e.value
        return lambda r: v
    if isinstance(e, Column):
        qual, name = e.table, e.name
        return lambda r: r(qual, name, "last")
    if isinstance(e, BinaryOp):
        lf, rf = _compile(e.left), _compile(e.right)
        op = e.op.upper()
        fn = _COMPARE.get(op)

        def binop(r):
            a, b = lf(r), rf(r)
            if a is None or b is None:
                return None
            if fn is None:
                _raise(f"MATCH_RECOGNIZE: unsupported operator {op!r}")
            return fn(a, b)
        return binop
    if isinstance(e, UnaryOp):
        f, op = _compile(e.operand), e.op

        def unary(r):
            v = f(r)
            if v is None:
                return None
            if op.upper() == "NOT":
                return not v
            if op == "-":
                return -v
            _raise(f"MATCH_RECOGNIZE: unary {op!r} unsupported")
        return unary
    if isinstance(e, FuncCall):
        fname = e.name.upper()
        if fname not in ("FIRST", "LAST"):
            return lambda r: _raise(f"MATCH_RECOGNIZE: function {fname!r} "
                                    "unsupported (FIRST/LAST)")
        if len(e.args) != 1 or not isinstance(e.args[0], Column) \
                or e.args[0].table is None:
            return lambda r: _raise(f"{fname}() takes one VAR.column "
                                    "argument")
        qual, name, mode = e.args[0].table, e.args[0].name, fname.lower()
        return lambda r: r(qual, name, mode)
    if isinstance(e, CaseWhen):
        branches = [(_compile(c), _compile(t)) for c, t in e.branches]
        default = None if e.default is None else _compile(e.default)

        def case(r):
            for cond, then in branches:
                if cond(r):
                    return then(r)
            return None if default is None else default(r)
        return case
    kind = type(e).__name__
    return lambda r: _raise(f"MATCH_RECOGNIZE: unsupported expression {kind}")


def _define_predicate(var: str, expr: Expr):
    """DEFINE var AS expr -> a condition of (event, history)."""
    ev = _compile(expr)

    def pred(event: dict, by_name: dict) -> bool:
        def resolve(qual: Optional[str], col: str, mode: str):
            if qual is None or qual == var:
                # the current row is provisionally var's: LAST(var) is
                # the row, FIRST(var) the first captured one (else the row)
                if mode == "first":
                    events = by_name.get(var)
                    if events:
                        return events[0].get(col)
                return event.get(col)
            events = by_name.get(qual)
            if not events:
                return None          # nothing captured yet: unknown
            return (events[0] if mode == "first" else events[-1]).get(col)

        return bool(ev(resolve))

    return pred


def _uses_history(var: str, e: Expr) -> bool:
    if isinstance(e, Column):
        return e.table is not None and e.table != var
    if isinstance(e, BinaryOp):
        return _uses_history(var, e.left) or _uses_history(var, e.right)
    if isinstance(e, UnaryOp):
        return _uses_history(var, e.operand)
    if isinstance(e, FuncCall):
        if e.name.upper() == "FIRST":
            return True    # FIRST of the variable itself reads the captured
        return any(_uses_history(var, a) for a in e.args)
    if isinstance(e, CaseWhen):
        return (any(_uses_history(var, c) or _uses_history(var, t)
                    for c, t in e.branches)
                or (e.default is not None
                    and _uses_history(var, e.default)))
    return False


def _measure_fn(measures: list, partition_by: list):
    """A match -> the partition values and the measures."""
    evs = [_compile(expr) for expr, _alias in measures]

    def compute(match) -> tuple:
        events = match.events if hasattr(match, "events") else match

        def resolve(qual: Optional[str], col: str, mode: str):
            if qual is None:
                raise SqlError(
                    f"MEASURES column {col!r} must be qualified with a "
                    f"pattern variable (e.g. A.{col})")
            rows = events.get(qual)
            if not rows:
                return None
            return (rows[0] if mode == "first" else rows[-1]).get(col)

        first_rows = next((v for v in events.values() if v), None)
        out = [first_rows[0].get(col) if first_rows else None
               for col in partition_by]
        out.extend(ev(resolve) for ev in evs)
        return tuple(out)

    return compute


def _build_pattern(mr: MatchRecognize) -> Pattern:
    pat: Optional[Pattern] = None
    for var, quant in mr.pattern:
        # the first stage may start at any row; the rest are consecutive
        pat = Pattern.begin(var) if pat is None else pat.next(var)
        if quant == "+":
            # not .greedy(): without backtracking a greedy loop would eat
            # the row the next variable needs; greedy_per_start picks the
            # longest match instead
            pat.one_or_more().consecutive()
        elif quant == "*":
            pat.times_or_more(0).optional().consecutive()
        elif quant == "?":
            pat.optional()
        define = mr.defines.get(var)
        if define is None:
            continue                 # no DEFINE: any row
        pred = _define_predicate(var, define)
        if _uses_history(var, define):
            pat.where_with_history(pred)
        else:
            pat.where(lambda e, _p=pred: _p(e, {}))
    if mr.within_ms is not None:
        pat.within(mr.within_ms)
    return pat


def plan_match_recognize(mr: MatchRecognize, stream, in_schema: Schema,
                         env):
    """The clause on ``stream``; returns the derived stream with
    ``_sql_schema`` = the partition column and the measures."""
    for col in mr.partition_by + [mr.order_by]:
        if col not in in_schema:
            raise SqlError(f"MATCH_RECOGNIZE: column {col!r} not in input "
                           f"schema {list(in_schema.names)}")
    if not mr.partition_by:
        raise SqlError("MATCH_RECOGNIZE needs PARTITION BY (the keyed "
                       "contract of the CEP operator)")
    if len(mr.partition_by) > 1:
        raise SqlError("MATCH_RECOGNIZE supports one PARTITION BY column")
    out_fields = [(c, in_schema.field(c).dtype) for c in mr.partition_by]
    for expr, alias in mr.measures:
        # a measure of one column keeps its dtype; arithmetic is float64
        dtype: Any = np.float64
        base = expr.args[0] if isinstance(expr, FuncCall) and expr.args \
            else expr
        if isinstance(base, Column) and base.name in in_schema:
            dtype = in_schema.field(base.name).dtype
        out_fields.append((alias, dtype))
    out_schema = Schema(out_fields)
    skip = (SKIP_PAST_LAST_EVENT if mr.after_match == "SKIP PAST LAST ROW"
            else SKIP_TO_NEXT_ROW)
    ps = PatternStream(stream, _build_pattern(mr), mr.partition_by[0],
                       skip_strategy=skip, greedy_per_start=True,
                       order_column=mr.order_by)
    out = ps.select(_measure_fn(mr.measures, mr.partition_by), out_schema)
    out._sql_schema = out_schema
    return out
