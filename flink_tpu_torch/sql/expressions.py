"""SQL expression AST + vectorized compiler (copy of
``flink_tpu/sql/expressions.py``).

The analog of the reference planner's Janino expression codegen
(flink-table-planner codegen/ExprCodeGenerator et al.): instead of emitting
Java source per query, every scalar expression compiles to a closure over
whole columns — ``fn(cols: dict[str, np.ndarray], n: int) -> np.ndarray`` —
so one call evaluates the expression for an entire micro-batch of numpy
columns.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import numpy as np

__all__ = [
    "Expr", "Column", "Literal", "BinaryOp", "UnaryOp", "FuncCall", "Cast",
    "CaseWhen", "Star", "AggCall", "compile_expr", "collect_columns",
    "collect_aggs", "rewrite_expr", "ExprError",
]


def rewrite_expr(e: "Expr", fn) -> "Expr":
    """Bottom-up structural rewrite: apply ``fn`` to every node after its
    children have been rewritten (the planner's column-resolution hook)."""
    if isinstance(e, BinaryOp):
        e = BinaryOp(e.op, rewrite_expr(e.left, fn), rewrite_expr(e.right, fn))
    elif isinstance(e, UnaryOp):
        e = UnaryOp(e.op, rewrite_expr(e.operand, fn))
    elif isinstance(e, FuncCall):
        e = FuncCall(e.name, tuple(rewrite_expr(a, fn) for a in e.args))
    elif isinstance(e, Cast):
        e = Cast(rewrite_expr(e.operand, fn), e.type_name)
    elif isinstance(e, CaseWhen):
        e = CaseWhen(tuple((rewrite_expr(c, fn), rewrite_expr(v, fn))
                           for c, v in e.branches),
                     rewrite_expr(e.default, fn)
                     if e.default is not None else None)
    elif isinstance(e, AggCall):
        e = AggCall(e.kind,
                    rewrite_expr(e.arg, fn) if e.arg is not None else None,
                    e.distinct)
    return fn(e)


class ExprError(ValueError):
    pass


@dataclass(frozen=True)
class Expr:
    pass


@dataclass(frozen=True)
class Column(Expr):
    name: str
    table: Optional[str] = None  # qualifier (alias) for multi-table queries


@dataclass(frozen=True)
class Literal(Expr):
    value: Any


@dataclass(frozen=True)
class BinaryOp(Expr):
    op: str
    left: Expr
    right: Expr


@dataclass(frozen=True)
class UnaryOp(Expr):
    op: str          # "-" | "NOT"
    operand: Expr


@dataclass(frozen=True)
class FuncCall(Expr):
    name: str
    args: tuple


@dataclass(frozen=True)
class Cast(Expr):
    operand: Expr
    type_name: str


@dataclass(frozen=True)
class CaseWhen(Expr):
    branches: tuple      # ((cond, value), ...)
    default: Optional[Expr]


@dataclass(frozen=True)
class Star(Expr):
    pass


@dataclass(frozen=True)
class AggCall(Expr):
    """Aggregate call site (SUM/COUNT/MIN/MAX/AVG). ``arg`` is None for
    COUNT(*). The planner hoists these out of select/having expressions;
    they never reach compile_expr."""
    kind: str
    arg: Optional[Expr]
    distinct: bool = False


_BINOPS: dict[str, Callable] = {
    "+": np.add, "-": np.subtract, "*": np.multiply,
    "/": np.divide, "%": np.mod,
    "=": np.equal, "<>": np.not_equal, "!=": np.not_equal,
    "<": np.less, "<=": np.less_equal,
    ">": np.greater, ">=": np.greater_equal,
    "AND": np.logical_and, "OR": np.logical_or,
}

_CAST_TYPES = {
    "INT": np.int64, "INTEGER": np.int64, "BIGINT": np.int64,
    "FLOAT": np.float64, "DOUBLE": np.float64,
    "BOOLEAN": np.bool_, "VARCHAR": object, "STRING": object,
}


def _vec_str(fn: Callable) -> Callable:
    u = np.frompyfunc(fn, 1, 1)

    def apply(x):
        return u(x.astype(object) if x.dtype != object else x)
    return apply


_FUNCS: dict[str, Callable] = {
    "ABS": lambda a: np.abs(a),
    "MOD": lambda a, b: np.mod(a, b),
    "FLOOR": lambda a: np.floor(a),
    "CEIL": lambda a: np.ceil(a),
    "CEILING": lambda a: np.ceil(a),
    "SQRT": lambda a: np.sqrt(a),
    "POWER": lambda a, b: np.power(a, b),
    "LN": lambda a: np.log(a),
    "EXP": lambda a: np.exp(a),
    "ROUND": lambda a, *d: np.round(a, int(d[0][0]) if d else 0),
    "GREATEST": lambda *a: np.maximum.reduce(list(a)),
    "LEAST": lambda *a: np.minimum.reduce(list(a)),
    "LOWER": _vec_str(lambda s: s.lower()),
    "UPPER": _vec_str(lambda s: s.upper()),
    "CHAR_LENGTH": _vec_str(len),
    "CONCAT": lambda *a: np.frompyfunc(
        lambda *xs: "".join(str(x) for x in xs), len(a), 1)(*a),
    "COALESCE": lambda *a: _coalesce(*a),
}


def _coalesce(*arrays):
    out = np.array(arrays[0], dtype=object, copy=True)
    for arr in arrays[1:]:
        missing = np.array([v is None for v in out], dtype=bool)
        if not missing.any():
            break
        out[missing] = np.asarray(arr, dtype=object)[missing]
    return out


def collect_columns(e: Expr, out: set[str]) -> None:
    """All column names referenced by ``e`` (including inside aggregates)."""
    if isinstance(e, Column):
        out.add(e.name)
    elif isinstance(e, BinaryOp):
        collect_columns(e.left, out)
        collect_columns(e.right, out)
    elif isinstance(e, UnaryOp):
        collect_columns(e.operand, out)
    elif isinstance(e, FuncCall):
        for a in e.args:
            collect_columns(a, out)
    elif isinstance(e, Cast):
        collect_columns(e.operand, out)
    elif isinstance(e, CaseWhen):
        for c, v in e.branches:
            collect_columns(c, out)
            collect_columns(v, out)
        if e.default is not None:
            collect_columns(e.default, out)
    elif isinstance(e, AggCall) and e.arg is not None:
        collect_columns(e.arg, out)


def collect_aggs(e: Expr, out: list[AggCall]) -> None:
    """All AggCall nodes in ``e`` in evaluation order (dedup by identity of
    the (kind, arg) pair so SUM(x)+SUM(x) shares one accumulator)."""
    if isinstance(e, AggCall):
        if e not in out:
            out.append(e)
    elif isinstance(e, BinaryOp):
        collect_aggs(e.left, out)
        collect_aggs(e.right, out)
    elif isinstance(e, UnaryOp):
        collect_aggs(e.operand, out)
    elif isinstance(e, FuncCall):
        for a in e.args:
            collect_aggs(a, out)
    elif isinstance(e, Cast):
        collect_aggs(e.operand, out)
    elif isinstance(e, CaseWhen):
        for c, v in e.branches:
            collect_aggs(c, out)
            collect_aggs(v, out)
        if e.default is not None:
            collect_aggs(e.default, out)


def compile_expr(e: Expr, agg_slots: Optional[dict] = None) -> Callable:
    """Expr -> fn(cols, n) -> np.ndarray.

    ``agg_slots`` maps AggCall -> column name; the planner uses it to
    compile post-aggregation expressions (select items over agg results)
    where each aggregate has been materialized as a column.
    """
    if isinstance(e, AggCall):
        if agg_slots is None or e not in agg_slots:
            raise ExprError(f"aggregate {e.kind} not allowed here")
        slot = agg_slots[e]
        return lambda cols, n: cols[slot]
    if isinstance(e, Column):
        name = e.name
        def col(cols, n):
            if name not in cols:
                raise ExprError(f"unknown column {name!r}")
            return cols[name]
        return col
    if isinstance(e, Literal):
        v = e.value
        def lit(cols, n):
            if isinstance(v, bool):
                return np.full(n, v, dtype=np.bool_)
            if isinstance(v, int):
                return np.full(n, v, dtype=np.int64)
            if isinstance(v, float):
                return np.full(n, v, dtype=np.float64)
            if v is None:
                return np.full(n, None, dtype=object)
            return np.full(n, v, dtype=object)
        return lit
    if isinstance(e, BinaryOp):
        fn = _BINOPS.get(e.op)
        if fn is None:
            raise ExprError(f"unsupported operator {e.op!r}")
        lf = compile_expr(e.left, agg_slots)
        rf = compile_expr(e.right, agg_slots)
        op = e.op
        def bin_(cols, n):
            a, b = lf(cols, n), rf(cols, n)
            if op in ("=", "<>", "!=") and (a.dtype == object
                                            or b.dtype == object):
                return (np.asarray(a, object) == np.asarray(b, object)
                        if op == "=" else
                        np.asarray(a, object) != np.asarray(b, object))
            return fn(a, b)
        return bin_
    if isinstance(e, UnaryOp):
        of = compile_expr(e.operand, agg_slots)
        if e.op == "-":
            return lambda cols, n: np.negative(of(cols, n))
        if e.op == "NOT":
            return lambda cols, n: np.logical_not(of(cols, n))
        raise ExprError(f"unsupported unary {e.op!r}")
    if isinstance(e, FuncCall):
        fn = _FUNCS.get(e.name)
        if fn is None:
            raise ExprError(f"unknown function {e.name!r}")
        arg_fns = [compile_expr(a, agg_slots) for a in e.args]
        return lambda cols, n: fn(*(f(cols, n) for f in arg_fns))
    if isinstance(e, Cast):
        of = compile_expr(e.operand, agg_slots)
        ty = _CAST_TYPES.get(e.type_name.upper())
        if ty is None:
            raise ExprError(f"unknown cast type {e.type_name!r}")
        if ty is object:
            return lambda cols, n: np.array(
                [str(v) for v in of(cols, n)], dtype=object)
        return lambda cols, n: of(cols, n).astype(ty)
    if isinstance(e, CaseWhen):
        branch_fns = [(compile_expr(c, agg_slots), compile_expr(v, agg_slots))
                      for c, v in e.branches]
        default_fn = (compile_expr(e.default, agg_slots)
                      if e.default is not None else None)
        def case(cols, n):
            vals = [vf(cols, n) for _, vf in branch_fns]
            default = (default_fn(cols, n) if default_fn is not None
                       else np.zeros(n, dtype=np.asarray(vals[0]).dtype))
            out = np.array(default, copy=True)
            taken = np.zeros(n, dtype=bool)
            for (cf, _), val in zip(branch_fns, vals):
                cond = cf(cols, n).astype(bool) & ~taken
                out[cond] = np.asarray(val)[cond] if np.ndim(val) else val
                taken |= cond
            return out
        return case
    raise ExprError(f"cannot compile {e!r}")
