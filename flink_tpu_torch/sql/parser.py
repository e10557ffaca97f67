"""SQL parser: tokenizer + recursive descent over the streaming subset
(copy of ``flink_tpu/sql/parser.py``; the planner of the port refuses the
joins and MATCH_RECOGNIZE it parses).

The analog of the reference's Calcite/JavaCC dialect (flink-sql-parser) for
the surface the planner supports:

    SELECT items FROM table_ref [WHERE e] [GROUP BY e, ...] [HAVING e]
        [ORDER BY e [ASC|DESC], ...] [LIMIT n]

``table_ref`` is a table name, a windowing TVF over one —
``TUMBLE(TABLE t, DESCRIPTOR(ts_col), INTERVAL '5' SECOND)`` /
``HOP(TABLE t, DESCRIPTOR(ts_col), INTERVAL slide, INTERVAL size)``
(FLIP-145 window TVFs; reference SqlWindowTableFunction) — or a
parenthesized subquery. Aggregates: COUNT(*)/COUNT/SUM/MIN/MAX/AVG
[DISTINCT]. No external parser dependency: the grammar is small enough that
a hand-rolled LL(1) parser is clearer than bundling a generator.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Union

from .expressions import (
    AggCall, BinaryOp, Cast, CaseWhen, Column, Expr, FuncCall, Literal, Star,
    UnaryOp,
)

__all__ = ["parse", "SelectStmt", "TableRef", "JoinClause", "WindowTVF",
           "MatchRecognize",
           "OrderItem", "SelectItem", "SqlError"]

_AGG_FUNCS = {"COUNT", "SUM", "MIN", "MAX", "AVG"}

_UNITS_MS = {
    "MILLISECOND": 1, "SECOND": 1000, "MINUTE": 60_000, "HOUR": 3_600_000,
    "DAY": 86_400_000,
}


class SqlError(ValueError):
    pass


@dataclass
class SelectItem:
    expr: Expr
    alias: Optional[str] = None


@dataclass
class TableRef:
    name: str
    alias: Optional[str] = None


@dataclass
class JoinClause:
    """FROM a JOIN b ON cond (reference SqlJoin). ``kind`` in
    INNER|LEFT|RIGHT|FULL; multi-way joins left-nest.
    ``temporal_time`` set => ``b FOR SYSTEM_TIME AS OF <expr>``: b is a
    versioned table and the join picks the version valid at the left
    row's time (reference SqlSnapshot -> StreamExecTemporalJoin)."""

    kind: str
    left: "FromClause"
    right: "FromClause"
    on: Expr
    temporal_time: Optional[Expr] = None


@dataclass
class WindowTVF:
    kind: str                   # "TUMBLE" | "HOP" | "CUMULATE"
    table: "FromClause"
    time_col: str
    size_ms: int
    slide_ms: Optional[int] = None   # HOP slide / CUMULATE step


@dataclass
class MatchRecognize:
    """MATCH_RECOGNIZE over a table (reference flink-table match-recognize
    -> flink-cep lowering; SQL:2016 row pattern recognition)."""

    table: "TableRef"
    partition_by: list          # [column name]
    order_by: str               # time attribute column
    measures: list              # [(Expr, alias)]
    pattern: list               # [(var, quantifier)] quantifier in
                                # {"", "+", "*", "?"} or (min, max|None)
    defines: dict               # var -> Expr
    after_match: str = "SKIP PAST LAST ROW"
    within_ms: Optional[int] = None
    alias: Optional[str] = None


@dataclass
class OrderItem:
    expr: Expr
    descending: bool = False


@dataclass
class SelectStmt:
    items: list
    from_: "FromClause"
    where: Optional[Expr] = None
    group_by: list = field(default_factory=list)
    having: Optional[Expr] = None
    order_by: list = field(default_factory=list)
    limit: Optional[int] = None
    alias: Optional[str] = None  # derived-table alias: (SELECT ...) s


FromClause = Union[TableRef, WindowTVF, SelectStmt, "JoinClause",
                   "MatchRecognize"]


_TOKEN_RE = re.compile(r"""
    \s*(?:
      (?P<num>\d+\.\d+|\d+)
    | (?P<str>'(?:[^']|'')*')
    | (?P<id>[A-Za-z_][A-Za-z_0-9]*)
    | (?P<op><=|>=|<>|!=|=|<|>|\(|\)|,|\*|\+|-|/|%|\.|\?)
    )""", re.VERBOSE)


def _tokenize(sql: str) -> list[tuple[str, str]]:
    tokens: list[tuple[str, str]] = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            if sql[pos:].strip() == "" or sql[pos] == ";":
                break
            raise SqlError(f"cannot tokenize at: {sql[pos:pos+20]!r}")
        pos = m.end()
        if m.lastgroup == "num":
            tokens.append(("num", m.group("num")))
        elif m.lastgroup == "str":
            tokens.append(("str", m.group("str")[1:-1].replace("''", "'")))
        elif m.lastgroup == "id":
            tokens.append(("id", m.group("id")))
        else:
            tokens.append(("op", m.group("op")))
    tokens.append(("eof", ""))
    return tokens


class _Parser:
    def __init__(self, sql: str):
        self.toks = _tokenize(sql)
        self.i = 0

    # -- token helpers -----------------------------------------------------
    def peek(self) -> tuple[str, str]:
        return self.toks[self.i]

    def next(self) -> tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        k, v = self.peek()
        return k == "id" and v.upper() in kws

    def eat_kw(self, kw: str) -> bool:
        if self.at_kw(kw):
            self.next()
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        if not self.eat_kw(kw):
            raise SqlError(f"expected {kw}, got {self.peek()[1]!r}")

    def eat_op(self, op: str) -> bool:
        k, v = self.peek()
        if k == "op" and v == op:
            self.next()
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.eat_op(op):
            raise SqlError(f"expected {op!r}, got {self.peek()[1]!r}")

    # -- grammar -----------------------------------------------------------
    def parse_select(self) -> SelectStmt:
        self.expect_kw("SELECT")
        items = [self.select_item()]
        while self.eat_op(","):
            items.append(self.select_item())
        self.expect_kw("FROM")
        from_ = self.from_clause()
        stmt = SelectStmt(items, from_)
        if self.eat_kw("WHERE"):
            stmt.where = self.expr()
        if self.eat_kw("GROUP"):
            self.expect_kw("BY")
            stmt.group_by = [self.expr()]
            while self.eat_op(","):
                stmt.group_by.append(self.expr())
        if self.eat_kw("HAVING"):
            stmt.having = self.expr()
        if self.eat_kw("ORDER"):
            self.expect_kw("BY")
            stmt.order_by = [self.order_item()]
            while self.eat_op(","):
                stmt.order_by.append(self.order_item())
        if self.eat_kw("LIMIT"):
            k, v = self.next()
            if k != "num":
                raise SqlError("LIMIT expects a number")
            stmt.limit = int(v)
        return stmt

    def select_item(self) -> SelectItem:
        if self.eat_op("*"):
            return SelectItem(Star())
        e = self.expr()
        alias = None
        if self.eat_kw("AS"):
            k, v = self.next()
            if k != "id":
                raise SqlError("expected alias after AS")
            alias = v
        elif self.peek()[0] == "id" and not self.at_kw(
                "FROM", "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT"):
            alias = self.next()[1]
        return SelectItem(e, alias)

    def order_item(self) -> OrderItem:
        e = self.expr()
        desc = False
        if self.eat_kw("DESC"):
            desc = True
        else:
            self.eat_kw("ASC")
        return OrderItem(e, desc)

    def from_clause(self) -> FromClause:
        left = self.from_primary()
        while True:
            kind = None
            if self.at_kw("JOIN"):
                kind = "INNER"
            elif self.at_kw("INNER"):
                self.next()
                kind = "INNER"
            elif self.at_kw("LEFT", "RIGHT", "FULL"):
                kind = self.next()[1].upper()
                self.eat_kw("OUTER")
            else:
                return left
            self.expect_kw("JOIN")
            right = self.from_primary()
            temporal_time = None
            if self.eat_kw("FOR"):
                # b FOR SYSTEM_TIME AS OF l.rowtime [AS alias]
                self.expect_kw("SYSTEM_TIME")
                self.expect_kw("AS")
                self.expect_kw("OF")
                temporal_time = self.expr()
                alias = self.maybe_alias()
                if alias is not None:
                    if isinstance(right, TableRef):
                        right.alias = alias
                    else:
                        raise SqlError(
                            "FOR SYSTEM_TIME alias requires a plain table")
            self.expect_kw("ON")
            cond = self.expr()
            left = JoinClause(kind, left, right, cond,
                              temporal_time=temporal_time)

    def from_primary(self) -> FromClause:
        if self.eat_op("("):
            inner = self.from_clause_inner()
            self.expect_op(")")
            alias = self.maybe_alias()
            if alias is not None and isinstance(inner, (TableRef, SelectStmt)):
                inner.alias = alias
            return inner
        k, v = self.peek()
        if k == "id" and v.upper() in ("TUMBLE", "HOP", "CUMULATE",
                               "SESSION"):
            return self.window_tvf()
        if k != "id":
            raise SqlError(f"expected table name, got {v!r}")
        self.next()
        if self.at_kw("MATCH_RECOGNIZE"):
            return self.match_recognize(TableRef(v))
        return TableRef(v, self.maybe_alias())

    def from_clause_inner(self) -> FromClause:
        if self.at_kw("SELECT"):
            return self.parse_select()
        if self.at_kw("TUMBLE", "HOP", "CUMULATE", "SESSION"):
            return self.window_tvf()
        if self.at_kw("TABLE"):
            self.next()
            k, v = self.next()
            if k != "id":
                raise SqlError("expected table name after TABLE")
            return TableRef(v)
        k, v = self.next()
        if k != "id":
            raise SqlError(f"expected table reference, got {v!r}")
        return TableRef(v)

    def maybe_alias(self) -> Optional[str]:
        if self.eat_kw("AS"):
            return self.next()[1]
        if (self.peek()[0] == "id"
                and not self.at_kw("WHERE", "GROUP", "HAVING", "ORDER",
                                   "LIMIT", "ON", "JOIN", "INNER", "LEFT",
                                   "RIGHT", "FULL", "OUTER", "FOR")):
            return self.next()[1]
        return None

    def window_tvf(self) -> WindowTVF:
        kind = self.next()[1].upper()
        self.expect_op("(")
        self.expect_kw("TABLE")
        k, tname = self.next()
        if k != "id":
            raise SqlError("expected table name after TABLE")
        self.expect_op(",")
        self.expect_kw("DESCRIPTOR")
        self.expect_op("(")
        k, time_col = self.next()
        if k != "id":
            raise SqlError("expected column in DESCRIPTOR")
        self.expect_op(")")
        self.expect_op(",")
        first = self.interval()
        slide = None
        size = first
        if self.eat_op(","):
            second = self.interval()
            slide, size = first, second
        self.expect_op(")")
        self.maybe_alias()
        if kind in ("TUMBLE", "SESSION"):
            if slide is not None:
                raise SqlError(
                    f"{kind} takes exactly one INTERVAL "
                    f"({'the gap' if kind == 'SESSION' else 'the size'}); "
                    "two intervals are HOP/CUMULATE syntax")
            # SESSION's single interval is the gap (reference SESSION TVF)
            return WindowTVF(kind, TableRef(tname), time_col, size)
        if slide is None:
            raise SqlError(
                f"{kind} takes two INTERVALs "
                f"({'slide, size' if kind == 'HOP' else 'step, size'})")
        return WindowTVF(kind, TableRef(tname), time_col, size, slide)

    def match_recognize(self, table: TableRef) -> MatchRecognize:
        """MATCH_RECOGNIZE ( PARTITION BY col ORDER BY col MEASURES ...
        [ONE ROW PER MATCH] [AFTER MATCH SKIP ...] PATTERN (A B+ C)
        [WITHIN INTERVAL ...] DEFINE var AS expr, ... )"""
        self.expect_kw("MATCH_RECOGNIZE")
        self.expect_op("(")
        partition_by: list[str] = []
        if self.eat_kw("PARTITION"):
            self.expect_kw("BY")
            partition_by.append(self._ident("PARTITION BY column"))
            while self.eat_op(","):
                partition_by.append(self._ident("PARTITION BY column"))
        self.expect_kw("ORDER")
        self.expect_kw("BY")
        order_by = self._ident("ORDER BY column")
        self.expect_kw("MEASURES")
        measures = [self._measure()]
        while self.eat_op(","):
            measures.append(self._measure())
        if self.eat_kw("ONE"):
            self.expect_kw("ROW")
            self.expect_kw("PER")
            self.expect_kw("MATCH")
        after = "SKIP PAST LAST ROW"
        if self.eat_kw("AFTER"):
            self.expect_kw("MATCH")
            self.expect_kw("SKIP")
            if self.eat_kw("PAST"):
                self.expect_kw("LAST")
                self.expect_kw("ROW")
            elif self.eat_kw("TO"):
                self.expect_kw("NEXT")
                self.expect_kw("ROW")
                after = "SKIP TO NEXT ROW"
            else:
                raise SqlError("AFTER MATCH SKIP supports PAST LAST ROW "
                               "and TO NEXT ROW")
        self.expect_kw("PATTERN")
        self.expect_op("(")
        pattern: list[tuple[str, Any]] = []
        while not self.eat_op(")"):
            var = self._ident("pattern variable")
            quant: Any = ""
            if self.eat_op("+"):
                quant = "+"
            elif self.eat_op("*"):
                quant = "*"
            elif self.eat_op("?"):
                quant = "?"
            pattern.append((var, quant))
        if not pattern:
            raise SqlError("empty PATTERN")
        within_ms = None
        if self.eat_kw("WITHIN"):
            within_ms = self.interval()
        self.expect_kw("DEFINE")
        defines: dict[str, Expr] = {}
        var = self._ident("DEFINE variable")
        self.expect_kw("AS")
        defines[var] = self.expr()
        while self.eat_op(","):
            var = self._ident("DEFINE variable")
            self.expect_kw("AS")
            defines[var] = self.expr()
        self.expect_op(")")
        alias = self.maybe_alias()
        known = {v for v, _ in pattern}
        for var in defines:
            if var not in known:
                raise SqlError(f"DEFINE references unknown pattern "
                               f"variable {var!r} (pattern: {sorted(known)})")

        def check_vars(e) -> None:
            if isinstance(e, Column) and e.table is not None \
                    and e.table not in known:
                raise SqlError(
                    f"MEASURES/DEFINE references unknown pattern variable "
                    f"{e.table!r} (pattern: {sorted(known)})")
            for attr in ("left", "right", "operand"):
                sub = getattr(e, attr, None)
                if sub is not None:
                    check_vars(sub)
            for sub in getattr(e, "args", ()) or ():
                check_vars(sub)
            for c, t in getattr(e, "branches", ()) or ():
                check_vars(c)
                check_vars(t)
            default = getattr(e, "default", None)
            if default is not None:
                check_vars(default)

        for m_expr, _alias in measures:
            check_vars(m_expr)
        for d_expr in defines.values():
            check_vars(d_expr)
        return MatchRecognize(table, partition_by, order_by, measures,
                              pattern, defines, after, within_ms, alias)

    def _ident(self, what: str) -> str:
        k, v = self.next()
        if k != "id":
            raise SqlError(f"expected {what}, got {v!r}")
        return v

    def _measure(self) -> tuple:
        e = self.expr()
        self.expect_kw("AS")
        return (e, self._ident("measure alias"))

    def interval(self) -> int:
        self.expect_kw("INTERVAL")
        k, v = self.next()
        if k == "str":
            amount = float(v)
        elif k == "num":
            amount = float(v)
        else:
            raise SqlError("INTERVAL expects a quoted number")
        k, unit = self.next()
        if k != "id" or unit.upper().rstrip("S") not in _UNITS_MS:
            raise SqlError(f"unknown interval unit {unit!r}")
        return int(amount * _UNITS_MS[unit.upper().rstrip("S")])

    # -- expressions (precedence: OR < AND < NOT < cmp < add < mul < unary)
    def expr(self) -> Expr:
        return self.or_expr()

    def or_expr(self) -> Expr:
        e = self.and_expr()
        while self.at_kw("OR"):
            self.next()
            e = BinaryOp("OR", e, self.and_expr())
        return e

    def and_expr(self) -> Expr:
        e = self.not_expr()
        while self.at_kw("AND"):
            self.next()
            e = BinaryOp("AND", e, self.not_expr())
        return e

    def not_expr(self) -> Expr:
        if self.at_kw("NOT"):
            self.next()
            return UnaryOp("NOT", self.not_expr())
        return self.cmp_expr()

    def cmp_expr(self) -> Expr:
        e = self.add_expr()
        if self.at_kw("BETWEEN"):
            self.next()
            lo = self.add_expr()
            self.expect_kw("AND")
            hi = self.add_expr()
            return BinaryOp("AND", BinaryOp(">=", e, lo),
                            BinaryOp("<=", e, hi))
        if self.at_kw("IN"):
            self.next()
            self.expect_op("(")
            opts = [self.expr()]
            while self.eat_op(","):
                opts.append(self.expr())
            self.expect_op(")")
            out: Expr = BinaryOp("=", e, opts[0])
            for o in opts[1:]:
                out = BinaryOp("OR", out, BinaryOp("=", e, o))
            return out
        k, v = self.peek()
        if k == "op" and v in ("=", "<>", "!=", "<", "<=", ">", ">="):
            self.next()
            return BinaryOp(v, e, self.add_expr())
        return e

    def add_expr(self) -> Expr:
        e = self.mul_expr()
        while True:
            k, v = self.peek()
            if k == "op" and v in ("+", "-"):
                self.next()
                e = BinaryOp(v, e, self.mul_expr())
            else:
                return e

    def mul_expr(self) -> Expr:
        e = self.unary_expr()
        while True:
            k, v = self.peek()
            if k == "op" and v in ("*", "/", "%"):
                self.next()
                e = BinaryOp(v, e, self.unary_expr())
            else:
                return e

    def unary_expr(self) -> Expr:
        if self.eat_op("-"):
            return UnaryOp("-", self.unary_expr())
        self.eat_op("+")
        return self.primary()

    def primary(self) -> Expr:
        k, v = self.peek()
        if k == "num":
            self.next()
            return Literal(float(v) if "." in v else int(v))
        if k == "str":
            self.next()
            return Literal(v)
        if self.eat_op("("):
            e = self.expr()
            self.expect_op(")")
            return e
        if k != "id":
            raise SqlError(f"unexpected token {v!r}")
        upper = v.upper()
        if upper == "CASE":
            return self.case_when()
        if upper == "CAST":
            self.next()
            self.expect_op("(")
            inner = self.expr()
            self.expect_kw("AS")
            tk, tv = self.next()
            if tk != "id":
                raise SqlError("expected type after CAST(expr AS")
            self.expect_op(")")
            return Cast(inner, tv)
        if upper == "TRUE":
            self.next()
            return Literal(True)
        if upper == "FALSE":
            self.next()
            return Literal(False)
        if upper == "NULL":
            self.next()
            return Literal(None)
        self.next()
        # function call?
        if self.eat_op("("):
            if upper in _AGG_FUNCS:
                distinct = self.eat_kw("DISTINCT")
                if self.eat_op("*"):
                    self.expect_op(")")
                    return AggCall("count", None, distinct)
                arg = self.expr()
                self.expect_op(")")
                return AggCall(upper.lower(), arg, distinct)
            args: list[Expr] = []
            if not self.eat_op(")"):
                args.append(self.expr())
                while self.eat_op(","):
                    args.append(self.expr())
                self.expect_op(")")
            return FuncCall(upper, tuple(args))
        # qualified name t.col: carry the qualifier for join resolution
        if self.eat_op("."):
            ck, cv = self.next()
            if ck != "id":
                raise SqlError("expected column after '.'")
            return Column(cv, table=v)
        return Column(v)

    def case_when(self) -> Expr:
        self.expect_kw("CASE")
        branches = []
        while self.eat_kw("WHEN"):
            cond = self.expr()
            self.expect_kw("THEN")
            branches.append((cond, self.expr()))
        default = self.expr() if self.eat_kw("ELSE") else None
        self.expect_kw("END")
        if not branches:
            raise SqlError("CASE needs at least one WHEN")
        return CaseWhen(tuple(branches), default)


def parse(sql: str) -> SelectStmt:
    p = _Parser(sql)
    stmt = p.parse_select()
    if p.peek()[0] != "eof":
        raise SqlError(f"trailing tokens at {p.peek()[1]!r}")
    return stmt
