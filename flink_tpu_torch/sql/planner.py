"""SQL planner: SelectStmt -> DataStream pipeline (trimmed port of
``flink_tpu/sql/planner.py``).

The analog of the reference's planner + codegen chain (flink-table-planner
delegation/PlannerBase.scala:170 translate -> ExecNode graph -> Janino
codegen), collapsed: "codegen" here is compiling expressions to vectorized
column closures (expressions.compile_expr) and picking operators —

* stateless SELECT/WHERE      -> one BatchFnOperator (fused by chaining,
  reference StreamExecCalc)
* GROUP BY window_start/end over a window TVF
                              -> keyBy + window aggregation, lowered to the
  device slice-window operator when eligible (reference
  StreamExecWindowAggregate -> SliceSharedWindowAggProcessor)
* plain GROUP BY              -> GroupAggOperator changelog aggregation
  (reference StreamExecGroupAggregate -> GroupAggFunction)
* ORDER BY <agg> DESC LIMIT n over a changelog -> host TopN operator
  (reference StreamExecRank)
* JOIN ... ON a.x = b.y       -> key both sides, connect, and a
  StreamingJoinOperator (inner, left, right, full; changelog out, residual
  conjuncts of an inner join as a filter after it); b FOR SYSTEM_TIME AS
  OF l.ts -> TemporalJoinOperator (reference StreamExecJoin /
  StreamExecTemporalJoin). A GROUP BY over a join's changelog carries its
  rowkind column and retracts.

Aggregate inputs and group keys are materialized as generated columns
(``__agg0__``, ...) by a projection ahead of the exchange, which is what the
two-phase local/global split needs (reference StreamExecLocalGroupAggregate).

The routes follow the environment's ``state.backend.type`` as the
reference's do: under ``tpu`` (the default) integer-keyed GROUP BY goes
to ``DeviceGroupAggOperator``, TUMBLE/HOP and SESSION windows with one
integer key to the device window operators; CUMULATE windows, other keys
and the ``hashmap`` backend take the host WindowOperator
(``_host_window_agg``). Joins plan as the reference plans them (host
operators); MATCH_RECOGNIZE lowers onto the CEP operator
(``sql/match_recognize.py``), whose rows a GROUP BY above it takes on its
host-batch route.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from ..api.datastream import DataStream
from ..core.config import SqlOptions
from ..core.functions import AggregateFunction
from ..core.records import RecordBatch, Schema
from ..runtime.operators.device_window import AggSpec as DevAggSpec
from ..runtime.operators.simple import BatchFnOperator
from ..window.assigners import (
    CumulateWindows, EventTimeSessionWindows, SlidingEventTimeWindows,
    TumblingEventTimeWindows,
)
from . import rowkind as rk
from .device_group_agg import DeviceGroupAggOperator, combine_key_columns
from .expressions import (
    AggCall, BinaryOp, Column, Expr, Star, collect_aggs, collect_columns,
    compile_expr, rewrite_expr,
)
from .group_agg import GroupAggOperator, LocalGroupAggOperator, SqlAggSpec
from .join import StreamingJoinOperator, TemporalJoinOperator
from .match_recognize import plan_match_recognize
from .parser import JoinClause, MatchRecognize, SelectItem, SelectStmt, \
    TableRef, WindowTVF
from .topn import TopNOperator

__all__ = ["plan", "PlanError"]

WINDOW_COLS = ("window_start", "window_end")


class PlanError(ValueError):
    pass


def _device_backend(env) -> bool:
    """The reference's ``state.backend.type == "tpu"`` test."""
    return getattr(env, "state_backend", None) == "tpu"


def plan(stmt: SelectStmt, resolve_table, env) -> DataStream:
    """Translate ``stmt`` onto DataStream ops. ``resolve_table(name)``
    returns the registered catalog entry's (DataStream, Schema)."""
    return _Planner(resolve_table, env).plan_select(stmt)


class _Planner:
    def __init__(self, resolve_table, env):
        self.resolve = resolve_table
        self.env = env

    # -- FROM --------------------------------------------------------------
    def plan_from(self, from_) -> tuple[
            DataStream, Schema, Optional[WindowTVF], dict]:
        """Returns (stream, schema, window_tvf, qualifiers) where
        ``qualifiers`` maps table alias -> {original column -> current
        column name in the stream's schema} for qualified-name resolution."""
        if isinstance(from_, TableRef):
            ds, schema = self.resolve(from_.name)
            alias = from_.alias or from_.name
            quals = {alias: {f.name: f.name for f in schema.fields}}
            return ds, schema, None, quals
        if isinstance(from_, WindowTVF):
            ds, schema, inner_tvf, quals = self.plan_from(from_.table)
            if inner_tvf is not None:
                raise PlanError("nested window TVFs are not supported")
            if from_.time_col not in schema:
                raise PlanError(
                    f"DESCRIPTOR column {from_.time_col!r} not in table")
            return ds, schema, from_, quals
        if isinstance(from_, SelectStmt):
            sub = self.plan_select(from_)
            if sub._sql_schema is None:
                raise PlanError("subquery output schema unknown")
            quals = ({from_.alias: {f.name: f.name
                                    for f in sub._sql_schema.fields}}
                     if from_.alias else {})
            return sub, sub._sql_schema, None, quals
        if isinstance(from_, JoinClause):
            return self.plan_join(from_)
        if isinstance(from_, MatchRecognize):
            ds, schema = self.resolve(from_.table.name)
            out = plan_match_recognize(from_, ds, schema, self.env)
            quals = ({from_.alias: {f.name: f.name
                                    for f in out._sql_schema.fields}}
                     if from_.alias else {})
            return out, out._sql_schema, None, quals
        raise PlanError(f"unsupported FROM clause {from_!r}")

    # -- JOIN --------------------------------------------------------------
    def plan_join(self, jc: JoinClause) -> tuple[
            DataStream, Schema, None, dict]:
        """Equi-join of two streams (reference StreamExecJoin ->
        StreamingJoinOperator): key both sides by the equi columns, connect
        through a two-input vertex; residual (non-equi) conjuncts become a
        post-join filter (inner only). Columns colliding across sides are
        renamed ``{alias}_{name}``; the other side's numeric fields are
        promoted to float64 when nullable (outer joins pad with NaN/None)."""
        lds, lschema, ltvf, lq = self.plan_from(jc.left)
        rds, rschema, rtvf, rq = self.plan_from(jc.right)
        if ltvf is not None or rtvf is not None:
            raise PlanError("window TVFs cannot be direct join inputs; wrap "
                            "the windowed aggregation in a subquery")
        dup = set(lq) & set(rq)
        if dup:
            raise PlanError(
                f"duplicate table alias(es) in join: {sorted(dup)}")
        join_type = {"INNER": "inner", "LEFT": "left", "RIGHT": "right",
                     "FULL": "full"}[jc.kind]

        lnames = [f.name for f in lschema.fields
                  if f.name != rk.ROWKIND_COLUMN]
        rnames = [f.name for f in rschema.fields
                  if f.name != rk.ROWKIND_COLUMN]
        lprefix = next(iter(lq)) if len(lq) == 1 else "l"
        rprefix = next(iter(rq)) if len(rq) == 1 else "r"
        out_l = {n: n if n not in set(rnames) else f"{lprefix}_{n}"
                 for n in lnames}
        out_r = {n: n if n not in set(lnames) else f"{rprefix}_{n}"
                 for n in rnames}
        if set(out_l.values()) & set(out_r.values()):
            raise PlanError("join column renaming collision; add aliases")

        # resolve one ON-condition column to (side, renamed name)
        def resolve_on(c: Column) -> tuple[str, str]:
            if c.table is not None:
                if c.table in lq and c.name in lq[c.table]:
                    return "l", out_l[lq[c.table][c.name]]
                if c.table in rq and c.name in rq[c.table]:
                    return "r", out_r[rq[c.table][c.name]]
                raise PlanError(f"cannot resolve {c.table}.{c.name} in ON")
            in_l, in_r = c.name in out_l, c.name in out_r
            if in_l and in_r:
                raise PlanError(f"ambiguous column {c.name!r} in ON")
            if in_l:
                return "l", out_l[c.name]
            if in_r:
                return "r", out_r[c.name]
            raise PlanError(f"unknown column {c.name!r} in ON")

        equi: list[tuple[str, str]] = []   # (left col, right col), renamed
        residual: list[Expr] = []
        for conj in _conjuncts(jc.on):
            if (isinstance(conj, BinaryOp) and conj.op == "="
                    and isinstance(conj.left, Column)
                    and isinstance(conj.right, Column)):
                s1, n1 = resolve_on(conj.left)
                s2, n2 = resolve_on(conj.right)
                if s1 != s2:
                    equi.append((n1, n2) if s1 == "l" else (n2, n1))
                    continue
            residual.append(conj)
        if not equi:
            raise PlanError("streaming join needs at least one equi "
                            "condition a.x = b.y")
        if residual and join_type != "inner":
            raise PlanError("non-equi ON conditions are only supported for "
                            "INNER joins")

        l_nullable = join_type in ("right", "full")
        r_nullable = join_type in ("left", "full")
        renamed_l = self._rename_side(lds, lschema, out_l, "JoinLeftRename")
        renamed_r = self._rename_side(rds, rschema, out_r, "JoinRightRename")

        out_fields = (
            [(out_l[n], _nullable_dtype(lschema.field(n).dtype, l_nullable))
             for n in lnames]
            + [(out_r[n], _nullable_dtype(rschema.field(n).dtype, r_nullable))
               for n in rnames]
            + [(rk.ROWKIND_COLUMN, np.int8)])
        out_schema = Schema(out_fields)

        lkey_names = [p[0] for p in equi]
        rkey_names = [p[1] for p in equi]
        lkey_idx = (lnames.index(_orig(out_l, lkey_names[0]))
                    if len(equi) == 1
                    else tuple(lnames.index(_orig(out_l, n))
                               for n in lkey_names))
        rkey_idx = (rnames.index(_orig(out_r, rkey_names[0]))
                    if len(equi) == 1
                    else tuple(rnames.index(_orig(out_r, n))
                               for n in rkey_names))

        lkeyed = (renamed_l.key_by(lkey_names[0]) if len(equi) == 1
                  else renamed_l.key_by(
                      lambda row, _i=lkey_idx: tuple(row[i] for i in _i)))
        rkeyed = (renamed_r.key_by(rkey_names[0]) if len(equi) == 1
                  else renamed_r.key_by(
                      lambda row, _i=rkey_idx: tuple(row[i] for i in _i)))

        n_l, n_r = len(lnames), len(rnames)
        jt = join_type
        if jc.temporal_time is not None:
            # b FOR SYSTEM_TIME AS OF l.rowtime: versioned-table join
            # (reference StreamExecTemporalJoin.java:77). Event time rides
            # the record timestamps; the AS OF column must name the left
            # side's time attribute (documenting which side is probed).
            if join_type not in ("inner", "left"):
                raise PlanError(
                    "temporal join supports INNER and LEFT JOIN only")
            tcol = jc.temporal_time
            if not isinstance(tcol, Column):
                raise PlanError("FOR SYSTEM_TIME AS OF expects a column")
            # the time attribute is the stream's out-of-band record
            # timestamp, so the AS OF column need not be a data column —
            # but its qualifier must name the LEFT (probe) side
            on_left = (tcol.table in lq if tcol.table is not None
                       else tcol.name in out_l)
            if not on_left:
                raise PlanError(
                    "FOR SYSTEM_TIME AS OF must reference the left "
                    "(probe) side's time attribute")
            joined = lkeyed.connect(rkeyed).transform(
                "TemporalJoin",
                lambda: TemporalJoinOperator(jt, lkey_idx, rkey_idx,
                                             out_schema, n_l, n_r))
        else:
            joined = lkeyed.connect(rkeyed).transform(
                "Join",
                lambda: StreamingJoinOperator(jt, lkey_idx, rkey_idx,
                                              out_schema, n_l, n_r))
        if residual:
            cond = residual[0]
            for c in residual[1:]:
                cond = BinaryOp("AND", cond, c)
            cond = rewrite_expr(cond, lambda e: (
                Column(resolve_on(e)[1]) if isinstance(e, Column) else e))
            cond_fn = compile_expr(cond)

            def filt(batch: RecordBatch):
                mask = cond_fn(dict(batch.columns), batch.n).astype(bool)
                idx = np.flatnonzero(mask)
                return batch.take(idx)

            joined = joined.transform(
                "JoinFilter", lambda: BatchFnOperator(filt, "JoinFilter"))

        quals: dict = {}
        for q, m in lq.items():
            quals[q] = {orig: out_l[cur] for orig, cur in m.items()
                        if cur in out_l}
        for q, m in rq.items():
            quals[q] = {orig: out_r[cur] for orig, cur in m.items()
                        if cur in out_r}
        joined._sql_schema = out_schema
        return joined, out_schema, None, quals

    def _rename_side(self, ds: DataStream, schema: Schema,
                     rename: dict, name: str) -> DataStream:
        if all(k == v for k, v in rename.items()):
            return ds
        out_fields = [(rename.get(f.name, f.name), f.dtype)
                      for f in schema.fields]
        out_schema = Schema(out_fields)

        def project(batch: RecordBatch):
            cols = {rename.get(f.name, f.name): batch.column(f.name)
                    for f in batch.schema.fields}
            return RecordBatch(out_schema, cols, batch.timestamps)

        return ds.transform(name, lambda: BatchFnOperator(project, name))

    # -- SELECT ------------------------------------------------------------
    def plan_select(self, stmt: SelectStmt) -> DataStream:
        ds, schema, tvf, quals = self.plan_from(stmt.from_)
        stmt = _resolve_stmt(stmt, schema, quals)

        # hoist aggregates from select items + having
        agg_calls: list[AggCall] = []
        for item in stmt.items:
            if not isinstance(item.expr, Star):
                collect_aggs(item.expr, agg_calls)
        if stmt.having is not None:
            collect_aggs(stmt.having, agg_calls)

        if tvf is not None or stmt.group_by or agg_calls:
            out = self.plan_aggregate(stmt, ds, schema, tvf, agg_calls)
        else:
            out = self.plan_calc(stmt, ds, schema)
        out = self.plan_order_limit(stmt, out)
        return out

    # -- stateless calc (project + filter) ---------------------------------
    def plan_calc(self, stmt: SelectStmt, ds: DataStream,
                  schema: Schema) -> DataStream:
        where_fn = (compile_expr(stmt.where)
                    if stmt.where is not None else None)
        out_fields, item_fns = self._select_fns(stmt.items, schema)
        # changelog input: pass the rowkind column through so downstream
        # changelog consumers (TopN, sinks) keep retraction semantics
        if (rk.ROWKIND_COLUMN in schema
                and not any(n == rk.ROWKIND_COLUMN for n, _ in out_fields)):
            out_fields = out_fields + [(rk.ROWKIND_COLUMN, np.int8)]
            item_fns = item_fns + [(rk.ROWKIND_COLUMN,
                                    lambda cols, n: cols[rk.ROWKIND_COLUMN])]
        out_schema = Schema(out_fields)

        def calc(batch: RecordBatch) -> Optional[RecordBatch]:
            cols, n = dict(batch.columns), batch.n
            ts = batch.timestamps
            if where_fn is not None:
                mask = where_fn(cols, n).astype(bool)
                if not mask.all():
                    idx = np.flatnonzero(mask)
                    cols = {k: v[idx] for k, v in cols.items()}
                    ts = ts[idx]
                    n = len(idx)
            out_cols = {name: np.asarray(fn(cols, n))
                        for name, fn in item_fns}
            return RecordBatch(out_schema, out_cols, ts)

        out = ds.transform("Calc", lambda: BatchFnOperator(calc, "Calc"))
        out._sql_schema = out_schema
        return out

    def _select_fns(self, items, schema: Schema,
                    agg_slots: Optional[dict] = None):
        """[(out_name, fn)] + schema fields for the select list."""
        out_fields: list[tuple[str, Any]] = []
        fns: list[tuple[str, Any]] = []
        for i, item in enumerate(items):
            if isinstance(item.expr, Star):
                for f in schema.fields:
                    name = f.name
                    fns.append((name,
                                (lambda nm: lambda cols, n: cols[nm])(name)))
                    out_fields.append((name, f.dtype))
                continue
            name = item.alias or _default_name(item.expr, i)
            fn = compile_expr(item.expr, agg_slots)
            fns.append((name, fn))
            out_fields.append((name, _infer_dtype(item.expr, schema)))
        return out_fields, fns

    # -- aggregation -------------------------------------------------------
    def plan_aggregate(self, stmt: SelectStmt, ds: DataStream, schema: Schema,
                       tvf: Optional[WindowTVF],
                       agg_calls: list[AggCall]) -> DataStream:
        group_exprs = list(stmt.group_by)
        window_group = []
        if tvf is not None:
            window_group = [g for g in group_exprs
                            if isinstance(g, Column)
                            and g.name in WINDOW_COLS]
            group_exprs = [g for g in group_exprs
                           if not (isinstance(g, Column)
                                   and g.name in WINDOW_COLS)]
            if len(window_group) == 0:
                raise PlanError(
                    "window TVF queries must GROUP BY window_start/"
                    "window_end")

        # project: key columns + agg input columns (+ time for windows)
        key_names: list[str] = []
        key_fns = []
        for i, g in enumerate(group_exprs):
            if isinstance(g, Column):
                key_names.append(g.name)
                key_fns.append(None)
            else:
                key_names.append(f"__key{i}__")
                key_fns.append(compile_expr(g))
        agg_specs: list[SqlAggSpec] = []
        agg_in_fns = []
        for i, call in enumerate(agg_calls):
            if call.arg is None:
                agg_specs.append(SqlAggSpec("count", None, f"__out{i}__"))
                agg_in_fns.append(None)
            else:
                in_name = (call.arg.name if isinstance(call.arg, Column)
                           else f"__agg{i}__")
                agg_specs.append(SqlAggSpec(call.kind, in_name,
                                            f"__out{i}__", call.distinct))
                agg_in_fns.append(None if isinstance(call.arg, Column)
                                  else compile_expr(call.arg))

        where_fn = (compile_expr(stmt.where)
                    if stmt.where is not None else None)
        time_col = tvf.time_col if tvf is not None else None
        pre_fields: list[tuple[str, Any]] = []
        for name, g in zip(key_names, group_exprs):
            pre_fields.append(
                (name, schema.field(name).dtype if name in schema
                 else _infer_dtype(g, schema)))
        for spec, call in zip(agg_specs, agg_calls):
            if spec.field is not None:
                pre_fields.append(
                    (spec.field, schema.field(spec.field).dtype
                     if spec.field in schema
                     else _infer_dtype(call.arg, schema)))
        # changelog input (e.g. aggregating over a join's output): carry the
        # rowkind column so GroupAggOperator retracts correctly
        changelog_in = rk.ROWKIND_COLUMN in schema
        if changelog_in:
            if tvf is not None:
                raise PlanError(
                    "window aggregation over a changelog (updating) input "
                    "is not supported; aggregate before the window or use "
                    "an append-only input")
            pre_fields.append((rk.ROWKIND_COLUMN, np.int8))
        seen = set()
        pre_fields = [(n, d) for n, d in pre_fields
                      if not (n in seen or seen.add(n))]
        if not pre_fields:
            # global COUNT(*) reads no input columns; a unit column keeps
            # the batch's row count flowing through the exchange
            pre_fields = [("__rows__", np.int8)]
        pre_schema = Schema(pre_fields)

        def pre_project(batch: RecordBatch) -> Optional[RecordBatch]:
            cols, n = dict(batch.columns), batch.n
            ts = batch.timestamps
            if time_col is not None:
                ts = cols[time_col].astype(np.int64)
            if where_fn is not None:
                mask = where_fn(cols, n).astype(bool)
                idx = np.flatnonzero(mask)
                cols = {k: v[idx] for k, v in cols.items()}
                ts = ts[idx]
                n = len(idx)
            for name, fn in zip(key_names, key_fns):
                if fn is not None:
                    cols[name] = np.asarray(fn(cols, n))
            for spec, fn in zip(agg_specs, agg_in_fns):
                if fn is not None:
                    cols[spec.field] = np.asarray(fn(cols, n))
            out_cols = {f.name: cols[f.name] for f in pre_schema.fields
                        if f.name in cols}
            if "__rows__" in pre_schema and "__rows__" not in out_cols:
                out_cols["__rows__"] = np.zeros(n, np.int8)
            return RecordBatch(pre_schema, out_cols, ts)

        projected = ds.transform(
            "PreProject", lambda: BatchFnOperator(pre_project, "PreProject"))

        if tvf is not None:
            agged, agg_schema = self._window_agg(
                projected, pre_schema, tvf, key_names, agg_specs)
        else:
            agged, agg_schema = self._group_agg(
                projected, pre_schema, key_names, agg_specs)

        return self._post_project(stmt, agged, agg_schema, group_exprs,
                                  key_names, agg_calls, agg_specs,
                                  window=tvf is not None)

    def _group_agg(self, ds: DataStream, pre_schema: Schema,
                   key_names: list[str], agg_specs: list[SqlAggSpec]):
        # two-phase split (reference StreamExecLocalGroupAggregate /
        # StreamExecGlobalGroupAggregate): a stateless local combine runs
        # BEFORE the keyed exchange on each upstream subtask, so the
        # exchange carries one partial row per distinct key per
        # micro-batch; the global operator merges partials into state
        two_phase = self.env.config.get(SqlOptions.TWO_PHASE_AGG)
        is_global = not key_names
        if is_global:
            # global aggregation: single pseudo key
            key_names = ["__global__"]

            def add_global(batch: RecordBatch):
                cols = dict(batch.columns)
                cols["__global__"] = np.zeros(batch.n, np.int64)
                schema = Schema([("__global__", np.int64)]
                                + [(f.name, f.dtype)
                                   for f in batch.schema.fields])
                return RecordBatch(schema, cols, batch.timestamps)

            ds = ds.transform(
                "GlobalKey", lambda: BatchFnOperator(add_global, "GlobalKey"))
        specs = list(agg_specs)
        names = list(key_names)
        # device lowering: with integer group keys the changelog
        # aggregation runs on device accumulator planes, one group
        # aggregation step per micro-batch (reference hot loop:
        # GroupAggFunction.processElement:125). The device fold already
        # pre-aggregates the whole batch, so the two-phase local combine
        # is redundant and skipped.

        def _int_key(n: str) -> bool:
            if is_global:
                return True  # synthesized __global__ key is int64
            f = pre_schema.field(n)
            return (f.dtype is not object
                    and np.issubdtype(np.dtype(f.dtype), np.integer))

        # changelog input + MIN/MAX => the retract-exact count-map path
        # (host only, single phase): the local combine and the device fold
        # both reduce extrema lossily (MinWithRetractAggFunction analog)
        retract_mm = (rk.ROWKIND_COLUMN in pre_schema
                      and any(s.kind in ("min", "max") for s in specs))
        if retract_mm:
            two_phase = False
        use_device = (_device_backend(self.env)
                      and all(_int_key(n) for n in key_names)
                      and all(not s.distinct for s in specs)
                      and not retract_mm)
        if two_phase and not use_device:
            ds = ds.transform(
                "LocalGroupAggregate",
                lambda: LocalGroupAggOperator(names, specs))
        if is_global:
            keyed = ds.key_by(lambda row: 0)
        elif len(key_names) == 1:
            keyed = ds.key_by(key_names[0])
        elif use_device:
            # route by the SAME combined int64 word the device backend
            # stores: its snapshots place keys by hash_batch of the
            # combined word, so the exchange must hash that word too, or a
            # restore at parallelism > 1 would put a group's state on a
            # subtask that never receives its records
            def _combined(batch, _names=tuple(key_names)):
                return combine_key_columns(
                    [np.asarray(batch.column(n)) for n in _names])
            _combined.vectorized = True
            keyed = ds.key_by(_combined)
        else:
            # the local combine keeps key columns first in ITS output
            key_idx = (tuple(range(len(key_names)))
                       if two_phase
                       else tuple(pre_schema.index_of(n)
                                  for n in key_names))
            keyed = ds.key_by(
                lambda row, _idx=key_idx: tuple(row[i] for i in _idx))
        if use_device:
            device = self.env.device
            out = keyed._one_input(
                "GroupAggregate(device)",
                lambda: DeviceGroupAggOperator(names, specs, device=device),
                key_extractor=keyed.key_extractor)
        else:
            out = keyed._one_input(
                "GroupAggregate",
                lambda: GroupAggOperator(
                    names, specs, partial_input=two_phase,
                    retract_minmax=retract_mm),
                key_extractor=keyed.key_extractor)
        out_schema = Schema(
            [(n, np.float64 if n.startswith("__key") else object)
             for n in key_names]
            + [(s.out_name, np.float64) for s in agg_specs]
            + [(rk.ROWKIND_COLUMN, np.int8)])
        return out, out_schema

    def _window_agg(self, ds: DataStream, pre_schema: Schema,
                    tvf: WindowTVF, key_names: list[str],
                    agg_specs: list[SqlAggSpec]):
        if len(key_names) != 1:
            raise PlanError(
                "window aggregation currently needs exactly one non-window "
                "group key (matches the Nexmark shapes); got "
                f"{key_names or 'none'}")
        if tvf.kind == "TUMBLE":
            assigner = TumblingEventTimeWindows.of(tvf.size_ms)
        elif tvf.kind == "HOP":
            assigner = SlidingEventTimeWindows.of(tvf.size_ms, tvf.slide_ms)
        elif tvf.kind == "CUMULATE":
            # parser: CUMULATE(..., INTERVAL step, INTERVAL size)
            assigner = CumulateWindows.of(tvf.size_ms, tvf.slide_ms)
        elif tvf.kind == "SESSION":
            assigner = EventTimeSessionWindows.with_gap(tvf.size_ms)
        else:
            raise PlanError(f"{tvf.kind} windows not supported yet")
        key_field = pre_schema.field(key_names[0])
        use_device = (_device_backend(self.env)
                      and tvf.kind in ("TUMBLE", "HOP", "SESSION")
                      and key_field.dtype is not object
                      and np.issubdtype(np.dtype(key_field.dtype),
                                        np.integer)
                      and (tvf.kind == "SESSION"
                           or assigner.pane_size is not None))
        windowed = ds.key_by(key_names[0]).window(assigner)
        out_schema = Schema(
            [(key_names[0], key_field.dtype),
             ("window_start", np.int64), ("window_end", np.int64)]
            + [(s.out_name, np.float64) for s in agg_specs])
        if use_device:
            dev_specs = [DevAggSpec(s.kind, s.field, out_name=s.out_name)
                         for s in agg_specs]
            out = windowed.device_aggregate(dev_specs,
                                            name="WindowAggregate")
        else:
            out = self._host_window_agg(windowed, pre_schema, agg_specs,
                                        out_schema)
        return out, out_schema

    def _host_window_agg(self, windowed, pre_schema: Schema,
                         agg_specs: list[SqlAggSpec], out_schema: Schema):
        """The aggregates on the host WindowOperator: one composite
        accumulator a (key, window), rows (key, window_start, window_end,
        *results)."""
        agg = _CompositeAggregate(pre_schema, agg_specs)

        def window_fn(key, window, result):
            yield (key, window.start, window.end) + tuple(result)

        return windowed._build("WindowAggregate", aggregate=agg,
                               window_fn=window_fn, out_schema=out_schema)

    # -- post-aggregation projection --------------------------------------
    def _post_project(self, stmt: SelectStmt, ds: DataStream,
                      agg_schema: Schema, group_exprs, key_names,
                      agg_calls, agg_specs, window: bool) -> DataStream:
        agg_slots = {call: spec.out_name
                     for call, spec in zip(agg_calls, agg_specs)}
        # group-by expressions are addressable by their key column name
        rewrites: dict[Expr, str] = {}
        for g, name in zip(group_exprs, key_names):
            rewrites[g] = name

        def rewrite(e: Expr) -> Expr:
            if e in rewrites:
                return Column(rewrites[e])
            return e

        items = [type(it)(rewrite(it.expr), it.alias) if not
                 isinstance(it.expr, Star) else it for it in stmt.items]
        having_fn = None
        if stmt.having is not None:
            having_fn = compile_expr(rewrite(stmt.having), agg_slots)
        out_fields, item_fns = self._select_fns(items, agg_schema, agg_slots)
        has_rowkind = rk.ROWKIND_COLUMN in agg_schema
        if has_rowkind and not any(n == rk.ROWKIND_COLUMN
                                   for n, _ in out_fields):
            out_fields = out_fields + [(rk.ROWKIND_COLUMN, np.int8)]
            item_fns = item_fns + [(rk.ROWKIND_COLUMN,
                                    lambda cols, n: cols[rk.ROWKIND_COLUMN])]
        out_schema = Schema(out_fields)

        def post(batch: RecordBatch) -> Optional[RecordBatch]:
            cols, n = dict(batch.columns), batch.n
            ts = batch.timestamps
            if having_fn is not None:
                mask = having_fn(cols, n).astype(bool)
                idx = np.flatnonzero(mask)
                cols = {k: v[idx] for k, v in cols.items()}
                ts = ts[idx]
                n = len(idx)
            out_cols = {name: np.asarray(fn(cols, n))
                        for name, fn in item_fns}
            return RecordBatch(out_schema, out_cols, ts)

        out = ds.transform("PostProject",
                           lambda: BatchFnOperator(post, "PostProject"))
        out._sql_schema = out_schema
        return out

    # -- ORDER BY / LIMIT --------------------------------------------------
    def plan_order_limit(self, stmt: SelectStmt,
                         ds: DataStream) -> DataStream:
        if not stmt.order_by and stmt.limit is None:
            return ds
        if not stmt.order_by:
            raise PlanError("LIMIT without ORDER BY is non-deterministic "
                            "on streams; add ORDER BY")
        schema = getattr(ds, "_sql_schema", None)
        if schema is None:
            raise PlanError("ORDER BY needs a known schema")
        # resolve order expressions against the select list: an expression
        # that IS a select item (e.g. ORDER BY SUM(v) with SUM(v) selected)
        # sorts by that item's output column
        out_names: dict[Expr, str] = {}
        for i, item in enumerate(stmt.items):
            if not isinstance(item.expr, Star):
                out_names[item.expr] = (item.alias
                                        or _default_name(item.expr, i))
        sort_fns = []
        for o in stmt.order_by:
            expr = o.expr
            if expr in out_names:
                expr = Column(out_names[expr])
            elif isinstance(expr, Column) and expr.name not in schema:
                raise PlanError(f"ORDER BY column {expr.name!r} is not in "
                                "the select list")
            sort_fns.append((compile_expr(expr), o.descending))
        limit = stmt.limit
        if limit is None:
            raise PlanError("streaming ORDER BY requires LIMIT (Top-N)")
        out = ds.global_().transform(
            "TopN",
            lambda: TopNOperator(schema, sort_fns, limit),
            parallelism=1)
        out._sql_schema = schema
        return out


def _conjuncts(e: Expr) -> list:
    if isinstance(e, BinaryOp) and e.op == "AND":
        return _conjuncts(e.left) + _conjuncts(e.right)
    return [e]


def _orig(rename: dict, renamed: str) -> str:
    for k, v in rename.items():
        if v == renamed:
            return k
    raise KeyError(renamed)


def _nullable_dtype(dtype, nullable: bool):
    """Outer-join null padding: integer/bool columns become float64 (NaN
    null), floats keep NaN, objects keep None."""
    if not nullable or dtype is object:
        return dtype
    if np.issubdtype(np.dtype(dtype), np.floating):
        return dtype
    return np.float64


def _resolve_stmt(stmt: SelectStmt, schema: Schema,
                  quals: dict) -> SelectStmt:
    """Rewrite qualified columns (a.x) to their current schema names and
    validate unqualified ones against the joined/renamed schema."""

    def resolve(e: Expr) -> Expr:
        if not isinstance(e, Column):
            return e
        if e.table is not None:
            m = quals.get(e.table)
            if m is None or e.name not in m:
                raise PlanError(
                    f"cannot resolve column {e.table}.{e.name}")
            return Column(m[e.name])
        if e.name in schema:
            return e
        hits = {m[e.name] for m in quals.values() if e.name in m}
        if len(hits) == 1:
            return Column(hits.pop())
        if len(hits) > 1:
            raise PlanError(f"ambiguous column {e.name!r}")
        return e  # window_start/window_end appear later; defer

    def rw(e: Expr) -> Expr:
        return rewrite_expr(e, resolve)

    out = SelectStmt(
        items=[it if isinstance(it.expr, Star)
               else SelectItem(rw(it.expr), it.alias) for it in stmt.items],
        from_=stmt.from_,
        where=rw(stmt.where) if stmt.where is not None else None,
        group_by=[rw(g) for g in stmt.group_by],
        having=rw(stmt.having) if stmt.having is not None else None,
        order_by=[type(o)(rw(o.expr), o.descending) for o in stmt.order_by],
        limit=stmt.limit)
    return out


def _default_name(e: Expr, i: int) -> str:
    if isinstance(e, Column):
        return e.name
    if isinstance(e, AggCall):
        return f"{e.kind}_{e.arg.name}" if isinstance(e.arg, Column) \
            else e.kind
    return f"EXPR{i}"


def _infer_dtype(e: Expr, schema: Schema):
    """Best-effort output dtype for a select expression."""
    if isinstance(e, Column) and e.name in schema:
        return schema.field(e.name).dtype
    if isinstance(e, AggCall):
        return np.float64
    cols: set[str] = set()
    collect_columns(e, cols)
    if cols and all(c in schema and schema.field(c).dtype is object
                    for c in cols):
        return object
    return np.float64


class _CompositeAggregate(AggregateFunction):
    """The SQL aggregates of one window as one accumulator (a list, one
    slot an aggregate): COUNT, SUM, AVG (sum, count), MIN and MAX."""

    def __init__(self, pre_schema: Schema, specs: list[SqlAggSpec]):
        self._idx = {f.name: i for i, f in enumerate(pre_schema.fields)}
        self._specs = list(specs)
        self._single = len(pre_schema) == 1

    def create_accumulator(self):
        return [(0.0, 0) if s.kind == "avg"
                else (0 if s.kind in ("count", "sum") else None)
                for s in self._specs]

    def add(self, value, acc):
        row = (value,) if self._single else value
        out = []
        for s, a in zip(self._specs, acc):
            v = None if s.field is None else row[self._idx[s.field]]
            if s.kind == "count":
                out.append(a + (1 if s.field is None else (v is not None)))
            elif s.kind == "sum":
                out.append(a + v)
            elif s.kind == "avg":
                out.append((a[0] + v, a[1] + 1))
            elif s.kind == "min":
                out.append(v if a is None else min(a, v))
            else:
                out.append(v if a is None else max(a, v))
        return out

    def merge(self, a, b):
        out = []
        for s, x, y in zip(self._specs, a, b):
            if s.kind in ("count", "sum"):
                out.append(x + y)
            elif s.kind == "avg":
                out.append((x[0] + y[0], x[1] + y[1]))
            elif x is None or y is None:
                out.append(y if x is None else x)
            else:
                out.append(min(x, y) if s.kind == "min" else max(x, y))
        return out

    def get_result(self, acc):
        return [(a[0] / a[1] if a[1] else 0.0) if s.kind == "avg" else a
                for s, a in zip(self._specs, acc)]
