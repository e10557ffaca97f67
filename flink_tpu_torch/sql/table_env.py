"""TableEnvironment: the SQL entry point (port of
``flink_tpu/sql/table_env.py``).

Analog of the reference's TableEnvironment
(flink-table-api-java internal/TableEnvironmentImpl.java:145 —
executeSql:727, executeInternal:839) fused with its
StreamTableEnvironment bridge (from_data_stream/to_data_stream/
to_changelog_stream): a catalog of named tables over DataStreams, a parser +
planner, and result collection.

A query runs on the environment's device (``cuda`` unless the environment
was made with ``device="cpu"``); a spec-backed query gets a fresh
environment with the same configuration and device. Results are kept as
the sink's columnar batches: ``collect`` builds the reference's Python
rows from them, and ``batches`` hands them over column by column.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from ..api.datastream import DataStream
from ..api.environment import StreamExecutionEnvironment
from ..connectors.core import CollectSink, Sink, SinkWriter
from ..core.config import Configuration
from ..core.functions import SinkFunction
from ..core.records import RecordBatch, Schema
from ..graph.stream_graph import build_job_graph, build_stream_graph
from ..runtime.operators.simple import BatchFnOperator
from . import rowkind as rk
from .ddl import (
    Catalog, CatalogTable, CreateTableStmt, CreateViewStmt, DescribeStmt,
    DropStmt, ExplainStmt, InsertStmt, ShowCreateStmt, ShowTablesStmt,
    ShowViewsStmt, dtype_to_sql_type, instantiate_sink, instantiate_source,
    parse_statement, sql_type_to_dtype,
)
from .parser import parse
from .planner import PlanError, plan

__all__ = ["TableEnvironment", "Table", "TableResult"]


class Table:
    """A named or derived table: a DataStream + schema pair."""

    def __init__(self, t_env: "TableEnvironment", stream: DataStream,
                 schema: Schema):
        self._t_env = t_env
        self.stream = stream
        self.schema = schema

    def to_data_stream(self) -> DataStream:
        return self.stream

    def execute(self, timeout: Optional[float] = 120.0) -> "TableResult":
        return self._t_env._execute_table(self, timeout)


class TableResult:
    """Materialized query result (reference TableResult#collect): given
    rows, or the columnar batches a query's sink collected."""

    def __init__(self, schema: Schema, rows: Optional[list] = None,
                 batches: Optional[list] = None):
        self.schema = schema
        self._batches = batches
        self._row_cache = rows

    @property
    def _rows(self) -> list:
        if self._row_cache is None:
            self._row_cache = [r for b in self._batches
                               for r in b.iter_rows()]
        return self._row_cache

    def batches(self) -> list[RecordBatch]:
        """The result as RecordBatches in arrival order."""
        if self._batches is None:
            return ([RecordBatch.from_rows(self.schema, self._rows)]
                    if self._rows else [])
        return list(self._batches)

    def collect(self) -> list:
        return list(self._rows)

    def collect_final(self) -> list:
        """Fold the changelog: apply +I/+U/-U/-D and return the final rows
        (order of last insertion)."""
        if rk.ROWKIND_COLUMN not in self.schema:
            return list(self._rows)
        kind_idx = self.schema.index_of(rk.ROWKIND_COLUMN)
        alive: dict[tuple, int] = {}
        order: list[tuple] = []
        for row in self._rows:
            data = tuple(v for i, v in enumerate(row) if i != kind_idx)
            kind = row[kind_idx]
            if kind in (int(rk.UPDATE_BEFORE), int(rk.DELETE)):
                m = alive.get(data, 0) - 1
                if m <= 0:
                    alive.pop(data, None)
                else:
                    alive[data] = m
            else:
                alive[data] = alive.get(data, 0) + 1
                order.append(data)
        seen: set = set()
        out: list[tuple] = []
        for data in reversed(order):
            if data in alive and data not in seen:
                out.extend([data] * alive[data])
                seen.add(data)
        out.reverse()
        return out

    def print(self) -> None:
        names = self.schema.names
        print(" | ".join(names))
        for row in self._rows:
            print(" | ".join(str(v) for v in row))


class TableEnvironment:
    def __init__(self, env: Optional[StreamExecutionEnvironment] = None):
        self.env = env or StreamExecutionEnvironment()
        self._catalog: dict[str, tuple[DataStream, Schema]] = {}
        # DDL catalog: connector specs + views, re-plannable into a fresh
        # execution environment per query (reference GenericInMemoryCatalog)
        self.catalog = Catalog()

    @staticmethod
    def create(env: Optional[StreamExecutionEnvironment] = None
               ) -> "TableEnvironment":
        return TableEnvironment(env)

    # -- catalog -----------------------------------------------------------
    def create_temporary_view(self, name: str, stream: DataStream,
                              schema: Optional[Schema] = None) -> None:
        """Register a DataStream as a queryable table
        (reference createTemporaryView)."""
        if schema is None:
            schema = getattr(stream.transformation, "schema", None) \
                or getattr(stream, "_sql_schema", None)
            if schema is None:
                raise ValueError(
                    f"cannot infer schema for view {name!r}; pass schema=")
        self._catalog[name.lower()] = (stream, schema)

    def from_data_stream(self, stream: DataStream,
                         schema: Optional[Schema] = None) -> Table:
        if schema is None:
            schema = getattr(stream.transformation, "schema", None)
        return Table(self, stream, schema)

    def _resolve(self, name: str) -> tuple[DataStream, Schema]:
        return self._make_resolver(self.env)(name)

    def _make_resolver(self, env: StreamExecutionEnvironment):
        """Name resolution for one query: bound streams as-is; catalog
        specs instantiated into ``env`` (cached so a self-join shares one
        source); views re-planned recursively."""
        instantiated: dict[str, tuple[DataStream, Schema]] = {}

        def resolve(name: str) -> tuple[DataStream, Schema]:
            key = name.lower()
            bound = self._catalog.get(key)
            if bound is not None:
                return bound
            if key in instantiated:
                return instantiated[key]
            entry = self.catalog.get(key)
            if entry is None:
                raise PlanError(
                    f"table {name!r} not found; registered: "
                    f"{sorted(set(self._catalog) | set(self.catalog.names()))}")
            if entry.kind == "view":
                stream = plan(entry.view_select, resolve, env)
                out = (stream, stream._sql_schema)
            else:
                out = (instantiate_source(env, entry), entry.schema)
            instantiated[key] = out
            return out

        return resolve

    def _fresh_env(self) -> StreamExecutionEnvironment:
        """Spec-backed queries get their own execution environment (same
        config), so one TableEnvironment can run many statements without
        re-executing earlier pipelines. Queries over bound user streams
        must keep the user's env."""
        if self._catalog:
            return self.env
        return StreamExecutionEnvironment(
            Configuration(dict(self.env.config._values)),
            device=self.env.device)

    # -- SQL ---------------------------------------------------------------
    def sql_query(self, sql: str) -> Table:
        stmt = parse(sql)
        env = self._fresh_env()
        out = plan(stmt, self._make_resolver(env), env)
        return Table(self, out, out._sql_schema)

    def execute_sql(self, sql: str,
                    timeout: Optional[float] = 120.0) -> TableResult:
        """Route one statement: queries plan+execute; DDL mutates the
        catalog (reference TableEnvironmentImpl.executeSql:727)."""
        stmt = parse_statement(sql)
        if isinstance(stmt, CreateTableStmt):
            schema = Schema([(c, sql_type_to_dtype(t))
                             for c, t in stmt.columns])
            self.catalog.create(
                CatalogTable(stmt.name, "spec", schema, stmt.options,
                             stmt.watermark_col, stmt.watermark_delay_ms),
                if_not_exists=stmt.if_not_exists)
            return self._ok()
        if isinstance(stmt, CreateViewStmt):
            self.catalog.create(
                CatalogTable(stmt.name, "view", view_select=stmt.select))
            return self._ok()
        if isinstance(stmt, DropStmt):
            # temporary views registered through create_temporary_view live
            # in _catalog; SHOW/resolve and DROP must agree on both stores
            if stmt.name.lower() in self._catalog:
                del self._catalog[stmt.name.lower()]
                return self._ok()
            self.catalog.drop(stmt.name, stmt.kind, stmt.if_exists)
            return self._ok()
        if isinstance(stmt, ShowTablesStmt):
            names = sorted(set(self.catalog.names())
                           | set(self._catalog))
            return TableResult(Schema([("table name", object)]),
                               [(n,) for n in names])
        if isinstance(stmt, ShowViewsStmt):
            views = sorted(
                {n for n in self.catalog.names()
                 if self.catalog.get(n).kind == "view"}
                | set(self._catalog))
            return TableResult(Schema([("view name", object)]),
                               [(n,) for n in views])
        if isinstance(stmt, ShowCreateStmt):
            return self._show_create(stmt.name)
        if isinstance(stmt, DescribeStmt):
            entry = self.catalog.get(stmt.name)
            if entry is not None and entry.schema is not None:
                schema = entry.schema
            elif entry is not None and entry.kind == "view":
                # derive the view's schema by planning it (no execution)
                env = self._fresh_env()
                schema = plan(entry.view_select,
                              self._make_resolver(env), env)._sql_schema
            elif stmt.name.lower() in self._catalog:
                schema = self._catalog[stmt.name.lower()][1]
            else:
                raise PlanError(f"table {stmt.name!r} not found")
            return TableResult(
                Schema([("name", object), ("type", object)]),
                [(f.name, dtype_to_sql_type(f.dtype))
                 for f in schema.fields])
        if isinstance(stmt, ExplainStmt):
            return self._explain(stmt)
        if isinstance(stmt, InsertStmt):
            return self._execute_insert(stmt, timeout)
        # plain query
        env = self._fresh_env()
        out = plan(stmt, self._make_resolver(env), env)
        return Table(self, out, out._sql_schema).execute(timeout)

    def _validate_insert(self, stmt: InsertStmt, env) -> tuple:
        """Shared by execution AND EXPLAIN, so EXPLAIN surfaces the same
        errors the real INSERT would (target kind, changelog, arity).
        Returns (target entry, planned stream)."""
        target = self.catalog.get(stmt.target)
        if target is None:
            raise PlanError(f"sink table {stmt.target!r} not found")
        if target.kind != "spec":
            raise PlanError(f"cannot INSERT INTO {target.kind} "
                            f"{stmt.target!r}; target must be a connector-"
                            f"backed table")
        stream = plan(stmt.select, self._make_resolver(env), env)
        out_schema = stream._sql_schema
        if rk.ROWKIND_COLUMN in out_schema:
            raise PlanError(
                f"INSERT INTO {stmt.target}: the query produces a "
                "retracting changelog; only append-only queries can feed "
                "a table sink (aggregate before inserting or collect the "
                "result instead)")
        if len(out_schema) != len(target.schema):
            raise PlanError(
                f"INSERT INTO {stmt.target}: query produces "
                f"{len(out_schema)} columns, table has "
                f"{len(target.schema)}")
        return target, stream

    def _execute_insert(self, stmt: InsertStmt,
                        timeout: Optional[float]) -> TableResult:
        """INSERT INTO sink_table SELECT ... (reference executeInternal
        with a ModifyOperation -> DynamicTableSink)."""
        env = self._fresh_env()
        target, stream = self._validate_insert(stmt, env)
        out_schema = stream._sql_schema
        # map query columns to the TARGET's names positionally (reference
        # maps insert columns by position): formats like json encode field
        # names, so aliased query outputs must be renamed before the sink
        target_schema = target.schema
        src_names = out_schema.names
        # rebuild batches whenever names OR dtypes differ: RecordBatch
        # construction against the target schema both renames positionally
        # and coerces column dtypes to the sink's declared types
        if out_schema.fields != target_schema.fields:
            def rename(batch: RecordBatch):
                cols = {t: batch.columns[s]
                        for s, t in zip(src_names, target_schema.names)}
                return RecordBatch(target_schema, cols, batch.timestamps)

            stream = stream.transform(
                "InsertRename",
                lambda: BatchFnOperator(rename, "InsertRename"))
        sink = instantiate_sink(target, config=stream.env.config)
        rows = _CountingSink()
        stream.add_sink(rows.wrap(sink), f"insert-{stmt.target}")
        stream.env.execute(f"insert-{stmt.target}", timeout=timeout)
        return TableResult(Schema([("rows", np.int64)], ), [(rows.count,)])

    def _execute_table(self, table: Table,
                       timeout: Optional[float]) -> TableResult:
        sink = CollectSink()
        table.stream.add_sink(sink, "SqlCollect")
        # execute on the env the query was PLANNED into (a fresh one for
        # spec-backed queries, the user's for bound streams)
        table.stream.env.execute("sql-query", timeout=timeout)
        return TableResult(table.schema, batches=sink.batches)

    def _explain(self, stmt: ExplainStmt) -> TableResult:
        """EXPLAIN <query | INSERT>: plan without executing and render the
        physical JobGraph — chained vertices, parallelism, exchanges
        (reference TableEnvironment.explainSql). The graph is built
        directly from the planned terminal transformation: nothing is
        registered on the (possibly user-owned) environment, so EXPLAIN
        never leaks sinks into a later execute()."""
        env = self._fresh_env()
        inner = stmt.select
        sink_line = None
        if isinstance(inner, InsertStmt):
            # same validation as execution: EXPLAIN must fail where the
            # real INSERT would (view target, arity, retracting query)
            target, stream = self._validate_insert(inner, env)
            sink_line = (f"sink: {inner.target} "
                         f"[{target.options.get('connector')}]")
        else:
            stream = plan(inner, self._make_resolver(env), env)
        sg = build_stream_graph([stream.transformation], env.config)
        jg = build_job_graph(sg, env.config, "explain")
        lines = ["== Physical Execution Plan =="]
        for vid, v in jg.vertices.items():
            lines.append(f"{vid}: {v.name} (parallelism={v.parallelism}, "
                         f"max={v.max_parallelism})")
            for e in jg.in_edges(vid):
                lines.append(f"  <- {e.source_vertex} "
                             f"[{e.partitioner_name}]")
        if sink_line:
            lines.append(sink_line)
        return TableResult(Schema([("plan", object)]),
                           [(ln,) for ln in lines])

    def _show_create(self, name: str) -> "TableResult":
        """Reconstruct the DDL from the catalog entry (reference SHOW
        CREATE TABLE)."""
        entry = self.catalog.get(name)
        if entry is None or entry.kind != "spec":
            raise PlanError(
                f"SHOW CREATE TABLE: {name!r} is not a connector-backed "
                "table in the catalog")
        cols = [f"  {f.name} {dtype_to_sql_type(f.dtype)}"
                for f in entry.schema.fields]
        if entry.watermark_col:
            # MILLISECOND keeps the delay exact (float formatting would
            # silently round it on round-trip)
            cols.append(f"  WATERMARK FOR {entry.watermark_col} AS "
                        f"{entry.watermark_col} - INTERVAL "
                        f"'{entry.watermark_delay_ms}' MILLISECOND")

        def q(s: str) -> str:
            return str(s).replace("'", "''")   # SQL string escaping

        opts = ",\n".join(f"  '{q(k)}' = '{q(v)}'"
                          for k, v in sorted(entry.options.items()))
        ddl = (f"CREATE TABLE {entry.name} (\n" + ",\n".join(cols)
               + f"\n) WITH (\n{opts}\n)")
        return TableResult(Schema([("create statement", object)]),
                           [(ddl,)])

    @staticmethod
    def _ok() -> "TableResult":
        return TableResult(Schema([("result", object)]), [("OK",)])


class _CountingSink:
    """Wraps the target sink so INSERT INTO can report rows written."""

    def __init__(self):
        self.count = 0
        self._lock = threading.Lock()

    def _add(self, n: int) -> None:
        with self._lock:
            self.count += n

    def wrap(self, sink):
        """``sink``: a ``Sink`` (its writer's two-phase calls pass through,
        so a filesystem or log table commits at checkpoints) or a
        ``SinkFunction`` (``instantiate_sink``)."""
        outer = self
        if isinstance(sink, Sink):
            class _CountingWrapper(Sink):
                def create_writer(self, subtask_index: int) -> SinkWriter:
                    inner = sink.create_writer(subtask_index)

                    class _W(SinkWriter):
                        def write_batch(self, batch):
                            outer._add(batch.n)
                            return inner.write_batch(batch)

                        def flush(self):
                            inner.flush()

                        def prepare_commit(self, checkpoint_id):
                            inner.prepare_commit(checkpoint_id)

                        def commit(self, checkpoint_id):
                            inner.commit(checkpoint_id)

                        def snapshot(self):
                            return inner.snapshot()

                        def restore(self, state):
                            inner.restore(state)

                        def close(self):
                            inner.close()

                    return _W()

            return _CountingWrapper()

        class _CountingFn(SinkFunction):
            def invoke_batch(self, batch):
                outer._add(batch.n)
                return sink.invoke_batch(batch)

        return _CountingFn()
