"""SQL DDL: CREATE TABLE/VIEW, DROP, SHOW, DESCRIBE, INSERT INTO — and the
catalog + connector-factory machinery behind them (trimmed port of
``flink_tpu/sql/ddl.py``).

Reference semantics: TableEnvironmentImpl.executeSql:727 routes non-query
statements to catalog operations (flink-table-api-java), table specs live in
a catalog (GenericInMemoryCatalog), and `WITH ('connector'='...')` options
are resolved through the factory SPI (FactoryUtil.createDynamicTableSource;
flink-table-common factories/Factory). Here the catalog stores *connector
specs*, instantiated lazily into an execution environment when a query
references them — "codegen" for a spec is just building the DataStream
source, so a spec-backed table can be re-planned into any number of fresh
environments (each execute_sql gets its own), unlike a temporary view which
stays bound to the user's stream.

Grammar (LL(1), same tokenizer as the query parser):

    CREATE [TEMPORARY] TABLE [IF NOT EXISTS] name
        (col TYPE [, ...] [, WATERMARK FOR col AS col - INTERVAL 'n' UNIT])
        WITH ('connector' = '...', ...)
    CREATE [TEMPORARY] VIEW name AS <select>
    DROP TABLE|VIEW [IF EXISTS] name
    SHOW TABLES | DESCRIBE name | INSERT INTO name <select>

Connectors: datagen (rows-per-second, number-of-rows, per-field kind =
sequence|random), filesystem (path, format = csv|json|binary|columnar|
avro), log (the Kafka-shaped partitioned log: topic, broker: a name of a
process-global in-memory broker, or host:port of a ``LogBrokerServer``),
socket, print, blackhole; then the connectors that plugins registered
(``register_connector``, ``core/plugins.py``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from ..core.functions import SinkFunction
from ..core.records import Schema
from ..core.watermarks import WatermarkStrategy
from .parser import SelectStmt, SqlError, _tokenize, parse

__all__ = ["Catalog", "CatalogTable", "parse_statement", "CreateTableStmt",
           "CreateViewStmt", "DropStmt", "ShowTablesStmt", "ShowViewsStmt",
           "ShowCreateStmt", "DescribeStmt", "InsertStmt", "ExplainStmt",
           "instantiate_source", "instantiate_sink",
           "sql_type_to_dtype", "dtype_to_sql_type"]

_SQL_TYPES = {
    "TINYINT": np.int32, "SMALLINT": np.int32, "INT": np.int32,
    "INTEGER": np.int32, "BIGINT": np.int64,
    "FLOAT": np.float32, "REAL": np.float32, "DOUBLE": np.float64,
    "DECIMAL": np.float64, "NUMERIC": np.float64,
    "BOOLEAN": np.bool_,
    "STRING": object, "VARCHAR": object, "CHAR": object,
    "TIMESTAMP": np.int64, "TIMESTAMP_LTZ": np.int64, "DATE": np.int64,
    "BYTES": object, "VARBINARY": object,
}

_UNITS_MS = {
    "MILLISECOND": 1, "SECOND": 1000, "MINUTE": 60_000, "HOUR": 3_600_000,
    "DAY": 86_400_000,
}


def sql_type_to_dtype(t: str):
    dt = _SQL_TYPES.get(t.upper())
    if dt is None:
        raise SqlError(f"unsupported SQL type {t!r}")
    return dt


def dtype_to_sql_type(dt) -> str:
    if dt is object:
        return "STRING"
    name = np.dtype(dt).name
    return {"int32": "INT", "int64": "BIGINT", "float32": "FLOAT",
            "float64": "DOUBLE", "bool": "BOOLEAN"}.get(name, name.upper())


# -- statements -------------------------------------------------------------

@dataclass
class CreateTableStmt:
    name: str
    columns: list  # [(name, sql_type)]
    options: dict
    watermark_col: Optional[str] = None
    watermark_delay_ms: int = 0
    if_not_exists: bool = False
    temporary: bool = False


@dataclass
class CreateViewStmt:
    name: str
    select: SelectStmt
    select_sql: str = ""
    temporary: bool = False


@dataclass
class DropStmt:
    kind: str  # "TABLE" | "VIEW"
    name: str
    if_exists: bool = False


@dataclass
class ShowTablesStmt:
    pass


@dataclass
class ShowViewsStmt:
    pass


@dataclass
class ShowCreateStmt:
    name: str


@dataclass
class DescribeStmt:
    name: str


@dataclass
class InsertStmt:
    target: str
    select: SelectStmt


@dataclass
class ExplainStmt:
    select: SelectStmt


# -- DDL parser -------------------------------------------------------------

class _DdlParser:
    def __init__(self, sql: str):
        self.toks = _tokenize(sql)
        self.i = 0
        self.sql = sql

    def peek(self) -> tuple[str, str]:
        return self.toks[self.i] if self.i < len(self.toks) else ("eof", "")

    def next(self) -> tuple[str, str]:
        t = self.peek()
        self.i += 1
        return t

    def expect_kw(self, *kws: str) -> str:
        kind, val = self.next()
        if kind != "id" or val.upper() not in kws:
            raise SqlError(f"expected {'/'.join(kws)}, got {val!r}")
        return val.upper()

    def accept_kw(self, kw: str) -> bool:
        kind, val = self.peek()
        if kind == "id" and val.upper() == kw:
            self.i += 1
            return True
        return False

    def ident(self) -> str:
        kind, val = self.next()
        if kind != "id":
            raise SqlError(f"expected identifier, got {val!r}")
        return val

    def string(self) -> str:
        kind, val = self.next()
        if kind != "str":
            raise SqlError(f"expected string literal, got {val!r}")
        return val  # tokenizer already stripped the quotes

    def expect_sym(self, sym: str) -> None:
        kind, val = self.next()
        if val != sym:
            raise SqlError(f"expected {sym!r}, got {val!r}")

    # CREATE ... ------------------------------------------------------------
    def parse_create(self):
        self.expect_kw("CREATE")
        temporary = self.accept_kw("TEMPORARY")
        what = self.expect_kw("TABLE", "VIEW")
        if what == "VIEW":
            name = self.ident()
            self.expect_kw("AS")
            rest = self.sql[self._rest_pos():].strip()
            if not rest:
                raise SqlError(f"CREATE VIEW {name}: missing SELECT body")
            return CreateViewStmt(name, parse(rest), rest, temporary)
        if_not_exists = False
        if self.accept_kw("IF"):
            self.expect_kw("NOT")
            self.expect_kw("EXISTS")
            if_not_exists = True
        name = self.ident()
        self.expect_sym("(")
        columns: list[tuple[str, str]] = []
        wm_col, wm_delay = None, 0
        while True:
            if self.accept_kw("WATERMARK"):
                self.expect_kw("FOR")
                wm_col = self.ident()
                self.expect_kw("AS")
                wm_delay = self._watermark_expr(wm_col)
            else:
                col = self.ident()
                kind, t = self.next()
                if kind != "id":
                    raise SqlError(f"expected type after column {col!r}")
                sql_type_to_dtype(t)  # validate now, fail loud at DDL time
                # swallow parametrized types: VARCHAR(255), DECIMAL(10, 2)
                if self.peek()[1] == "(":
                    while self.next()[1] != ")":
                        pass
                columns.append((col, t.upper()))
            kind, val = self.next()
            if val == ")":
                break
            if val != ",":
                raise SqlError(f"expected ',' or ')' in column list, "
                               f"got {val!r}")
        options: dict[str, str] = {}
        if self.accept_kw("WITH"):
            self.expect_sym("(")
            while True:
                k = self.string()
                self.expect_sym("=")
                options[k] = self.string()
                kind, val = self.next()
                if val == ")":
                    break
                if val != ",":
                    raise SqlError(f"expected ',' or ')' in WITH, got {val!r}")
        if not columns:
            raise SqlError(f"CREATE TABLE {name}: empty column list")
        return CreateTableStmt(name, columns, options, wm_col, wm_delay,
                               if_not_exists, temporary)

    def _watermark_expr(self, col: str) -> int:
        """``col - INTERVAL 'n' UNIT`` (or bare ``col`` = 0 delay)."""
        first = self.ident()
        if first != col:
            raise SqlError(f"WATERMARK FOR {col} AS must reference {col}")
        if self.peek()[1] != "-":
            return 0
        self.next()
        self.expect_kw("INTERVAL")
        n = self.string()
        kind, unit = self.next()
        factor = _UNITS_MS.get(unit.upper())
        if factor is None:
            raise SqlError(f"bad interval unit {unit!r}")
        return int(float(n) * factor)

    def _rest_pos(self) -> int:
        """Char offset of the current token in the original SQL (the view
        body is re-parsed by the query parser from here)."""
        # tokens do not carry offsets; find the i-th token occurrence by
        # re-tokenizing prefix lengths — small inputs, clarity over speed
        upper = 0
        target = self.toks[self.i][1]
        seen = self.toks[: self.i]
        pos = 0
        for kind, val in seen:
            pos = self.sql.find(val, pos) + len(val)
        return self.sql.find(target, pos) if target else pos

    # others -----------------------------------------------------------------
    def parse_drop(self) -> DropStmt:
        self.expect_kw("DROP")
        kind = self.expect_kw("TABLE", "VIEW")
        if_exists = False
        if self.accept_kw("IF"):
            self.expect_kw("EXISTS")
            if_exists = True
        return DropStmt(kind, self.ident(), if_exists)

    def parse_insert(self) -> InsertStmt:
        self.expect_kw("INSERT")
        self.expect_kw("INTO")
        target = self.ident()
        rest = self.sql[self._rest_pos():].strip()
        if not rest:
            raise SqlError(f"INSERT INTO {target}: missing SELECT body")
        return InsertStmt(target, parse(rest))


def parse_statement(sql: str):
    """Statement router: returns a DDL statement object or a SelectStmt."""
    stripped = sql.strip()
    head = stripped.split(None, 1)[0].upper() if stripped else ""
    p = _DdlParser(stripped)
    if head == "CREATE":
        return p.parse_create()
    if head == "DROP":
        return p.parse_drop()
    if head == "SHOW":
        p.expect_kw("SHOW")
        what = p.expect_kw("TABLES", "VIEWS", "CREATE")
        if what == "TABLES":
            return ShowTablesStmt()
        if what == "VIEWS":
            return ShowViewsStmt()
        p.expect_kw("TABLE")
        return ShowCreateStmt(p.ident())
    if head in ("DESCRIBE", "DESC"):
        p.next()
        return DescribeStmt(p.ident())
    if head == "INSERT":
        return p.parse_insert()
    if head == "EXPLAIN":
        parts = stripped.split(None, 1)
        rest = parts[1].strip() if len(parts) > 1 else ""
        if not rest:
            raise SqlError("EXPLAIN: missing statement")
        inner = parse_statement(rest)
        if not isinstance(inner, (SelectStmt, InsertStmt)):
            raise SqlError("EXPLAIN supports queries and INSERT INTO")
        return ExplainStmt(inner)
    return parse(stripped)


# -- catalog ----------------------------------------------------------------

@dataclass
class CatalogTable:
    """One catalog entry: a connector spec (lazily instantiated), a view
    (re-planned per query), or a bound stream (temporary view over a user
    DataStream)."""

    name: str
    kind: str                      # "spec" | "view"
    schema: Optional[Schema] = None
    options: dict = field(default_factory=dict)
    watermark_col: Optional[str] = None
    watermark_delay_ms: int = 0
    view_select: Optional[SelectStmt] = None


class Catalog:
    """In-memory catalog (reference GenericInMemoryCatalog)."""

    def __init__(self, name: str = "default_catalog"):
        self.name = name
        self._tables: dict[str, CatalogTable] = {}

    def create(self, table: CatalogTable, if_not_exists: bool = False) -> None:
        key = table.name.lower()
        if key in self._tables:
            if if_not_exists:
                return
            raise SqlError(f"table {table.name!r} already exists")
        self._tables[key] = table

    def drop(self, name: str, kind: str, if_exists: bool = False) -> None:
        key = name.lower()
        entry = self._tables.get(key)
        if entry is None:
            if if_exists:
                return
            raise SqlError(f"{kind.lower()} {name!r} does not exist")
        is_view = entry.kind == "view"
        if (kind == "VIEW") != is_view:
            raise SqlError(f"{name!r} is a {'view' if is_view else 'table'}; "
                           f"use DROP {'VIEW' if is_view else 'TABLE'}")
        del self._tables[key]

    def get(self, name: str) -> Optional[CatalogTable]:
        return self._tables.get(name.lower())

    def names(self) -> list[str]:
        return sorted(t.name for t in self._tables.values())


# -- connector factories ----------------------------------------------------

# process-global named brokers of the log connector, so tables created in
# different TableEnvironments meet in one topic (as two Kafka clients share
# a cluster by its address)
_BROKERS: dict[Any, Any] = {}
_BROKERS_LOCK = threading.Lock()

# plugin connectors, looked up after the built-in ones: name ->
# {"source": factory or None, "sink": factory or None}
_PLUGIN_CONNECTORS: dict[str, dict] = {}


def register_connector(name: str, source=None, sink=None) -> None:
    """The plugin seam: ``source(env, catalog_table) -> DataStream``,
    ``sink(catalog_table) -> Sink | SinkFunction``."""
    _PLUGIN_CONNECTORS[name] = {"source": source, "sink": sink}


def _broker(name: str, config=None):
    """The named in-process broker, or a TCP client when the name is
    host:port (a ``LogBrokerServer`` listens there). ``config`` gives the
    client's cluster secret, which is part of the cache key: a caller with
    another secret gets a connection of its own."""
    from ..utils import auth

    cache_key: Any = name
    if ":" in name:
        cache_key = (name, auth.resolve_secret(config))
    with _BROKERS_LOCK:
        b = _BROKERS.get(cache_key)
        if b is None:
            if ":" in name:   # one connection an address, not a statement
                from ..connectors.log_net import RemoteLogBroker
                b = RemoteLogBroker(name, config=config)
            else:
                from ..connectors.log import InMemoryLogBroker
                b = InMemoryLogBroker()
            _BROKERS[cache_key] = b
        return b


def _format(options: dict, schema: Schema):
    from ..formats.core import BinaryFormat, CsvFormat, JsonFormat
    fmt = options.get("format", "csv")
    if fmt == "csv":
        return CsvFormat(schema)
    if fmt == "json":
        return JsonFormat(schema)
    if fmt == "binary":
        return BinaryFormat(schema)
    if fmt == "columnar":
        from ..formats.columnar import ColumnarFormat
        return ColumnarFormat(schema)
    if fmt == "avro":
        from ..formats.avro import AvroFormat
        return AvroFormat(schema)
    raise SqlError(f"unsupported format {fmt!r} "
                   f"(csv|json|binary|columnar|avro)")


def _log_format(entry: "CatalogTable"):
    fmt = _format(entry.options, entry.schema)
    if fmt.binary:
        raise SqlError("log topics carry text lines; use csv|json "
                       f"(table {entry.name!r})")
    return fmt


def _watermark_strategy(entry: CatalogTable) -> Optional[WatermarkStrategy]:
    if entry.watermark_col is None:
        return None
    return (WatermarkStrategy
            .for_bounded_out_of_orderness(entry.watermark_delay_ms)
            .with_timestamp_column(entry.watermark_col))


def _datagen_fn(schema: Schema, options: dict):
    """Vectorized generator from per-field options:
    fields.<name>.kind = sequence (start + idx) | random (min..max)."""
    specs = []
    for f in schema.fields:
        kind = options.get(f"fields.{f.name}.kind", "sequence")
        lo = int(options.get(f"fields.{f.name}.min", 0))
        hi = int(options.get(f"fields.{f.name}.max", 1 << 20))
        start = int(options.get(f"fields.{f.name}.start", 0))
        specs.append((f.name, f.dtype, kind, lo, hi, start))

    def gen(idx: np.ndarray) -> dict:
        out = {}
        for name, dtype, kind, lo, hi, start in specs:
            if dtype is object:
                out[name] = np.array([f"{name}-{int(i)}" for i in idx],
                                     dtype=object)
            elif kind == "random":
                # stateless per-idx hash keeps restore deterministic
                u = (idx.astype(np.uint64)
                     * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(33)
                span = max(hi - lo + 1, 1)
                out[name] = (lo + (u % np.uint64(span)).astype(np.int64)) \
                    .astype(dtype)
            else:
                out[name] = (start + idx).astype(dtype)
        return out

    return gen


def instantiate_source(env, entry: CatalogTable):
    """Build a DataStream for a spec-backed catalog table in ``env``
    (reference FactoryUtil.createDynamicTableSource)."""
    opts = entry.options
    connector = opts.get("connector")
    if connector is None:
        raise SqlError(f"table {entry.name!r} has no 'connector' option")
    ws = _watermark_strategy(entry)
    if connector == "datagen":
        count = opts.get("number-of-rows")
        rate = opts.get("rows-per-second")
        return env.datagen(
            _datagen_fn(entry.schema, opts), entry.schema,
            count=int(count) if count else None,
            rate_per_sec=float(rate) if rate else None,
            timestamp_column=entry.watermark_col,
            watermark_strategy=ws, name=entry.name)
    if connector == "filesystem":
        from ..connectors.file import FileSource
        src = FileSource(opts["path"], _format(opts, entry.schema))
        return env.from_source(src, ws, entry.name)
    if connector == "log":
        from ..connectors.log import LogSource
        src = LogSource(_broker(opts.get("broker", "default"),
                                config=env.config),
                        opts["topic"], _log_format(entry),
                        bounded=opts.get("bounded", "false") == "true",
                        starting_offsets=opts.get("scan.startup.mode",
                                                  "earliest"))
        return env.from_source(src, ws, entry.name)
    if connector == "socket":
        from ..connectors.socket import SocketSource
        if (len(entry.schema) != 1
                or entry.schema.fields[0].dtype is not object):
            raise SqlError("socket tables carry newline-delimited text: "
                           "declare exactly one STRING column")
        src = SocketSource(opts.get("hostname", "127.0.0.1"),
                           int(opts["port"]), entry.schema)
        return env.from_source(src, ws, entry.name)
    plugin = _PLUGIN_CONNECTORS.get(connector)
    if plugin is not None and plugin.get("source") is not None:
        return plugin["source"](env, entry)
    raise SqlError(f"unknown connector {connector!r} for source table "
                   f"{entry.name!r}")


class _BlackHole(SinkFunction):
    def invoke_batch(self, batch) -> bool:
        return True


class _Print(SinkFunction):
    def invoke_batch(self, batch) -> bool:
        for row in batch.iter_rows():
            print(row)
        return True


def instantiate_sink(entry: CatalogTable, config=None):
    """Build the sink of INSERT INTO's target, a ``Sink`` or a
    ``SinkFunction`` (reference FactoryUtil.createDynamicTableSink).
    ``config`` gives a network broker's cluster secret."""
    opts = entry.options
    connector = opts.get("connector")
    if connector == "filesystem":
        from ..connectors.file import FileSink
        return FileSink(opts["path"], _format(opts, entry.schema))
    if connector == "log":
        from ..connectors.log import LogSink
        fmt = _log_format(entry)
        broker = _broker(opts.get("broker", "default"), config=config)
        broker.create_topic(opts["topic"])
        return LogSink(broker, opts["topic"], fmt)
    if connector == "blackhole":
        return _BlackHole()
    if connector == "print":
        return _Print()
    plugin = _PLUGIN_CONNECTORS.get(connector)
    if plugin is not None and plugin.get("sink") is not None:
        return plugin["sink"](entry)
    raise SqlError(f"unknown connector {connector!r} for sink table "
                   f"{entry.name!r}")
