"""SQL/Table layer of the port (port of ``flink_tpu/sql``): parser,
planner, changelog operators, TableEnvironment.

``TableEnvironment(env).execute_sql(sql)`` parses, plans onto the
DataStream graph and runs it on the environment's device. Integer-keyed
GROUP BY runs on the device group aggregation (``sql/device_group_agg.py``,
kernels in ``csrc/group_agg.cu``); TUMBLE, HOP and SESSION windows with
one integer key on the device window operators; other keys, DISTINCT and
MIN/MAX over a changelog on the host ``GroupAggOperator``. Joins plan to
the host ``StreamingJoinOperator`` (inner, left, right, full) and
``TemporalJoinOperator`` (``FOR SYSTEM_TIME AS OF``) of ``sql/join.py``;
a GROUP BY over a join's changelog retracts. ``sql/dedup.py`` (keep-first
on the device row plane, keep-last on the host) and ``sql/over_agg.py``
are operators the planner does not route, as in the reference.
"""

from .expressions import (
    AggCall, BinaryOp, Cast, CaseWhen, Column, Expr, ExprError, FuncCall,
    Literal, Star, UnaryOp, compile_expr,
)
from .group_agg import GroupAggOperator, SqlAggSpec
from .parser import SelectStmt, SqlError, TableRef, WindowTVF, parse
from .planner import PlanError, plan
from .rowkind import (
    DELETE, INSERT, ROWKIND_COLUMN, ROWKIND_NAMES, UPDATE_AFTER,
    UPDATE_BEFORE,
)
from .table_env import Table, TableEnvironment, TableResult
from .topn import TopNOperator

__all__ = [
    "TableEnvironment", "Table", "TableResult", "parse", "plan",
    "SelectStmt", "SqlError", "PlanError", "TableRef", "WindowTVF",
    "GroupAggOperator", "SqlAggSpec", "TopNOperator",
    "Expr", "Column", "Literal", "BinaryOp", "UnaryOp", "FuncCall", "Cast",
    "CaseWhen", "Star", "AggCall", "ExprError", "compile_expr",
    "ROWKIND_COLUMN", "ROWKIND_NAMES", "INSERT", "UPDATE_BEFORE",
    "UPDATE_AFTER", "DELETE",
]
