"""Changelog row kinds (copy of ``flink_tpu/sql/rowkind.py``).

Analog of the reference's RowKind (flink-table-common
org/apache/flink/table/data/RowKind.java): every changelog-producing SQL
operator emits an extra int8 ``__rowkind__`` column. Append-only streams
simply have no such column.
"""

from __future__ import annotations

import numpy as np

__all__ = ["INSERT", "UPDATE_BEFORE", "UPDATE_AFTER", "DELETE",
           "ROWKIND_COLUMN", "ROWKIND_NAMES"]

INSERT = np.int8(0)         # +I
UPDATE_BEFORE = np.int8(1)  # -U
UPDATE_AFTER = np.int8(2)   # +U
DELETE = np.int8(3)         # -D

ROWKIND_COLUMN = "__rowkind__"
ROWKIND_NAMES = {0: "+I", 1: "-U", 2: "+U", 3: "-D"}
