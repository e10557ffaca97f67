"""The tracing clock (trimmed port of ``flink_tpu/metrics/tracing.py``).

Only ``now_ms`` is ported: the device-time ledger stamps its samples and
recompile records with it. Spans, the tracer, the flight recorder and the
Perfetto export are not ported yet, so the port emits no span and its
span inventory is empty (the lint's TPU301 holds code, this inventory and
``flink_tpu_torch/docs/OBSERVABILITY.md`` to that).
"""

from __future__ import annotations

import time

__all__ = ["now_ms", "SPAN_INVENTORY"]

# Epoch offset sampled once at import: now_ms() is monotonic-derived but
# reports epoch milliseconds, so durations are immune to wall-clock steps
# while start times still line up with log timestamps.
_EPOCH_OFFSET_MS = time.time() * 1000.0 - time.monotonic() * 1000.0  # lint: wall-clock-ok sampled once at import to anchor the monotonic clock


def now_ms() -> int:
    """Epoch milliseconds measured on the monotonic clock."""
    return int(time.monotonic() * 1000.0 + _EPOCH_OFFSET_MS)


#: (scope, name, where) of every span the port emits, sorted: none yet
SPAN_INVENTORY: tuple = ()
