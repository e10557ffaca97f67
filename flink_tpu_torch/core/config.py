"""Job configuration: the few string keys the port reads.

A trimmed stand-in for ``flink_tpu/core/config.py``'s typed options. Keys
and defaults match the reference's, so one dict of settings drives both.
"""

from __future__ import annotations

from typing import Any, Optional

__all__ = ["Configuration", "DEFAULTS"]

#: key -> default (reference: PipelineOptions / TaskOptions /
#: WindowOptions)
DEFAULTS: dict[str, Any] = {
    "pipeline.micro-batch-size": 4096,
    "pipeline.max-parallelism": 128,
    "task.max-inflight": 2,
    # coalesce consecutive same-schema micro-batches host-side up to this
    # many records, then run one ingest step (0/1: off)
    "task.coalesce.target-records": 0,
    # age deadline of a non-empty coalescing buffer, checked when the next
    # batch arrives (0: none)
    "task.coalesce.timeout-ms": 0,
    # incremental fires: a running window accumulator per invertible
    # aggregate and a merge tree per min/max, sealed once per pane
    "window.fire.incremental": False,
}


class Configuration:
    def __init__(self, values: Optional[dict] = None):
        self._values: dict[str, Any] = {}
        for k, v in (values or {}).items():
            self.set(k, v)

    def set(self, key: str, value: Any) -> "Configuration":
        if key not in DEFAULTS:
            raise KeyError(f"unknown option {key!r}; the port reads "
                           f"{sorted(DEFAULTS)}")
        kind = type(DEFAULTS[key])
        if kind is bool and isinstance(value, str):
            if value.strip().lower() not in ("true", "false"):
                raise ValueError(f"{key} takes true or false, not {value!r}")
            value = value.strip().lower() == "true"
        self._values[key] = kind(value)
        return self

    def get(self, key: str) -> Any:
        return self._values.get(key, DEFAULTS[key])
