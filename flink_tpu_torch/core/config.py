"""Job configuration: the few string keys the port reads.

A trimmed stand-in for ``flink_tpu/core/config.py``'s typed options. Keys
and defaults match the reference's, so one dict of settings drives both.
"""

from __future__ import annotations

from typing import Any, Optional

__all__ = ["Configuration", "DEFAULTS"]

#: key -> default (reference: PipelineOptions / TaskOptions)
DEFAULTS: dict[str, Any] = {
    "pipeline.micro-batch-size": 4096,
    "pipeline.max-parallelism": 128,
    "task.max-inflight": 2,
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
        self._values[key] = type(DEFAULTS[key])(value)
        return self

    def get(self, key: str) -> Any:
        return self._values.get(key, DEFAULTS[key])
