"""State descriptors: named, typed handles to keyed state (trimmed port of
``flink_tpu/state/descriptors.py``: the value descriptor and its TTL
config, the only kind the device backend's row plane holds)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

__all__ = ["StateDescriptor", "ValueStateDescriptor", "StateTtlConfig"]


@dataclass(frozen=True)
class StateTtlConfig:
    """Relaxed TTL (reference StateTtlConfig): entries expire ttl seconds
    after last update; cleanup happens lazily on access."""

    ttl: float
    update_on_read: bool = False


@dataclass(frozen=True)
class StateDescriptor:
    name: str
    kind: str  # value | list | reducing | aggregating | map
    default: Any = None
    ttl: Optional[StateTtlConfig] = None

    def __post_init__(self):
        if self.kind not in ("value", "list", "reducing", "aggregating",
                             "map"):
            raise ValueError(f"Unknown state kind {self.kind!r}")


def ValueStateDescriptor(name: str, default: Any = None,
                         ttl: Optional[StateTtlConfig] = None
                         ) -> StateDescriptor:
    return StateDescriptor(name, "value", default, ttl)
