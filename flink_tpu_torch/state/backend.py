"""Keyed state handles (trimmed port of ``flink_tpu/state/backend.py``:
the ``State`` and ``ValueState`` interfaces the device backend's row
plane implements)."""

from __future__ import annotations

from typing import Any

__all__ = ["State", "ValueState"]


class State:
    def clear(self) -> None:
        raise NotImplementedError


class ValueState(State):
    def value(self) -> Any:
        raise NotImplementedError

    def update(self, value: Any) -> None:
        raise NotImplementedError
