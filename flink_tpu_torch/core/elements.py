"""Stream elements besides record batches (copy of the ``Watermark`` part
of ``flink_tpu/core/elements.py``)."""

from __future__ import annotations

from dataclasses import dataclass

from .records import MAX_TIMESTAMP

__all__ = ["Watermark", "MAX_WATERMARK"]


@dataclass(frozen=True)
class Watermark:
    """Event-time watermark: no further records with ts <= this will arrive."""

    timestamp: int


MAX_WATERMARK = Watermark(MAX_TIMESTAMP)
