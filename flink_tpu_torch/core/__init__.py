"""Core substrate of the port: records, key groups, watermarks, config."""

from .config import Configuration  # noqa: F401
from .elements import MAX_WATERMARK, Watermark  # noqa: F401
from .keygroups import (  # noqa: F401
    KeyGroupRange, hash_batch, key_groups_for_hash_batch, murmur_mix,
)
from .records import MAX_TIMESTAMP, MIN_TIMESTAMP, RecordBatch, Schema  # noqa: F401
from .watermarks import WatermarkStrategy  # noqa: F401
