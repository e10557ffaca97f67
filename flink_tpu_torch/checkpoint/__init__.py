"""Checkpoints: the coordinator, storage, and the restore map."""

from .coordinator import CheckpointCoordinator, build_restore_map  # noqa: F401
from .storage import (  # noqa: F401
    CompletedCheckpoint, CorruptArtifactError, FsCheckpointStorage,
    MemoryCheckpointStorage,
)
