"""Checkpoints of the port, on the reference's on-disk layout."""
from .checkpoint import (CheckpointManager, latest_step, restore_state,
                         save_state)

__all__ = ["CheckpointManager", "save_state", "restore_state", "latest_step"]
