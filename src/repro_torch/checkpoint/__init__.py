"""Checkpoints of parameter and optimizer trees, in the reference's
format."""
from .store import (CheckpointManager, restore_checkpoint,  # noqa: F401
                    save_checkpoint)
