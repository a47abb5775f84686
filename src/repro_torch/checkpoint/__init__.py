"""Checkpoint files in the reference's ``.npz`` layout (``ckpt``)."""
from .ckpt import (CheckpointManager, flatten, restore_pytree,  # noqa: F401
                   save_pytree)
