"""Sharded, atomic, elastically-restorable checkpointing (port of
``repro.checkpoint``; the same on-disk format)."""
from repro_torch.checkpoint.checkpointer import (
    CheckpointManager,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)

__all__ = [
    "CheckpointManager", "latest_step", "load_checkpoint", "save_checkpoint",
]
