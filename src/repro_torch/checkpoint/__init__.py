"""Atomic, hash-verified checkpoints of nested trees of arrays; the port
of ``repro.checkpoint``, whose files it reads and writes."""

from .manager import (CheckpointManager, load_checkpoint_tree,
                      restore_checkpoint, save_checkpoint)

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint",
           "load_checkpoint_tree"]
