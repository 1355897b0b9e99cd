"""Fault-tolerant checkpointing (paper §4.4 'Fault tolerance'), on the
reference's on-disk layout."""

from repro_torch.checkpoint.store import save_checkpoint, restore_checkpoint, latest_step
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "CheckpointManager"]
