"""Checkpoints in the reference's on-disk format (`repro.ckpt`), so a
checkpoint written by either package restores in the other."""
from repro_torch.ckpt.checkpoint import (CheckpointManager, save_pytree,
                                         restore_pytree, latest_step)

__all__ = ["CheckpointManager", "save_pytree", "restore_pytree",
           "latest_step"]
