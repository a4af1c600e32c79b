"""Checkpointing: atomic, compressed (zstd, zlib fallback), restored onto
the caller's device.

Port of ``repro.ckpt``.
"""
from repro_torch.ckpt.checkpoint import (
    CheckpointManager, latest_step, restore_checkpoint, save_checkpoint,
)

__all__ = [
    "CheckpointManager", "latest_step", "restore_checkpoint", "save_checkpoint",
]
