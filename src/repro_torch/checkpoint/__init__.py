"""Checkpoints: atomic, crc-checked manifest directories (the plan store
sits on them) and tree checkpoints in the reference's files."""

from .store import (
    CheckpointManager,
    latest_step,
    load_checkpoint,
    manifest_exists,
    read_manifest_dir,
    save_checkpoint,
    write_manifest_dir,
)

__all__ = ["CheckpointManager", "latest_step", "load_checkpoint",
           "manifest_exists", "read_manifest_dir", "save_checkpoint",
           "write_manifest_dir"]
