"""Manifest directories: named arrays + JSON metadata, atomic and crc-checked.

Only the manifest layer of ``repro.checkpoint`` is ported so far (the plan
store sits on it); the tree checkpoints come with the training slice.
"""

from .store import manifest_exists, read_manifest_dir, write_manifest_dir

__all__ = ["manifest_exists", "read_manifest_dir", "write_manifest_dir"]
