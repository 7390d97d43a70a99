"""PyTorch/CUDA port of the I/O-efficient sparse inference engine.

A second package beside ``repro`` (the JAX reference), with the same module
names so each counterpart is easy to find:

  * ``core``    — a verbatim copy of ``repro.core`` (graph, Theorem-1 bounds,
                  the I/O simulator, Connection Reordering, BSR packing);
  * ``kernels`` — schedule packing (``ops``), oracles (``ref``) and the two
                  hand-written Hopper kernels (``bsr_matmul``: one layer per
                  launch; ``bsr_megakernel``: the whole net per launch);
  * ``engine``  — ``Engine`` / ``ExecutionPlan`` over those kernels;
  * ``serving`` — bucketed plans and the step-driven ``SparseServer``;
  * ``launch.serve`` — ``python -m repro_torch.launch.serve --sparse-ffnn``.

The package imports ``torch`` and numpy only — never ``jax`` and nothing of
``repro``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain PyTorch
version.
"""

from .convert import layers_from_numpy
from .engine import Engine, ExecutionPlan, IOReport
from .sparse import ScheduledSparseFFNN, prune_dense_stack

__all__ = [
    "Engine",
    "ExecutionPlan",
    "IOReport",
    "ScheduledSparseFFNN",
    "layers_from_numpy",
    "prune_dense_stack",
]
