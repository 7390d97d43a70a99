"""Scheduled sparse FFNN execution: the paper's pipeline end to end.

prune -> BSR -> block DAG -> Theorem-1 schedule -> (optional) Connection
Reordering -> fused execution plan.  Port of ``repro.sparse.layers``: a thin
veneer over :class:`repro_torch.engine.Engine`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Union

import numpy as np
import torch

from ..core.blocksparse import (
    BlockFFNN,
    BSRLayer,
    simulated_tile_traffic,
    to_bsr,
)
from ..engine import Engine, ExecutionPlan
from ..kernels.ops import CompiledSchedule


def prune_dense_stack(
    weights: Sequence[np.ndarray],
    biases: Sequence[np.ndarray],
    density: float,
    block_m: int = 128,
    block_n: int = 128,
) -> List[BSRLayer]:
    """Block-magnitude-prune a stack of dense layers to ``density``."""
    return [
        to_bsr(w, block_m, block_n, density=density, bias=b)
        for w, b in zip(weights, biases)
    ]


@dataclasses.dataclass
class ScheduledSparseFFNN:
    """Multi-layer block-sparse FFNN with a paper-optimized execution schedule."""

    layers: List[BSRLayer]
    schedules: List[CompiledSchedule]
    block_ffnn: BlockFFNN
    order: np.ndarray          # block-DAG connection order in effect
    plan: ExecutionPlan
    engine: Engine
    activation: Union[str, Callable] = "relu"

    @classmethod
    def build(
        cls,
        layers: Sequence[BSRLayer],
        activation: Union[str, Callable] = "relu",
        reorder: bool = False,
        M_tiles: int = 3,
        reorder_iters: int = 2000,
        seed: int = 0,
        backend: str = "auto",
        fuse: bool = True,
        device="cuda",
    ) -> "ScheduledSparseFFNN":
        """Compile with the Theorem-1 schedule; optionally improve it with CR
        (re-grouped by output tile so the kernels can run it).  With
        ``fuse=True`` the whole net runs as one megakernel launch."""
        engine = Engine(
            backend=backend, activation=activation, final_activation=None,
            reorder=reorder, M_tiles=M_tiles, reorder_iters=reorder_iters,
            seed=seed, fuse=fuse, device=device,
        )
        plan = engine.compile(list(layers))
        return cls(
            layers=plan.layers, schedules=plan.schedules,
            block_ffnn=plan.block_ffnn, order=plan.order,
            plan=plan, engine=engine, activation=activation,
        )

    @property
    def fused(self) -> bool:
        """True when the compiled plan runs as one flat cross-layer dispatch."""
        return self.plan.fused

    def __call__(self, x) -> torch.Tensor:
        return self.plan(x)

    def simulated_ios(self, M_tiles: int = 3, policy: str = "min"):
        """Exact simulated tile I/Os of the current order (paper's cost model)."""
        return simulated_tile_traffic(self.block_ffnn, self.order, M_tiles, policy)
