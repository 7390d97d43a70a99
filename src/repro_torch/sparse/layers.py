"""Scheduled sparse FFNN execution: the paper's pipeline end to end.

prune -> BSR -> block DAG -> Theorem-1 schedule -> (optional) Connection
Reordering -> fused execution plan.  Port of ``repro.sparse.layers``: a thin
veneer over :class:`repro_torch.engine.Engine`.

Beside the reference's layers, the port has a gated-linear pair layer
(:class:`GLULayer`, pruned by :func:`prune_glu_ffn`): the gate and up
projections of a SwiGLU FFN, ``act(x @ Wg + bg) * (x @ Wu + bu)``, as two
block-sparse matrices with one block mask, so that the engine schedules a
kept (gate, up) pair as one block of its DAG.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar, List, Sequence, Union

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
class GLULayer:
    """A gate/up pair layer: ``y = act(x @ Wg + bg) * (x @ Wu + bu)``.

    The gate and up matrices share one block mask: kept block ``i`` is
    input tile ``rows[i]`` to output tile ``cols[i]`` in both.  Its storage
    packs the two blocks of a pair side by side, as the kernels stream them:
    ``blocks[i] = [gate block | up block]`` ([block_m, 2 * block_n]), and
    ``bias`` holds, per output tile, the gate's bias and then the up's.  To
    the engine's block DAG a pair is one connection (``rows``, ``cols``);
    ``act`` is the layer's epilogue in the engine (the hidden activation),
    applied to the gate.  ``n_out`` is the width of ``y``.
    """

    n_in: int
    n_out: int
    block_m: int
    block_n: int
    rows: np.ndarray           # int32 [pairs] input tile
    cols: np.ndarray           # int32 [pairs] output tile
    blocks: np.ndarray         # float32 [pairs, block_m, 2 * block_n]
    bias: np.ndarray           # float32 [grid_out * 2 * block_n]
    pair: ClassVar[bool] = True

    @property
    def grid_in(self) -> int:
        return self.n_in // self.block_m

    @property
    def grid_out(self) -> int:
        return self.n_out // self.block_n

    @property
    def nnz_blocks(self) -> int:
        return int(len(self.rows))

    def wide_bias(self) -> np.ndarray:
        """``[bg | bu]``: the bias of the layer's ``[gate | up]`` layer,
        which the layered path runs before the product."""
        return np.ascontiguousarray(np.asarray(self.bias).reshape(
            self.grid_out, 2, self.block_n).transpose(1, 0, 2)).reshape(-1)

    @classmethod
    def from_pair(cls, gate: BSRLayer, up: BSRLayer) -> "GLULayer":
        """The pair layer of two BSR layers with one block mask."""
        same = (gate.n_in, gate.n_out, gate.block_m, gate.block_n) == \
            (up.n_in, up.n_out, up.block_m, up.block_n)
        if not same or not (np.array_equal(gate.rows, up.rows)
                            and np.array_equal(gate.cols, up.cols)):
            raise ValueError("a pair layer's gate and up must have one shape "
                             "and one block mask")
        go, bn = gate.grid_out, gate.block_n
        bias = np.stack([np.asarray(gate.bias, np.float32).reshape(go, bn),
                         np.asarray(up.bias, np.float32).reshape(go, bn)],
                        axis=1)
        return cls(n_in=gate.n_in, n_out=gate.n_out, block_m=gate.block_m,
                   block_n=bn, rows=np.asarray(gate.rows, np.int32),
                   cols=np.asarray(gate.cols, np.int32),
                   blocks=np.concatenate([gate.blocks, up.blocks], axis=2
                                         ).astype(np.float32),
                   bias=bias.reshape(-1))


def pair_mask(w_gate: np.ndarray, w_up: np.ndarray, block: int,
              density: float) -> np.ndarray:
    """The (gate, up) block pairs that pruning to ``density`` keeps: the
    ``round(density * blocks)`` pairs (at least one) of largest joint
    Frobenius norm ``sqrt(|G_ij|^2 + |U_ij|^2)``.  bool [n_in / block,
    n_out / block]."""
    n_in, n_out = w_gate.shape
    if w_up.shape != w_gate.shape:
        raise ValueError("gate and up must have one shape")
    if n_in % block or n_out % block:
        raise ValueError("matrix dims must be multiples of the block size")
    gi, go = n_in // block, n_out // block
    mass = sum((w.astype(np.float64).reshape(gi, block, go, block) ** 2
                ).sum(axis=(1, 3)) for w in (w_gate, w_up))
    mass = np.sqrt(mass)
    k = max(1, int(round(density * gi * go)))
    thresh = np.partition(mass.ravel(), -k)[-k]
    return mass >= thresh


def prune_glu_ffn(
    w_gate: np.ndarray,
    w_up: np.ndarray,
    w_down: np.ndarray,
    density: float,
    block: int = 128,
    b_gate=None,
    b_up=None,
    b_down=None,
) -> List[Union[GLULayer, BSRLayer]]:
    """Block-magnitude-prune a gated FFN ``down(act(x Wg + bg) * (x Wu +
    bu)) + b_down`` to ``density``: the gate/up pair layer keeps its pairs
    by joint norm (:func:`pair_mask`), the down projection its blocks by
    their own norm.  Missing biases are zero.  Returns ``[pair, down]``."""
    mask = pair_mask(w_gate, w_up, block, density)
    gi, go = mask.shape
    rows, cols = np.nonzero(mask)

    def half(w, b):
        tiles = w.reshape(gi, block, go, block).transpose(0, 2, 1, 3)
        return BSRLayer(
            n_in=w.shape[0], n_out=w.shape[1], block_m=block, block_n=block,
            rows=rows.astype(np.int32), cols=cols.astype(np.int32),
            blocks=tiles[rows, cols].astype(np.float32),
            bias=np.zeros(w.shape[1], np.float32) if b is None
            else np.asarray(b, np.float32))

    pair = GLULayer.from_pair(half(w_gate, b_gate), half(w_up, b_up))
    down = to_bsr(w_down, block, block, density=density, bias=b_down)
    return [pair, down]


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
