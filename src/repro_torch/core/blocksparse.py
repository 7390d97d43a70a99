"""Block-granular reformulation of the paper's I/O model for the TPU hierarchy.

The paper's model is scalar; a TPU moves 128-aligned tiles between HBM and VMEM
and multiplies them on a 128x128 MXU.  Everything in the paper survives the
substitution {neuron value -> activation tile, connection -> nonzero weight
block, fast memory of M words -> VMEM budget of M tiles}:

  * a sparse layer weight matrix becomes a BSR matrix; each nonzero block
    (bi, bj) is a "connection" from input tile bi to output tile bj;
  * stacking layers gives a *block DAG* — an FFNN in the paper's exact sense
    whose "neurons" are activation tiles; `to_block_ffnn` builds it;
  * `FFNN.theorem1_order` on the block DAG is the 2-optimal schedule (grouped
    by output tile: each output tile is VMEM-resident for one contiguous grid
    interval, so partial sums never spill — writes = #output tiles);
  * `core.reorder.connection_reordering` on the block DAG is Connection
    Reordering of the *kernel grid schedule*, with the exact simulated tile
    traffic (``core.iosim.simulate``) as objective;
  * the resulting order is exported as flat schedule arrays for the Pallas
    kernel (`kernels/bsr_matmul.py`) via `schedule_arrays`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .graph import FFNN
from .iosim import simulate


@dataclasses.dataclass
class BSRLayer:
    """One block-sparse layer: y = act(x @ W + b) with W in BSR form."""

    n_in: int                  # input features
    n_out: int                 # output features
    block_m: int               # input-tile size (rows of W blocks)
    block_n: int               # output-tile size (cols of W blocks)
    rows: np.ndarray           # int32 [nnz_blocks] input-tile index
    cols: np.ndarray           # int32 [nnz_blocks] output-tile index
    blocks: np.ndarray         # float32 [nnz_blocks, block_m, block_n]
    bias: np.ndarray           # float32 [n_out]

    @property
    def grid_in(self) -> int:
        return self.n_in // self.block_m

    @property
    def grid_out(self) -> int:
        return self.n_out // self.block_n

    @property
    def nnz_blocks(self) -> int:
        return int(len(self.rows))

    def to_dense(self) -> np.ndarray:
        w = np.zeros((self.n_in, self.n_out), dtype=self.blocks.dtype)
        bm, bn = self.block_m, self.block_n
        for r, c, b in zip(self.rows, self.cols, self.blocks):
            w[r * bm:(r + 1) * bm, c * bn:(c + 1) * bn] = b
        return w


def to_bsr(
    w: np.ndarray,
    block_m: int = 128,
    block_n: int = 128,
    density: Optional[float] = None,
    bias: Optional[np.ndarray] = None,
) -> BSRLayer:
    """Cluster an (optionally already-sparse) dense matrix into BSR blocks.

    If ``density`` is given, keep the top fraction of blocks by Frobenius mass
    (block-magnitude pruning — the block-granular analogue of the paper's
    magnitude pruning); otherwise keep all blocks with any nonzero.
    """
    n_in, n_out = w.shape
    if n_in % block_m or n_out % block_n:
        raise ValueError("matrix dims must be multiples of the block size")
    gi, go = n_in // block_m, n_out // block_n
    tiles = w.reshape(gi, block_m, go, block_n).transpose(0, 2, 1, 3)
    mass = np.sqrt((tiles.astype(np.float64) ** 2).sum(axis=(2, 3)))
    if density is not None:
        k = max(1, int(round(density * gi * go)))
        thresh = np.partition(mass.ravel(), -k)[-k]
        mask = mass >= thresh
    else:
        mask = mass > 0
    rows, cols = np.nonzero(mask)
    blocks = tiles[rows, cols].astype(np.float32)
    if bias is None:
        bias = np.zeros(n_out, dtype=np.float32)
    return BSRLayer(
        n_in=n_in, n_out=n_out, block_m=block_m, block_n=block_n,
        rows=rows.astype(np.int32), cols=cols.astype(np.int32),
        blocks=blocks, bias=np.asarray(bias, dtype=np.float32),
    )


@dataclasses.dataclass
class BlockFFNN:
    """A stack of BSR layers viewed as the paper's FFNN over activation tiles."""

    layers: List[BSRLayer]
    net: FFNN                    # block DAG: neurons = tiles, connections = blocks
    conn_layer: np.ndarray       # [Wb] which layer each block-connection belongs to
    conn_block: np.ndarray       # [Wb] index into that layer's rows/cols/blocks


def to_block_ffnn(layers: Sequence[BSRLayer]) -> BlockFFNN:
    """Build the block DAG.  Tile numbering: layer-0 input tiles first, then each
    layer's output tiles."""
    for a, b in zip(layers[:-1], layers[1:]):
        if a.n_out != b.n_in or a.block_n != b.block_m:
            raise ValueError("layer tile shapes must chain")
    offsets = [0, layers[0].grid_in]
    for l in layers:
        offsets.append(offsets[-1] + l.grid_out)
    n = offsets[-1]
    src_l, dst_l, lay_l, blk_l = [], [], [], []
    for k, l in enumerate(layers):
        src_l.append(l.rows.astype(np.int64) + offsets[k])
        dst_l.append(l.cols.astype(np.int64) + offsets[k + 1])
        lay_l.append(np.full(l.nnz_blocks, k, dtype=np.int32))
        blk_l.append(np.arange(l.nnz_blocks, dtype=np.int64))
    src = np.concatenate(src_l)
    dst = np.concatenate(dst_l)
    is_input = np.zeros(n, bool)
    is_input[: layers[0].grid_in] = True
    is_output = np.zeros(n, bool)
    is_output[offsets[-2]:] = True
    net = FFNN(
        n_neurons=n, src=src, dst=dst,
        weight=np.ones(len(src), dtype=np.float32),
        is_input=is_input, is_output=is_output,
        bias=np.zeros(n, dtype=np.float32),
    )
    return BlockFFNN(
        layers=list(layers), net=net,
        conn_layer=np.concatenate(lay_l),
        conn_block=np.concatenate(blk_l),
    )


def schedule_arrays(bffnn: BlockFFNN, order: np.ndarray, layer: int):
    """Export a (possibly reordered) block schedule for one layer's Pallas kernel.

    Returns (perm, row_ids, col_ids, first_visit, last_visit):
      * perm        — permutation of the layer's block storage into schedule order,
      * row/col ids — input/output tile per grid step,
      * first/last  — 1 where the grid step is the first/last visiting its output
                      tile (first -> initialize accumulator with zeros; last ->
                      the tile's value is final after this step).
    The Theorem-1 order makes every output tile's visits contiguous, which is
    what lets the kernel keep the accumulator in VMEM between steps.
    """
    sel = np.asarray(order)[bffnn.conn_layer[np.asarray(order)] == layer]
    blk = bffnn.conn_block[sel]
    lay = bffnn.layers[layer]
    rows = lay.rows[blk].astype(np.int32)
    cols = lay.cols[blk].astype(np.int32)
    nsteps = len(blk)
    first = np.zeros(nsteps, dtype=np.int32)
    last = np.zeros(nsteps, dtype=np.int32)
    seen: dict = {}
    for t, c in enumerate(cols):
        if int(c) not in seen:
            first[t] = 1
        seen[int(c)] = t
    for c, t in seen.items():
        last[t] = 1
    # a correct schedule for the revisit-kernel requires contiguous visits
    return blk.astype(np.int32), rows, cols, first, last


def regroup_by_output(net: FFNN, order: np.ndarray) -> np.ndarray:
    """Stable-regroup a connection order by output neuron, ranking groups by
    their *last* appearance; the internal order within groups is preserved
    (keeps CR's input-locality gains kernel-compatible).

    Ranking by last appearance keeps the result topological: for any edge
    B -> A, every B-incoming connection precedes the consuming connection in
    the input order, so last(B) < last(A) and group B lands wholly before
    group A — i.e. the group sequence is a topological order of the neurons,
    which is exactly the Theorem-1 family."""
    order = np.asarray(order)
    dst = net.dst[order]
    last_seen: dict = {}
    for idx, d in enumerate(dst):
        last_seen[int(d)] = idx
    group_rank = np.array([last_seen[int(d)] for d in dst])
    return order[np.argsort(group_rank, kind="stable")]


def is_contiguous_by_output(cols: np.ndarray) -> bool:
    """True iff every output tile's visits form one contiguous run."""
    seen = set()
    prev = None
    for c in cols:
        c = int(c)
        if c != prev and c in seen:
            return False
        seen.add(c)
        prev = c
    return True


def simulated_tile_traffic(bffnn: BlockFFNN, order: np.ndarray, M_tiles: int,
                           policy: str = "min"):
    """Exact simulated HBM<->VMEM tile transfers for a block schedule — the
    paper's I/O count at tile granularity (used as the CR objective and in
    the §Perf kernel-schedule hillclimb)."""
    return simulate(bffnn.net, order, M_tiles, policy)
