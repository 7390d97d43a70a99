"""FFNN-as-DAG representation (paper §II).

An FFNN is a weighted DAG given as a list of connection triples ``(i, j, w_ij)``
plus one value per vertex: the input value for input neurons and the bias for
non-input neurons.  Inference (Algorithm 1) processes the connections in a
*topological order of the connections* — whenever the output neuron of ``e_i``
is the input neuron of ``e_j`` we must have ``i < j``.

This module holds the graph container, topological-order utilities (including
the 2-optimal Theorem-1 order and the layer-by-layer order the paper compares
against), a reference forward pass used to check that reordering preserves the
computed function, and the random generator from Appendix A.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

Activation = Callable[[np.ndarray], np.ndarray]


def relu(x: np.ndarray) -> np.ndarray:
    return np.maximum(x, 0.0)


@dataclasses.dataclass
class FFNN:
    """Sparse FFNN given as connection triples over a DAG.

    Attributes:
      n_neurons: total number of neurons N (inputs + hidden + outputs).
      src, dst:  int32 arrays of shape [W] — connection endpoints.
      weight:    float32 array of shape [W].
      is_input:  bool [N] — input neurons (their ``bias`` slot holds the input value
                 during a concrete forward pass; for I/O analysis only the count I matters).
      is_output: bool [N] — output neurons (their values must be written back).
      bias:      float32 [N] — bias for non-input neurons, input value for inputs.
    """

    n_neurons: int
    src: np.ndarray
    dst: np.ndarray
    weight: np.ndarray
    is_input: np.ndarray
    is_output: np.ndarray
    bias: np.ndarray

    # ---- size aliases matching the paper's notation -------------------------
    @property
    def N(self) -> int:
        return int(self.n_neurons)

    @property
    def W(self) -> int:
        return int(len(self.src))

    @property
    def I(self) -> int:  # noqa: E743 — paper notation
        return int(self.is_input.sum())

    @property
    def S(self) -> int:
        return int(self.is_output.sum())

    def __post_init__(self):
        self.src = np.asarray(self.src, dtype=np.int32)
        self.dst = np.asarray(self.dst, dtype=np.int32)
        self.weight = np.asarray(self.weight, dtype=np.float32)
        self.is_input = np.asarray(self.is_input, dtype=bool)
        self.is_output = np.asarray(self.is_output, dtype=bool)
        self.bias = np.asarray(self.bias, dtype=np.float32)

    # ---- structure ----------------------------------------------------------
    def in_degree(self) -> np.ndarray:
        return np.bincount(self.dst, minlength=self.N).astype(np.int64)

    def out_degree(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.N).astype(np.int64)

    def neuron_topo_order(self) -> np.ndarray:
        """Kahn topological order of the neurons; raises on cycles."""
        indeg = self.in_degree()
        # adjacency in CSR-ish form
        order_by_src = np.argsort(self.src, kind="stable")
        sorted_src = self.src[order_by_src]
        starts = np.searchsorted(sorted_src, np.arange(self.N))
        ends = np.searchsorted(sorted_src, np.arange(self.N) + 1)
        out = np.empty(self.N, dtype=np.int64)
        head = 0
        stack = list(np.flatnonzero(indeg == 0))
        k = 0
        while stack:
            n = stack.pop()
            out[k] = n
            k += 1
            for e in order_by_src[starts[n]:ends[n]]:
                d = int(self.dst[e])
                indeg[d] -= 1
                if indeg[d] == 0:
                    stack.append(d)
        if k != self.N:
            raise ValueError("graph has a cycle — not an FFNN DAG")
        head = k  # noqa: F841  (kept for symmetry/debuggability)
        return out

    def validate(self) -> None:
        if (self.is_input & self.is_output).any():
            raise ValueError("a neuron cannot be both input and output")
        if self.in_degree()[self.is_input].sum() != 0:
            raise ValueError("input neurons must have no incoming connections")
        self.neuron_topo_order()  # raises on cycles

    # ---- topological orders of the connections ------------------------------
    def is_topological_connection_order(self, order: np.ndarray) -> bool:
        """Check: for connections e_i before e_j, dst(e_i) == src(e_j) ⇒ i < j."""
        order = np.asarray(order)
        if sorted(order.tolist()) != list(range(self.W)):
            return False
        # position of each connection in the order
        pos = np.empty(self.W, dtype=np.int64)
        pos[order] = np.arange(self.W)
        # for each neuron: latest position at which it is produced (appears as dst)
        # must precede the earliest position at which it is consumed (appears as src).
        last_prod = np.full(self.N, -1, dtype=np.int64)
        np.maximum.at(last_prod, self.dst, pos)
        first_cons = np.full(self.N, np.iinfo(np.int64).max, dtype=np.int64)
        np.minimum.at(first_cons, self.src, pos)
        return bool(np.all(last_prod < first_cons))

    def theorem1_order(self) -> np.ndarray:
        """The 2-optimal order from the proof of Theorem 1.

        Fix a topological order of the non-input neurons and reorder the
        connections so their *output* neurons appear in that order — the order
        is partitioned into one contiguous interval per non-input neuron.

        We use the (layer, id) topological order, which for layered nets is
        exactly the paper's initial order (Appendix A: "we order the
        connections layer-by-layer with respect to their output neuron").
        """
        layer = self.layers_longest_path()
        topo_pos = layer * (self.N + 1) + np.arange(self.N)
        return np.argsort(topo_pos[self.dst], kind="stable")

    def layer_order(self, layer_of: Optional[np.ndarray] = None) -> np.ndarray:
        """Layer-after-layer order (the 'standard' matrix-vector order, §II.A).

        Sorts connections by the layer of their output neuron; within a layer by
        *source* neuron — the column-major access of a matrix-vector product.
        """
        if layer_of is None:
            layer_of = self.layers_longest_path()
        return np.lexsort((self.src, layer_of[self.dst]))

    def layers_longest_path(self) -> np.ndarray:
        """Layer index = longest path from any input (0 for inputs)."""
        topo = self.neuron_topo_order()
        layer = np.zeros(self.N, dtype=np.int64)
        pos = np.empty(self.N, dtype=np.int64)
        pos[topo] = np.arange(self.N)
        order = np.argsort(pos[self.src], kind="stable")
        for e in order:
            s, d = int(self.src[e]), int(self.dst[e])
            if layer[s] + 1 > layer[d]:
                layer[d] = layer[s] + 1
        return layer

    # ---- reference execution -------------------------------------------------
    def forward(
        self,
        x: Optional[np.ndarray] = None,
        order: Optional[np.ndarray] = None,
        activation: Activation = relu,
    ) -> np.ndarray:
        """Reference forward pass following Algorithm 1's update rule.

        ``x`` (shape [I]) overrides the stored input values.  Returns the values
        of the output neurons (in increasing neuron-id order).  Processing in any
        topological connection order yields the same result — used by tests to
        show CR preserves the function.
        """
        vals = self.bias.astype(np.float64).copy()
        if x is not None:
            vals[self.is_input] = np.asarray(x, dtype=np.float64)
        if order is None:
            order = self.theorem1_order()
        remaining = self.in_degree()
        # inputs and in-degree-0 non-inputs are complete from the start
        complete = remaining == 0
        act = activation
        for e in order:
            s, d = int(self.src[e]), int(self.dst[e])
            if not complete[s]:
                raise ValueError("order is not topological: consumed incomplete neuron")
            vals[d] += self.weight[e] * vals[s]
            remaining[d] -= 1
            if remaining[d] == 0:
                vals[d] = act(np.asarray(vals[d]))
                complete[d] = True
        return vals[self.is_output].astype(np.float32)


def drop_isolated(net: FFNN) -> FFNN:
    """Remove neurons with no connections at all (dead units from pruning).

    Theorem 1 assumes a *connected* FFNN; block-magnitude pruning can leave
    tiles with neither incoming nor outgoing blocks.  The kernel still
    bias-patches them (they are dead code); the I/O analysis drops them."""
    deg = net.in_degree() + net.out_degree()
    keep = (deg > 0) | net.is_output
    if keep.all():
        return net
    new_id = np.cumsum(keep) - 1
    return FFNN(
        n_neurons=int(keep.sum()),
        src=new_id[net.src], dst=new_id[net.dst], weight=net.weight,
        is_input=net.is_input[keep], is_output=net.is_output[keep],
        bias=net.bias[keep],
    )


def partition_columns_balanced(loads: Sequence[int], parts: int) -> np.ndarray:
    """Assign columns to ``parts`` equal-count groups, balancing total load.

    The sharded engine partitions each layer's block-columns (output tiles)
    across the ``model`` axis of a device mesh.  ``shard_map`` needs every
    shard to hold the *same number* of columns (uniform per-device shapes),
    but throughput is governed by the heaviest shard's *load* (SparseNN:
    load balance across partitions, not total traffic, bounds end-to-end
    speed) — so within the equal-count constraint we balance the summed
    per-column loads (nnz blocks) with greedy LPT: columns in decreasing
    load order, each to the least-loaded shard that still has capacity.

    Returns ``assign`` (int64 [n_cols]) with values in [0, parts).
    Deterministic: ties break on column id, then shard id.  Raises unless
    ``n_cols`` is divisible by ``parts``.
    """
    loads = np.asarray(loads, dtype=np.int64)
    n = len(loads)
    if parts < 1:
        raise ValueError(f"parts must be >= 1, got {parts}")
    if n % parts:
        raise ValueError(
            f"cannot split {n} block-columns into {parts} equal shards; "
            "column count must be divisible by the model-axis size"
        )
    cap = n // parts
    assign = np.empty(n, dtype=np.int64)
    shard_load = np.zeros(parts, dtype=np.int64)
    shard_fill = np.zeros(parts, dtype=np.int64)
    # decreasing load, increasing column id on ties (stable sort of -loads)
    for c in np.argsort(-loads, kind="stable"):
        open_ = np.flatnonzero(shard_fill < cap)
        s = open_[np.argmin(shard_load[open_])]
        assign[c] = s
        shard_load[s] += loads[c]
        shard_fill[s] += 1
    return assign


# ------------------------------------------------------------------------------
# Constructors
# ------------------------------------------------------------------------------


def from_layer_sizes(
    sizes: Sequence[int],
    masks: Sequence[np.ndarray],
    weights: Optional[Sequence[np.ndarray]] = None,
    biases: Optional[Sequence[np.ndarray]] = None,
    seed: int = 0,
) -> FFNN:
    """Build a layered FFNN from per-layer-pair boolean masks.

    ``masks[k]`` has shape (sizes[k], sizes[k+1]) — True where a connection exists.
    """
    rng = np.random.default_rng(seed)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    n = int(offsets[-1])
    src_l, dst_l, w_l = [], [], []
    for k, mask in enumerate(masks):
        assert mask.shape == (sizes[k], sizes[k + 1])
        i, j = np.nonzero(mask)
        src_l.append(i + offsets[k])
        dst_l.append(j + offsets[k + 1])
        if weights is not None:
            w_l.append(weights[k][i, j])
        else:
            w_l.append(rng.standard_normal(len(i)) / np.sqrt(max(1, sizes[k])))
    src = np.concatenate(src_l) if src_l else np.zeros(0, np.int32)
    dst = np.concatenate(dst_l) if dst_l else np.zeros(0, np.int32)
    w = np.concatenate(w_l) if w_l else np.zeros(0, np.float32)
    is_input = np.zeros(n, bool)
    is_input[: sizes[0]] = True
    is_output = np.zeros(n, bool)
    is_output[offsets[-2]:] = True
    bias = rng.standard_normal(n).astype(np.float32) * 0.1
    if biases is not None:
        for k, b in enumerate(biases):
            bias[offsets[k + 1]: offsets[k + 2]] = b
    bias[is_input] = rng.standard_normal(int(is_input.sum())).astype(np.float32)
    return FFNN(n, src, dst, w, is_input, is_output, bias)


def random_ffnn(width: int, depth: int, density: float, seed: int = 0) -> FFNN:
    """Random sparse MLP per Appendix A.

    ``depth`` hidden+input layers of ``width`` neurons each, plus one output
    neuron.  For each non-output neuron draw k ~ U{1, max(1, ceil(2·p·next − 1))}
    outgoing connections to random neurons of the next layer.
    """
    rng = np.random.default_rng(seed)
    sizes = [width] * depth + [1]
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    n = int(offsets[-1])
    src_l, dst_l = [], []
    for k in range(len(sizes) - 1):
        nxt = sizes[k + 1]
        kmax = max(1, int(np.ceil(2.0 * density * nxt - 1)))
        for u in range(sizes[k]):
            kk = int(rng.integers(1, kmax + 1))
            kk = min(kk, nxt)
            targets = rng.choice(nxt, size=kk, replace=False)
            src_l.append(np.full(kk, offsets[k] + u, dtype=np.int64))
            dst_l.append(targets + offsets[k + 1])
    src = np.concatenate(src_l)
    dst = np.concatenate(dst_l)
    w = (rng.standard_normal(len(src)) / np.sqrt(width)).astype(np.float32)
    is_input = np.zeros(n, bool)
    is_input[:width] = True
    is_output = np.zeros(n, bool)
    is_output[-1] = True
    bias = (rng.standard_normal(n) * 0.1).astype(np.float32)
    net = FFNN(n, src, dst, w, is_input, is_output, bias)
    return net


def from_dense_weights(
    weights: Sequence[np.ndarray],
    density: float,
    seed: int = 0,
) -> FFNN:
    """Magnitude-prune a stack of dense layer weights to ``density`` and wrap as FFNN.

    This is the paper's BERT experiment path: take W1 (1024×4096), W2 (4096×1024),
    keep the largest-|w| fraction per matrix, build the sparse DAG.
    """
    masks, sizes = [], [weights[0].shape[0]]
    for wmat in weights:
        sizes.append(wmat.shape[1])
        k = max(1, int(round(density * wmat.size)))
        thresh = np.partition(np.abs(wmat).ravel(), -k)[-k]
        masks.append(np.abs(wmat) >= thresh)
    return from_layer_sizes(sizes, masks, weights=list(weights), seed=seed)
