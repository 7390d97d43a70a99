"""Compact Growth (paper §V) — constructive generation of I/O-optimal FFNNs.

The pebble/bag construction (Theorem 2): starting from an empty FFNN and an
empty bag (= fast memory), apply steps of four types
  1) add a gray or black pebble (<= M-2 pebbles present): read a neuron,
  2) draw a connection black -> gray: one multiply-accumulate,
  3) turn gray -> black: apply the activation,
  4) remove a black pebble: delete from fast memory,
and the resulting FFNN admits inference with exactly N + W reads and S writes
for memory size M — and *every* FFNN admitting that is constructible this way.

``generate`` implements the randomized generator of Appendix B; the returned
``order`` is the connection order induced by the construction, which achieves
the lower bound when simulated with M >= M_g.  ``bandwidth_order`` implements
Corollary 1: any FFNN of bandwidth k is compact-growable with M = k + 2.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .graph import FFNN


@dataclasses.dataclass
class CompactGrown:
    net: FFNN
    order: np.ndarray   # connection order induced by the construction
    M_g: int            # memory size the net was grown for


def generate(
    M_g: int,
    n_iters: int = 1000,
    in_degree: int = 5,
    seed: int = 0,
) -> CompactGrown:
    """Appendix-B generator.

    Start with M_g - 2 computed (black) input pebbles in the bag.  Each of the
    ``n_iters`` iterations: add a new neuron (gray pebble), draw incoming
    connections from ``in_degree`` random bag members, remove the last of those
    members from the bag.  Finally add one output neuron connected from all
    remaining bag members.
    """
    if M_g < 3:
        raise ValueError("M_g >= 3 required")
    rng = np.random.default_rng(seed)
    n_inputs = M_g - 2
    bag = list(range(n_inputs))          # black pebbles (computed neurons)
    src_l, dst_l = [], []
    next_id = n_inputs
    for _ in range(n_iters):
        new = next_id
        next_id += 1
        k = min(in_degree, len(bag))
        picks = rng.choice(len(bag), size=k, replace=False)
        for p in picks:
            src_l.append(bag[p])
            dst_l.append(new)
        # remove the last of the chosen neurons from the bag, then the new
        # neuron (now fully computed -> black) joins the bag.
        evicted = bag[picks[-1]]
        bag.remove(evicted)
        bag.append(new)
    out = next_id
    next_id += 1
    for b in bag:
        src_l.append(b)
        dst_l.append(out)

    n = next_id
    src = np.array(src_l, dtype=np.int32)
    dst = np.array(dst_l, dtype=np.int32)
    w = (rng.standard_normal(len(src)) / np.sqrt(max(1, in_degree))).astype(np.float32)
    is_input = np.zeros(n, bool)
    is_input[:n_inputs] = True
    is_output = np.zeros(n, bool)
    is_output[out] = True
    bias = (rng.standard_normal(n) * 0.1).astype(np.float32)
    net = FFNN(n, src, dst, w, is_input, is_output, bias)
    # construction order == creation order of the connections
    order = np.arange(net.W, dtype=np.int64)
    return CompactGrown(net=net, order=order, M_g=M_g)


def bandwidth(net: FFNN, neuron_order: Optional[np.ndarray] = None) -> int:
    """Bandwidth w.r.t. a topological neuron order (default: Kahn order):
    max distance in the order between the endpoints of any connection."""
    if neuron_order is None:
        neuron_order = net.neuron_topo_order()
    pos = np.empty(net.N, dtype=np.int64)
    pos[neuron_order] = np.arange(net.N)
    if net.W == 0:
        return 0
    return int(np.max(pos[net.dst] - pos[net.src]))


def bandwidth_order(net: FFNN, neuron_order: Optional[np.ndarray] = None) -> Tuple[np.ndarray, int]:
    """Corollary 1: with M = bandwidth + 2, the order 'connections sorted by the
    position of their output neuron' achieves the lower bound.  Returns
    (connection_order, required_M)."""
    if neuron_order is None:
        neuron_order = net.neuron_topo_order()
    pos = np.empty(net.N, dtype=np.int64)
    pos[neuron_order] = np.arange(net.N)
    k = bandwidth(net, neuron_order)
    order = np.lexsort((pos[net.src], pos[net.dst]))
    return order.astype(np.int64), k + 2
