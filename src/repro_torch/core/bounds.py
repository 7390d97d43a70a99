"""Theorem 1 bounds and the witness constructions of Propositions 1–2.

Theorem 1 (connected FFNN, M >= 3):
    W + N + S  <=  IOs(N, M)  <=  2 (W + N - I)
    W + N      <=  rIOs(N, M) <=  2 W + N - I
    S          <=  wIOs(N, M) <=  N - I
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .graph import FFNN, from_layer_sizes


@dataclasses.dataclass(frozen=True)
class Bounds:
    reads_lo: int
    reads_hi: int
    writes_lo: int
    writes_hi: int

    @property
    def total_lo(self) -> int:
        return self.reads_lo + self.writes_lo

    @property
    def total_hi(self) -> int:
        # Theorem 1 upper bound: 2 (W + N - I) = (2W + N - I) + (N - I)
        return self.reads_hi + self.writes_hi


def theorem1_bounds(net: FFNN) -> Bounds:
    W, N, I, S = net.W, net.N, net.I, net.S
    return Bounds(
        reads_lo=W + N,
        reads_hi=2 * W + N - I,
        writes_lo=S,
        writes_hi=N - I,
    )


# ------------------------------------------------------------------------------
# Witnesses (used by tests to check tightness, mirroring Lemmas 1-3 / Prop. 2)
# ------------------------------------------------------------------------------


def lemma1_net(M: int, depth: int = 4, seed: int = 0) -> FFNN:
    """Layered FFNN where consecutive layers fit in M-1 slots: attains the lower
    bound exactly (Lemma 1)."""
    width = max(1, (M - 1) // 2)
    sizes = [width] * depth
    rng = np.random.default_rng(seed)
    masks = [rng.random((sizes[k], sizes[k + 1])) < 0.5 for k in range(depth - 1)]
    for m in masks:  # keep connected: every row/col has an entry
        m[np.arange(m.shape[0]), np.arange(m.shape[0]) % m.shape[1]] = True
        m[np.arange(m.shape[1]) % m.shape[0], np.arange(m.shape[1])] = True
    return from_layer_sizes(sizes, masks, seed=seed)


def lemma2_net(n_inputs: int, seed: int = 0) -> FFNN:
    """Star: I inputs -> 1 output.  IOs = 2 (W + N - I) exactly (Lemma 2)."""
    mask = np.ones((n_inputs, 1), dtype=bool)
    return from_layer_sizes([n_inputs, 1], [mask], seed=seed)


def lemma3_net(n_inputs: int, hidden: int, n_outputs: int, seed: int = 0) -> FFNN:
    """I inputs, one hidden layer of h, S outputs with S >> h: wIOs ≈ N - I (Lemma 3)."""
    rng = np.random.default_rng(seed)
    m1 = rng.random((n_inputs, hidden)) < 0.5
    m1[:, 0] = True
    m1[0, :] = True
    m2 = rng.random((hidden, n_outputs)) < 0.5
    m2[:, 0] = True
    m2[0, :] = True
    return from_layer_sizes([n_inputs, hidden, n_outputs], [m1, m2], seed=seed)


def proposition2_net(M: int, c: int, seed: int = 0) -> FFNN:
    """2M parallel chains of length c between one input and one output neuron.

    Layer-after-layer inference needs >= M·c write-I/Os; chain-after-chain needs
    exactly 1 temporary-free schedule (S=1 write).  (Proposition 2.)
    """
    chains = 2 * M
    sizes = [1] + [chains] * c + [1]
    masks = []
    masks.append(np.ones((1, chains), dtype=bool))
    eye = np.eye(chains, dtype=bool)
    for _ in range(c - 1):
        masks.append(eye)
    masks.append(np.ones((chains, 1), dtype=bool))
    return from_layer_sizes(sizes, masks, seed=seed)


def chain_order(net: FFNN) -> np.ndarray:
    """Chain-after-chain connection order for ``proposition2_net`` (DFS from input)."""
    # depth-first topological order over connections: follow each chain to the end.
    order_by_src = np.argsort(net.src, kind="stable")
    sorted_src = net.src[order_by_src]
    starts = np.searchsorted(sorted_src, np.arange(net.N))
    ends = np.searchsorted(sorted_src, np.arange(net.N) + 1)
    remaining_in = net.in_degree()
    out: list = []
    # process one chain at a time: for each first-layer edge, walk the chain
    roots = np.flatnonzero(net.is_input)
    stack = []
    for r in roots:
        for e in order_by_src[starts[r]:ends[r]][::-1]:
            stack.append(int(e))
    seen_edge = np.zeros(net.W, dtype=bool)
    while stack:
        e = stack.pop()
        if seen_edge[e]:
            continue
        seen_edge[e] = True
        out.append(e)
        d = int(net.dst[e])
        remaining_in[d] -= 1
        if remaining_in[d] == 0:
            for e2 in order_by_src[starts[d]:ends[d]][::-1]:
                stack.append(int(e2))
    assert len(out) == net.W, "graph not fully reachable from inputs"
    return np.array(out, dtype=np.int64)
