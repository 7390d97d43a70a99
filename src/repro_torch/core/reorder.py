"""Connection Reordering (paper §IV) — simulated annealing over topological orders.

Neighbor moves (paper §IV.A): pick a random connection e_i and window size
w ~ U{0..ws-1}; the window is e_i..e_{min(i+w, W)}.  With prob. 0.5 move the
window's connections left, else right:

  * left:  starting from the *leftmost*, move each connection left until a
    connection with the same input neuron, or whose output neuron equals our
    input neuron, is found; insert right after it (or at the very beginning).
  * right: starting from the *rightmost*, move each connection right until a
    connection with the same output neuron, or whose input neuron equals our
    output neuron, is found; insert right before it (or at the very end).

Both moves preserve topological validity: moving left never crosses the
producer of the moved connection's input; moving right never crosses a
consumer of its output.

Update rule (§IV.B): always accept improvements; accept a non-improvement with
probability 2^{-(newIOs - oldIOs) * t^sigma} at iteration t.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

from .graph import FFNN
from .iosim import IncrementalSimulator, IOStats, simulate


@dataclasses.dataclass
class ReorderResult:
    order: np.ndarray          # best order found
    ios: int                   # total I/Os of best order
    initial_ios: int
    history: np.ndarray        # accepted-order I/Os per iteration (len T+1)
    accepted: int
    proposed: int


def propose(
    order: List[int],
    src,
    dst,
    ws: int,
    rng: np.random.Generator,
    max_move_span: int = 0,
) -> List[int]:
    """One windowed left/right move; returns a new order (input not mutated).

    ``src``/``dst`` may be numpy arrays or plain lists; lists are ~4x faster
    for the scan loops below.
    """
    W = len(order)
    i = int(rng.integers(0, W))
    w = int(rng.integers(0, max(1, ws)))
    direction = 0 if rng.random() < 0.5 else 1
    return _apply_move(list(order), src, dst, i, w, direction, max_move_span)


def _apply_move(new: List[int], src, dst, i: int, w: int, direction: int,
                span: int = 0) -> List[int]:
    """Apply the windowed move in place on list ``new`` and return it.

    ``span`` > 0 caps how far any connection travels: the anchor scan stops
    after ``span`` positions and inserts there.  Cutting the scan short is
    always topologically safe — the shortened move crosses only connections
    already checked conflict-free (the full move's validity argument applies
    to every prefix of the scan).
    """
    W = len(new)
    j = min(i + w, W - 1)
    if direction == 0:
        # move window members left, starting from the leftmost (position i).
        # after each removal+reinsert, the window's remaining members shift
        # by at most the insertion; we track positions explicitly.
        for k in range(i, j + 1):
            pos = k  # current position of the connection to move
            e = new[pos]
            a = src[e]
            p = pos - 1
            lo = -1 if span <= 0 else max(-1, pos - span - 1)
            while p > lo:
                f = new[p]
                if src[f] == a or dst[f] == a:
                    break
                p -= 1
            # insert right after p
            if p + 1 != pos:
                new.pop(pos)
                new.insert(p + 1, e)
    else:
        # move window members right, starting from the rightmost (position j).
        for k in range(j, i - 1, -1):
            pos = k
            e = new[pos]
            b = dst[e]
            p = pos + 1
            hi = W if span <= 0 else min(W, pos + span + 1)
            while p < hi:
                f = new[p]
                if dst[f] == b or src[f] == b:
                    break
                p += 1
            # insert right before p
            if p - 1 != pos:
                new.pop(pos)
                new.insert(p - 1, e)
    return new


def connection_reordering(
    net: FFNN,
    order: np.ndarray,
    M: int,
    policy: str = "min",
    T: int = 20_000,
    sigma: float = 0.2,
    ws: Optional[int] = None,
    seed: int = 0,
    callback: Optional[Callable[[int, int, int], None]] = None,
    incremental: Optional[bool] = None,
    max_move_span: Optional[int] = None,
) -> ReorderResult:
    """Run Connection Reordering for ``T`` iterations.

    ``ws`` defaults to four times the average in-degree (paper §VI.A.1).
    ``callback(t, cur_ios, best_ios)`` is invoked every iteration if given.

    ``incremental`` selects the windowed delta evaluator
    (:class:`core.iosim.IncrementalSimulator`): each proposal is charged
    O(window + affected suffix) instead of a full O(W) re-simulation.  The
    delta totals are exact, so results are bit-identical to the full path
    for the same seed.  Default (None): on for the MIN policy, off for
    LRU/RR (whose recency state does not admit the cheap convergence
    splice).  Forcing ``incremental=True`` with a non-MIN policy raises.

    ``max_move_span`` (None/0 = the paper's unbounded scan) caps how far a
    proposal may carry any connection.  The paper's moves travel to the
    nearest dependency, which on 10k+-block DAGs makes the changed window —
    and hence the cost of even the *incremental* delta evaluation —
    arbitrarily large; a cap keeps every proposal's changed window (and its
    re-simulated suffix) O(ws + span).  Capped moves remain topologically
    valid (any prefix of the anchor scan is), so the result stays inside
    the Theorem-1 family after regrouping.
    """
    from . import _iosim_c

    if incremental is None:
        incremental = policy.lower() == "min"
    span = int(max_move_span or 0)
    if span < 0:
        raise ValueError(f"max_move_span must be >= 0, got {span}")
    rng = np.random.default_rng(seed)
    if ws is None:
        avg_in = net.W / max(1, net.N - net.I)
        ws = max(1, int(round(4 * avg_in)))
    use_c = _iosim_c.available()
    src32 = np.ascontiguousarray(net.src, dtype=np.int32)
    dst32 = np.ascontiguousarray(net.dst, dtype=np.int32)
    src_l = dst_l = None
    if not use_c:
        src_l, dst_l = net.src.tolist(), net.dst.tolist()

    cur = np.ascontiguousarray(order, dtype=np.int64).copy()
    inc_sim = IncrementalSimulator(net, cur, M, policy) if incremental else None
    cur_ios = inc_sim.total if inc_sim is not None \
        else simulate(net, cur, M, policy).total
    best = cur.copy()
    best_ios = cur_ios
    initial = cur_ios
    history = np.empty(T + 1, dtype=np.int64)
    history[0] = cur_ios
    accepted = 0
    W = net.W

    for t in range(1, T + 1):
        # identical proposal randomness on both paths
        i = int(rng.integers(0, W))
        w = int(rng.integers(0, max(1, ws)))
        direction = 0 if rng.random() < 0.5 else 1
        if use_c:
            cand = cur.copy()
            _iosim_c.propose_move_c(cand, src32, dst32, i, w, direction, span)
        else:
            cand = np.array(
                _apply_move(cur.tolist(), src_l, dst_l, i, w, direction,
                            span),
                dtype=np.int64,
            )
        ios = inc_sim.propose(cand) if inc_sim is not None \
            else simulate(net, cand, M, policy).total
        if ios < cur_ios:
            accept = True
        else:
            accept = bool(rng.random() < 2.0 ** (-(ios - cur_ios) * (t ** sigma)))
        if accept:
            cur, cur_ios = cand, ios
            accepted += 1
            if inc_sim is not None:
                inc_sim.commit()
            if ios < best_ios:
                best, best_ios = cand.copy(), ios
        history[t] = cur_ios
        if callback is not None:
            callback(t, cur_ios, best_ios)

    return ReorderResult(
        order=best,
        ios=int(best_ios),
        initial_ios=int(initial),
        history=history,
        accepted=accepted,
        proposed=T,
    )
