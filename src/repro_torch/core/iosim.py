"""Exact I/O simulator for Algorithm 1 (paper §II) under MIN / LRU / RR eviction.

Cost model (paper §II):
  * every connection triple is streamed through fast memory: 1 read-I/O each,
    deleted for free after use (M ≥ 3 reserves one slot for it, so *neuron
    values* occupy at most M-1 slots — cf. the Theorem 2 proof);
  * a neuron-value access that misses fast memory costs 1 read-I/O
    (first access to a non-input neuron reads its bias, first access to an
    input neuron reads the input value, later misses re-read the stored value);
  * evicting a value costs 1 write-I/O iff the eviction must preserve it:
    the value is dirty (slow memory does not hold the current value) AND
    (it will be used again OR it belongs to an output neuron).  Everything
    else is a free deletion — this is the paper's "efficient eviction policy";
  * at the end of the computation every output value must reside in slow
    memory (dirty cached outputs are flushed, 1 write-I/O each).

Policies:
  * MIN  — Belady: evict the value referenced farthest in the future, preferring
           values never referenced again (paper: trivially implementable offline
           once the connection order is fixed).
  * LRU  — least-recently-used.
  * RR   — round-robin pointer over the M-1 slots.

The simulator is granularity-agnostic: a "value" can be a scalar (paper-faithful)
or an activation tile (the TPU block reformulation in ``core/blocksparse.py``).
"""

from __future__ import annotations

import dataclasses
import heapq
from bisect import bisect_left, bisect_right
from typing import List, Optional, Tuple

import numpy as np

from .graph import FFNN

INF = np.iinfo(np.int64).max


@dataclasses.dataclass(frozen=True)
class IOStats:
    reads: int
    writes: int

    @property
    def total(self) -> int:
        return self.reads + self.writes


def _build_trace(net: FFNN, order: np.ndarray):
    """Neuron-access trace of Algorithm 1: (src_0, dst_0, src_1, dst_1, ...)."""
    order = np.asarray(order, dtype=np.int64)
    src = net.src[order].astype(np.int64)
    dst = net.dst[order].astype(np.int64)
    trace = np.empty(2 * len(order), dtype=np.int64)
    trace[0::2] = src
    trace[1::2] = dst
    return trace


def _next_use(trace: np.ndarray, n_neurons: int) -> np.ndarray:
    """next_use[t] = next position > t at which trace[t] is accessed (INF if none).

    Vectorized: stable-sort positions by value; within each value group the next
    occurrence is simply the following sorted position.
    """
    T = len(trace)
    order = np.argsort(trace, kind="stable")
    sorted_vals = trace[order]
    nxt_sorted = np.full(T, INF, dtype=np.int64)
    if T > 1:
        same = sorted_vals[:-1] == sorted_vals[1:]
        nxt_sorted[:-1][same] = order[1:][same]
    nxt = np.empty(T, dtype=np.int64)
    nxt[order] = nxt_sorted
    return nxt


def _prev_use(trace: np.ndarray, n_neurons: int) -> np.ndarray:
    """prev_use[t] = last position < t at which trace[t] is accessed (-1 if none)."""
    T = len(trace)
    order = np.argsort(trace, kind="stable")
    sorted_vals = trace[order]
    prv_sorted = np.full(T, -1, dtype=np.int64)
    if T > 1:
        same = sorted_vals[:-1] == sorted_vals[1:]
        prv_sorted[1:][same] = order[:-1][same]
    prv = np.empty(T, dtype=np.int64)
    prv[order] = prv_sorted
    return prv


def simulate(
    net: FFNN,
    order: np.ndarray,
    M: int,
    policy: str = "min",
    validate_order: bool = False,
    force_python: bool = False,
) -> IOStats:
    """Count exact read/write I/Os of Algorithm 1 for ``order`` with memory ``M``.

    Uses the C accelerator (``_iosim_c``) when available unless
    ``force_python=True``; both paths implement identical semantics and the
    test suite cross-checks them.
    """
    if M < 3:
        raise ValueError("the model requires M >= 3")
    if validate_order and not net.is_topological_connection_order(order):
        raise ValueError("not a topological connection order")
    policy = policy.lower()
    if policy not in ("min", "lru", "rr"):
        raise ValueError(f"unknown eviction policy {policy!r}")

    if not force_python:
        fast = _simulate_fast(net, order, M, policy)
        if fast is not None:
            return fast

    trace_np = _build_trace(net, order)
    T = len(trace_np)
    capacity = M - 1  # one slot stays free for the streamed connection
    n = net.N

    # --- per-neuron state (plain Python lists: ~5x faster scalar access) ------
    trace = trace_np.tolist()
    in_cache = bytearray(n)
    dirty = bytearray(n)
    remaining_uses = np.bincount(trace_np, minlength=n).tolist()
    is_output = net.is_output
    is_output_l = is_output.astype(np.int8).tolist()

    nxt = _next_use(trace_np, n).tolist() if policy == "min" else None
    cur_next_use = [INF] * n if policy == "min" else None

    reads = int(net.W)  # every connection is read exactly once
    writes = 0
    cached = 0

    heappush, heappop = heapq.heappush, heapq.heappop

    if policy == "min":
        heap: list = []  # (-next_use, neuron), lazy invalidation
        for t in range(T):
            v = trace[t]
            if in_cache[v]:
                cur_next_use[v] = nxt[t]
                heappush(heap, (-nxt[t], v))
            else:
                if cached >= capacity:
                    while True:
                        negnu, u = heappop(heap)
                        if in_cache[u] and cur_next_use[u] == -negnu:
                            break
                    if dirty[u] and (remaining_uses[u] > 0 or is_output_l[u]):
                        writes += 1
                        dirty[u] = 0
                    in_cache[u] = 0
                    cached -= 1
                reads += 1
                in_cache[v] = 1
                cached += 1
                cur_next_use[v] = nxt[t]
                heappush(heap, (-nxt[t], v))
            remaining_uses[v] -= 1
            if t & 1:  # dst access: partial sum updated in fast memory
                dirty[v] = 1
    elif policy == "lru":
        lru_clock = 0
        lru_stamp = [0] * n
        lru_heap: list = []
        for t in range(T):
            v = trace[t]
            lru_clock += 1
            if in_cache[v]:
                lru_stamp[v] = lru_clock
                heappush(lru_heap, (lru_clock, v))
            else:
                if cached >= capacity:
                    while True:
                        stamp, u = heappop(lru_heap)
                        if in_cache[u] and lru_stamp[u] == stamp:
                            break
                    if dirty[u] and (remaining_uses[u] > 0 or is_output_l[u]):
                        writes += 1
                        dirty[u] = 0
                    in_cache[u] = 0
                    cached -= 1
                reads += 1
                in_cache[v] = 1
                cached += 1
                lru_stamp[v] = lru_clock
                heappush(lru_heap, (lru_clock, v))
            remaining_uses[v] -= 1
            if t & 1:
                dirty[v] = 1
    else:  # rr
        rr_slots = [-1] * capacity
        slot_of = [-1] * n
        rr_ptr = 0
        free_slots = list(range(capacity - 1, -1, -1))
        for t in range(T):
            v = trace[t]
            if not in_cache[v]:
                if cached >= capacity:
                    while True:
                        u = rr_slots[rr_ptr]
                        ptr = rr_ptr
                        rr_ptr = (rr_ptr + 1) % capacity
                        if u >= 0 and in_cache[u]:
                            break
                    if dirty[u] and (remaining_uses[u] > 0 or is_output_l[u]):
                        writes += 1
                        dirty[u] = 0
                    in_cache[u] = 0
                    cached -= 1
                    rr_slots[ptr] = v
                    slot_of[v] = ptr
                else:
                    s = free_slots.pop()
                    rr_slots[s] = v
                    slot_of[v] = s
                reads += 1
                in_cache[v] = 1
                cached += 1
            remaining_uses[v] -= 1
            if t & 1:
                dirty[v] = 1

    # flush: outputs must reside in slow memory.  Outputs evicted dirty already
    # paid their write inside the eviction branch above.
    in_cache_np = np.frombuffer(bytes(in_cache), dtype=np.int8).astype(bool)
    dirty_np = np.frombuffer(bytes(dirty), dtype=np.int8).astype(bool)
    writes += int((in_cache_np & dirty_np & is_output).sum())
    # output neurons that never appear in the trace (no in/out connections):
    # their bias is read and the activated value written, 1 I/O each.
    untouched = is_output & (np.bincount(trace_np, minlength=n) == 0)
    reads += int(untouched.sum())
    writes += int(untouched.sum())

    return IOStats(reads=reads, writes=writes)


def _simulate_fast(net: FFNN, order: np.ndarray, M: int, policy: str) -> Optional[IOStats]:
    """C-accelerated path; returns None when the accelerator is unavailable."""
    from . import _iosim_c

    if not _iosim_c.available():
        return None
    trace = _build_trace(net, order)
    res = _iosim_c.simulate_c(trace, net.N, M - 1, net.is_output, policy)
    if res is None:
        return None
    miss_reads, evict_writes = res
    reads = int(net.W) + miss_reads
    writes = evict_writes
    untouched = net.is_output & (np.bincount(trace, minlength=net.N) == 0)
    reads += int(untouched.sum())
    writes += int(untouched.sum())
    return IOStats(reads=reads, writes=writes)


class IncrementalSimulator:
    """Exact windowed/incremental re-evaluation of the I/O cost under MIN.

    The annealer (``core.reorder``) evaluates thousands of proposals, each a
    *local* permutation of the current order; a full ``simulate()`` per
    proposal is O(W).  This evaluator keeps the baseline simulation's state
    checkpointed and, per proposal, re-simulates only the part of the trace
    the move can actually affect:

      1. diff the candidate against the baseline order -> window [lo, hi];
      2. restart point R: pre-window, the only Belady inputs that change are
         the next-use keys of window-touched neurons, and those keys stay
         inside the window's trace span.  An eviction decision can only flip
         where BOTH the victim's key and the runner-up's key point into the
         window (keys before it still win, keys past it still lose, whatever
         the permutation).  The baseline run records (victim key, runner-up
         key) per eviction, so R = the first such "dangerous" eviction —
         usually the window start itself;
      3. resume the MIN simulation from the latest checkpoint <= R, reading
         next-use values through a window-aware accessor;
      4. stop as soon as the resumed cache state reconverges with a baseline
         checkpoint past the window (capacity is M-1 tiles, so reconvergence
         is typically immediate) and splice the baseline's suffix cost.

    The returned totals are *exactly* ``simulate(net, cand, M, "min").total``
    — validated in tests — at O(window + affected-suffix) cost instead of
    O(W).  ``commit()`` adopts the last proposed order by splicing the
    baseline structures (trace, next-use chains, access positions,
    checkpoints, eviction records) in O(window) plus O(#checkpoints).  The
    re-simulated segments run through the C accelerator (``_iosim_c``) when
    available, with the pure-Python runner as the reference fallback.

    Only the MIN policy is supported: LRU/RR recency state does not admit
    the same cheap convergence argument.  ``connection_reordering`` falls
    back to full simulation for those policies.
    """

    def __init__(self, net: FFNN, order: np.ndarray, M: int,
                 policy: str = "min", stride: Optional[int] = None):
        if M < 3:
            raise ValueError("the model requires M >= 3")
        if policy.lower() != "min":
            raise ValueError("IncrementalSimulator supports only the MIN policy")
        self.net = net
        self.M = M
        self.capacity = M - 1
        T = 2 * net.W
        if stride is None:
            stride = max(32, (T // 256) & ~1)
        if stride % 2:
            raise ValueError("stride must be even (trace parity)")
        self.stride = stride
        self.heavy_stride = stride * 16
        self._is_out_np = np.ascontiguousarray(net.is_output.astype(np.uint8))
        self._is_output_l = net.is_output.astype(np.int8).tolist()
        self._untouched: Optional[int] = None
        self._pending = None
        from . import _iosim_c
        self._c = _iosim_c
        self._use_c = _iosim_c.available()
        self._rebuild(np.ascontiguousarray(order, dtype=np.int64))

    # -- public API ---------------------------------------------------------
    @property
    def total(self) -> int:
        """Total I/Os of the current baseline order."""
        return self._total

    def propose(self, cand: np.ndarray) -> int:
        """Exact total I/Os of candidate order ``cand`` (not adopted)."""
        cand = np.ascontiguousarray(cand, dtype=np.int64)
        diff = np.nonzero(cand != self.order)[0]
        if len(diff) == 0:
            self._pending = None
            return self._total
        lo, hi = int(diff[0]), int(diff[-1])
        t_lo, t_hi_end = 2 * lo, 2 * hi + 2
        win = cand[lo:hi + 1]
        wtr = np.empty(2 * len(win), dtype=np.int64)
        wtr[0::2] = self.net.src[win]
        wtr[1::2] = self.net.dst[win]
        wtr_l = wtr.tolist()
        # window structures, vectorized: per-neuron access positions, the
        # in-window next-use chain (candidate coordinates), the first access
        # past the window per neuron ("after"), and the last pre-window
        # access per neuron (whose next-use key must be overridden).  The
        # old window holds the same neuron multiset, so its sorted grouping
        # aligns with the candidate's; that turns both boundary lookups into
        # plain gathers from next_use/prev_use.  The python loop below runs
        # once per *distinct* window neuron, not per access.
        L = len(wtr)
        wn = _next_use(wtr, self.net.N)
        wnxt = np.where(wn == INF, np.int64(0), wn + np.int64(t_lo))
        su = np.argsort(wtr, kind="stable")
        sv = wtr[su]
        cuts = np.nonzero(sv[1:] != sv[:-1])[0] + 1
        grp_starts = np.concatenate([[0], cuts])
        grp_ends = np.concatenate([cuts, [L]])
        pos_glob = su + t_lo
        old_tr = self.trace[t_lo:t_hi_end]
        osu = np.argsort(old_tr, kind="stable")
        osv = old_tr[osu]
        ocuts = np.nonzero(osv[1:] != osv[:-1])[0] + 1
        ostarts = np.concatenate([[0], ocuts])
        oends = np.concatenate([ocuts, [L]])
        after_vals = self.next_use[osu[oends - 1] + t_lo]
        ov_pos = self.prev_use[osu[ostarts] + t_lo]   # -1 where none
        ov_val = pos_glob[grp_starts]                 # first candidate access
        wnxt[pos_glob[grp_ends - 1] - t_lo] = after_vals
        win_pos: dict = {}
        for a, b in zip(grp_starts.tolist(), grp_ends.tolist()):
            win_pos[int(sv[a])] = pos_glob[a:b].tolist()
        # danger-based restart point (see class docstring, step 2)
        R = t_lo
        if len(self._ev_t):
            m = int(np.searchsorted(self._ev_t, t_lo))
            if m:
                k1, k2 = self._ev_k1[:m], self._ev_k2[:m]
                danger = ((k1 >= t_lo) & (k1 < t_hi_end)
                          & (k2 >= t_lo) & (k2 < t_hi_end))
                hits = np.nonzero(danger)[0]
                if len(hits):
                    R = int(self._ev_t[hits[0]])
        ki = bisect_right(self._ckpt_times, R) - 1
        runner = self._run_min_c if self._use_c else self._run_min
        total, new_ckpts, ev_rows, conv_at, dr, dw = runner(
            ki, t_lo, t_hi_end, wtr, wnxt, win_pos, ov_pos, ov_val)
        self._pending = (cand, t_lo, t_hi_end, wtr, wtr_l, win_pos,
                         ki, new_ckpts, ev_rows, conv_at, dr, dw, total,
                         (pos_glob, sv, grp_starts, grp_ends, after_vals,
                          ov_pos))
        return total

    def commit(self) -> None:
        """Adopt the last proposed order as the new baseline (O(window))."""
        if self._pending is None:
            return
        (cand, t_lo, t_hi_end, wtr, wtr_l, win_pos,
         ki, new_ckpts, ev_rows, conv_at, dr, dw, total,
         grp) = self._pending
        pos_glob, sv, grp_starts, grp_ends, after_vals, ov_pos = grp
        self._pending = None
        self.order = cand
        # 1. splice the trace
        self.trace[t_lo:t_hi_end] = wtr
        self.trace_l[t_lo:t_hi_end] = wtr_l
        # 2. splice per-neuron access positions (same count per neuron: the
        #    window holds the same connections, permuted)
        ap, astart = self.acc_pos_l, self.acc_start_l
        for v, lst in win_pos.items():
            s, e = astart[v], astart[v + 1]
            i0 = bisect_left(ap, t_lo, s, e)
            i1 = bisect_left(ap, t_hi_end, s, e)
            ap[i0:i1] = lst
        # 3. re-chain next-use / prev-use through the window, vectorized
        #    over the sorted (neuron, position) grouping from propose()
        nxt_np, prv_np = self.next_use, self.prev_use
        same = sv[:-1] == sv[1:]
        aidx = pos_glob[:-1][same]
        bidx = pos_glob[1:][same]
        nxt_np[aidx] = bidx
        prv_np[bidx] = aidx
        last_pos = pos_glob[grp_ends - 1]
        first_pos = pos_glob[grp_starts]
        nxt_np[last_pos] = after_vals
        fin = after_vals != INF
        prv_np[after_vals[fin]] = last_pos[fin]
        prv_np[first_pos] = ov_pos
        live = ov_pos >= 0
        nxt_np[ov_pos[live]] = first_pos[live]
        if not self._use_c:
            # keep the list mirror the pure-Python runner reads
            nl = self.next_use_l
            for i, val in zip(aidx.tolist(), bidx.tolist()):
                nl[i] = val
            for i, val in zip(last_pos.tolist(), after_vals.tolist()):
                nl[i] = val
            for i, val in zip(ov_pos[live].tolist(), first_pos[live].tolist()):
                nl[i] = val
        # 3. splice light checkpoints: prefix (valid: decisions before the
        #    restart point are provably identical) + those recorded during
        #    the resumed run + the baseline tail past the convergence point
        #    with cumulative counters shifted by the run's read/write delta
        t0 = self._ckpts[ki][0]
        if conv_at is not None:
            kp = bisect_left(self._ckpt_times, conv_at)
            tail = [(t, c, d, cr + dr, cw + dw)
                    for (t, c, d, cr, cw) in self._ckpts[kp:]]
            self._ckpts = self._ckpts[:ki + 1] + new_ckpts + tail
        else:
            self._ckpts = self._ckpts[:ki + 1] + new_ckpts
        self._ckpt_times = [c[0] for c in self._ckpts]
        self._ckpt_index = {t: i for i, t in enumerate(self._ckpt_times)}
        # 4. recompute heavy checkpoints invalidated by the window
        n = self.net.N
        for th in sorted(self._heavy):
            if t_lo < th < t_hi_end:
                tprev = max(t for t in self._heavy if t <= t_lo)
                rem = self._heavy[tprev].copy()
                rem -= np.bincount(self.trace[tprev:th],
                                   minlength=n).astype(rem.dtype)
                self._heavy[th] = rem
        # 5. eviction records: prefix keys that pointed into the permuted
        #    window are stale (the neuron's next access moved) — recompute
        #    from the spliced access positions (key at an eviction == first
        #    access of the neuron past the eviction time); then splice
        i0 = int(np.searchsorted(self._ev_t, t0))
        for karr, varr in ((self._ev_k1, self._ev_v1),
                           (self._ev_k2, self._ev_v2)):
            stale = np.nonzero((karr[:i0] >= t_lo) & (karr[:i0] < t_hi_end))[0]
            for j in stale.tolist():
                v = int(varr[j])
                s, e = astart[v], astart[v + 1]
                i = bisect_left(ap, int(self._ev_t[j]), s, e)
                karr[j] = ap[i] if i < e else INF
        parts = [np.stack([self._ev_t[:i0], self._ev_k1[:i0],
                           self._ev_k2[:i0], self._ev_v1[:i0],
                           self._ev_v2[:i0]], axis=1)]
        parts.extend(ev_rows)
        if conv_at is not None:
            ic = int(np.searchsorted(self._ev_t, conv_at))
            parts.append(np.stack([self._ev_t[ic:], self._ev_k1[ic:],
                                   self._ev_k2[ic:], self._ev_v1[ic:],
                                   self._ev_v2[ic:]], axis=1))
        self._set_ev(np.concatenate(parts, axis=0))
        self._total = total

    # -- internals ----------------------------------------------------------
    def _set_ev(self, ev: np.ndarray) -> None:
        ev = np.asarray(ev, dtype=np.int64).reshape(-1, 5)
        self._ev_t = np.ascontiguousarray(ev[:, 0])
        self._ev_k1 = np.ascontiguousarray(ev[:, 1])
        self._ev_k2 = np.ascontiguousarray(ev[:, 2])
        self._ev_v1 = np.ascontiguousarray(ev[:, 3])
        self._ev_v2 = np.ascontiguousarray(ev[:, 4])

    def _first_base_at_or_after(self, v: int, t: int) -> int:
        ap, astart = self.acc_pos_l, self.acc_start_l
        s, e = astart[v], astart[v + 1]
        i = bisect_left(ap, t, s, e)
        return ap[i] if i < e else INF

    def _record_ckpt(self, t: int, in_cache: np.ndarray, dirty: np.ndarray,
                     r: int, w: int):
        cset = tuple(int(v) for v in np.nonzero(in_cache)[0])
        dset = frozenset(int(v) for v in np.nonzero(in_cache & dirty)[0])
        return (t, cset, dset, int(r), int(w))

    def _rebuild(self, order: np.ndarray) -> None:
        """Full baseline MIN simulation with checkpoint recording (O(W))."""
        net = self.net
        n = net.N
        self.order = order
        trace = _build_trace(net, order)
        self.trace = trace
        T = len(trace)
        self.T = T
        self.trace_l = trace.tolist()
        self.next_use = _next_use(trace, n)
        self.next_use_l = self.next_use.tolist()
        self.prev_use = _prev_use(trace, n)
        idx = np.argsort(trace, kind="stable")
        counts = np.bincount(trace, minlength=n)
        starts = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        self.acc_pos_l = idx.tolist()
        self.acc_start_l = starts.tolist()
        if self._untouched is None:
            self._untouched = int((net.is_output & (counts == 0)).sum())

        in_cache = np.zeros(n, dtype=np.uint8)
        dirty = np.zeros(n, dtype=np.uint8)
        remaining = counts.astype(np.int64)
        out = np.zeros(3, dtype=np.int64)
        ckpts: List[Tuple] = []
        heavy = {}
        ev_parts: List[np.ndarray] = []
        stride = self.stride
        if self._use_c:
            t = 0
            while t < T:
                if t % self.heavy_stride == 0:
                    heavy[t] = remaining.copy()
                ckpts.append(self._record_ckpt(t, in_cache, dirty,
                                               out[0], out[1]))
                cached_ids = np.nonzero(in_cache)[0].astype(np.int64)
                cached_nu = np.array(
                    [self._first_base_at_or_after(int(v), t)
                     for v in cached_ids], dtype=np.int64)
                t_next = min(T, t + stride)
                seg = trace[t:t_next]
                ev_out = np.empty(5 * len(seg), dtype=np.int64)
                ok = self._c.resume_min_segment_c(
                    seg, self.next_use[t:t_next], n, self.capacity,
                    self._is_out_np, in_cache, dirty, remaining,
                    cached_ids, cached_nu, ev_out, out)
                if not ok:  # accelerator died mid-flight: start over in python
                    self._use_c = False
                    self._rebuild(order)
                    return
                rows = ev_out[:5 * int(out[2])].reshape(-1, 5).copy()
                rows[:, 0] += t
                ev_parts.append(rows)
                t = t_next
            reads, writes = int(out[0]), int(out[1])
            flush = int((in_cache.astype(bool) & dirty.astype(bool)
                         & net.is_output).sum())
            ev = (np.concatenate(ev_parts, axis=0) if ev_parts
                  else np.empty((0, 5), dtype=np.int64))
        else:
            reads, writes, flush, ckpts, heavy, ev = self._rebuild_py(
                counts.tolist())
        self._ckpts = ckpts
        self._ckpt_times = [c[0] for c in ckpts]
        self._ckpt_index = {t: i for i, t in enumerate(self._ckpt_times)}
        self._heavy = heavy
        self._set_ev(ev)
        u = self._untouched
        self._total = int(net.W + reads + u + writes + flush + u)

    def _rebuild_py(self, remaining: list):
        """Pure-Python baseline pass (reference path, no C accelerator)."""
        net = self.net
        n = net.N
        T = self.T
        trace_l = self.trace_l
        nxt = self.next_use_l
        is_out = self._is_output_l
        capacity = self.capacity
        stride = self.stride
        in_cache = bytearray(n)
        dirty = bytearray(n)
        cur_next_use = [INF] * n
        cache_set: set = set()
        heap: list = []
        heappush, heappop = heapq.heappush, heapq.heappop
        reads = writes = cached = 0
        ckpts: List[Tuple] = []
        heavy = {}
        ev_rec: List[Tuple[int, int, int, int, int]] = []
        for t in range(T):
            if t % stride == 0:
                cset = tuple(cache_set)
                dset = frozenset(v for v in cset if dirty[v])
                ckpts.append((t, cset, dset, reads, writes))
                if t % self.heavy_stride == 0:
                    heavy[t] = np.array(remaining, dtype=np.int64)
            v = trace_l[t]
            if in_cache[v]:
                cur_next_use[v] = nxt[t]
                heappush(heap, (-nxt[t], v))
            else:
                if cached >= capacity:
                    while True:
                        negnu, u = heappop(heap)
                        if in_cache[u] and cur_next_use[u] == -negnu:
                            break
                    if dirty[u] and (remaining[u] > 0 or is_out[u]):
                        writes += 1
                        dirty[u] = 0
                    in_cache[u] = 0
                    cache_set.discard(u)
                    cached -= 1
                    # runner-up key: discard stale heap tops, then peek
                    while heap:
                        negnu2, u2 = heap[0]
                        if in_cache[u2] and cur_next_use[u2] == -negnu2:
                            break
                        heappop(heap)
                    if heap:
                        ev_rec.append((t, -negnu, -heap[0][0], u, heap[0][1]))
                    else:
                        ev_rec.append((t, -negnu, -1, u, -1))
                reads += 1
                in_cache[v] = 1
                cache_set.add(v)
                cached += 1
                cur_next_use[v] = nxt[t]
                heappush(heap, (-nxt[t], v))
            remaining[v] -= 1
            if t & 1:
                dirty[v] = 1
        flush = sum(1 for v in cache_set if dirty[v] and is_out[v])
        ev = (np.array(ev_rec, dtype=np.int64).reshape(-1, 5) if ev_rec
              else np.empty((0, 5), dtype=np.int64))
        return reads, writes, flush, ckpts, heavy, ev

    def _remaining_at(self, t0: int) -> np.ndarray:
        """Per-neuron remaining-use counts entering trace position t0."""
        th = (t0 // self.heavy_stride) * self.heavy_stride
        while th not in self._heavy:
            th -= self.heavy_stride
        rem = self._heavy[th].copy()
        if th < t0:
            rem -= np.bincount(self.trace[th:t0],
                               minlength=self.net.N).astype(rem.dtype)
        return rem

    def _first_cand_at_or_after(self, v: int, t: int, t_lo: int,
                                t_hi_end: int, win_pos: dict) -> int:
        """First access of ``v`` at-or-after ``t`` under the candidate order
        (``t`` must be <= t_lo or >= t_hi_end — never inside the window)."""
        if t >= t_hi_end:
            return self._first_base_at_or_after(v, t)
        p = self._first_base_at_or_after(v, t)
        if p < t_lo:
            return p
        lst = win_pos.get(v)
        if lst is not None:
            return lst[0]
        return p  # >= t_hi_end (window positions only exist for win neurons)

    # -- C-accelerated resumed run -----------------------------------------
    def _run_min_c(self, ki: int, t_lo: int, t_hi_end: int,
                   wtr: np.ndarray, wnxt: np.ndarray, win_pos: dict,
                   ov_pos: np.ndarray, ov_val: np.ndarray):
        net = self.net
        n = net.N
        T = self.T
        t0, cached0, dirty0, r0, w0 = self._ckpts[ki]
        in_cache = np.zeros(n, dtype=np.uint8)
        dirty = np.zeros(n, dtype=np.uint8)
        if cached0:
            in_cache[list(cached0)] = 1
        if dirty0:
            dirty[list(dirty0)] = 1
        remaining = self._remaining_at(t0)
        out = np.zeros(3, dtype=np.int64)
        out[0], out[1] = r0, w0
        new_ckpts: List[Tuple] = []
        ev_rows: List[np.ndarray] = []

        def run_seg(trace_seg, nxt_seg, seg_start):
            if not len(trace_seg):
                return True
            cached_ids = np.nonzero(in_cache)[0].astype(np.int64)
            cached_nu = np.array(
                [self._first_cand_at_or_after(int(v), seg_start, t_lo,
                                              t_hi_end, win_pos)
                 for v in cached_ids], dtype=np.int64)
            ev_out = np.empty(5 * len(trace_seg), dtype=np.int64)
            ok = self._c.resume_min_segment_c(
                np.ascontiguousarray(trace_seg), np.ascontiguousarray(nxt_seg),
                n, self.capacity, self._is_out_np, in_cache, dirty,
                remaining, cached_ids, cached_nu, ev_out, out)
            if ok:
                rows = ev_out[:5 * int(out[2])].reshape(-1, 5).copy()
                rows[:, 0] += seg_start
                ev_rows.append(rows)
            return ok

        # pre-window segment: the last pre-window access of each window
        # neuron has a next-use key pointing into the window — redirect it
        # to the neuron's first candidate window position
        ok = True
        if t0 < t_lo:
            nxt_seg = self.next_use[t0:t_lo].copy()
            live = ov_pos >= t0
            nxt_seg[ov_pos[live] - t0] = ov_val[live]
            ok = run_seg(self.trace[t0:t_lo], nxt_seg, t0)
            if ok:
                new_ckpts.append(self._record_ckpt(t_lo, in_cache, dirty,
                                                   out[0], out[1]))
        # the window itself
        if ok:
            ok = run_seg(wtr, wnxt, t_lo)
        # post-window chunks, ending at baseline checkpoint times so the
        # convergence comparison can splice the baseline suffix cost
        if ok:
            times = self._ckpt_times
            j = bisect_right(times, t_hi_end)
            t = t_hi_end
            while t < T:
                ci = self._ckpt_index.get(t)
                if ci is not None and t >= t_hi_end and t > t0:
                    _, bc, bd, br, bw = self._ckpts[ci]
                    if len(bc) == int(in_cache.sum()) and \
                            all(in_cache[u] for u in bc) and \
                            all(bool(dirty[u]) == (u in bd) for u in bc):
                        total = self._total + int(out[0] - br) + \
                            int(out[1] - bw)
                        return (total, new_ckpts, ev_rows, t,
                                int(out[0] - br), int(out[1] - bw))
                new_ckpts.append(self._record_ckpt(t, in_cache, dirty,
                                                   out[0], out[1]))
                t_next = times[j] if j < len(times) else T
                j += 1
                if t_next <= t:
                    continue
                ok = run_seg(self.trace[t:t_next], self.next_use[t:t_next], t)
                if not ok:
                    break
                t = t_next
        if not ok:  # accelerator failure: fall back to the reference runner
            self._use_c = False
            self.next_use_l = self.next_use.tolist()  # refresh the mirror
            return self._run_min(ki, t_lo, t_hi_end, wtr, wnxt, win_pos)
        flush = int((in_cache.astype(bool) & dirty.astype(bool)
                     & net.is_output).sum())
        u_ = self._untouched
        total = int(net.W + out[0] + u_ + out[1] + flush + u_)
        return (total, new_ckpts, ev_rows, None,
                int(out[0] - r0), int(out[1] - w0))

    # -- pure-Python resumed run (reference path) ---------------------------
    def _run_min(self, ki: int, t_lo: int, t_hi_end: int,
                 wtr: np.ndarray, wnxt_np: np.ndarray, win_pos: dict,
                 ov_pos: Optional[np.ndarray] = None,
                 ov_val: Optional[np.ndarray] = None):
        """Resume the MIN simulation from checkpoint ``ki`` under the
        candidate trace; returns (total, new_ckpts, ev_rows, converged_at,
        dr, dw).  Pre-window next-use overrides are resolved lazily here, so
        ``ov_pos``/``ov_val`` are accepted for signature parity and unused."""
        net = self.net
        n = net.N
        T = self.T
        stride = self.stride
        t0, cached0, dirty0, r0, w0 = self._ckpts[ki]
        r, w = r0, w0
        trace_l = self.trace_l
        next_use_l = self.next_use_l
        ap, astart = self.acc_pos_l, self.acc_start_l
        is_out = self._is_output_l
        capacity = self.capacity
        ckpts = self._ckpts
        ckpt_index = self._ckpt_index
        wtr_l = wtr.tolist()
        wnxt = wnxt_np.tolist()

        def nxt_after(t: int, v: int) -> int:
            """Next access of ``v`` strictly after ``t`` under the candidate
            order; only called for t < t_lo."""
            nu = next_use_l[t] if t >= 0 and trace_l[t] == v else -1
            if nu >= 0:
                if nu < t_lo or v not in win_pos:
                    return nu
                return win_pos[v][0]
            s, e = astart[v], astart[v + 1]
            i = bisect_right(ap, t, s, e)
            if i < e and ap[i] < t_lo:
                return ap[i]
            lst = win_pos.get(v)
            if lst is not None:
                return lst[0]
            i = bisect_left(ap, t_hi_end, s, e)
            return ap[i] if i < e else INF

        in_cache = bytearray(n)
        dirty = bytearray(n)
        for v in cached0:
            in_cache[v] = 1
        for v in dirty0:
            dirty[v] = 1
        cache_set = set(cached0)
        cached = len(cached0)
        remaining = self._remaining_at(t0).tolist()
        cur_next_use = [INF] * n
        heap: list = []
        heappush, heappop = heapq.heappush, heapq.heappop
        for v in cached0:
            nu = self._first_cand_at_or_after(v, t0, t_lo, t_hi_end, win_pos)
            cur_next_use[v] = nu
            heappush(heap, (-nu, v))

        new_ckpts: List[Tuple] = []
        ev_rec: List[Tuple[int, int, int, int, int]] = []
        t = t0
        while t < T:
            if t % stride == 0 and t > t0:
                if t >= t_hi_end:
                    ci = ckpt_index.get(t)
                    if ci is not None:
                        _, bc, bd, br, bw = ckpts[ci]
                        if len(bc) == cached and \
                                all(in_cache[u] for u in bc) and \
                                all((dirty[u] == 1) == (u in bd) for u in bc):
                            # cache state reconverged with the baseline: the
                            # remaining suffix costs exactly what it cost there
                            total = self._total + (r - br) + (w - bw)
                            ev = (np.array(ev_rec, np.int64).reshape(-1, 5)
                                  if ev_rec else np.empty((0, 5), np.int64))
                            return total, new_ckpts, [ev], t, r - br, w - bw
                cset = tuple(cache_set)
                dset = frozenset(u for u in cset if dirty[u])
                new_ckpts.append((t, cset, dset, r, w))
            if t >= t_hi_end:
                v = trace_l[t]
                nu = next_use_l[t]
            elif t >= t_lo:
                v = wtr_l[t - t_lo]
                nu = wnxt[t - t_lo]
            else:
                v = trace_l[t]
                nu = nxt_after(t, v)
            if in_cache[v]:
                cur_next_use[v] = nu
                heappush(heap, (-nu, v))
            else:
                if cached >= capacity:
                    while True:
                        negnu, u = heappop(heap)
                        if in_cache[u] and cur_next_use[u] == -negnu:
                            break
                    if dirty[u] and (remaining[u] > 0 or is_out[u]):
                        w += 1
                        dirty[u] = 0
                    in_cache[u] = 0
                    cache_set.discard(u)
                    cached -= 1
                    while heap:
                        negnu2, u2 = heap[0]
                        if in_cache[u2] and cur_next_use[u2] == -negnu2:
                            break
                        heappop(heap)
                    if heap:
                        ev_rec.append((t, -negnu, -heap[0][0], u, heap[0][1]))
                    else:
                        ev_rec.append((t, -negnu, -1, u, -1))
                r += 1
                in_cache[v] = 1
                cache_set.add(v)
                cached += 1
                cur_next_use[v] = nu
                heappush(heap, (-nu, v))
            remaining[v] -= 1
            if t & 1:
                dirty[v] = 1
            t += 1
        flush = sum(1 for u in cache_set if dirty[u] and is_out[u])
        u_ = self._untouched
        total = int(net.W + r + u_ + w + flush + u_)
        ev = (np.array(ev_rec, np.int64).reshape(-1, 5) if ev_rec
              else np.empty((0, 5), np.int64))
        return total, new_ckpts, [ev], None, r - r0, w - w0


def simulate_curve(
    net: FFNN,
    order: np.ndarray,
    Ms: np.ndarray,
    policy: str = "min",
) -> np.ndarray:
    """Total I/Os for a sweep of memory sizes (paper Fig. 3/5)."""
    return np.array([simulate(net, order, int(m), policy).total for m in Ms])


def trace_length(net: FFNN) -> int:
    return 2 * net.W
