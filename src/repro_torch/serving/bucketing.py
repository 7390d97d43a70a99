"""Bucketed execution plans: variable batch sizes over one compiled schedule.

Port of ``repro.serving.bucketing`` (sharded plans are not ported yet).  The
offline cost — block DAG, Theorem-1 order, Connection Reordering, schedule
packing — is paid once by a single ``Engine.compile``, or not at all on a
plan-store hit; each power-of-two batch bucket gets its own forward over the
*same* schedule tensors, a batch of n rows runs through the smallest bucket
>= n, and is padded only up to that bucket.  The kernels' work grows with
the padded batch, so small buckets keep tail batches cheap.

The pipeline's hand-off unit, :class:`FormedBatch`, and its per-(server,
bucket) dispatch lanes, :class:`DispatchQueues`, are the reference's own
code: the scheduler forms batches against a snapshot of the plan set, and a
lane admits one in-flight batch at a time.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.blocksparse import BlockFFNN, BSRLayer
from ..engine import Engine, ExecutionPlan
from ..obs.trace import NULL_TRACER


def bucket_sizes(max_batch: int) -> Tuple[int, ...]:
    """Powers of two up to ``max_batch``, plus ``max_batch`` itself when it
    is not a power of two."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    sizes = []
    b = 1
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch)
    return tuple(sizes)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class BucketedPlanSet:
    """One compiled schedule, one forward per batch bucket."""

    base: ExecutionPlan
    buckets: Tuple[int, ...]
    plans: Dict[int, ExecutionPlan]
    cache_hit: bool = False           # True when the base plan came warm
    bucket_calls: Dict[int, int] = dataclasses.field(default_factory=dict)
    warmup_s: Dict[int, float] = dataclasses.field(default_factory=dict)
    compile_s: float = 0.0            # wall time of the compile/store lookup
    safe_mode: bool = False           # True on a safe twin (per layer)
    safe: Optional["BucketedPlanSet"] = None   # precompiled safe-mode twin
    tracer: Optional[object] = dataclasses.field(default=None, repr=False,
                                                 compare=False)
    # guards ``bucket_calls``: an abandoned timed-out attempt may still run
    # a bucket while its retry runs it again
    _mu: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, init=False, repr=False,
        compare=False)

    @property
    def _tr(self):
        tr = self.tracer
        return tr if tr is not None else NULL_TRACER

    @classmethod
    def compile(
        cls,
        net: Union[BlockFFNN, Sequence[BSRLayer]],
        engine: Optional[Engine] = None,
        max_batch: int = 32,
        plan_store=None,
        backend: Optional[str] = None,
        safe_twin: bool = False,
    ) -> "BucketedPlanSet":
        """Compile the schedule once, then fan it out across batch buckets.

        ``plan_store`` (a :class:`repro_torch.serving.plancache.PlanStore`)
        makes the one expensive compile a content-addressed lookup: a hit
        rebuilds the plan from the stored connection order with zero
        annealer iterations.  ``safe_twin=True`` also fans out the base
        plan's safe-mode twin (per-layer dispatch, gate off, same backend:
        the same function through the simplest kernel route) into
        ``self.safe``, so a circuit
        breaker can degrade to it without compiling on the failure path.
        """
        engine = engine or Engine()
        tracer = engine.tracer
        tr = tracer if tracer is not None else NULL_TRACER
        t0 = time.perf_counter()
        if plan_store is not None:
            base, hit = plan_store.get_or_compile(engine, net, backend)
        else:
            base, hit = engine.compile(net, backend), False
        sizes = bucket_sizes(max_batch)
        with tr.span("bucket.fanout", buckets=len(sizes), cache_hit=hit):
            plans = {b: base.with_fresh_forward() for b in sizes}
        out = cls(base=base, buckets=sizes, plans=plans, cache_hit=hit,
                  bucket_calls={b: 0 for b in sizes},
                  compile_s=time.perf_counter() - t0, tracer=tracer)
        if safe_twin:
            out.safe = out.build_safe_twin()
        return out

    def build_safe_twin(self) -> "BucketedPlanSet":
        """This set's schedule fanned out through the plan's safe twin (per
        layer, ungated, same backend — ``ExecutionPlan.safe_twin``): same
        buckets, same schedule tensors by reference, marked
        ``safe_mode`` so the server counts the batches it runs."""
        safe_base = self.base.safe_twin()
        return dataclasses.replace(
            self,
            base=safe_base,
            plans={b: safe_base.with_fresh_forward() for b in self.buckets},
            bucket_calls={b: 0 for b in self.buckets},
            warmup_s={},
            safe_mode=True,
            safe=None,
        )

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]

    @property
    def n_in(self) -> int:
        return self.base.n_in

    @property
    def n_out(self) -> int:
        return self.base.n_out

    @property
    def dtype(self) -> np.dtype:
        """The input dtype every bucket runs with, as numpy names it (what
        a client's rows are cast to, e.g. by the HTTP front door)."""
        return torch.empty(0, dtype=self.base.dtype).numpy().dtype

    @property
    def weight_dtype(self) -> str:
        return self.base.weight_dtype

    def bucket_for(self, n: int) -> int:
        """Smallest bucket that fits ``n`` rows (the largest one if none)."""
        if n < 1:
            raise ValueError(f"batch size must be >= 1, got {n}")
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_batch

    def warmup(self) -> "BucketedPlanSet":
        """Run every bucket once ahead of traffic (the first call builds the
        kernels), then time one more call per bucket into ``warmup_s`` — the
        seed of the server's per-bucket latency estimate.  Warmup calls are
        not counted in ``bucket_calls`` or the plans' ``calls``."""
        tr = self._tr
        device = self.base.device
        for b in self.buckets:
            with tr.span("bucket.warmup", bucket=b,
                         safe_mode=self.safe_mode) as sp:
                x = torch.zeros((b, self.n_in), dtype=self.base.dtype,
                                device=device)
                self.plans[b](x)
                _sync(device)
                t0 = time.perf_counter()
                self.plans[b](x)
                _sync(device)
                self.warmup_s[b] = time.perf_counter() - t0
                sp["warmup_s"] = round(self.warmup_s[b], 6)
            self.plans[b].calls = 0
        if self.safe is not None:
            # the degraded path must be warm too: a breaker trip is the
            # worst moment to build a bucket
            self.safe.warmup()
        return self

    def __call__(self, x) -> np.ndarray:
        """Run a batch of any size.  ``x`` is ``[n, n_in]``; batches larger
        than the top bucket run in top-bucket chunks.  Returns host numpy."""
        x = torch.as_tensor(x).to(self.base.dtype)
        if x.ndim != 2 or x.shape[1] != self.n_in:
            raise ValueError(
                f"expected input [n, {self.n_in}], got {tuple(x.shape)}")
        n = x.shape[0]
        if n > self.max_batch:
            parts = [self(x[i:i + self.max_batch])
                     for i in range(0, n, self.max_batch)]
            return np.concatenate(parts)
        b = self.bucket_for(n)
        if n < b:
            x = torch.cat([x, x.new_zeros((b - n, x.shape[1]))])
        with self._mu:
            self.bucket_calls[b] += 1
        y = self.plans[b](x)
        return y[:n].cpu().numpy()

    def describe(self) -> str:
        src = "plan-store hit" if self.cache_hit else "cold compile"
        extra = ""
        if self.safe_mode:
            extra = " [SAFE MODE]"
        elif self.safe is not None:
            extra = " [+safe twin]"
        return (f"BucketedPlanSet buckets={list(self.buckets)}{extra} "
                f"({src}); " + self.base.describe())


# --------------------------------------------------------------------------- #
# Pipeline plumbing: formed batches and per-bucket dispatch lanes.
#
# The serving pipeline separates batch FORMATION (the scheduler thread's
# wait-or-fire policy) from batch EXECUTION (a bounded worker pool).  The
# hand-off unit is a ``FormedBatch``: the popped requests plus a snapshot of
# the ``BucketedPlanSet`` they were formed against — executing against the
# snapshot (not ``server.plans``) is what keeps ``swap()`` atomic when
# batches overlap: a swap installed mid-flight never splits one batch across
# two weight sets.
#
# ``DispatchQueues`` holds one bounded FIFO *lane* per (server, bucket).  The
# invariant that buys determinism is **at most one in-flight batch per
# lane**: a lane with an executing batch hands out nothing, so same-bucket
# batches complete in formation order no matter how many workers drain the
# queues, while different buckets (distinct lanes) overlap freely.
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class FormedBatch:
    """A batch the formation stage has committed: requests popped from the
    server queue, bound to the plan-set snapshot they will execute on."""

    reqs: List[object]
    plans: BucketedPlanSet
    bucket: int
    t_formed: float
    server: Optional[object] = None   # owning SparseServer (lane key + stats)
    gen: int = 0                      # server plan generation at formation
                                      # (fences breaker feedback from stale
                                      # in-flight batches — see server.py)

    @property
    def lane(self) -> Tuple[int, int]:
        return (id(self.server), self.bucket)


class DispatchQueues:
    """Per-(server, bucket) dispatch lanes between formation and execution.

    * ``put`` appends a formed batch to its lane (bounded by ``per_lane``;
      the formation stage checks ``can_accept`` first, so a full lane is
      backpressure, not an error).
    * ``take`` blocks for a *ready* lane — non-empty and with no batch in
      flight — and returns the globally oldest ready batch, marking the
      lane busy.  One-in-flight-per-lane is what keeps same-bucket batches
      FIFO under a multi-worker pool.
    * ``complete`` retires the in-flight batch, freeing the lane and waking
      both workers (a queued successor became ready) and any drain waiter.

    One instance may be shared by several servers (``ModelRouter``): lanes
    are keyed by ``(id(server), bucket)``, so models never share a lane but
    do share the worker pool draining them.
    """

    def __init__(self, per_lane: int = 2):
        if per_lane < 1:
            raise ValueError(f"per_lane must be >= 1, got {per_lane}")
        self.per_lane = per_lane
        self._cv = threading.Condition(threading.Lock())
        self._lanes: Dict[Tuple[int, int], Deque[FormedBatch]] = {}
        self._busy: Dict[Tuple[int, int], FormedBatch] = {}
        self._closed = False

    # ---- formation side ------------------------------------------------- #
    def can_accept(self, lane: Tuple[int, int]) -> bool:
        with self._cv:
            q = self._lanes.get(lane)
            return not self._closed and (q is None or len(q) < self.per_lane)

    def lane_free(self, lane: Tuple[int, int]) -> bool:
        """True when the lane has nothing queued and nothing in flight — a
        batch put there now is picked up immediately by an idle worker."""
        with self._cv:
            q = self._lanes.get(lane)
            return not q and lane not in self._busy

    def put(self, batch: FormedBatch) -> bool:
        """Enqueue on the batch's lane; False when closed or the lane is
        full (the caller keeps the requests queued and retries later)."""
        with self._cv:
            if self._closed:
                return False
            q = self._lanes.get(batch.lane)
            if q is None:
                q = self._lanes[batch.lane] = collections.deque()
            if len(q) >= self.per_lane:
                return False
            q.append(batch)
            self._cv.notify_all()
            return True

    # ---- execution side ------------------------------------------------- #
    def _ready_locked(self) -> Optional[FormedBatch]:
        best = None
        for lane, q in self._lanes.items():
            if q and lane not in self._busy:
                if best is None or q[0].t_formed < best[0].t_formed:
                    best = (q[0], lane)
        if best is None:
            return None
        batch, lane = best
        self._lanes[lane].popleft()
        self._busy[lane] = batch
        return batch

    def take(self, timeout: Optional[float] = None) -> Optional[FormedBatch]:
        """Oldest ready batch, or None on timeout / close-and-empty."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                batch = self._ready_locked()
                if batch is not None:
                    return batch
                if self._closed and not any(self._lanes.values()):
                    return None
                if deadline is None:
                    self._cv.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    self._cv.wait(remaining)

    def complete(self, batch: FormedBatch) -> None:
        with self._cv:
            if self._busy.get(batch.lane) is batch:
                del self._busy[batch.lane]
            self._cv.notify_all()

    # ---- introspection / drain ------------------------------------------ #
    def ready_count(self) -> int:
        with self._cv:
            return sum(1 for lane, q in self._lanes.items()
                       if q and lane not in self._busy)

    def depth(self) -> int:
        with self._cv:
            return sum(len(q) for q in self._lanes.values())

    def in_flight(self) -> int:
        with self._cv:
            return len(self._busy)

    def pending(self, server: Optional[object] = None) -> int:
        """Queued + in-flight batches, optionally for one server only."""
        with self._cv:
            if server is None:
                return (sum(len(q) for q in self._lanes.values())
                        + len(self._busy))
            sid = id(server)
            n = sum(len(q) for lane, q in self._lanes.items()
                    if lane[0] == sid)
            n += sum(1 for lane in self._busy if lane[0] == sid)
            return n

    def wait_idle(self, server: Optional[object] = None,
                  timeout: Optional[float] = None) -> bool:
        """Block until ``pending(server) == 0``; False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                if server is None:
                    if (not any(self._lanes.values())
                            and not self._busy):
                        return True
                else:
                    sid = id(server)
                    if (not any(q for lane, q in self._lanes.items()
                                if lane[0] == sid)
                            and not any(lane[0] == sid
                                        for lane in self._busy)):
                        return True
                if deadline is None:
                    self._cv.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                    self._cv.wait(remaining)

    def drain_batches(self, server: Optional[object] = None
                      ) -> List[FormedBatch]:
        """Pop every queued (not in-flight) batch — the shutdown path uses
        this to run leftovers inline after the pool stops."""
        out: List[FormedBatch] = []
        with self._cv:
            for lane in list(self._lanes):
                if server is not None and lane[0] != id(server):
                    continue
                q = self._lanes[lane]
                while q:
                    out.append(q.popleft())
            self._cv.notify_all()
        out.sort(key=lambda b: b.t_formed)
        return out

    def close(self) -> None:
        """Stop accepting new batches; blocked ``take`` calls return None
        once the queues empty out."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
