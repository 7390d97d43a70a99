"""Step-driven continuous-batching scheduler over bucketed execution plans.

Port of the step-driven half of ``repro.serving.server.SparseServer``.  The
compiled plan set already paid the offline schedule cost, so the server's
job is batch formation under a latency SLO:

  * **admission** — a bounded queue; submits beyond ``max_queue`` are
    rejected immediately (``submit`` returns None);
  * **wait-or-fire** — a batch fires when it is full (``max_batch`` rows),
    when the oldest request has waited ``max_wait_s``, or when the oldest
    request's deadline minus the per-bucket EWMA batch latency says firing
    any later would miss it;
  * **bucket routing** — a fired batch of n rows runs through the smallest
    plan bucket >= n;
  * **I/O telemetry** — ``self.io`` (an ``obs.telemetry.IOTelemetry``)
    records each bucket's static plan gauges after its first batch and, every
    ``measure_dynamic_every`` batches on a gated fused plan, the batch's
    measured dynamic I/O (``ExecutionPlan.measure_dynamic``).  A measurement
    that raises never fails the batch: it becomes an ``io.measure_failed``
    trace event and counts in ``metrics.io_measure_failed``.

The caller drives ``step``/``poll``/``drain`` and collects with
``result(rid)``; with an injected ``clock`` the schedule is deterministic.
The async scheduler thread, executor pool, model router, hot swap, circuit
breaker, watchdog and snapshot of the reference are not ported yet.  A
batch whose plan call raises propagates the error to the caller of
``step``.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional

import numpy as np

from ..obs.telemetry import IOTelemetry
from ..obs.trace import NULL_TRACER
from .bucketing import BucketedPlanSet
from .metrics import ServingMetrics


@dataclasses.dataclass
class Request:
    rid: int
    x: np.ndarray                 # [n_in] feature vector
    t_submit: float
    deadline: float               # absolute clock time


class SparseServer:
    """Request queue + step-driven scheduler serving a :class:`BucketedPlanSet`.

    Args:
      plans: the compiled bucketed plan set to serve.
      max_batch: rows per fired batch (default: the top plan bucket).
      max_queue: admission bound; ``submit`` returns None beyond it.
      slo_ms: target end-to-end latency; a request's deadline is
        ``t_submit + slo_ms`` unless it gives its own.
      max_wait_ms: wait-or-fire threshold for the oldest queued request
        (default ``slo_ms / 4``).
      clock: monotonic time source; injectable for deterministic tests.
      result_capacity: finished results retained for collection; beyond it
        the oldest uncollected result is evicted (``metrics.results_evicted``).
      tracer: a ``repro_torch.obs.Tracer`` receiving the ``io.measure`` /
        ``io.measure_failed`` events (default: the disabled tracer).
      measure_dynamic_every: sample measured dynamic I/O every N batches and
        fold it into ``self.io`` (needs a gated fused plan; inactive
        otherwise); 0 disables sampling.
    """

    def __init__(
        self,
        plans: BucketedPlanSet,
        max_batch: Optional[int] = None,
        max_queue: int = 1024,
        slo_ms: float = 50.0,
        max_wait_ms: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        result_capacity: int = 4096,
        tracer=None,
        measure_dynamic_every: int = 0,
    ):
        self.plans = plans
        self.max_batch = max_batch or plans.max_batch
        if self.max_batch > plans.max_batch:
            raise ValueError(
                f"max_batch {self.max_batch} exceeds top plan bucket "
                f"{plans.max_batch}")
        self.max_queue = max_queue
        self.slo_s = slo_ms / 1e3
        self.max_wait_s = (max_wait_ms / 1e3 if max_wait_ms is not None
                           else self.slo_s / 4.0)
        self.clock = clock
        self.result_capacity = result_capacity
        self.metrics = ServingMetrics()
        self._queue: deque = deque()
        # finished, uncollected results in completion order (eviction pops
        # the front); a rid is absent while queued
        self._results: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._rid = itertools.count()
        # per-bucket execution-latency EWMAs, seeded from warmup() timings,
        # so the deadline clause is live from the first request
        self._lat_ewma: Dict[int, float] = dict(plans.warmup_s)
        self._lock = threading.Lock()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.io = IOTelemetry()
        self.measure_dynamic_every = measure_dynamic_every
        self._measure_countdown = measure_dynamic_every
        self._io_seen: set = set()    # buckets already gauged

    # ------------------------------------------------------------------ #
    # admission and collection
    # ------------------------------------------------------------------ #
    def submit(self, x, deadline_ms: Optional[float] = None) -> Optional[int]:
        """Enqueue one request.  Returns its id, or None when the queue is
        full.  A wrong-shape input raises here, never in a batch."""
        x = np.asarray(x)
        if x.shape != (self.plans.n_in,):
            raise ValueError(
                f"expected input [{self.plans.n_in}], got {tuple(x.shape)}")
        now = self.clock()
        with self._lock:
            depth = len(self._queue)
            if depth >= self.max_queue:
                self.metrics.record_submit(now, depth, admitted=False)
                return None
            rid = next(self._rid)
            deadline = now + (deadline_ms / 1e3 if deadline_ms is not None
                              else self.slo_s)
            self._queue.append(Request(rid=rid, x=x, t_submit=now,
                                       deadline=deadline))
            self.metrics.record_submit(now, depth, admitted=True)
            return rid

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def result(self, rid: int) -> Optional[np.ndarray]:
        """Pop a finished request's output (None while still queued, or
        after its uncollected result was evicted)."""
        with self._lock:
            return self._results.pop(rid, None)

    # ------------------------------------------------------------------ #
    # scheduling
    # ------------------------------------------------------------------ #
    def _estimated_batch_s(self) -> float:
        """EWMA latency estimate for a batch of the current queue depth,
        keyed by the bucket it would route to (the most pessimistic known
        bucket when that one has no observation; 0.0 with none at all)."""
        if not self._lat_ewma:
            return 0.0
        n = max(1, min(len(self._queue), self.max_batch))
        est = self._lat_ewma.get(self.plans.bucket_for(n))
        return est if est is not None else max(self._lat_ewma.values())

    def should_fire(self, now: Optional[float] = None) -> bool:
        """Wait-or-fire policy for the current queue state."""
        with self._lock:
            return self._should_fire_locked(now)

    def _should_fire_locked(self, now: Optional[float] = None) -> bool:
        if not self._queue:
            return False
        if len(self._queue) >= self.max_batch:
            return True
        now = self.clock() if now is None else now
        head = self._queue[0]
        if now - head.t_submit >= self.max_wait_s:
            return True
        # waiting any longer guarantees an SLO miss
        return head.deadline - now <= self._estimated_batch_s()

    def step(self, flush: bool = False) -> int:
        """Fire at most one batch if the policy (or ``flush``) says so.
        Returns the number of requests served."""
        with self._lock:
            now = self.clock()
            if not self._queue or not (flush or self._should_fire_locked(now)):
                return 0
            take = min(len(self._queue), self.max_batch)
            reqs: List[Request] = [self._queue.popleft() for _ in range(take)]
        return self._run_batch(reqs, t_formed=now)

    def poll(self) -> int:
        """Fire as many batches as the policy allows right now."""
        served = 0
        while True:
            n = self.step()
            if n == 0:
                return served
            served += n

    def drain(self) -> int:
        """Serve everything queued, ignoring the wait policy."""
        served = 0
        while True:
            n = self.step(flush=True)
            if n == 0:
                return served
            served += n

    def _run_batch(self, reqs: List[Request], t_formed: float) -> int:
        n = len(reqs)
        bucket = self.plans.bucket_for(n)
        x = np.stack([r.x for r in reqs])
        t0 = self.clock()
        y = self.plans(x)          # host numpy: the device work is finished
        t1 = self.clock()
        exec_s = t1 - t0
        waits = [t_formed - r.t_submit for r in reqs]
        misses = sum(1 for r in reqs if t1 > r.deadline)
        with self._lock:
            prev = self._lat_ewma.get(bucket)
            self._lat_ewma[bucket] = (exec_s if prev is None
                                      else 0.5 * prev + 0.5 * exec_s)
            for i, r in enumerate(reqs):
                self._results[r.rid] = y[i]
            evicted = 0
            while len(self._results) > self.result_capacity:
                self._results.popitem(last=False)
                evicted += 1
            if evicted:
                self.metrics.record_result_evictions(evicted)
            self.metrics.record_batch(t1, n, bucket, exec_s, waits, misses)
            do_measure = False
            if self.measure_dynamic_every > 0:
                self._measure_countdown -= 1
                if self._measure_countdown <= 0:
                    self._measure_countdown = self.measure_dynamic_every
                    do_measure = True
            io_first = bucket not in self._io_seen
            self._io_seen.add(bucket)
        # I/O telemetry runs outside the lock: static gauges once per
        # bucket, measured dynamic I/O on the sampling cadence
        if io_first:
            self.io.observe_plan(bucket, self.plans.plans.get(
                bucket, self.plans.base))
        if do_measure:
            self._measure_dynamic(bucket, x)
        return n

    def _measure_dynamic(self, bucket: int, x: np.ndarray) -> None:
        """Sample measured dynamic I/O for one served batch (gated fused
        plans only; inactive otherwise).  Telemetry must never fail
        serving, so a measurement error becomes a trace event and a count."""
        base = self.plans.base
        if not base.gate or base._measure is None:
            return
        try:
            report = base.measure_dynamic(x)
        except Exception as e:
            self.metrics.record_measure_failed()
            if self.tracer.enabled:
                self.tracer.event("io.measure_failed", model=self.io.model,
                                  bucket=bucket, error=type(e).__name__)
            return
        self.io.observe_dynamic(bucket, report)
        if self.tracer.enabled:
            self.tracer.event(
                "io.measure", model=self.io.model, bucket=bucket,
                dynamic_blocks=int(report.dynamic_total),
                static_blocks=int(report.static_total),
                read_fraction=round(float(report.read_fraction), 4))
