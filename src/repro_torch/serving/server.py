"""Continuous-batching request scheduler over bucketed execution plans.

Port of ``repro.serving.server``.  ``SparseServer`` is the serving half of
the paper's amortization story: the compiled plan substrate
(``BucketedPlanSet``) already paid the offline schedule cost, so the
server's job is batch formation under a latency SLO:

  * **admission** — a bounded queue; submits beyond ``max_queue`` are
    rejected immediately (backpressure instead of unbounded latency);
  * **wait-or-fire** — a batch fires when it is full (``max_batch`` rows),
    when the oldest request has waited ``max_wait_s``, or when the oldest
    request's deadline minus the per-bucket EWMA batch latency says firing
    any later would miss it;
  * **bucket routing** — a fired batch of n rows runs through the smallest
    plan bucket >= n, so tail batches stop paying full-bucket latency;
  * **I/O telemetry** — ``self.io`` records each bucket's static plan
    gauges after its first batch and, every ``measure_dynamic_every``
    batches on a gated fused plan, the batch's measured dynamic I/O.  A
    measurement that raises never fails the batch: it becomes an
    ``io.measure_failed`` trace event and counts in
    ``metrics.io_measure_failed``.

The server runs in one of two modes over the SAME scheduling code:

  * **step-driven** (default) — the caller drives ``step``/``poll``/
    ``drain``; with an injected ``clock`` this is fully deterministic;
  * **async** — ``start()`` spawns a background scheduler thread that
    drives the identical policy against the real clock while caller
    threads ``submit`` concurrently; ``wait(rid)`` blocks on a per-request
    event; ``shutdown()`` drains the queue and joins the thread.

Async mode optionally runs as a staged **pipeline** (``executor_workers >
0``): the scheduler thread only forms batches
(:class:`~repro_torch.serving.bucketing.FormedBatch` snapshots) onto
per-bucket dispatch lanes (:class:`~repro_torch.serving.bucketing.
DispatchQueues`), and a bounded :class:`ExecutorPool` drains them.  At most
one batch per lane is in flight, so same-bucket batches complete in
formation order, while different buckets overlap across workers.  On the
card the workers overlap host work — formation, stacking, the copies and
``.cpu()`` — not kernels: every worker thread launches on the default
stream, and the kernel wrappers serialize the launches of one schedule
(see ``kernels.bsr_matmul``).

``swap(net)`` hot-swaps the served plan set: the new plans compile (or
plan-store-hit) off the serving path, then install atomically between
batches — an in-flight batch keeps the old plan set by reference, so no
batch sees mixed weights and no request is dropped.  ``ModelRouter`` serves
several named plan sets from one process: per-model queues and metrics, one
shared scheduler thread.

Fault tolerance (``serving.resilience``): batches run under a
``RetryPolicy`` (bounded retry + backoff + optional per-attempt timeout),
outputs pass a NaN/Inf guard, a failed batch is contained (its requests
complete as None and it is counted; serving goes on), a per-server
``CircuitBreaker`` degrades to the plan set's precompiled safe-mode twin
(the same schedule lowered per layer, ungated: on the ``kernel`` backend
one ``bsr_matmul`` launch per layer, never plain PyTorch) after K
consecutive failures — a visible, counted state (``metrics.degraded_batches``, ``breaker_state`` in the snapshot) —
and half-opens back after a cool-down, and a ``Watchdog`` restarts a dead
or wedged scheduler thread without losing queued requests.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional

import numpy as np

from ..obs.telemetry import IOTelemetry, plan_io_attrs
from ..obs.trace import NULL_TRACER, Tracer
from .bucketing import BucketedPlanSet, DispatchQueues, FormedBatch
from .metrics import ServingMetrics
from .resilience import (
    BatchTimeoutError,
    CircuitBreaker,
    FaultInjector,
    Heartbeat,
    OutputGuardError,
    RetryPolicy,
    Watchdog,
    call_with_timeout,
    check_finite,
)

# the async scheduler's idle tick: an upper bound on how long the loop
# sleeps when nothing says when the policy could next change state
_IDLE_WAIT_S = 0.05
# lower bound on a computed sleep so a deadline a few ns away cannot
# degenerate into a spin loop
_MIN_WAIT_S = 1e-4


@dataclasses.dataclass
class Request:
    rid: int
    x: np.ndarray                 # [n_in] feature vector
    t_submit: float
    deadline: Optional[float]     # absolute clock time, or None


class _Slot:
    """Per-request result slot: the finished row + a lazily-created
    completion event (allocated only when a caller actually blocks in
    ``wait`` — poll-style callers never pay for it).  ``waiters`` counts
    threads currently blocked in ``wait``: a slot someone is actively
    collecting is exempt from capacity/TTL eviction."""

    __slots__ = ("event", "value", "t_done", "done", "waiters")

    def __init__(self):
        self.event: Optional[threading.Event] = None
        self.value: Optional[np.ndarray] = None
        self.t_done: Optional[float] = None
        self.done = False
        self.waiters = 0


class ExecutorPool:
    """Bounded execution-stage worker pool draining :class:`DispatchQueues`.

    Each worker blocks in ``dispatch.take()`` for the oldest *ready* lane
    (non-empty, nothing in flight) and runs the batch through its owning
    server's ``_run_batch`` — against the plan-set snapshot the batch was
    formed with, so a concurrent ``swap()`` never mixes weights inside a
    batch.  A worker that catches a non-batch error (``_run_batch`` already
    contains plan failures) completes the batch's slots as None, so the
    invariant — a failed batch never takes the server down, and its
    waiters always unblock — holds with any number of workers.

    One pool may be shared by several servers (``ModelRouter``): batches
    carry their server, so the worker loop is server-agnostic.  Per-worker
    busy time and batch counts feed the ``pool.per_worker`` utilization
    gauges in snapshots.
    """

    def __init__(self, dispatch: DispatchQueues, workers: int = 2,
                 wake: Optional[Callable[[], None]] = None,
                 name: str = "sparse-exec"):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.dispatch = dispatch
        self.workers = workers
        self.wake = wake              # fired after every completion (the
                                      # formation loop may be lane-blocked)
        self.name = name
        self._mu = threading.Lock()
        self._threads: Dict[int, threading.Thread] = {}
        self._busy: Dict[int, FormedBatch] = {}
        self._stats = {i: {"batches": 0, "busy_s": 0.0}
                       for i in range(workers)}
        self._stop = threading.Event()
        self._started_at: Optional[float] = None

    # ------------------------------------------------------------------ #
    def start(self) -> "ExecutorPool":
        with self._mu:
            self._stop.clear()
            if self._started_at is None:
                self._started_at = time.monotonic()
            for i in range(self.workers):
                t = self._threads.get(i)
                if t is None or not t.is_alive():
                    self._spawn_locked(i)
        return self

    def _spawn_locked(self, i: int) -> None:
        t = threading.Thread(target=self._work, args=(i,),
                             name=f"{self.name}-{i}", daemon=True)
        self._threads[i] = t
        t.start()

    def ensure(self) -> None:
        """Respawn dead worker threads (watchdog ``on_poll`` hook).  A
        worker can only die on a non-``Exception`` raise — the loop
        swallows everything else — but the lanes it was draining must not
        go silent when it does."""
        if self._stop.is_set():
            return
        with self._mu:
            if self._stop.is_set() or self._started_at is None:
                return
            for i in range(self.workers):
                t = self._threads.get(i)
                if t is None or not t.is_alive():
                    self._spawn_locked(i)

    @property
    def running(self) -> bool:
        with self._mu:
            return any(t.is_alive() for t in self._threads.values())

    @property
    def accepting(self) -> bool:
        """True while the pool is live and not stopping — the formation
        stage dispatches only while this holds (otherwise it executes
        inline, the pre-pipeline path)."""
        return (not self._stop.is_set() and self._started_at is not None
                and self.running)

    def idle_workers(self) -> int:
        with self._mu:
            alive = sum(1 for t in self._threads.values() if t.is_alive())
            return max(0, alive - len(self._busy))

    # ------------------------------------------------------------------ #
    def _work(self, i: int) -> None:
        while not self._stop.is_set():
            batch = self.dispatch.take(timeout=_IDLE_WAIT_S)
            if batch is None:
                continue
            server = batch.server
            t0 = time.monotonic()
            with self._mu:
                self._busy[i] = batch
            try:
                server._run_batch(batch, worker=i)
            except Exception:
                # _run_batch contains plan failures itself; anything that
                # still escapes (a bug in the completion path, say) must
                # not leave the batch's waiters blocked forever
                try:
                    now = server.clock()
                    with server._cv:
                        server._finish_slots(batch.reqs, None, now)
                        server.metrics.record_batch_failure(
                            now, len(batch.reqs))
                except Exception:
                    pass
            finally:
                with self._mu:
                    self._busy.pop(i, None)
                    st = self._stats[i]
                    st["batches"] += 1
                    st["busy_s"] += time.monotonic() - t0
                self.dispatch.complete(batch)
                server._notify()
                if self.wake is not None:
                    self.wake()

    # ------------------------------------------------------------------ #
    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> bool:
        """Stop the workers.  With ``drain`` (default) every queued and
        in-flight batch executes first (bounded by ``timeout``); without
        it, queued batches are left on the lanes for the caller to run
        inline (in-flight ones still finish).  Returns True when the pool
        fully stopped in time."""
        drained = True
        if drain and self._started_at is not None:
            drained = self.dispatch.wait_idle(timeout=timeout)
        self._stop.set()
        self.dispatch.close()
        joined = True
        with self._mu:
            threads = list(self._threads.values())
        for t in threads:
            if t is not threading.current_thread():
                t.join(timeout)
                joined = joined and not t.is_alive()
        return drained and joined

    def snapshot(self) -> dict:
        """Per-worker utilization (busy-time fraction since pool start)
        plus dispatch-queue state — rendered with a ``worker=`` label by
        ``obs.prom``."""
        with self._mu:
            up = (time.monotonic() - self._started_at
                  if self._started_at is not None else 0.0)
            per_worker = {
                str(i): {
                    "batches": st["batches"],
                    "busy_s": round(st["busy_s"], 6),
                    "utilization": (st["busy_s"] / up if up > 0 else 0.0),
                    "in_flight": 1 if i in self._busy else 0,
                }
                for i, st in self._stats.items()
            }
            busy = len(self._busy)
        return {
            "workers": self.workers,
            "busy_workers": busy,
            "dispatch_depth": self.dispatch.depth(),
            "dispatch_in_flight": self.dispatch.in_flight(),
            "per_worker": per_worker,
        }


class SwapHandle:
    """Future-style handle for an asynchronous plan swap
    (``swap(..., swap_async=True)``).

    The replacement plan set compiles (or plan-store-hits) and warms on a
    background thread; the reference install happens between batches when
    it is ready.  ``wait()`` blocks for the install and returns the
    replaced plan set (re-raising a build failure); ``done`` polls."""

    def __init__(self):
        self._ev = threading.Event()
        self._old: Optional[BucketedPlanSet] = None
        self._err: Optional[BaseException] = None

    @property
    def done(self) -> bool:
        return self._ev.is_set()

    def wait(self, timeout: Optional[float] = None
             ) -> Optional[BucketedPlanSet]:
        if not self._ev.wait(timeout):
            raise TimeoutError("swap still building/installing")
        if self._err is not None:
            raise self._err
        return self._old


class SparseServer:
    """Request queue + scheduler serving a :class:`BucketedPlanSet`.

    Args:
      plans: the compiled bucketed plan set to serve.
      max_batch: rows per fired batch (default: the top plan bucket).
      max_queue: admission bound; ``submit`` returns None beyond it.
      slo_ms: target end-to-end latency.  Requests submitted without an
        explicit deadline get ``t_submit + slo_ms``.
      max_wait_ms: wait-or-fire threshold for the oldest queued request
        (default ``slo_ms / 4`` — batching may spend at most a quarter of
        the SLO budget on waiting).
      clock: monotonic time source; injectable for deterministic tests.
      result_capacity: finished results retained for collection; beyond it
        the OLDEST uncollected result is evicted (and counted in
        ``metrics.results_evicted``), so a caller that never polls cannot
        leak every response ever served.
      result_ttl_s: optional age bound on uncollected results (evaluated
        against the injected clock on every insert/submit).
      engine / plan_store / backend: the compile settings
        ``swap(net)`` uses to build the replacement plan set; only needed
        when hot-swap by network (rather than by prebuilt plans) is used.
      retry: a :class:`RetryPolicy` for batch execution (per-attempt
        timeout, bounded retry, backoff).  Default: one attempt, no
        timeout — the pre-resilience behavior.
      breaker: a :class:`CircuitBreaker`; requires ``plans.safe`` (compile
        with ``safe_twin=True``).  After K consecutive batch failures the
        server degrades to the safe-mode twin, and probes the fast plan
        again after the breaker's cool-down.
      output_guard: fail batches whose output contains NaN/Inf (on by
        default — garbage must not be served as a result).
      enforce_deadlines: evict queued requests whose deadline has already
        passed (they complete as None) instead of serving them late.
      watchdog_s: arm a scheduler watchdog on ``start()``: a scheduler
        thread that dies, or wedges for longer than this with work queued,
        is restarted — queued requests and result slots live on the
        server, so nothing queued is lost.
      fault_injector: a :class:`~repro_torch.serving.resilience.FaultInjector`
        whose ``server.*`` sites this server fires (chaos testing).
      name: model name stamped on every span and metric this server emits
        (``ModelRouter`` sets it to the routing key).
      tracer: a :class:`repro_torch.obs.Tracer` recording the request lifecycle
        (submit → queue → execute → done), swaps, breaker transitions, and
        watchdog restarts.  Default is the shared disabled ``NULL_TRACER``
        — one ``enabled`` check per site, nothing recorded.
      measure_dynamic_every: sample measured dynamic I/O
        (``ExecutionPlan.measure_dynamic``) every N successful batches and
        fold it into ``self.io`` (requires a gated fused plan; silently
        inactive otherwise).  0 disables sampling — the measurement runs a
        second instrumented forward, so it is opt-in.
      executor_workers: size of the execution-stage worker pool.  0 (the
        default) keeps the pre-pipeline behavior: the scheduler thread
        forms AND executes each batch itself.  With N >= 1, ``start()``
        also spawns an :class:`ExecutorPool` — the scheduler only forms
        batches onto per-bucket dispatch lanes and the pool drains them,
        so different-bucket batches overlap while same-bucket batches
        stay FIFO.  Step-driven mode ignores this (no pool runs until
        ``start()``).
      dispatch_per_lane: formed batches a dispatch lane buffers beyond
        the in-flight one (lane-full is backpressure on formation, not an
        error).

    All public methods are thread-safe; plan execution itself runs outside
    the lock, so submits are never blocked behind a running batch.
    ``snapshot()`` unifies metrics, I/O gauges, and resilience state — the
    dict the Prometheus endpoint renders (see ``obs.prom``).
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
        result_ttl_s: Optional[float] = None,
        engine=None,
        plan_store=None,
        backend: Optional[str] = None,
        retry: Optional[RetryPolicy] = None,
        breaker: Optional[CircuitBreaker] = None,
        output_guard: bool = True,
        enforce_deadlines: bool = False,
        watchdog_s: Optional[float] = None,
        fault_injector: Optional[FaultInjector] = None,
        name: str = "default",
        tracer: Optional[Tracer] = None,
        measure_dynamic_every: int = 0,
        executor_workers: int = 0,
        dispatch_per_lane: int = 2,
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
        self.result_ttl_s = result_ttl_s
        self.metrics = ServingMetrics()
        self._engine = engine
        self._plan_store = plan_store
        self._backend = backend
        self._queue: deque = deque()
        self._results: Dict[int, _Slot] = {}
        # finished-and-uncollected rids in completion order (t_done
        # ascending): capacity eviction pops the front, the TTL sweep stops
        # at the first unexpired entry — both O(evicted), never O(live)
        self._done: "OrderedDict[int, float]" = OrderedDict()
        self._rid = itertools.count()
        # per-bucket execution-latency EWMAs, seeded from warmup() timings
        # when available — so the deadline clause is live from the very
        # first request instead of dead until the first batch completes
        self._lat_ewma: Dict[int, float] = dict(plans.warmup_s)
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._closed = False
        self._drain_on_stop = True
        # resilience (see serving.resilience)
        self.retry = retry if retry is not None \
            else RetryPolicy(max_retries=0, timeout_s=None)
        self.breaker = breaker
        if breaker is not None and getattr(plans, "safe", None) is None:
            raise ValueError(
                "a circuit breaker needs a safe-mode twin to degrade to — "
                "compile the plan set with "
                "BucketedPlanSet.compile(..., safe_twin=True)")
        self.output_guard = output_guard
        self.enforce_deadlines = enforce_deadlines
        self.watchdog_s = watchdog_s
        self.injector = fault_injector
        self._fast_plans: Optional[BucketedPlanSet] = None
        self._degraded = False
        self._heartbeat = Heartbeat()
        self._watchdog: Optional[Watchdog] = None
        # observability (see obs)
        self.name = name
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.io = IOTelemetry(model=name)
        self.measure_dynamic_every = measure_dynamic_every
        self._measure_countdown = measure_dynamic_every
        self._io_seen: set = set()   # (plan-set id, bucket) already gauged
        # pipeline: formation -> dispatch lanes -> executor pool.
        # Nothing is created until start(); step-driven mode never sees it.
        if executor_workers < 0:
            raise ValueError(
                f"executor_workers must be >= 0, got {executor_workers}")
        self.executor_workers = executor_workers
        self.dispatch_per_lane = dispatch_per_lane
        self._dispatch: Optional[DispatchQueues] = None
        self._pool: Optional[ExecutorPool] = None
        self._pool_owned = False     # router-attached pools are stopped by
                                     # the router, not this server
        # plan generation counter: bumped by EVERY plan install (swap,
        # breaker degrade, fast-plan reinstall).  Batches carry the gen
        # they were formed at; breaker feedback from a batch whose gen is
        # stale (formed before the last install) is dropped — an in-flight
        # fast batch failing after degradation must not re-trip the
        # breaker, and a stale safe success must not resolve a probe.
        self._plan_gen = 0
        if breaker is not None and breaker.on_transition is None:
            # breaker state changes (incl. half-open probe admission, which
            # no metric counter sees) become trace events
            breaker.on_transition = self._breaker_transition

    def _breaker_transition(self, event: str, state: str) -> None:
        tr = self.tracer
        if tr.enabled:
            tr.event(f"breaker.{event}", model=self.name, state=state)

    def _fire(self, site: str, value=None):
        """Fire a fault-injection site (no-op without an injector)."""
        inj = self.injector
        return value if inj is None else inj.fire(site, value)

    # ------------------------------------------------------------------ #
    # admission
    # ------------------------------------------------------------------ #
    def submit(self, x, deadline_ms: Optional[float] = None) -> Optional[int]:
        """Enqueue one request.  Returns its id, or None when the queue is
        full (admission control — the caller sheds load instead of queueing
        unboundedly past the SLO) or the server has shut down.  A wrong-shape
        input raises HERE, in the submitting thread — it must never reach
        batch formation, where it would poison every request in its batch."""
        rid, _, _ = self._submit(x, deadline_ms)
        return rid

    def submit_ex(self, x, deadline_ms: Optional[float] = None
                  ) -> "tuple[Optional[int], Optional[str]]":
        """``submit`` with the rejection reason: ``(rid, None)`` on
        admission, ``(None, "queue_full")`` on backpressure, ``(None,
        "closed")`` after shutdown.  The HTTP front door maps these onto
        429 vs 503 (see ``serving.http``)."""
        rid, _, reason = self._submit(x, deadline_ms)
        return rid, reason

    def _submit(self, x, deadline_ms: Optional[float] = None
                ) -> "tuple[Optional[int], bool, Optional[str]]":
        """``(rid, wake, reason)`` — ``wake`` is True when this submit changed the
        scheduler's decision state: the queue just became non-empty (a
        sleeping scheduler may be on its idle tick) or just reached a full
        batch (fire now).  Any other submit leaves the head request — and so
        the wait-or-fire timeout a scheduler is already sleeping on —
        unchanged.  Computed atomically under the lock so a shared-scheduler
        caller (``ModelRouter``) cannot miss the transition."""
        x = np.asarray(x)
        if x.shape != (self.plans.n_in,):
            raise ValueError(
                f"expected input [{self.plans.n_in}], got {tuple(x.shape)}")
        now = self.clock()
        with self._cv:
            self._evict_expired(now)
            depth = len(self._queue)
            if self._closed or depth >= self.max_queue:
                self.metrics.record_submit(now, depth, admitted=False)
                if self.tracer.enabled:
                    self.tracer.event("request.submit", model=self.name,
                                      depth=depth, admitted=False,
                                      closed=self._closed)
                return None, False, \
                    ("closed" if self._closed else "queue_full")
            rid = next(self._rid)
            deadline = now + (deadline_ms / 1e3 if deadline_ms is not None
                              else self.slo_s)
            self._queue.append(Request(rid=rid, x=x,
                                       t_submit=now, deadline=deadline))
            # the result slot exists from admission, so wait(rid) can block
            # on it before the request is ever picked into a batch
            self._results[rid] = _Slot()
            self.metrics.record_submit(now, depth, admitted=True)
            if self.tracer.enabled:
                self.tracer.event("request.submit", model=self.name,
                                  rid=rid, depth=depth, admitted=True)
            # wake on any transition that can change the scheduler's
            # decision or its sleep bound: queue newly non-empty, reached a
            # full batch, or crossed a bucket boundary (the deadline clause
            # estimates from the bucket the CURRENT depth routes to, so a
            # bucket change moves the fire time the scheduler slept on)
            qlen = depth + 1
            pmax = self.plans.max_batch
            wake = (qlen == 1 or qlen == self.max_batch
                    or (qlen <= pmax
                        and self.plans.bucket_for(qlen)
                        != self.plans.bucket_for(max(1, qlen - 1))))
            if wake:
                self._cv.notify_all()
            return rid, wake, None

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def result(self, rid: int) -> Optional[np.ndarray]:
        """Pop a finished request's output (None while still queued, or
        after its uncollected result was evicted)."""
        with self._lock:
            slot = self._results.get(rid)
            if slot is None or not slot.done:
                return None
            del self._results[rid]
            self._done.pop(rid, None)
            return slot.value

    def status(self, rid: int) -> str:
        """``"pending"`` (queued or in flight), ``"done"`` (result ready to
        collect), or ``"unknown"`` (never admitted, already collected, or
        evicted).  The HTTP front door's poll path."""
        with self._lock:
            slot = self._results.get(rid)
            if slot is None:
                return "unknown"
            return "done" if slot.done else "pending"

    def cancel(self, rid: int) -> bool:
        """Cancel request ``rid`` if it is still queued: it leaves the
        queue, its slot completes as None (waiters unblock), and it is
        counted in ``metrics.cancelled``.  Returns False when the request
        is already in a batch, finished, or unknown — an in-flight row
        cannot be pulled out of a running plan call."""
        with self._cv:
            for i, r in enumerate(self._queue):
                if r.rid == rid:
                    del self._queue[i]
                    self._finish_slots([r], None, self.clock())
                    self.metrics.record_cancel()
                    return True
        return False

    def wait(self, rid: int, timeout: Optional[float] = None,
             cancel_on_timeout: bool = False) -> Optional[np.ndarray]:
        """Block until request ``rid`` finishes, then pop its output.
        Returns None on timeout (the result stays collectable) or when the
        result was already collected/evicted.  This is the Future-style
        collection path for async-mode callers.

        ``cancel_on_timeout`` turns a timeout into per-request deadline
        enforcement: the request is cancelled if still queued (evicted
        cleanly, never served) — an in-flight or finished request is left
        alone and its result stays collectable."""
        with self._lock:
            slot = self._results.get(rid)
            if slot is None:
                return None
            if slot.event is None:
                slot.event = threading.Event()
                if slot.done:
                    slot.event.set()
            slot.waiters += 1
        finished = False
        try:
            finished = slot.event.wait(timeout)
        finally:
            # collect in the SAME locked section that drops the waiter
            # refcount: releasing the count first would open a window where
            # eviction deletes the served result before we pop it
            with self._lock:
                slot.waiters -= 1
                value = None
                if finished and slot.done and \
                        self._results.get(rid) is slot:
                    del self._results[rid]
                    self._done.pop(rid, None)
                    value = slot.value
        if not finished and cancel_on_timeout:
            self.cancel(rid)
        return value

    # ------------------------------------------------------------------ #
    # result retention
    # ------------------------------------------------------------------ #
    def _evict_expired(self, now: float) -> None:
        """Drop uncollected results past ``result_ttl_s`` (lock held).
        ``_done`` is ordered by completion time, so the sweep stops at the
        first unexpired entry — in-flight requests, and slots a ``wait``
        caller is actively blocked on, are never touched."""
        if self.result_ttl_s is None:
            return
        victims = []
        for rid, t_done in self._done.items():
            if now - t_done <= self.result_ttl_s:
                break
            if self._results[rid].waiters:
                continue
            victims.append(rid)
        for rid in victims:
            del self._done[rid]
            del self._results[rid]
        if victims:
            self.metrics.record_result_evictions(len(victims))

    def _evict_over_capacity(self) -> None:
        """Drop the oldest FINISHED results beyond capacity (lock held).
        In-flight slots don't count against the cap; slots with an active
        ``wait`` caller are skipped — a served result must never turn into
        a None for a thread already blocked on collecting it."""
        need = len(self._done) - self.result_capacity
        if need <= 0:
            return
        victims = []
        for rid in self._done:         # oldest first; stops after `need`
            if need <= 0:
                break
            if self._results[rid].waiters:
                continue
            victims.append(rid)
            need -= 1
        for rid in victims:
            del self._done[rid]
            del self._results[rid]
        if victims:
            self.metrics.record_result_evictions(len(victims))

    # ------------------------------------------------------------------ #
    # scheduling
    # ------------------------------------------------------------------ #
    def _estimated_batch_s(self, n: Optional[int] = None) -> float:
        """EWMA execution-latency estimate for a batch of ``n`` rows (the
        current queue depth by default), keyed by the bucket it would route
        to.  A bucket with no observation yet falls back to the most
        pessimistic known bucket; with no observations at all (no warmup,
        no batch served) the estimate is 0.0 and the deadline clause stays
        conservative."""
        if not self._lat_ewma:
            return 0.0
        if n is None:
            n = max(1, min(len(self._queue), self.max_batch))
        bucket = self.plans.bucket_for(min(n, self.plans.max_batch))
        est = self._lat_ewma.get(bucket)
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
        if head.deadline is not None and \
                head.deadline - now <= self._estimated_batch_s():
            return True   # waiting any longer guarantees an SLO miss
        return False

    def _seconds_to_fire_locked(self, now: float) -> float:
        """How long (at most) until the wait-or-fire policy could flip for
        the CURRENT queue head — the async loop's sleep bound.  New submits
        wake the loop through the condition variable regardless."""
        if not self._queue:
            return _IDLE_WAIT_S
        head = self._queue[0]
        until = head.t_submit + self.max_wait_s - now
        if head.deadline is not None:
            until = min(until,
                        head.deadline - self._estimated_batch_s() - now)
        return min(_IDLE_WAIT_S, max(_MIN_WAIT_S, until))

    def _evict_expired_requests(self, now: float) -> None:
        """Deadline enforcement on the queue (lock held; no-op unless
        ``enforce_deadlines``): requests whose deadline has already passed
        are evicted — their slots complete as None immediately instead of
        wasting a batch row on an answer nobody can use in time."""
        if not self.enforce_deadlines or not self._queue:
            return
        expired = [r for r in self._queue
                   if r.deadline is not None and now > r.deadline]
        if not expired:
            return
        dead = {r.rid for r in expired}
        kept = [r for r in self._queue if r.rid not in dead]
        self._queue.clear()
        self._queue.extend(kept)
        self._finish_slots(expired, None, now)
        self.metrics.record_deadline_evictions(len(expired))

    def _breaker_admit_locked(self, now: float) -> None:
        """Ask the breaker which plan set the NEXT batch runs on (lock
        held).  While degraded, an elapsed cool-down half-opens the breaker
        and reinstalls the fast plans for one probe batch; the probe's
        outcome (``on_success``/``on_failure``) decides whether they
        stay."""
        if self.breaker is None or not self._degraded:
            return
        if self.breaker.use_fast(now):
            fast = self._fast_plans
            if fast is not None:
                self.plans = fast
                self._plan_gen += 1   # fence: stale safe batches still in
                                      # flight must not resolve the probe
                if fast.warmup_s:
                    self._lat_ewma = dict(fast.warmup_s)
            self._degraded = False

    def _breaker_failure_locked(self, now: float) -> None:
        """Feed one terminal batch failure to the breaker (lock held); on a
        trip/reopen, degrade: install the safe-mode twin through the same
        reference-install path ``swap()`` uses — in-flight batches keep
        their snapshot, the next batch runs safe."""
        if self.breaker is None:
            return
        if self.breaker.on_failure(now) is None:
            return
        fast = self._fast_plans if self._degraded else self.plans
        safe = getattr(fast, "safe", None)
        if safe is not None:
            self._fast_plans = fast
            self.plans = safe
            self._plan_gen += 1   # fence: in-flight fast batches that fail
                                  # AFTER this install are stale — their
                                  # breaker feedback is dropped, so one bad
                                  # overlap window can't double-trip
            self._degraded = True
            if safe.warmup_s:
                self._lat_ewma = dict(safe.warmup_s)
        self.metrics.record_breaker_trip()
        self._cv.notify_all()

    def _pipeline_active(self) -> bool:
        """True while formed batches should go to the dispatch lanes (a
        live, accepting executor pool is attached)."""
        pool = self._pool
        return (self._dispatch is not None and pool is not None
                and pool.accepting)

    def _notify(self) -> None:
        """Wake the formation loop (executor-pool completion callback — a
        freed lane may unblock formation or a drain waiter)."""
        with self._cv:
            self._cv.notify_all()

    def _choose_take_locked(self, dispatching: bool) -> int:
        """How many rows the next formed batch takes (lock held; queue
        known non-empty and policy-fired).  Inline execution always takes
        the preferred count (pre-pipeline behavior).  When dispatching,
        lane state decides:

          * preferred lane free -> preferred count (a worker picks it up
            immediately);
          * preferred lane occupied but a worker sits idle -> **spill**: a
            full batch for the largest FREE smaller bucket, so an idle
            worker gets different-bucket work to overlap instead of the
            one hot lane serializing everything (at saturation every
            preferred batch is the top bucket — without spill, workers > 1
            would add nothing);
          * otherwise queue onto the preferred lane while it has room, or
            form nothing (lane-full backpressure; a completion notifies).
        """
        qlen = len(self._queue)
        n_pref = min(qlen, self.max_batch)
        if not dispatching:
            return n_pref
        pref_bucket = self.plans.bucket_for(
            min(n_pref, self.plans.max_batch))
        lane_pref = (id(self), pref_bucket)
        d = self._dispatch
        if d.lane_free(lane_pref):
            return n_pref
        if self._pool is not None and self._pool.idle_workers() > 0:
            for b in reversed(self.plans.buckets):
                if b >= pref_bucket or b > qlen:
                    continue
                if d.lane_free((id(self), b)):
                    return b
        return n_pref if d.can_accept(lane_pref) else 0

    def _form_batch(self, flush: bool = False,
                    dispatching: bool = False) -> Optional[FormedBatch]:
        """The formation stage: apply the wait-or-fire policy and pop one
        batch worth of requests, bound to a snapshot of the current plan
        set (and its generation).  Returns None when the policy says wait
        — or, when dispatching, when every eligible lane is full."""
        with self._lock:
            now = self.clock()
            self._evict_expired_requests(now)
            if not self._queue:
                return None
            if not flush and not self._should_fire_locked(now):
                return None
            self._breaker_admit_locked(now)
            take = self._choose_take_locked(dispatching)
            if take <= 0:
                return None
            reqs: List[Request] = [self._queue.popleft()
                                   for _ in range(take)]
            # formation-time depth: what the batch LEFT behind (arrival-time
            # depth alone can't show pool-induced buildup)
            self.metrics.record_formation(len(self._queue))
            plans = self.plans        # snapshot: a swap() between batches
            return FormedBatch(reqs=reqs, plans=plans,
                               bucket=plans.bucket_for(len(reqs)),
                               t_formed=now, server=self,
                               gen=self._plan_gen)

    def _pump(self, flush: bool = False) -> int:
        """Formation loop body in pipeline mode: form batches onto their
        dispatch lanes until the policy or lane backpressure says stop.
        Returns rows dispatched (NOT served — execution is async)."""
        dispatched = 0
        while True:
            batch = self._form_batch(flush, dispatching=True)
            if batch is None:
                return dispatched
            if not self._dispatch.put(batch):
                # closed (shutdown race) — run inline so nothing is lost
                self._run_batch(batch)
                return dispatched + len(batch.reqs)
            dispatched += len(batch.reqs)

    def step(self, flush: bool = False) -> int:
        """Fire at most one batch if the policy (or ``flush``) says so.
        Returns the number of requests served."""
        batch = self._form_batch(flush)
        if batch is None:
            return 0
        return self._run_batch(batch)

    def poll(self) -> int:
        """Fire as many batches as the policy allows right now."""
        served = 0
        while True:
            n = self.step()
            if n == 0:
                return served
            served += n

    def drain(self) -> int:
        """Serve everything queued, ignoring the wait policy (shutdown /
        end-of-trace flush).  In pipeline mode this pumps the backlog
        through the dispatch lanes and waits for the pool to go idle —
        the bounded-drain invariant holds with any number of workers."""
        if self._pipeline_active():
            dispatched = 0
            while True:
                dispatched += self._pump(flush=True)
                with self._cv:
                    if not self._queue:
                        break
                    if not self._pipeline_active():
                        break   # pool stopped mid-drain: finish inline
                    # lanes full: a completion notifies; bounded wait so a
                    # dying pool cannot wedge the drain
                    self._cv.wait(timeout=_IDLE_WAIT_S)
            if self._dispatch is not None:
                # bounded waits so a pool that stops mid-drain can't wedge
                # us; whatever it leaves on the lanes runs inline below
                while self._pipeline_active() and \
                        not self._dispatch.wait_idle(server=self,
                                                     timeout=_IDLE_WAIT_S):
                    pass
                for b in self._dispatch.drain_batches(server=self):
                    self._run_batch(b)
            # inline sweep for anything left (pool stopped mid-drain)
            while True:
                n = self.step(flush=True)
                if n == 0:
                    return dispatched
                dispatched += n
        served = 0
        while True:
            n = self.step(flush=True)
            if n == 0:
                return served
            served += n

    # ------------------------------------------------------------------ #
    # async mode
    # ------------------------------------------------------------------ #
    def start(self) -> "SparseServer":
        """Spawn the background scheduler thread (idempotent).  The thread
        drives the SAME wait-or-fire policy ``step`` uses, against the real
        clock, while callers ``submit`` concurrently.  With ``watchdog_s``
        a watchdog thread is armed alongside it (see ``_respawn``)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._closed = False
            self._drain_on_stop = True
            if self.executor_workers > 0 and self._dispatch is None:
                # own pipeline (a router-attached one arrives via
                # _attach_pool instead): lanes + pool live for the
                # server's lifetime; start() after shutdown() rebuilds
                # them because close() is sticky on DispatchQueues
                self._dispatch = DispatchQueues(
                    per_lane=self.dispatch_per_lane)
                self._pool = ExecutorPool(self._dispatch,
                                          workers=self.executor_workers,
                                          name=f"{self.name}-exec")
                self._pool_owned = True
            if self._pool is not None and self._pool_owned:
                self._pool.start()
            self._spawn_scheduler_locked()
            if self.watchdog_s is not None and \
                    (self._watchdog is None or not self._watchdog.running):
                pool = self._pool if self._pool_owned else None
                self._watchdog = Watchdog(
                    timeout_s=self.watchdog_s,
                    heartbeat=self._heartbeat,
                    get_thread=lambda: self._thread,
                    has_work=lambda: len(self._queue) > 0,
                    restart=self._respawn,
                    stop_event=self._stop,
                    on_poll=(pool.ensure if pool is not None else None),
                ).start()
        return self

    def _attach_pool(self, dispatch: DispatchQueues,
                     pool: ExecutorPool) -> None:
        """Hook this server up to a SHARED dispatch/pool (``ModelRouter``):
        lanes are keyed by (server, bucket) so models never share a lane,
        but the workers draining them are common.  The router owns the
        pool's lifecycle."""
        with self._lock:
            self._dispatch = dispatch
            self._pool = pool
            self._pool_owned = False

    def _spawn_scheduler_locked(self) -> None:
        # beat first: a fresh scheduler must never look stale to the
        # watchdog before its first loop iteration
        self._heartbeat.beat()
        self._thread = threading.Thread(
            target=self._serve_loop, name="sparse-server", daemon=True)
        self._thread.start()

    def _respawn(self, dead: bool) -> None:
        """Watchdog callback: the scheduler thread died (crashed) or wedged
        past ``watchdog_s`` with work queued — replace it.  Queued requests
        and result slots are server state, not thread state, so the new
        scheduler picks the backlog up exactly where the old one left it; a
        wedged-but-alive old thread retires itself at its next loop check
        (``self._thread is not me``)."""
        with self._cv:
            if self._stop.is_set():
                return
            self.metrics.record_watchdog_restart()
            if self.tracer.enabled:
                self.tracer.event("watchdog.restart", model=self.name,
                                  dead=dead)
            self._spawn_scheduler_locked()
            self._cv.notify_all()

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def _serve_loop(self) -> None:
        me = threading.current_thread()
        while True:
            if self._thread is not me:
                return  # superseded by a watchdog restart — retire quietly
            self._heartbeat.beat()
            # chaos site: an injected raise here kills this thread (the
            # watchdog-restart path); fired OUTSIDE the lock so an injected
            # hang wedges only the scheduler, never submitters
            self._fire("server.scheduler")
            with self._cv:
                while not self._stop.is_set() and not self._queue:
                    if self._thread is not me:
                        return
                    self._heartbeat.beat()
                    self._cv.wait(timeout=_IDLE_WAIT_S)
                if self._stop.is_set() and \
                        (not self._drain_on_stop or not self._queue):
                    return
                timeout = self._seconds_to_fire_locked(self.clock())
            # execution happens OUTSIDE the lock: submits stay unblocked.
            # Pipeline mode only FORMS here — execution is the pool's job
            pipelined = self._pipeline_active()
            if pipelined:
                served = self._pump(flush=self._stop.is_set())
            else:
                served = self.step(flush=self._stop.is_set())
            if served == 0:
                with self._cv:
                    # re-check under the cv before sleeping: a notify that
                    # landed between step() and here (e.g. the queue filling
                    # to a full batch) would otherwise be lost and the ready
                    # batch would sleep out the stale timeout.  In pipeline
                    # mode a zero pump may also mean lane-full backpressure
                    # — then the wait is correct regardless of the policy
                    # (a batch completion notifies this cv), and it stays
                    # bounded by `timeout` <= the idle tick
                    if pipelined or (not self._stop.is_set()
                                     and not self._should_fire_locked()):
                        if not (self._stop.is_set() and not self._queue):
                            self._cv.wait(timeout=timeout)

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None,
                 drain_timeout_s: Optional[float] = None) -> bool:
        """Stop the scheduler thread gracefully.  New submits are rejected
        from this point on.  With ``drain`` (default) every queued request
        is served before the thread exits — the loop switches to flush
        mode, and anything it leaves behind is drained synchronously here.
        With ``drain=False`` the backlog is abandoned: the thread exits
        immediately, queued requests stay unserved, and their waiters only
        return on timeout (bad-traffic bailout, not the graceful path).

        ``drain_timeout_s`` bounds the WHOLE graceful path: a scheduler
        hung inside a batch would otherwise block this join (and the
        drain) forever.  Past the bound the hung thread and any remaining
        backlog are abandoned — the drain keeps running on a daemon helper,
        but shutdown returns.  Returns True when the stop fully completed
        (thread joined and, with ``drain``, the backlog fully served)."""
        with self._cv:
            self._closed = True
            self._drain_on_stop = drain
            self._stop.set()
            self._cv.notify_all()
        t = self._thread
        join_s = timeout if timeout is not None else drain_timeout_s
        joined = True
        if t is not None and t is not threading.current_thread():
            t.join(join_s)
            joined = not t.is_alive()
        if self._watchdog is not None:
            self._watchdog.join(1.0)
        if self._pool is not None and self._pool_owned:
            # execution stage: with drain, every queued + in-flight lane
            # batch runs before the workers stop; leftovers (a worker died
            # mid-stop) run inline so no dispatched request is lost
            joined = self._pool.stop(drain=drain,
                                     timeout=drain_timeout_s) and joined
            if drain and self._dispatch is not None:
                for b in self._dispatch.drain_batches(server=self):
                    self._run_batch(b)
            # sticky close() on the lanes: rebuild on the next start()
            self._dispatch = None
            self._pool = None
            self._pool_owned = False
        if not drain:
            return joined
        if drain_timeout_s is None:
            self.drain()
            return joined
        done = threading.Event()

        def _drain_bg():
            try:
                self.drain()
            finally:
                done.set()

        helper = threading.Thread(target=_drain_bg, daemon=True,
                                  name="sparse-server-drain")
        helper.start()
        return done.wait(drain_timeout_s) and joined

    # ------------------------------------------------------------------ #
    # plan hot-swap
    # ------------------------------------------------------------------ #
    def swap(self, net=None, plans: Optional[BucketedPlanSet] = None,
             warmup: bool = True, swap_async: bool = False):
        """Hot-swap the served plan set; returns the replaced one.

        Pass ``net`` (a pruned layer stack / ``BlockFFNN`` — the weight
        update) to compile the replacement through the server's
        engine/plan-store settings, or a prebuilt ``plans``.  The compile,
        the plan-store lookup, and the bucket warmup all run OFF the
        serving path — no lock held, batches keep firing throughout; only
        the final reference install holds the lock.  A batch snapshots
        ``self.plans`` when it forms, so an in-flight batch finishes on the
        plan set it started with: no request is ever dropped or served by
        mixed weights, and the swapped-in weights take effect on the next
        batch.

        ``swap_async=True`` moves even the *caller's* wait off the serving
        path: the build runs on a background thread and the install lands
        between batches when it is ready — a weight update never stalls
        the pipeline or the thread requesting it.  Returns a
        :class:`SwapHandle` immediately (``handle.wait()`` -> the replaced
        plan set).
        """
        if (net is None) == (plans is None):
            raise ValueError("swap needs exactly one of net= or plans=")
        tr = self.tracer
        t_sw0 = tr.clock() if tr.enabled else 0.0
        if not swap_async:
            built, compile_s, cache_hit = self._swap_build(net, plans,
                                                           warmup)
            return self._swap_install(built, compile_s, cache_hit, t_sw0)
        handle = SwapHandle()

        def _bg():
            try:
                built, compile_s, cache_hit = self._swap_build(net, plans,
                                                               warmup)
                handle._old = self._swap_install(built, compile_s,
                                                 cache_hit, t_sw0)
            except BaseException as e:  # surfaced via handle.wait()
                handle._err = e
            finally:
                handle._ev.set()

        threading.Thread(target=_bg, daemon=True,
                         name=f"{self.name}-swap").start()
        return handle

    def _swap_build(self, net, plans: Optional[BucketedPlanSet],
                    warmup: bool):
        """The off-path half of a swap: compile/plan-store-hit (for a
        ``net=`` swap), safe-twin completion, warmup, shape validation.
        No server lock is ever held here."""
        # prebuilt plans= paid their compile long ago (possibly never, in a
        # ping-pong swap) — only a net= swap charges compile time/hit state
        # to the swap metrics
        compile_s, cache_hit = 0.0, True
        if plans is None:
            if self._engine is None:
                raise ValueError(
                    "swap(net) needs the server constructed with engine= "
                    "(and optionally plan_store=) to compile the "
                    "replacement plan set")
            plans = BucketedPlanSet.compile(
                net, engine=self._engine, max_batch=self.plans.max_batch,
                plan_store=self._plan_store, backend=self._backend,
                safe_twin=self.breaker is not None)
            if warmup:
                plans.warmup()
            compile_s, cache_hit = plans.compile_s, plans.cache_hit
        elif self.breaker is not None and \
                getattr(plans, "safe", None) is None:
            # a breaker-guarded server must always have a degradation
            # target; build the twin here, still OFF the serving path
            plans.safe = plans.build_safe_twin()
            if warmup:
                plans.safe.warmup()
        if (plans.n_in, plans.n_out) != (self.plans.n_in, self.plans.n_out):
            raise ValueError(
                f"swapped plans change the model shape: "
                f"{plans.n_in}->{plans.n_out} vs "
                f"{self.plans.n_in}->{self.plans.n_out}; hot-swap is for "
                "weight updates — serve a different architecture as its "
                "own ModelRouter model instead")
        if plans.max_batch < self.max_batch:
            raise ValueError(
                f"swapped plans' top bucket {plans.max_batch} is below the "
                f"server's max_batch {self.max_batch}")
        return plans, compile_s, cache_hit

    def _swap_install(self, plans: BucketedPlanSet, compile_s: float,
                      cache_hit: bool, t_sw0: float) -> BucketedPlanSet:
        """The locked half of a swap: the reference install, between
        batches by construction (every formed batch carries its own plan
        snapshot and generation)."""
        tr = self.tracer
        with self._cv:
            # the logically-installed set is the fast one even while the
            # breaker has the safe twin serving — return that, and start
            # the new weights with a clean failure history
            old = self._fast_plans if self._degraded and \
                self._fast_plans is not None else self.plans
            self.plans = plans
            self._plan_gen += 1   # fence: batches formed before this
                                  # install must not feed the (reset)
                                  # breaker or the reseeded EWMA
            self._fast_plans = None
            self._degraded = False
            if self.breaker is not None:
                self.breaker.reset()
            if plans.warmup_s:
                self._lat_ewma = dict(plans.warmup_s)
            self.metrics.record_swap(self.clock(), compile_s, cache_hit)
            self._cv.notify_all()
        # the swapped-in plans' static I/O gauges replace the old ones on
        # first batch per bucket (fresh plan-set id in _io_seen)
        if tr.enabled:
            tr.span_at("plan.swap", t_sw0, tr.clock(), model=self.name,
                       compile_s=round(compile_s, 6), cache_hit=cache_hit)
        return old

    # ------------------------------------------------------------------ #
    def _attempt(self, plans: BucketedPlanSet, x: np.ndarray):
        """One bounded batch-execution attempt: injector sites, optional
        wall-clock timeout, NaN/Inf guard.  Raises on any failure."""

        def run():
            self._fire("server.run_batch")
            y = plans(x)
            return self._fire("server.result", y)

        y = call_with_timeout(run, self.retry.timeout_s, name="batch")
        if self.output_guard:
            check_finite(y)
        return y

    def _trace_batch(self, reqs: List[Request], plans, bucket: int,
                     t0: float, t1: float, attempt: int,
                     error: Optional[BaseException] = None,
                     worker: Optional[int] = None) -> None:
        """Record the batch's execute span, each request's retroactive queue
        span, and per-request done events (tracer enabled — caller checked)."""
        tr = self.tracer
        attrs = {"model": self.name, "bucket": bucket, "n": len(reqs),
                 "attempt": attempt + 1,
                 "degraded": bool(getattr(plans, "safe_mode", False))}
        if worker is not None:
            attrs["worker"] = worker
        attrs.update(plan_io_attrs(plans.plans.get(bucket, plans.base)))
        if error is not None:
            attrs["error"] = type(error).__name__
        tr.span_at("batch.execute", t0, t1, **attrs)
        for r in reqs:
            tr.span_at("request.queue", r.t_submit, t0, model=self.name,
                       rid=r.rid, bucket=bucket)
            tr.event("request.done", model=self.name, rid=r.rid,
                     ok=error is None,
                     miss=bool(r.deadline is not None and t1 > r.deadline))

    def _run_batch(self, batch: FormedBatch,
                   worker: Optional[int] = None) -> int:
        """Execute one formed batch — inline (scheduler thread, ``worker``
        None) or on an executor-pool worker.  Runs against the batch's own
        plan snapshot; breaker feedback is fenced by the batch's plan
        generation, so a batch that overlapped a swap/degrade/reinstall
        can neither trip nor reset state that belongs to newer plans."""
        reqs, plans = batch.reqs, batch.plans
        n = len(reqs)
        bucket = plans.bucket_for(n)
        x = np.stack([r.x for r in reqs])
        policy = self.retry
        tr = self.tracer
        attempt = 0
        while True:
            t0 = self.clock()
            try:
                y = self._attempt(plans, x)
                break
            except Exception as e:
                # a failed batch must not kill the scheduler thread (in
                # router mode that would stop EVERY model)
                timed_out = isinstance(e, BatchTimeoutError)
                nan_guard = isinstance(e, OutputGuardError)
                t1 = self.clock()
                if attempt < policy.max_retries:
                    attempt += 1
                    with self._lock:
                        self.metrics.record_retry(timed_out=timed_out,
                                                  nan_guard=nan_guard)
                    if tr.enabled:
                        tr.event("batch.retry", model=self.name,
                                 bucket=bucket, attempt=attempt,
                                 error=type(e).__name__)
                    if policy.backoff_s > 0:
                        time.sleep(policy.backoff(attempt))
                    continue
                # retries exhausted: complete the batch's slots with None
                # so waiters unblock, count the failure, feed the breaker,
                # move on
                if tr.enabled:
                    self._trace_batch(reqs, plans, bucket, t0, t1,
                                      attempt, error=e, worker=worker)
                with self._cv:
                    self.metrics.record_attempt_failure(timed_out=timed_out,
                                                        nan_guard=nan_guard)
                    self._finish_slots(reqs, None, t1)
                    self.metrics.record_batch_failure(t1, n)
                    if batch.gen == self._plan_gen:
                        self._breaker_failure_locked(t1)
                return n
        t1 = self.clock()
        exec_s = t1 - t0
        # the pipeline wait split: form-wait (submit -> formation) per
        # request, dispatch-wait (formation -> execution start) per batch.
        # Inline execution starts at formation time, so its dispatch wait
        # is ~0 and the totals match the pre-pipeline series
        dispatch_wait = max(0.0, t0 - batch.t_formed)
        waits = [batch.t_formed - r.t_submit for r in reqs]
        misses = sum(1 for r in reqs
                     if r.deadline is not None and t1 > r.deadline)
        if tr.enabled:
            self._trace_batch(reqs, plans, bucket, t0, t1, attempt,
                              worker=worker)
        do_measure = False
        with self._cv:
            if self.plans is plans:
                # don't let a batch that was in flight across a swap() write
                # the OLD plans' latency into the estimator the swap seeded
                prev = self._lat_ewma.get(bucket)
                self._lat_ewma[bucket] = (exec_s if prev is None
                                          else 0.5 * prev + 0.5 * exec_s)
            self._finish_slots(reqs, y, t1)
            self._evict_expired(t1)
            self.metrics.record_batch(t1, n, bucket, exec_s, waits, misses,
                                      dispatch_wait_s=dispatch_wait)
            if getattr(plans, "safe_mode", False):
                self.metrics.record_degraded_batch()
            if self.breaker is not None and batch.gen == self._plan_gen \
                    and self.breaker.on_success() == "reset":
                # half-open probe served: back on the fast plan for good
                self.metrics.record_breaker_reset()
                self._fast_plans = None
            if self.measure_dynamic_every > 0:
                self._measure_countdown -= 1
                if self._measure_countdown <= 0:
                    self._measure_countdown = self.measure_dynamic_every
                    do_measure = True
            # the seen-check must be atomic under the pool (two workers
            # finishing the same fresh (plan set, bucket) concurrently);
            # the observe itself stays outside the lock
            io_key = (id(plans), bucket)
            io_first = io_key not in self._io_seen
            if io_first:
                self._io_seen.add(io_key)
        # I/O telemetry runs OUTSIDE the lock: static gauges once per
        # (plan set, bucket), measured dynamic I/O on the sampling cadence
        if io_first:
            self.io.observe_plan(bucket, plans.plans.get(bucket, plans.base))
        if do_measure:
            self._measure_dynamic(plans, bucket, x)
        return n

    def _measure_dynamic(self, plans: BucketedPlanSet, bucket: int,
                         x: np.ndarray) -> None:
        """Sample measured dynamic I/O for one served batch (gated fused
        plans only — quietly inactive otherwise).  Telemetry must never
        fail serving, so a measurement error becomes a trace event and a
        count in ``metrics.io_measure_failed``."""
        base = plans.base
        if not base.gate or base._measure is None:
            return
        try:
            report = base.measure_dynamic(x)
        except Exception as e:
            self.metrics.record_measure_failed()
            if self.tracer.enabled:
                self.tracer.event("io.measure_failed", model=self.name,
                                  bucket=bucket, error=type(e).__name__)
            return
        self.io.observe_dynamic(bucket, report)
        if self.tracer.enabled:
            self.tracer.event(
                "io.measure", model=self.name, bucket=bucket,
                dynamic_blocks=int(report.dynamic_total),
                static_blocks=int(report.static_total),
                read_fraction=round(float(report.read_fraction), 4))

    def _finish_slots(self, reqs: List[Request], y, t1: float) -> None:
        """Complete (and wake) each request's slot — with its output row, or
        None for a failed batch (lock held)."""
        for i, r in enumerate(reqs):
            slot = self._results.get(r.rid)
            if slot is None:          # collected early / server torn down
                continue
            slot.value = None if y is None else y[i]
            slot.t_done = t1
            slot.done = True
            if slot.event is not None:
                slot.event.set()
            self._done[r.rid] = t1
        self._evict_over_capacity()

    # ------------------------------------------------------------------ #
    # observability
    # ------------------------------------------------------------------ #
    def snapshot(self) -> dict:
        """One JSON-safe cut of everything observable about this server:
        serving metrics (atomic — see ``ServingMetrics.snapshot``),
        per-bucket I/O gauges, resilience state, tracer accounting.  This
        is the dict ``obs.prom.render_prometheus`` renders."""
        snap = self.metrics.snapshot()
        snap["model"] = self.name
        snap["queue_depth_now"] = self.queue_depth
        snap["degraded"] = self._degraded
        if self._pool is not None and self._pool_owned:
            # per-worker utilization + dispatch state (router-shared pools
            # are reported once, at the router level)
            snap["pool"] = self._pool.snapshot()
        if self.breaker is not None:
            snap["breaker_state"] = self.breaker.state
            snap["breaker_open"] = self.breaker.state == "open"
        snap["io"] = self.io.snapshot()
        if self.tracer.enabled:
            snap["tracer"] = self.tracer.snapshot()
        return snap


# ---------------------------------------------------------------------- #
# multi-model serving
# ---------------------------------------------------------------------- #
class ModelRouter:
    """Serve several named :class:`BucketedPlanSet`s from one process.

    Each model gets its own :class:`SparseServer` (queue, admission bound,
    per-model metrics, hot-swap), but ONE shared scheduler thread drives
    them all round-robin — the per-model wait-or-fire policies stay exactly
    the single-model ones, batches never mix models, and a stalled model
    cannot starve another's admission (only delay its batches by one
    execution).

    ``submit`` routes by model id; ``swap(model, net)`` hot-swaps one model
    while the others keep serving.
    """

    def __init__(self, models: Dict[str, BucketedPlanSet],
                 clock: Callable[[], float] = time.monotonic,
                 server_settings: Optional[Dict[str, dict]] = None,
                 watchdog_s: Optional[float] = None,
                 fault_injector: Optional[FaultInjector] = None,
                 tracer: Optional[Tracer] = None,
                 executor_workers: int = 0,
                 dispatch_per_lane: int = 2,
                 **server_kwargs):
        """``server_kwargs`` apply to every model's server;
        ``server_settings[name]`` overlays per-model keyword arguments
        (e.g. the ``engine=``/``plan_store=`` swap settings, or a
        per-model ``breaker=``).  ``watchdog_s`` arms a watchdog over the
        SHARED scheduler thread; ``fault_injector`` fires the
        ``router.scheduler`` chaos site; ``tracer`` is shared by every
        model's server (spans carry the model name), so one export holds
        the whole process's request lifecycle.  ``executor_workers`` spawns
        ONE execution-stage pool shared by every model on ``start()``:
        lanes are per (model, bucket), so batches of different models — or
        different buckets of one model — overlap across the shared
        workers, while each lane stays FIFO."""
        if not models:
            raise ValueError("ModelRouter needs at least one model")
        settings = server_settings or {}
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.servers: Dict[str, SparseServer] = {
            name: SparseServer(plans, clock=clock,
                               **{"name": name, "tracer": self.tracer,
                                  **server_kwargs,
                                  **settings.get(name, {})})
            for name, plans in models.items()
        }
        self.clock = clock
        self.watchdog_s = watchdog_s
        self.injector = fault_injector
        self.watchdog_restarts = 0
        self._heartbeat = Heartbeat()
        self._watchdog: Optional[Watchdog] = None
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._drain_on_stop = True
        if executor_workers < 0:
            raise ValueError(
                f"executor_workers must be >= 0, got {executor_workers}")
        self.executor_workers = executor_workers
        self.dispatch_per_lane = dispatch_per_lane
        self._dispatch: Optional[DispatchQueues] = None
        self._pool: Optional[ExecutorPool] = None

    @classmethod
    def compile(cls, nets: Dict[str, object], engine=None, max_batch: int = 32,
                plan_store=None, backend: Optional[str] = None,
                warmup: bool = True, safe_twin: bool = False,
                breaker: Optional[Callable[[], CircuitBreaker]] = None,
                **router_kwargs) -> "ModelRouter":
        """Compile every named network into a bucketed plan set (one
        engine compile or plan-store hit each) and route them together.
        The per-model compile settings are threaded through to each server
        so ``swap(model, net)`` works out of the box.

        ``safe_twin`` also precompiles each model's safe-mode twin;
        ``breaker`` is a zero-arg factory (breaker state is per model —
        e.g. ``lambda: CircuitBreaker(threshold=3, cooldown_s=5)``) giving
        every server its own circuit breaker, and implies ``safe_twin``."""
        if breaker is not None:
            safe_twin = True
        models = {}
        for name, net in nets.items():
            plans = BucketedPlanSet.compile(net, engine=engine,
                                            max_batch=max_batch,
                                            plan_store=plan_store,
                                            backend=backend,
                                            safe_twin=safe_twin)
            if warmup:
                plans.warmup()
            models[name] = plans
        return cls(models,
                   server_settings={
                       name: dict(engine=engine, plan_store=plan_store,
                                  backend=backend,
                                  **({"breaker": breaker()}
                                     if breaker is not None else {}))
                       for name in models
                   }, **router_kwargs)

    # ------------------------------------------------------------------ #
    def _server(self, model: str) -> SparseServer:
        try:
            return self.servers[model]
        except KeyError:
            raise KeyError(
                f"unknown model {model!r}; serving "
                f"{sorted(self.servers)}") from None

    def submit(self, model: str, x,
               deadline_ms: Optional[float] = None) -> Optional[int]:
        """Enqueue one request for ``model``; the returned id is scoped to
        that model (pass the same model to ``result``/``wait``)."""
        # the wake decision is computed atomically inside the server's lock
        # (re-deriving it from queue_depth here could miss the empty->
        # non-empty transition when two submits race) and the router cv is
        # taken only AFTER the server lock is released — the shared loop
        # acquires router-then-server, so the reverse order would deadlock
        rid, wake, _ = self._server(model)._submit(x, deadline_ms)
        if wake:
            with self._cv:
                self._cv.notify_all()
        return rid

    def submit_ex(self, model: str, x,
                  deadline_ms: Optional[float] = None
                  ) -> "tuple[Optional[int], Optional[str]]":
        """``submit`` with the rejection reason (``None`` / ``"queue_full"``
        / ``"closed"``) — the HTTP front door's admission path."""
        rid, wake, reason = self._server(model)._submit(x, deadline_ms)
        if wake:
            with self._cv:
                self._cv.notify_all()
        return rid, reason

    def result(self, model: str, rid: int) -> Optional[np.ndarray]:
        return self._server(model).result(rid)

    def wait(self, model: str, rid: int,
             timeout: Optional[float] = None) -> Optional[np.ndarray]:
        return self._server(model).wait(rid, timeout)

    def swap(self, model: str, net=None,
             plans: Optional[BucketedPlanSet] = None,
             warmup: bool = True, swap_async: bool = False):
        return self._server(model).swap(net, plans=plans, warmup=warmup,
                                        swap_async=swap_async)

    @property
    def queue_depth(self) -> int:
        return sum(s.queue_depth for s in self.servers.values())

    # ------------------------------------------------------------------ #
    def poll(self) -> int:
        return sum(s.poll() for s in self.servers.values())

    def drain(self) -> int:
        return sum(s.drain() for s in self.servers.values())

    def step(self, flush: bool = False) -> int:
        return sum(s.step(flush=flush) for s in self.servers.values())

    # ------------------------------------------------------------------ #
    def start(self) -> "ModelRouter":
        """Spawn the ONE scheduler thread shared by every model (plus its
        watchdog when ``watchdog_s`` is set)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._drain_on_stop = True
            for s in self.servers.values():
                s._closed = False
            if self.executor_workers > 0 and self._dispatch is None:
                # ONE pool shared across every model: per-(model, bucket)
                # lanes, common workers.  Completions wake the shared
                # formation loop through the router cv
                self._dispatch = DispatchQueues(
                    per_lane=self.dispatch_per_lane)
                self._pool = ExecutorPool(self._dispatch,
                                          workers=self.executor_workers,
                                          wake=self._notify,
                                          name="router-exec")
                for s in self.servers.values():
                    s._attach_pool(self._dispatch, self._pool)
            if self._pool is not None:
                self._pool.start()
            self._spawn_scheduler_locked()
            if self.watchdog_s is not None and \
                    (self._watchdog is None or not self._watchdog.running):
                pool = self._pool
                self._watchdog = Watchdog(
                    timeout_s=self.watchdog_s,
                    heartbeat=self._heartbeat,
                    get_thread=lambda: self._thread,
                    has_work=lambda: self.queue_depth > 0,
                    restart=self._respawn,
                    stop_event=self._stop,
                    on_poll=(pool.ensure if pool is not None else None),
                ).start()
        return self

    def _notify(self) -> None:
        with self._cv:
            self._cv.notify_all()

    def _spawn_scheduler_locked(self) -> None:
        self._heartbeat.beat()
        self._thread = threading.Thread(
            target=self._serve_loop, name="model-router", daemon=True)
        self._thread.start()

    def _respawn(self, dead: bool) -> None:
        """Watchdog callback: replace a dead/wedged shared scheduler.  All
        queues and slots live on the per-model servers, so no model loses
        anything queued."""
        with self._cv:
            if self._stop.is_set():
                return
            self.watchdog_restarts += 1
            if self.tracer.enabled:
                self.tracer.event("watchdog.restart", scope="router",
                                  dead=dead)
            self._spawn_scheduler_locked()
            self._cv.notify_all()

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def _serve_loop(self) -> None:
        servers = list(self.servers.values())
        me = threading.current_thread()
        while True:
            if self._thread is not me:
                return  # superseded by a watchdog restart
            self._heartbeat.beat()
            inj = self.injector
            if inj is not None:
                inj.fire("router.scheduler")
            stopping = self._stop.is_set()
            if stopping and not self._drain_on_stop:
                return                 # abandon the backlog (bad-traffic exit)
            served = sum((s._pump(flush=stopping) if s._pipeline_active()
                          else s.step(flush=stopping)) for s in servers)
            if stopping and all(s.queue_depth == 0 for s in servers):
                return
            if served == 0:
                now = self.clock()
                with self._cv:
                    # each server's fire time is read under ITS lock — a
                    # concurrent drain()/step() may pop the head between an
                    # unlocked emptiness check and the head access otherwise.
                    # If any server became fireable since the step sweep (a
                    # notify raced the loop), skip the sleep entirely.  A
                    # pipeline server that is fireable but lane-blocked is
                    # NOT fireable for this purpose — waiting is right (a
                    # batch completion notifies the router cv), and spinning
                    # until a lane frees would starve the other models
                    timeout = _IDLE_WAIT_S
                    fireable = False
                    for s in servers:
                        with s._lock:
                            if not s._queue:
                                continue
                            if s._should_fire_locked(now):
                                if not s._pipeline_active() or \
                                        s._choose_take_locked(True) > 0:
                                    fireable = True
                                    break
                                continue
                            timeout = min(
                                timeout, s._seconds_to_fire_locked(now))
                    if not fireable and not self._stop.is_set():
                        self._cv.wait(timeout=timeout)

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None,
                 drain_timeout_s: Optional[float] = None) -> bool:
        """Graceful stop: reject new submits, serve everything queued (with
        ``drain``; ``drain=False`` abandons every model's backlog), join the
        shared scheduler thread.  ``drain_timeout_s`` bounds the whole
        graceful path exactly like :meth:`SparseServer.shutdown` — a batch
        hung in one model must not hold the process shutdown hostage.
        Returns True when the stop fully completed."""
        for s in self.servers.values():
            with s._cv:
                s._closed = True
        with self._cv:
            self._drain_on_stop = drain
            self._stop.set()
            self._cv.notify_all()
        t = self._thread
        join_s = timeout if timeout is not None else drain_timeout_s
        joined = True
        if t is not None and t is not threading.current_thread():
            t.join(join_s)
            joined = not t.is_alive()
        if self._watchdog is not None:
            self._watchdog.join(1.0)
        if self._pool is not None:
            # the router owns the shared pool: drain every model's lanes,
            # stop the workers, run leftovers inline on their own servers
            joined = self._pool.stop(drain=drain,
                                     timeout=drain_timeout_s) and joined
            if drain and self._dispatch is not None:
                for b in self._dispatch.drain_batches():
                    b.server._run_batch(b)
            for s in self.servers.values():
                s._dispatch = None
                s._pool = None
            self._dispatch = None
            self._pool = None
        if not drain:
            return joined
        if drain_timeout_s is None:
            self.drain()
            return joined
        done = threading.Event()

        def _drain_bg():
            try:
                self.drain()
            finally:
                done.set()

        helper = threading.Thread(target=_drain_bg, daemon=True,
                                  name="model-router-drain")
        helper.start()
        return done.wait(drain_timeout_s) and joined

    # ------------------------------------------------------------------ #
    def metrics_snapshot(self) -> dict:
        """Per-model metrics plus process-level totals."""
        per_model = {name: s.metrics.snapshot()
                     for name, s in self.servers.items()}
        total_keys = ("admitted", "rejected", "served", "batches",
                      "deadline_misses", "results_evicted",
                      "batch_failures", "failed_requests", "swaps",
                      "swap_hits", "retries", "batch_timeouts",
                      "nan_guard_failures", "breaker_trips",
                      "breaker_resets", "degraded_batches",
                      "watchdog_restarts", "deadline_evictions",
                      "cancelled")
        totals = {k: sum(m[k] for m in per_model.values())
                  for k in total_keys}
        # the shared scheduler's own watchdog restarts are router-level
        # (one thread serves every model), reported beside the per-model
        # sums rather than smeared into them
        totals["watchdog_restarts"] += self.watchdog_restarts
        return {"models": per_model, "total": totals,
                "router": {"watchdog_restarts": self.watchdog_restarts}}

    def snapshot(self) -> dict:
        """Full observability snapshot: every model's ``SparseServer
        .snapshot()`` (metrics + I/O gauges + resilience state) under
        ``models``, plus the process totals.  This is what a router-level
        Prometheus endpoint renders — the ``models`` map becomes a
        ``model=`` label."""
        base = self.metrics_snapshot()
        out = {
            "models": {name: s.snapshot()
                       for name, s in self.servers.items()},
            "total": base["total"],
            "router": base["router"],
        }
        if self._pool is not None:
            out["pool"] = self._pool.snapshot()
        return out

    def summary(self) -> str:
        lines = [f"{name}: {s.metrics.summary()}"
                 for name, s in self.servers.items()]
        return "\n".join(lines)
