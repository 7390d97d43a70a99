"""Serving metrics: per-request latency, queue depth, throughput, SLO hits.

Port of ``repro.serving.metrics``, with one counter more:
``io_measure_failed``, the dynamic-I/O samples that raised (the batch itself
was served).  Everything is recorded against the server's injected clock,
so tests drive time deterministically; ``snapshot`` returns a plain
JSON-serializable dict.

  * **bounded memory** — the observation series (``latency_s``,
    ``queue_wait_s``, ``form_wait_s``, ``dispatch_wait_s``, ``exec_s``,
    ``queue_depth``, ``form_depth``, ``swap_compile_s``, ``batch_sizes``)
    are :class:`repro_torch.obs.BoundedSeries`: exact percentiles up to
    4096 samples, then log-bucket estimates, bounded memory;
  * **atomic snapshots** — all ``record_*`` methods and ``snapshot()``
    share one leaf lock (nothing is called while it is held), so a snapshot
    taken under traffic is a consistent cut: ``served`` always equals the
    latency series' count.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

from ..obs.series import BoundedSeries


def percentile(xs: List[float], q: float) -> float:
    """Nearest-rank percentile; 0.0 for an empty series.

    Total on every input ``snapshot()`` can produce: a single-sample series
    answers every q with its one value, and out-of-range q clamps to
    [0, 100] (q=100 is the max, never an off-the-end index).
    """
    if not xs:
        return 0.0
    ys = sorted(xs)
    q = min(100.0, max(0.0, q))
    k = min(len(ys) - 1, max(0, int(round(q / 100.0 * (len(ys) - 1)))))
    return ys[k]


def _series() -> BoundedSeries:
    return BoundedSeries()


@dataclasses.dataclass
class ServingMetrics:
    """Counters + bounded series for one server lifetime."""

    admitted: int = 0
    rejected: int = 0
    served: int = 0
    batches: int = 0
    padded_rows: int = 0
    batched_rows: int = 0
    deadline_misses: int = 0
    results_evicted: int = 0
    batch_failures: int = 0
    failed_requests: int = 0
    swaps: int = 0
    swap_hits: int = 0
    # resilience counters (see repro.serving.resilience)
    retries: int = 0                # batch attempts retried after a failure
    batch_timeouts: int = 0         # attempts killed by RetryPolicy.timeout_s
    nan_guard_failures: int = 0     # batches failed by the NaN/Inf guard
    breaker_trips: int = 0          # circuit breaker closed/half_open -> open
    breaker_resets: int = 0         # half_open -> closed recoveries
    degraded_batches: int = 0       # batches served on the safe-mode twin
    watchdog_restarts: int = 0      # scheduler threads respawned
    deadline_evictions: int = 0     # queued requests evicted past deadline
    cancelled: int = 0              # requests cancelled before execution
    io_measure_failed: int = 0      # dynamic-I/O samples that raised
    latency_s: BoundedSeries = dataclasses.field(default_factory=_series)
    queue_wait_s: BoundedSeries = dataclasses.field(default_factory=_series)
    # the pipeline split of queue_wait_s: form-wait is submit ->
    # batch formation, dispatch-wait is formation -> execution start (time
    # a formed batch sat in its bucket's dispatch lane waiting for a
    # worker).  queue_wait_s stays their sum, so its series is comparable
    # across pre- and post-pipeline runs.
    form_wait_s: BoundedSeries = dataclasses.field(default_factory=_series)
    dispatch_wait_s: BoundedSeries = dataclasses.field(default_factory=_series)
    exec_s: BoundedSeries = dataclasses.field(default_factory=_series)
    swap_compile_s: BoundedSeries = dataclasses.field(default_factory=_series)
    queue_depth: BoundedSeries = dataclasses.field(default_factory=_series)
    # queue depth observed when a batch FORMS (after its rows are popped):
    # arrival-time depth alone cannot show pool-induced buildup — a slow
    # executor pool leaves rows behind at formation, and this series is
    # where that becomes visible
    form_depth: BoundedSeries = dataclasses.field(default_factory=_series)
    batch_sizes: BoundedSeries = dataclasses.field(default_factory=_series)
    bucket_hist: Dict[int, int] = dataclasses.field(default_factory=dict)
    max_queue_depth: int = 0
    t_first: Optional[float] = None
    t_last: Optional[float] = None
    # leaf lock: record_* are called from submit, scheduler, and watchdog
    # threads while snapshot() runs from metrics scrapes — one lock makes
    # every snapshot a consistent cut.  Nothing is called while held.
    _mu: threading.Lock = dataclasses.field(default_factory=threading.Lock,
                                            repr=False, compare=False)

    # ------------------------------------------------------------------ #
    def record_submit(self, now: float, depth: int, admitted: bool) -> None:
        """One submit.  ``depth`` is the queue depth the request OBSERVED on
        arrival (before any enqueue) — one convention for admitted and
        rejected submits, so the ``queue_depth`` series is comparable across
        both.  ``max_queue_depth`` separately tracks the depth *attained*:
        an admitted request deepens the queue to ``depth + 1``."""
        with self._mu:
            if self.t_first is None:
                self.t_first = now
            if admitted:
                self.admitted += 1
                self.max_queue_depth = max(self.max_queue_depth, depth + 1)
            else:
                self.rejected += 1
                self.max_queue_depth = max(self.max_queue_depth, depth)
            self.queue_depth.add(depth)

    def record_formation(self, depth: int) -> None:
        """Queue depth left behind at batch-formation time (rows the formed
        batch did NOT take).  Under a healthy pool this hugs zero; a
        saturated executor pool shows up here before it shows up in
        latency."""
        with self._mu:
            self.form_depth.add(depth)

    def record_batch(self, now: float, n: int, bucket: int, exec_s: float,
                     waits_s: List[float], misses: int,
                     dispatch_wait_s: float = 0.0) -> None:
        """One executed batch.  ``waits_s`` are per-request form-waits
        (submit -> batch formation); ``dispatch_wait_s`` is the batch's time
        on its dispatch lane (formation -> execution start), zero for the
        inline/step-driven path.  Total queue wait and latency include
        both, so pre-pipeline series remain comparable."""
        with self._mu:
            self.batches += 1
            self.served += n
            self.batch_sizes.add(n)
            self.bucket_hist[bucket] = self.bucket_hist.get(bucket, 0) + 1
            self.padded_rows += bucket - n
            self.batched_rows += bucket
            self.exec_s.add(exec_s)
            self.dispatch_wait_s.add(dispatch_wait_s)
            self.deadline_misses += misses
            for w in waits_s:
                self.form_wait_s.add(w)
                self.queue_wait_s.add(w + dispatch_wait_s)
                self.latency_s.add(w + dispatch_wait_s + exec_s)
            self.t_last = now

    def record_batch_failure(self, now: float, n: int) -> None:
        """One batch whose plan execution raised: its ``n`` requests were
        consumed (slots complete as None) but not served."""
        with self._mu:
            self.batch_failures += 1
            self.failed_requests += n
            self.t_last = now

    def record_result_evictions(self, n: int) -> None:
        """``n`` finished results dropped before the caller collected them
        (capacity/TTL eviction — see ``SparseServer`` result retention)."""
        with self._mu:
            self.results_evicted += n

    def record_swap(self, now: float, compile_s: float,
                    cache_hit: bool) -> None:
        """One plan hot-swap: the off-path compile (or plan-store hit) that
        produced the swapped-in plan set."""
        with self._mu:
            self.swaps += 1
            if cache_hit:
                self.swap_hits += 1
            self.swap_compile_s.add(compile_s)
            # deliberately NOT touching t_first/t_last: a pre-traffic swap
            # must not stretch the serving span throughput_rps is computed
            # over

    def record_retry(self, timed_out: bool = False,
                     nan_guard: bool = False) -> None:
        """One failed batch attempt that will be retried."""
        with self._mu:
            self.retries += 1
            if timed_out:
                self.batch_timeouts += 1
            if nan_guard:
                self.nan_guard_failures += 1

    def record_attempt_failure(self, timed_out: bool = False,
                               nan_guard: bool = False) -> None:
        """Classify one terminal (non-retried) attempt failure; the batch
        outcome itself is recorded by ``record_batch_failure``."""
        with self._mu:
            if timed_out:
                self.batch_timeouts += 1
            if nan_guard:
                self.nan_guard_failures += 1

    def record_breaker_trip(self) -> None:
        with self._mu:
            self.breaker_trips += 1

    def record_breaker_reset(self) -> None:
        with self._mu:
            self.breaker_resets += 1

    def record_degraded_batch(self) -> None:
        """One batch served on the safe-mode twin (bit-identical outputs,
        slower path)."""
        with self._mu:
            self.degraded_batches += 1

    def record_watchdog_restart(self) -> None:
        with self._mu:
            self.watchdog_restarts += 1

    def record_deadline_evictions(self, n: int) -> None:
        """``n`` queued requests evicted (completed as None) because their
        deadline passed before a batch picked them up."""
        with self._mu:
            self.deadline_evictions += n

    def record_cancel(self) -> None:
        with self._mu:
            self.cancelled += 1

    def record_measure_failed(self) -> None:
        """One dynamic-I/O measurement raised (the batch itself was served)."""
        with self._mu:
            self.io_measure_failed += 1

    # ------------------------------------------------------------------ #
    @staticmethod
    def _quantiles_ms(s: BoundedSeries) -> dict:
        return {
            "p50": 1e3 * s.percentile(50),
            "p99": 1e3 * s.percentile(99),
            "count": len(s),
        }

    def snapshot(self) -> dict:
        """A consistent cut of every counter and series.

        Holds the same lock ``record_*`` take, so concurrent traffic can
        never produce a torn read (e.g. ``served`` updated but the latency
        series not yet — the invariant ``served == latency_ms["count"]``
        holds in every snapshot)."""
        with self._mu:
            span = 0.0
            if self.t_first is not None and self.t_last is not None:
                span = max(0.0, self.t_last - self.t_first)
            return {
                "admitted": self.admitted,
                "rejected": self.rejected,
                "served": self.served,
                "batches": self.batches,
                "deadline_misses": self.deadline_misses,
                "results_evicted": self.results_evicted,
                "batch_failures": self.batch_failures,
                "failed_requests": self.failed_requests,
                "swaps": self.swaps,
                "swap_hits": self.swap_hits,
                "retries": self.retries,
                "batch_timeouts": self.batch_timeouts,
                "nan_guard_failures": self.nan_guard_failures,
                "breaker_trips": self.breaker_trips,
                "breaker_resets": self.breaker_resets,
                "degraded_batches": self.degraded_batches,
                "watchdog_restarts": self.watchdog_restarts,
                "deadline_evictions": self.deadline_evictions,
                "cancelled": self.cancelled,
                "io_measure_failed": self.io_measure_failed,
                "swap_compile_ms": self._quantiles_ms(self.swap_compile_s),
                "throughput_rps": self.served / span if span > 0 else 0.0,
                "latency_ms": self._quantiles_ms(self.latency_s),
                "queue_wait_ms": self._quantiles_ms(self.queue_wait_s),
                "form_wait_ms": self._quantiles_ms(self.form_wait_s),
                "dispatch_wait_ms": self._quantiles_ms(self.dispatch_wait_s),
                "form_depth": {
                    "p50": self.form_depth.percentile(50),
                    "p99": self.form_depth.percentile(99),
                    "count": len(self.form_depth),
                },
                "exec_ms": self._quantiles_ms(self.exec_s),
                "mean_batch_size": (self.batch_sizes.total / self.batches
                                    if self.batches else 0.0),
                "max_queue_depth": self.max_queue_depth,
                "padding_fraction": (self.padded_rows / self.batched_rows
                                     if self.batched_rows else 0.0),
                "bucket_hist": {str(k): v
                                for k, v in sorted(self.bucket_hist.items())},
            }

    def summary(self) -> str:
        s = self.snapshot()
        return (f"served {s['served']} ({s['rejected']} rejected, "
                f"{s['deadline_misses']} deadline misses) in {s['batches']} "
                f"batches (mean {s['mean_batch_size']:.1f} rows, "
                f"{100 * s['padding_fraction']:.0f}% padding); "
                f"latency p50 {s['latency_ms']['p50']:.1f} ms / "
                f"p99 {s['latency_ms']['p99']:.1f} ms, "
                f"{s['throughput_rps']:.1f} req/s")
