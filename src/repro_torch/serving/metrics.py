"""Serving metrics: per-request latency, queue depth, throughput, SLO hits.

Port of ``repro.serving.metrics`` for the step-driven server.  Everything is
recorded against the server's injected clock, so tests drive time
deterministically.  The observation series are
:class:`repro_torch.obs.BoundedSeries` (exact percentiles up to 4096
samples, then log-bucket estimates; bounded memory), and all ``record_*``
methods and ``snapshot()`` share one leaf lock, so a snapshot is a
consistent cut.  ``snapshot`` returns a plain JSON-serializable dict.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

from ..obs.series import BoundedSeries


def percentile(xs: List[float], q: float) -> float:
    """Nearest-rank percentile; 0.0 for an empty series, q clamped to
    [0, 100]."""
    if not xs:
        return 0.0
    ys = sorted(xs)
    q = min(100.0, max(0.0, q))
    k = min(len(ys) - 1, max(0, int(round(q / 100.0 * (len(ys) - 1)))))
    return ys[k]


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
    io_measure_failed: int = 0      # dynamic-I/O samples that raised
    latency_s: BoundedSeries = dataclasses.field(default_factory=BoundedSeries)
    queue_wait_s: BoundedSeries = dataclasses.field(
        default_factory=BoundedSeries)
    exec_s: BoundedSeries = dataclasses.field(default_factory=BoundedSeries)
    queue_depth: BoundedSeries = dataclasses.field(
        default_factory=BoundedSeries)
    batch_sizes: BoundedSeries = dataclasses.field(
        default_factory=BoundedSeries)
    bucket_hist: Dict[int, int] = dataclasses.field(default_factory=dict)
    max_queue_depth: int = 0
    t_first: Optional[float] = None
    t_last: Optional[float] = None
    _mu: threading.Lock = dataclasses.field(default_factory=threading.Lock,
                                            repr=False, compare=False)

    def record_submit(self, now: float, depth: int, admitted: bool) -> None:
        """One submit; ``depth`` is the queue depth the request observed on
        arrival (an admitted one deepens the queue to ``depth + 1``)."""
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

    def record_batch(self, now: float, n: int, bucket: int, exec_s: float,
                     waits_s: List[float], misses: int) -> None:
        """One executed batch of ``n`` rows on ``bucket``; ``waits_s`` are
        the per-request queue waits (submit -> batch formation)."""
        with self._mu:
            self.batches += 1
            self.served += n
            self.batch_sizes.add(n)
            self.bucket_hist[bucket] = self.bucket_hist.get(bucket, 0) + 1
            self.padded_rows += bucket - n
            self.batched_rows += bucket
            self.exec_s.add(exec_s)
            self.deadline_misses += misses
            for w in waits_s:
                self.queue_wait_s.add(w)
                self.latency_s.add(w + exec_s)
            self.t_last = now

    def record_result_evictions(self, n: int) -> None:
        """``n`` finished results dropped before the caller collected them."""
        with self._mu:
            self.results_evicted += n

    def record_measure_failed(self) -> None:
        """One dynamic-I/O measurement raised (the batch itself was served)."""
        with self._mu:
            self.io_measure_failed += 1

    @staticmethod
    def _quantiles_ms(s: BoundedSeries) -> dict:
        return {
            "p50": 1e3 * s.percentile(50),
            "p99": 1e3 * s.percentile(99),
            "count": len(s),
        }

    def snapshot(self) -> dict:
        """A consistent cut of every counter and series."""
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
                "io_measure_failed": self.io_measure_failed,
                "throughput_rps": self.served / span if span > 0 else 0.0,
                "latency_ms": self._quantiles_ms(self.latency_s),
                "queue_wait_ms": self._quantiles_ms(self.queue_wait_s),
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
