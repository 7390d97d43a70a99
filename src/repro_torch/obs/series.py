"""Bounded metric series: exact while small, streaming histogram forever.

`ServingMetrics` used to append every latency/queue-depth observation to a
plain Python list — unbounded memory on a week-long server.  A
:class:`BoundedSeries` keeps the same ``percentile()`` answers with capped
memory:

  * below ``exact_cap`` samples the raw values are retained and every
    quantile is **exact** (nearest-rank, identical to the old lists);
  * past the cap the raw values are released and only fixed log-spaced
    bucket counts remain.  With bucket ``growth=1.25`` a quantile is then
    answered from the geometric midpoint of its bucket — relative error at
    most ``sqrt(growth) - 1`` (≈ 11.8%), independent of stream length.

Every observation is binned on record (O(1) via a log-index), so the bucket
counts — what the Prometheus endpoint exports as a cumulative histogram —
are populated in both modes.  Memory is O(exact_cap + n_buckets) always.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Iterator, List, Optional, Tuple

__all__ = ["BoundedSeries"]


class BoundedSeries:
    """Bounded stream summary answering count/sum/min/max/percentile.

    Not internally locked: `ServingMetrics` guards all its series with its
    own (leaf) lock, and a second lock per observation would be pure
    overhead.  Standalone concurrent use needs external synchronisation.

    Args:
      exact_cap: number of raw samples kept before collapsing to buckets.
      lo / hi: bucket range.  Values below ``lo`` land in the first bucket,
        above ``hi`` in a ``+Inf`` overflow bucket.  Defaults cover 1 µs to
        10 000 s — every duration this repo records — and also serve
        dimensionless series (queue depth) acceptably.
      growth: geometric bucket width; bounds post-cap quantile error at
        ``sqrt(growth) - 1``.
    """

    __slots__ = ("exact_cap", "lo", "growth", "_log_lo", "_log_growth",
                 "_nb", "_counts", "_exact", "count", "total", "vmin", "vmax")

    def __init__(self, exact_cap: int = 4096, lo: float = 1e-6,
                 hi: float = 1e4, growth: float = 1.25):
        if exact_cap < 0:
            raise ValueError(f"exact_cap must be >= 0, got {exact_cap}")
        if not (lo > 0 and hi > lo and growth > 1):
            raise ValueError(f"bad bucket spec lo={lo} hi={hi} growth={growth}")
        self.exact_cap = exact_cap
        self.lo = lo
        self.growth = growth
        self._log_lo = math.log(lo)
        self._log_growth = math.log(growth)
        # buckets: (-inf, lo], (lo, lo*g], ..., (last, +inf) — the final
        # slot is the +Inf overflow bucket
        self._nb = int(math.ceil((math.log(hi) - self._log_lo)
                                 / self._log_growth)) + 2
        self._counts = [0] * self._nb
        self._exact: Optional[List[float]] = []
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    # ------------------------------------------------------------------ #
    def _bucket_index(self, v: float) -> int:
        if v <= self.lo:
            return 0
        i = int(math.floor((math.log(v) - self._log_lo) / self._log_growth)) + 1
        return min(i, self._nb - 1)

    def _bucket_upper(self, i: int) -> float:
        """Upper edge of bucket ``i`` (``inf`` for the overflow bucket)."""
        if i >= self._nb - 1:
            return math.inf
        return math.exp(self._log_lo + i * self._log_growth)

    def add(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        # bin on record so the histogram is populated in both modes
        self._counts[self._bucket_index(v)] += 1
        if self._exact is not None:
            self._exact.append(v)
            if len(self._exact) > self.exact_cap:
                self._exact = None      # collapse: buckets already hold all

    def extend(self, vs) -> None:
        for v in vs:
            self.add(v)

    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        return self.count

    def __bool__(self) -> bool:
        return self.count > 0

    @property
    def exact(self) -> bool:
        """True while quantiles are exact (raw samples still retained)."""
        return self._exact is not None

    def values(self) -> Optional[List[float]]:
        """Raw observations in arrival order, or None once collapsed."""
        return None if self._exact is None else list(self._exact)

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile; exact below ``exact_cap`` (identical to
        ``repro.serving.metrics.percentile`` on the raw list), within the
        documented bucket error after.  Returns 0.0 on an empty series."""
        if not self.count:
            return 0.0
        q = min(100.0, max(0.0, float(q)))
        # same nearest-index rank as the legacy list percentile, so snapshots
        # are bit-identical to the unbounded implementation while exact
        rank = min(self.count,
                   max(0, int(round(q / 100.0 * (self.count - 1)))) + 1)
        if self._exact is not None:
            return sorted(self._exact)[rank - 1]
        cum = 0
        for i, c in enumerate(self._counts):
            cum += c
            if cum >= rank:
                hi = self._bucket_upper(i)
                lo = self._bucket_upper(i - 1) if i > 0 else self.vmin
                if math.isinf(hi):      # overflow bucket: best guess is max
                    rep = self.vmax
                else:                   # geometric midpoint of the bucket
                    rep = math.sqrt(max(lo, self.lo * 1e-12) * hi)
                return min(self.vmax, max(self.vmin, rep))
        return self.vmax

    def buckets(self) -> Iterator[Tuple[float, int]]:
        """Cumulative ``(upper_edge, count)`` pairs, Prometheus-style
        (last edge is ``inf``; counts are cumulative)."""
        cum = 0
        for i, c in enumerate(self._counts):
            cum += c
            yield self._bucket_upper(i), cum

    def to_dict(self) -> dict:
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.vmin if self.count else 0.0,
            "max": self.vmax if self.count else 0.0,
            "mean": self.mean(),
            "exact": self.exact,
        }

    def __repr__(self) -> str:
        return (f"BoundedSeries(count={self.count}, mean={self.mean():.6g}, "
                f"exact={self.exact})")
