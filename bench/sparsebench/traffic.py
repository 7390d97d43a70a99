"""The one traffic generator: every mix is a data file of its parameters.

Host-side draws (arrival times, which pool row or batch each request or call
takes) come from ``numpy.random.default_rng``
seeded with ``[seed, stream]``; the inputs themselves are drawn on the device
with a ``torch.Generator`` in a few large calls.  The same seed gives the
same traffic, and every seed the same amount of it: an open loop sends
exactly ``round(rate * seconds)`` requests, in other arrival times.
"""

from __future__ import annotations

import numpy as np
import torch

# independent host streams of one seed
ARRIVALS, PICKS, SAMPLE = 1, 2, 4


def host_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream])


def arrivals(seed: int, rate: float, seconds: float) -> np.ndarray:
    """Due times (s from the window's start) of a Poisson open loop at
    ``rate`` requests per second: ``round(rate * seconds)`` of them, whose
    exponential gaps are drawn i.i.d. and then scaled so that the whole
    schedule spans the window."""
    n = int(round(rate * seconds))
    gaps = host_rng(seed, ARRIVALS).exponential(1.0, n + 1)
    t = np.cumsum(gaps)
    return (t[:n] / t[n] * seconds).astype(np.float64)


def picks(seed: int, n: int, pool: int) -> np.ndarray:
    """Which of ``pool`` inputs each of ``n`` requests or calls takes."""
    return host_rng(seed, PICKS).integers(0, pool, n)


def normal_rows(gen: torch.Generator, n: int, width: int,
                device) -> torch.Tensor:
    """``n`` distinct rows of N(0, 1) float32, on ``device``."""
    return torch.randn((n, width), generator=gen, dtype=torch.float32,
                       device=device)

