"""The traffic generator: reproducible per seed, with the offered rate the
mixes state."""

import numpy as np
import pytest

from sparsebench import traffic


@pytest.mark.parametrize("rate,seconds", [(5000.0, 20.0), (8000.0, 20.0),
                                          (300.0, 0.5)])
def test_arrivals_reproducible_with_the_offered_rate(rate, seconds):
    n = int(round(rate * seconds))
    a = traffic.arrivals(2**31 + 7, rate, seconds)
    b = traffic.arrivals(2**31 + 7, rate, seconds)
    c = traffic.arrivals(2**31 + 8, rate, seconds)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    # every seed sends the same number of requests, inside the window
    assert len(a) == len(c) == n
    assert np.all(np.diff(a) >= 0) and a[0] >= 0 and a[-1] < seconds
    # the rate holds over each half of the window, not only overall
    half = np.sum(a < seconds / 2)
    assert abs(half - n / 2) < 4 * np.sqrt(n) + 1
    # exponential gaps: as wide as they are long
    gaps = np.diff(a)
    if n > 1000:
        assert gaps.std() / gaps.mean() == pytest.approx(1.0, rel=0.05)


def test_picks_reproducible_and_cover_the_pool():
    a = traffic.picks(5, 100000, 8192)
    np.testing.assert_array_equal(a, traffic.picks(5, 100000, 8192))
    assert a.min() == 0 and a.max() == 8191
    assert not np.array_equal(a, traffic.picks(6, 100000, 8192))

