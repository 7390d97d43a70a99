"""Shared test configuration: deterministic seeds + small-net fixtures."""

import numpy as np
import pytest

from repro.sparse import prune_dense_stack


class FakeClock:
    """Manually-advanced virtual clock for the serving scheduler tests
    (inject as ``SparseServer(clock=...)``; shared by ``test_serving`` and
    ``test_server_async``)."""

    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "stress: real-thread concurrency stress tests (CI runs these in "
        "their own lane with -p no:cacheprovider -x)")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (the port's kernels on the card); "
        "skips without one")


@pytest.fixture(autouse=True)
def _deterministic_seeds():
    """Pin the legacy numpy global RNG for any test that touches it.

    Tests should prefer explicit ``np.random.default_rng(seed)`` generators;
    this fixture just makes anything that slips through reproducible."""
    np.random.seed(0)
    yield


@pytest.fixture
def make_stack():
    """Factory for small pruned BSR layer stacks (the shared test net).

    ``make_stack(sizes=(128, 256, 128), density=0.4, block=32, seed=0)``
    returns a list of ``BSRLayer`` whose tile shapes chain, with nonzero
    biases so epilogue bugs cannot hide.
    """

    def make(sizes=(128, 256, 128), density=0.4, block=32, seed=0):
        rng = np.random.default_rng(seed)
        ws = [
            rng.standard_normal((sizes[i], sizes[i + 1])).astype(np.float32) * 0.1
            for i in range(len(sizes) - 1)
        ]
        bs = [
            rng.standard_normal(sizes[i + 1]).astype(np.float32) * 0.1
            for i in range(len(sizes) - 1)
        ]
        return prune_dense_stack(ws, bs, density=density,
                                 block_m=block, block_n=block)

    return make
