"""Median time a request waits in the program's scheduler before its batch
runs, over every request of the window up to the profiled stretch: the
exact median of the queue waits the server records (``ServingMetrics``,
given a fresh series at the window's start that keeps every sample)."""

import numpy as np


def read(obs):
    waits = obs.get("queue_wait_s")
    if not waits:
        return None
    return 1e3 * float(np.median(waits))
