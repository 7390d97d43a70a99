"""95th percentile of how late the harness's generator thread submitted each
request after its due time, over the window up to the profiled stretch.  The
generator shares the interpreter with the server's threads, so this reads
how long the program's host path keeps an in-process client from running:
a share of every request's latency, which is timed from the due time."""

import numpy as np


def read(obs):
    late = obs.get("submit_lateness_s")
    if not late:
        return None
    late = np.asarray(late, dtype=np.float64)
    if not np.isfinite(late).all():
        return None
    return 1e3 * float(np.percentile(late, 95))
