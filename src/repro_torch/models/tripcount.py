"""Trip counts for the loops the port unrolls where the reference scans.

The reference runs ``_flash``'s two chunk loops and the train step's
microbatches as ``lax.scan``s, and its cost analysis
(``repro.launch.hlo_analysis.analyze_module``) visits a scan body once and
multiplies it by the trip count.  The port's loops are Python loops, and a
cost trace that ran every iteration would take minutes at 32k tokens (4,096
chunk pairs per layer).  The SSM's chunk recurrence (``ssm.ssd_chunked``)
stays unrolled: at most 256 iterations of five small ops per layer.

Outside a cost trace, ``trips(n)`` is ``range(n)`` and ``full(items, n)``
returns ``items``: the same ops run in the same order.  Inside one
(``launch.cost_analysis.analyze_step`` installs its tracer with
``counting``), a loop of more than ``exact + 1`` iterations runs
``exact + 1`` of them: the first ``exact`` as themselves, the next standing
for the other ``n - exact`` (every iteration of these loops has the same
shapes; ``exact`` covers the iterations before the steady state, in which
each iteration leaves the same bytes alive).  The tracer multiplies the
FLOPs and collectives of that iteration, forward, recomputed and backward,
by ``n - exact``, and its live bytes as the remaining iterations would add
them.  ``full`` repeats that iteration's item so that what the loop
returns keeps its full shape.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterable, List, Sequence

_local = threading.local()


def tracer():
    """The cost tracer of this thread's trace, or None."""
    return getattr(_local, "tracer", None)


@contextlib.contextmanager
def counting(t):
    """Install ``t`` (an object with ``loop(n, exact)``) for this thread."""
    prev = tracer()
    _local.tracer = t
    try:
        yield t
    finally:
        _local.tracer = prev


def trips(n: int, exact: int = 1) -> Iterable[int]:
    """The iterations of a loop of ``n`` alike iterations, whose steady
    state starts after ``exact`` of them."""
    t = tracer()
    if t is None or n <= exact + 1:
        return range(n)
    return t.loop(n, exact)


def full(items: Sequence, n: int, exact: int = 1) -> List:
    """One item per iteration of a loop over ``trips(n, exact)``: ``items``
    as given, or, in a cost trace, the last one repeated for the
    iterations it stands for."""
    if tracer() is None or n <= exact + 1:
        return items
    return list(items[:exact]) + [items[exact]] * (n - exact)


__all__ = ["counting", "full", "tracer", "trips"]
