"""Request tracing: a thread-safe, bounded ring-buffer span recorder.

The serving runtime (and the engine's compile pipeline) emit *spans* — named
intervals with attributes — and instant *events* into a :class:`Tracer`.
Design constraints, in order:

  * **near-zero overhead when disabled** — every instrumentation site checks
    ``tracer.enabled`` (one attribute read) before building any attribute
    dict; a disabled tracer records nothing and allocates nothing.
    ``NULL_TRACER`` is the shared disabled instance every un-instrumented
    server uses, so the hot path never branches on ``None``;
  * **bounded memory** — spans live in a ``deque(maxlen=capacity)`` ring:
    a week-long server keeps the *latest* ``capacity`` spans and counts the
    rest in ``dropped`` instead of growing without bound;
  * **injected clock** — spans are timestamped on the same clock the server
    schedules on (``SparseServer(clock=...)``), so deterministic fake-clock
    tests produce deterministic traces;
  * **standard export** — :meth:`Tracer.export` writes either Chrome-trace
    JSON (loadable in ``chrome://tracing`` / `Perfetto <https://ui.perfetto.dev>`_)
    or JSONL (one span object per line, grep/jq-friendly).

Span taxonomy (names, attributes, units) is documented in
``docs/observability.md``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

__all__ = ["Span", "Tracer", "NULL_TRACER"]


@dataclasses.dataclass
class Span:
    """One recorded interval (``phase="X"``) or instant event (``"i"``).

    Times are seconds on the tracer's clock; ``tid``/``thread`` identify the
    recording thread (Chrome trace rows group by tid)."""

    name: str
    t0: float
    t1: float
    tid: int
    thread: str
    phase: str = "X"                    # "X" complete span | "i" instant
    attrs: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def dur(self) -> float:
        return max(0.0, self.t1 - self.t0)

    def to_chrome(self, pid: int) -> dict:
        """One Chrome-trace event: complete (``X``, microsecond ``ts`` +
        ``dur``) or instant (``i``, thread-scoped)."""
        ev = {
            "name": self.name,
            "cat": self.name.split(".", 1)[0],
            "ph": self.phase,
            "ts": self.t0 * 1e6,
            "pid": pid,
            "tid": self.tid,
            "args": self.attrs,
        }
        if self.phase == "X":
            ev["dur"] = self.dur * 1e6
        else:
            ev["s"] = "t"               # instant events are thread-scoped
        return ev

    def to_dict(self) -> dict:
        return {"name": self.name, "t0": self.t0, "t1": self.t1,
                "dur": self.dur, "phase": self.phase, "tid": self.tid,
                "thread": self.thread, "attrs": self.attrs}


class _NullSpan:
    """The no-op context manager a disabled tracer hands out (shared
    singleton: entering/exiting it does nothing and allocates nothing)."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __setitem__(self, key, value) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _SpanCtx:
    """Context manager recording one span on exit.  Attributes can be added
    mid-span with ``sp["key"] = value`` (e.g. an outcome only known at the
    end of the interval)."""

    __slots__ = ("_tracer", "_name", "_attrs", "_t0")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, object]):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs

    def __enter__(self) -> "_SpanCtx":
        self._t0 = self._tracer.clock()
        return self

    def __setitem__(self, key: str, value) -> None:
        self._attrs[key] = value

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self._attrs.setdefault("error", exc_type.__name__)
        self._tracer.span_at(self._name, self._t0, self._tracer.clock(),
                             **self._attrs)
        return False


class Tracer:
    """Thread-safe bounded span recorder.

    Args:
      capacity: ring-buffer bound — the newest ``capacity`` spans are kept,
        older ones are evicted and counted in ``dropped``.
      clock: monotonic time source (inject the server's fake clock in
        tests; defaults to ``time.monotonic``).
      enabled: a disabled tracer is inert — ``span``/``event`` return
        immediately.  Instrumentation sites should additionally guard
        attribute-dict construction behind ``tracer.enabled`` so a disabled
        tracer costs one attribute read per site.
    """

    def __init__(self, capacity: int = 16384,
                 clock: Callable[[], float] = time.monotonic,
                 enabled: bool = True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.clock = clock
        self.enabled = enabled
        self._mu = threading.Lock()
        self._buf: deque = deque(maxlen=capacity)
        self.recorded = 0               # spans ever recorded
        self.dropped = 0                # spans evicted by the ring bound

    # ------------------------------------------------------------------ #
    # recording
    # ------------------------------------------------------------------ #
    def span(self, name: str, **attrs) -> "_SpanCtx | _NullSpan":
        """Context manager timing one interval: ``with tracer.span("x"): ...``."""
        if not self.enabled:
            return _NULL_SPAN
        return _SpanCtx(self, name, attrs)

    def span_at(self, name: str, t0: float, t1: float, **attrs) -> None:
        """Record a span whose endpoints were observed elsewhere (e.g. a
        request's queue interval, closed retroactively at batch formation)."""
        if not self.enabled:
            return
        t = threading.current_thread()
        self._record(Span(name=name, t0=t0, t1=t1, tid=t.ident or 0,
                          thread=t.name, attrs=attrs))

    def event(self, name: str, **attrs) -> None:
        """Record an instant event (a state transition, not an interval)."""
        if not self.enabled:
            return
        now = self.clock()
        t = threading.current_thread()
        self._record(Span(name=name, t0=now, t1=now, tid=t.ident or 0,
                          thread=t.name, phase="i", attrs=attrs))

    def _record(self, span: Span) -> None:
        with self._mu:
            if len(self._buf) == self.capacity:
                self.dropped += 1       # deque(maxlen) evicts the oldest
            self._buf.append(span)
            self.recorded += 1

    # ------------------------------------------------------------------ #
    # inspection / export
    # ------------------------------------------------------------------ #
    def spans(self) -> List[Span]:
        """Snapshot of the buffered spans, oldest first."""
        with self._mu:
            return list(self._buf)

    def clear(self) -> None:
        with self._mu:
            self._buf.clear()

    def snapshot(self) -> dict:
        with self._mu:
            return {"buffered": len(self._buf), "recorded": self.recorded,
                    "dropped": self.dropped, "capacity": self.capacity,
                    "enabled": self.enabled}

    def to_chrome(self) -> dict:
        """Chrome-trace/Perfetto-loadable JSON object.  Events are sorted by
        ``ts`` (retroactive spans can be recorded out of order; the sorted
        stream is what viewers — and the format validator in the tests —
        expect)."""
        pid = os.getpid()
        events = [s.to_chrome(pid) for s in self.spans()]
        events.sort(key=lambda e: (e["ts"], e.get("dur", 0.0)))
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome(self, path: str) -> str:
        with open(path, "w") as fh:
            json.dump(self.to_chrome(), fh)
            fh.write("\n")
        return path

    def export_jsonl(self, path: str) -> str:
        with open(path, "w") as fh:
            for s in self.spans():
                fh.write(json.dumps(s.to_dict()) + "\n")
        return path

    def export(self, path: str) -> str:
        """Chrome-trace JSON by default; JSONL when ``path`` ends ``.jsonl``."""
        if path.endswith(".jsonl"):
            return self.export_jsonl(path)
        return self.export_chrome(path)


#: Shared disabled tracer: the default for every un-instrumented server, so
#: hot paths branch on ``tracer.enabled`` instead of ``tracer is None``.
NULL_TRACER = Tracer(capacity=1, enabled=False)
