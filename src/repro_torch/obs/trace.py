"""Request tracing: a thread-safe, bounded ring-buffer span recorder, a
profiler sink, and a process-wide table of totals.

The serving runtime (and the engine's compile pipeline) emit *spans* — named
intervals with attributes — and instant *events* into a :class:`Tracer`.
Design constraints, in order:

  * **near-zero overhead when inactive** — tracing is *active* while a
    :class:`Tracer` is enabled or a ``torch.profiler`` profile collects.
    While it is not, every instrumentation site costs one cheap check (an
    attribute read or two) and builds no attribute dict, no
    span and no ``record_function``.  ``NULL_TRACER`` is the
    shared disabled instance every un-instrumented server uses, so the hot
    path never branches on ``None``;
  * **one clock with the device** — while a profiler collects, each span
    also opens a ``record_function`` range of its name, so it is an event
    of the profiler's own trace, on the profiler's clock, beside the device
    activity.  ``torch.profiler`` records such ranges from the thread that
    started it; a server's scheduler or worker threads show only under
    ``experimental_config=torch._C._profiler._ExperimentalConfig(
    profile_all_threads=True)``.  A range that encloses a launch is also
    shown on the device, as a user annotation of the span's name;
  * **totals** — every span recorded while tracing is active adds its
    count and seconds to a process-wide table, and :func:`count` adds to
    its counters (``syncs``); :func:`totals` reads it,
    :func:`reset_totals` empties it.  With only a profiler active, the
    table covers exactly the profiled stretch;
  * **bounded memory** — the ring is a ``deque(maxlen=capacity)`` of
    records: a span, an event, or the record of one root span with the
    spans nested in it on its thread and the requests it served, appended
    under one lock acquisition.  The records are expanded into spans and
    events at export.  A week-long server keeps the *latest* ``capacity``
    records and counts the spans of the rest in ``dropped``;
  * **injected clock** — spans are timestamped on the tracer's clock; give
    the tracer the server's clock (``Tracer(clock=...)``) and deterministic
    fake-clock tests produce deterministic traces;
  * **standard export** — :meth:`Tracer.export` writes either Chrome-trace
    JSON (loadable in ``chrome://tracing`` / `Perfetto <https://ui.perfetto.dev>`_)
    or JSONL (one span object per line, grep/jq-friendly).

Span taxonomy (names, attributes, units) is documented in
``docs/observability_torch.md``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from torch.autograd import profiler as _profiler

__all__ = ["Span", "Tracer", "NULL_TRACER", "NULL_SPAN", "span", "count",
           "profiling", "totals", "reset_totals"]


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


# --------------------------------------------------------------------------- #
# process-wide state: the totals table and each thread's open spans
# --------------------------------------------------------------------------- #
class _Totals:
    """Per span name its count and seconds, per counter its sum."""

    def __init__(self):
        self._mu = threading.Lock()
        self._spans: Dict[str, List[float]] = {}
        self._counters: Dict[str, float] = {}

    def add_span(self, name: str, seconds: float) -> None:
        with self._mu:
            c = self._spans.get(name)
            if c is None:
                self._spans[name] = [1, seconds]
            else:
                c[0] += 1
                c[1] += seconds

    def add_counter(self, name: str, value: float) -> None:
        with self._mu:
            self._counters[name] = self._counters.get(name, 0) + value

    def snapshot(self) -> dict:
        with self._mu:
            return {"spans": {k: {"count": int(c), "seconds": s}
                              for k, (c, s) in self._spans.items()},
                    "counters": dict(self._counters)}

    def reset(self) -> None:
        with self._mu:
            self._spans.clear()
            self._counters.clear()


_TOTALS = _Totals()


class _Local(threading.local):
    def __init__(self):
        self.stack: List["_SpanCtx"] = []   # recording spans, innermost last


_local = _Local()


def profiling() -> bool:
    """True while a ``torch.profiler`` profile collects (a process-wide
    flag, the same on every thread)."""
    return _profiler._is_profiler_enabled


def totals() -> dict:
    """The table of totals: ``{"spans": {name: {"count", "seconds"}},
    "counters": {name: sum}}`` over every span and count recorded while
    tracing was active, since the last :func:`reset_totals`."""
    return _TOTALS.snapshot()


def reset_totals() -> None:
    _TOTALS.reset()


# --------------------------------------------------------------------------- #
# spans
# --------------------------------------------------------------------------- #
class _NullSpan:
    """The no-op context manager handed out while tracing is inactive
    (shared singleton: entering/exiting it does nothing and allocates
    nothing)."""

    __slots__ = ()
    recording = False

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __setitem__(self, key, value) -> None:
        pass


NULL_SPAN = _NullSpan()


class _Record:
    """One root span's record in the ring, kept as plain tuples: the spans
    nested in it on its thread and itself (``(name, t0, t1, attrs)``), and
    the requests it served, as columns.  Expanded into spans at
    export, each request into its ``request.submit`` / ``request.queue`` /
    ``request.done``."""

    __slots__ = ("tid", "thread", "spans", "requests", "size")

    def __init__(self, tid: int, thread: str, spans: List[tuple],
                 requests: Optional[tuple]):
        self.tid = tid
        self.thread = thread
        self.spans = spans
        self.requests = requests
        n = len(requests[-1][0]) if requests is not None else 0
        self.size = len(spans) + 3 * n

    def expand(self) -> List[Span]:
        tid, thread = self.tid, self.thread
        out = [Span(name, t0, t1, tid, thread, attrs=attrs)
               for name, t0, t1, attrs in self.spans]
        if self.requests is None:
            return out
        model, bucket, t_start, t_done, ok, (rids, t_subs, depths,
                                             misses) = self.requests
        for rid, t_sub, depth, miss in zip(rids, t_subs, depths, misses):
            out.append(Span("request.submit", t_sub, t_sub, tid, thread, "i",
                            {"model": model, "rid": rid, "depth": depth,
                             "admitted": True}))
            out.append(Span("request.queue", t_sub, t_start, tid, thread,
                            "X", {"model": model, "rid": rid,
                                  "bucket": bucket}))
            out.append(Span("request.done", t_done, t_done, tid, thread, "i",
                            {"model": model, "rid": rid, "ok": ok,
                             "miss": miss}))
        return out


class _SpanCtx:
    """Context manager recording one span on exit.  Attributes can be added
    mid-span with ``sp["key"] = value`` (e.g. an outcome only known at the
    end of the interval); :func:`count` adds to every span open on its
    thread.  A span nested in another of the same tracer on the same
    thread joins the outermost one's record; a span that carries requests
    is a record of its own."""

    __slots__ = ("_tracer", "_name", "_attrs", "_t0", "_rf", "_kids",
                 "_reqs")
    recording = True

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, object]):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs
        self._rf = None
        self._kids: Optional[List[tuple]] = None
        self._reqs: Optional[tuple] = None

    def __enter__(self) -> "_SpanCtx":
        if _profiler._is_profiler_enabled:
            self._rf = _profiler.record_function(self._name)
            self._rf.__enter__()
        _local.stack.append(self)
        self._t0 = self._tracer.clock()
        return self

    def __setitem__(self, key: str, value) -> None:
        self._attrs[key] = value

    def requests(self, model: str, bucket: int, t_start: float,
                 t_done: float, ok: bool, columns: tuple) -> None:
        """Attach the requests a batch span served, as the columns
        ``(rids, t_submits, depths, misses)``: their queue spans end at
        ``t_start``, their done events fall at ``t_done``."""
        self._reqs = (model, bucket, t_start, t_done, ok, columns)

    def __exit__(self, exc_type, exc, tb) -> bool:
        tr = self._tracer
        t1 = tr.clock()
        stack = _local.stack
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        if exc_type is not None:
            self._attrs.setdefault("error", exc_type.__name__)
        _TOTALS.add_span(self._name, t1 - self._t0)
        if not tr.enabled:
            return False
        me = (self._name, self._t0, t1, self._attrs)
        root = stack[0] if stack else None
        if root is not None and root._tracer is tr and self._reqs is None:
            if root._kids is None:
                root._kids = [me]
            else:
                root._kids.append(me)
            return False
        t = threading.current_thread()
        if self._kids is None and self._reqs is None:
            tr._record(Span(self._name, self._t0, t1, t.ident or 0, t.name,
                            attrs=self._attrs))
            return False
        spans = self._kids or []
        spans.append(me)
        tr._record(_Record(t.ident or 0, t.name, spans, self._reqs))
        return False


def span(name: str, **attrs) -> "_SpanCtx | _NullSpan":
    """A span at a site with no tracer of its own (the bucket set, the
    plan).  It records while tracing is active here: nested in a recording
    span on this thread it joins that span's tracer, else while a profiler
    collects it feeds the profiler and the totals alone.  Otherwise the
    shared no-op."""
    stack = _local.stack
    if stack:
        return _SpanCtx(stack[-1]._tracer, name, attrs)
    if _profiler._is_profiler_enabled:
        return _SpanCtx(NULL_TRACER, name, attrs)
    return NULL_SPAN


def count(name: str, value: float = 1) -> None:
    """Add ``value`` to counter ``name``: in the totals and on every span
    open on this thread.  Nothing while tracing is inactive here."""
    stack = _local.stack
    if not stack and not _profiler._is_profiler_enabled:
        return
    _TOTALS.add_counter(name, value)
    for sp in stack:
        a = sp._attrs
        a[name] = a.get(name, 0) + value


# --------------------------------------------------------------------------- #
# the tracer
# --------------------------------------------------------------------------- #
class Tracer:
    """Thread-safe bounded span recorder.

    Tracing is active while the tracer is ``enabled`` or a
    ``torch.profiler`` profile collects.  An enabled tracer records into
    its ring (and the totals, and the profiler when one collects); a
    disabled one records spans only while a profiler collects, into the
    profiler and the totals — its ring stays empty.

    Args:
      capacity: ring-buffer bound in records — the newest ``capacity``
        records are kept, older ones are evicted and their spans counted in
        ``dropped``.
      clock: monotonic time source (inject the server's fake clock in
        tests; defaults to ``time.monotonic``).
      enabled: a disabled tracer's ring stays empty: ``span`` returns the
        no-op while no profiler collects, ``span_at``/``event`` return at
        once.  Instrumentation sites should guard attribute-dict
        construction behind ``tracer.enabled`` (or, for spans, behind
        ``tracer.enabled or profiling()``), so that inactive tracing costs
        one check per site.
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
        self._buffered = 0              # spans the buffered records hold
        self.recorded = 0               # spans ever recorded
        self.dropped = 0                # spans evicted by the ring bound

    # ------------------------------------------------------------------ #
    # recording
    # ------------------------------------------------------------------ #
    def span(self, name: str, **attrs) -> "_SpanCtx | _NullSpan":
        """Context manager timing one interval: ``with tracer.span("x"): ...``."""
        if self.enabled or _profiler._is_profiler_enabled:
            return _SpanCtx(self, name, attrs)
        return NULL_SPAN

    def span_at(self, name: str, t0: float, t1: float, **attrs) -> None:
        """Record a span whose endpoints were observed elsewhere (e.g. a
        swap's whole interval, closed when it installs)."""
        if not self.enabled:
            return
        _TOTALS.add_span(name, t1 - t0)
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

    def _record(self, rec) -> None:
        size = rec.size if type(rec) is _Record else 1
        with self._mu:
            if len(self._buf) == self.capacity:
                old = self._buf[0]      # deque(maxlen) evicts the oldest
                n = old.size if type(old) is _Record else 1
                self.dropped += n
                self._buffered -= n
            self._buf.append(rec)
            self._buffered += size
            self.recorded += size

    # ------------------------------------------------------------------ #
    # inspection / export
    # ------------------------------------------------------------------ #
    def spans(self) -> List[Span]:
        """Snapshot of the buffered spans and events, records expanded,
        oldest record first."""
        with self._mu:
            recs = list(self._buf)
        out: List[Span] = []
        for r in recs:
            if type(r) is _Record:
                out.extend(r.expand())
            else:
                out.append(r)
        return out

    def clear(self) -> None:
        with self._mu:
            self._buf.clear()
            self._buffered = 0

    def snapshot(self) -> dict:
        with self._mu:
            return {"buffered": self._buffered, "recorded": self.recorded,
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
