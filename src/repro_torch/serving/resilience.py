"""Fault tolerance for the serving runtime: the pieces that keep a server
serving when something inside it breaks.

The engine's layering already contains a correct fallback at every level —
the megakernel and the jnp segment lowering are bit-exact twins (PR 2), and
so are the gated and ungated forwards (PR 6) — exactly the way EIE and
SparseNN treat their compressed/sparsity-exploiting datapaths as
optimizations over a dense reference semantics.  What was missing is the
runtime machinery that *uses* that layering when the fast path misbehaves.
This module provides it:

  * :class:`RetryPolicy` — per-batch execution timeouts plus bounded retry
    with exponential backoff (``SparseServer(retry=...)``);
  * :class:`CircuitBreaker` — the classic three-state machine
    (``closed -> open -> half_open``) that trips after K consecutive batch
    failures/timeouts; the server reacts by swapping to the plan set's
    precompiled **safe-mode twin** (jnp backend, gating off — the same
    bit-exact forward, only slower) and probes the fast plan again after a
    cool-down;
  * :func:`check_finite` — the NaN/Inf output guard: a batch whose result
    is not finite *fails* (contained, per the PR-5 semantics) instead of
    silently returning garbage to every request in it;
  * :func:`call_with_timeout` — bounded execution of a possibly-hung plan
    call (a hung thread cannot be killed in Python; it is abandoned as a
    daemon and the batch is failed/retried);
  * :class:`Heartbeat` / :class:`Watchdog` — detects a dead or wedged
    scheduler thread and restarts it; the request queue and result slots
    are *server* state, so a restart loses nothing that was still queued;
  * :class:`FaultInjector` — deterministic fault injection at named sites
    (raise / delay / hang / corrupt), the harness ``tests/test_chaos.py``
    drives every one of the mechanisms above with.

Everything here is policy + plumbing: no piece touches the schedule
substrate, and the degraded path serves bit-identical outputs by
construction (``ExecutionPlan.safe_twin`` shares the schedule arrays by
reference).  See docs/serving.md "Failure semantics".
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np


class BatchTimeoutError(RuntimeError):
    """A batch execution attempt exceeded ``RetryPolicy.timeout_s``."""


class OutputGuardError(RuntimeError):
    """A batch produced NaN/Inf output (caught by the output guard)."""


# --------------------------------------------------------------------------- #
# retry / timeout / backoff
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff for batch execution.

    Args:
      max_retries: additional attempts after the first failure (0 = the
        pre-resilience behavior: one attempt, failure is final).
      timeout_s: wall-clock bound on ONE execution attempt; ``None`` runs
        unbounded on the calling thread (no helper-thread overhead).
      backoff_s / backoff_mult / max_backoff_s: the delay before retry
        attempt ``k`` (1-based) is ``min(max_backoff_s,
        backoff_s * backoff_mult ** (k - 1))``.
    """

    max_retries: int = 2
    timeout_s: Optional[float] = None
    backoff_s: float = 0.05
    backoff_mult: float = 2.0
    max_backoff_s: float = 2.0

    def backoff(self, attempt: int) -> float:
        """Sleep before retry ``attempt`` (1-based)."""
        return min(self.max_backoff_s,
                   self.backoff_s * self.backoff_mult ** (attempt - 1))


def call_with_timeout(fn: Callable[[], object],
                      timeout_s: Optional[float],
                      name: str = "call") -> object:
    """Run ``fn()`` with a wall-clock bound.

    ``timeout_s=None`` calls directly on this thread (zero overhead — the
    default serving path).  Otherwise the call runs on a daemon helper
    thread; on timeout :class:`BatchTimeoutError` is raised and the helper
    is *abandoned* (Python cannot cancel a running thread) — callers must
    treat the attempt's side effects as lost, which is safe for plan
    execution because plans are pure functions of their input.
    """
    if timeout_s is None:
        return fn()
    box: dict = {}
    done = threading.Event()

    def run():
        try:
            box["y"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised on the caller
            box["e"] = e
        finally:
            done.set()

    t = threading.Thread(target=run, daemon=True, name=f"timed-{name}")
    t.start()
    if not done.wait(timeout_s):
        raise BatchTimeoutError(
            f"{name} exceeded its {timeout_s}s execution timeout")
    if "e" in box:
        raise box["e"]
    return box["y"]


def check_finite(y) -> None:
    """Raise :class:`OutputGuardError` when ``y`` contains NaN/Inf.

    A non-finite batch result must fail the batch (requests complete as
    None, the failure is counted and feeds the circuit breaker) rather
    than be silently returned as garbage to every request in it.
    """
    arr = np.asarray(y)
    if arr.dtype.kind not in "fc":
        try:  # extended dtypes (bf16 …) need a float view to test
            arr = arr.astype(np.float32)
        except (TypeError, ValueError):
            return  # non-numeric output: nothing to guard
    if not np.isfinite(arr).all():
        bad = int(arr.size - np.isfinite(arr).sum())
        raise OutputGuardError(
            f"output guard: batch result has {bad} non-finite values")


# --------------------------------------------------------------------------- #
# circuit breaker
# --------------------------------------------------------------------------- #

class CircuitBreaker:
    """Three-state breaker over consecutive batch failures.

    * ``closed`` — healthy: serve the fast plan.  ``threshold`` consecutive
      failures trip it to ``open``.
    * ``open`` — degraded: the server swaps to the safe-mode twin.  After
      ``cooldown_s`` (measured on the server's injected clock) the next
      batch *probes* the fast plan (``half_open``).
    * ``half_open`` — one probe in flight: success closes the breaker
      (back on the fast plan), failure reopens it (back to the safe twin,
      cool-down restarts).

    The breaker only decides; the plan swap itself is the server's job
    (``SparseServer`` drives it through the same install path ``swap()``
    uses).  Methods return a transition event string (or None) so the
    server can count trips/resets in its metrics.

    ``on_transition`` (settable after construction) is called as
    ``on_transition(event, new_state)`` on EVERY state change — including
    the ``open -> half_open`` probe admission, which no return value
    surfaces — outside the breaker's lock.  The server wires its tracer
    through this so breaker transitions appear in exported traces.
    """

    def __init__(self, threshold: int = 3, cooldown_s: float = 5.0,
                 on_transition: Optional[Callable[[str, str], None]] = None):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.on_transition = on_transition
        self._mu = threading.Lock()
        self._state = "closed"
        self._failures = 0
        self._opened_at = 0.0
        self.trips = 0          # transitions into `open` (incl. reopen)
        self.resets = 0         # half_open -> closed recoveries

    def _notify(self, event: Optional[str]) -> Optional[str]:
        """Fire ``on_transition`` for ``event`` (lock NOT held — the
        callback may take other locks, e.g. a tracer's)."""
        if event is not None and self.on_transition is not None:
            self.on_transition(event, self.state)
        return event

    @property
    def state(self) -> str:
        with self._mu:
            return self._state

    @property
    def failures(self) -> int:
        with self._mu:
            return self._failures

    def on_success(self) -> Optional[str]:
        """A batch served fine.  Returns ``"reset"`` when a half-open probe
        just closed the breaker."""
        with self._mu:
            self._failures = 0
            if self._state == "half_open":
                self._state = "closed"
                self.resets += 1
                event = "reset"
            else:
                event = None
        return self._notify(event)

    def on_failure(self, now: float) -> Optional[str]:
        """A batch failed/timed out.  Returns ``"tripped"`` (closed -> open)
        or ``"reopened"`` (a half-open probe failed) on a transition."""
        with self._mu:
            self._failures += 1
            if self._state == "half_open":
                self._state = "open"
                self._opened_at = now
                self.trips += 1
                event = "reopened"
            elif self._state == "closed" and \
                    self._failures >= self.threshold:
                self._state = "open"
                self._opened_at = now
                self.trips += 1
                event = "tripped"
            else:
                event = None
        return self._notify(event)

    def use_fast(self, now: float) -> bool:
        """Should the NEXT batch run on the fast plan?  In ``open`` state
        this flips to ``half_open`` (and answers yes — the probe) once the
        cool-down has elapsed."""
        with self._mu:
            event = None
            if self._state == "open":
                if now - self._opened_at >= self.cooldown_s:
                    self._state = "half_open"
                    event = "half_open"
                else:
                    return False
        self._notify(event)
        return True

    def reset(self) -> None:
        """Force-close (a plan hot-swap installs fresh weights — old
        failure history is meaningless for them)."""
        with self._mu:
            changed = self._state != "closed"
            self._state = "closed"
            self._failures = 0
        self._notify("force_reset" if changed else None)


# --------------------------------------------------------------------------- #
# scheduler watchdog
# --------------------------------------------------------------------------- #

class Heartbeat:
    """Wall-clock heartbeat a scheduler loop beats each iteration and the
    watchdog reads.  Deliberately on ``time.monotonic`` rather than the
    server's injectable clock: liveness is a property of real threads."""

    __slots__ = ("_t",)

    def __init__(self):
        self._t = time.monotonic()

    def beat(self) -> None:
        self._t = time.monotonic()

    def age(self) -> float:
        return time.monotonic() - self._t


class Watchdog:
    """Background thread that restarts a dead or wedged scheduler.

    Every ``poll_s`` it checks the watched thread: restart when the thread
    has died (crashed/killed), or when there is queued work but the
    heartbeat is older than ``timeout_s`` (wedged — e.g. hung inside a
    batch with no execution timeout configured).  The restart callback
    must beat the heartbeat itself, so a freshly spawned scheduler is
    never double-restarted before its first loop iteration.
    """

    def __init__(self, *, timeout_s: float, heartbeat: Heartbeat,
                 get_thread: Callable[[], Optional[threading.Thread]],
                 has_work: Callable[[], bool],
                 restart: Callable[[bool], None],
                 stop_event: threading.Event,
                 poll_s: Optional[float] = None,
                 on_poll: Optional[Callable[[], None]] = None):
        self.timeout_s = timeout_s
        self.heartbeat = heartbeat
        self.get_thread = get_thread
        self.has_work = has_work
        self.restart = restart
        self._stop = stop_event
        self.poll_s = poll_s if poll_s is not None \
            else max(0.01, timeout_s / 4.0)
        # extra liveness hook fired every poll, watched-thread state aside:
        # the pipeline server uses it to respawn dead executor-pool workers
        # (the formation thread is `get_thread`; workers are a separate
        # population the dead/wedged checks don't see)
        self.on_poll = on_poll
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Watchdog":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serve-watchdog")
        self._thread.start()
        return self

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            if self.on_poll is not None:
                try:
                    self.on_poll()
                except Exception:
                    pass  # a liveness hook must never kill the watchdog
            t = self.get_thread()
            dead = t is None or not t.is_alive()
            wedged = (not dead and self.has_work()
                      and self.heartbeat.age() > self.timeout_s)
            if dead or wedged:
                self.restart(dead)

    def join(self, timeout: Optional[float] = None) -> None:
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout)


# --------------------------------------------------------------------------- #
# fault injection
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class _Fault:
    error: Optional[BaseException] = None
    delay_s: float = 0.0
    hang_s: Optional[float] = None
    corrupt: Optional[Callable] = None
    remaining: Optional[int] = None       # None = fire forever


class FaultInjector:
    """Deterministic fault injection at named sites.

    The serving runtime (and the plan store) call ``fire(site, value)`` at
    well-known points; an injector configured for that site can raise,
    delay, hang, or corrupt the value flowing through — driving every
    failure path the resilience layer has from a test, deterministically.

    Sites currently wired:

    ==================== ====================================================
    ``server.run_batch`` fired inside one batch-execution attempt (before
                         the plan call) — raise/hang/delay here exercises
                         retry, timeout, breaker, and watchdog-wedge paths
    ``server.result``    the batch output flows through ``corrupt=`` —
                         returning NaN-poisoned rows exercises the guard
    ``server.scheduler`` fired once per scheduler-loop iteration — an
                         injected raise kills the scheduler thread (the
                         watchdog-restart path)
    ``router.scheduler`` the ``ModelRouter`` analogue of the above
    ``store.load``       fired inside ``PlanStore.load``'s read path — a
                         raise sends the entry to quarantine
    ==================== ====================================================

    ``times=N`` arms a fault for exactly N firings (the default fires
    forever until ``clear``).  Hung sites block on an event for up to
    ``hang_s``; ``release_hangs()`` unblocks them all (test teardown).
    """

    def __init__(self):
        self._mu = threading.Lock()
        self._faults: Dict[str, _Fault] = {}
        self._unhang = threading.Event()
        self.fired: Dict[str, int] = {}

    def inject(self, site: str, *, error: Optional[BaseException] = None,
               delay_s: float = 0.0, hang_s: Optional[float] = None,
               corrupt: Optional[Callable] = None,
               times: Optional[int] = None) -> "FaultInjector":
        """Arm ``site``: raise ``error`` (an exception instance or class),
        sleep ``delay_s``, hang up to ``hang_s`` (until ``release_hangs``),
        and/or map the site's value through ``corrupt``.  ``times`` bounds
        how many firings the fault survives."""
        if error is None and not delay_s and hang_s is None \
                and corrupt is None:
            raise ValueError(f"fault at {site!r} does nothing")
        with self._mu:
            self._faults[site] = _Fault(error=error, delay_s=delay_s,
                                        hang_s=hang_s, corrupt=corrupt,
                                        remaining=times)
        return self

    def clear(self, site: Optional[str] = None) -> None:
        with self._mu:
            if site is None:
                self._faults.clear()
            else:
                self._faults.pop(site, None)

    def release_hangs(self) -> None:
        """Unblock every site currently (or subsequently) hanging."""
        self._unhang.set()

    def fired_count(self, site: str) -> int:
        with self._mu:
            return self.fired.get(site, 0)

    def fire(self, site: str, value=None):
        """Called by the runtime at ``site``.  Applies the armed fault (if
        any fires remain) and returns the possibly-corrupted value."""
        with self._mu:
            f = self._faults.get(site)
            if f is None or (f.remaining is not None and f.remaining <= 0):
                return value
            if f.remaining is not None:
                f.remaining -= 1
            self.fired[site] = self.fired.get(site, 0) + 1
            error, delay_s, hang_s, corrupt = \
                f.error, f.delay_s, f.hang_s, f.corrupt
        if delay_s:
            time.sleep(delay_s)
        if hang_s is not None:
            self._unhang.wait(hang_s)
        if error is not None:
            raise error() if isinstance(error, type) else error
        if corrupt is not None:
            return corrupt(value)
        return value
