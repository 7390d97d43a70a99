"""Fault tolerance: failure detection + checkpoint/restart, straggler watch.

``ResilientTrainer`` wraps a compiled train step with:
  * periodic async checkpoints (atomic — see checkpoint.store);
  * failure detection: non-finite loss, raised exceptions, or injected faults
    (the test hook standing in for a dead host);
  * automatic restore-from-last-good + batch skip on failure;
  * a ``StragglerMonitor`` that tracks per-step wall time against an EMA and
    flags slow steps (on a real fleet the flagged host is cordoned and its
    shard re-issued; on this single-host runtime the event is surfaced to the
    caller, and the policy is unit-tested at simulation level).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np

from repro_torch.checkpoint import CheckpointManager


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration: float
    ema: float
    factor: float


class StragglerMonitor:
    """EMA-based step-time watchdog (deterministic, testable)."""

    def __init__(self, factor: float = 3.0, alpha: float = 0.1,
                 warmup: int = 3):
        self.factor = factor
        self.alpha = alpha
        self.warmup = warmup
        self.ema: Optional[float] = None
        self.n = 0
        self.events = []

    def observe(self, step: int, duration: float) -> Optional[StragglerEvent]:
        self.n += 1
        if self.ema is None:
            self.ema = duration
            return None
        event = None
        if self.n > self.warmup and duration > self.factor * self.ema:
            event = StragglerEvent(step, duration, self.ema,
                                   duration / self.ema)
            self.events.append(event)
            # do not pollute the EMA with the outlier
            return event
        self.ema = (1 - self.alpha) * self.ema + self.alpha * duration
        return event


class FaultInjector:
    """Deterministic fault schedule for tests: fail at given steps."""

    def __init__(self, fail_at: Iterable[int] = ()):  # steps (0-based)
        self.fail_at = set(fail_at)
        self.injected = []

    def maybe_fail(self, step: int):
        if step in self.fail_at:
            self.fail_at.discard(step)
            self.injected.append(step)
            raise RuntimeError(f"injected fault at step {step}")


class ResilientTrainer:
    def __init__(
        self,
        train_step: Callable,        # (params, opt_state, batch) -> (p, o, metrics)
        params,
        opt_state,
        ckpt: CheckpointManager,
        ckpt_every: int = 50,
        max_restarts: int = 10,
        fault_injector: Optional[FaultInjector] = None,
        straggler: Optional[StragglerMonitor] = None,
        target_shardings=None,
    ):
        self.train_step = train_step
        self.params = params
        self.opt_state = opt_state
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.faults = fault_injector
        self.straggler = straggler or StragglerMonitor()
        self.target_shardings = target_shardings
        self.restarts = 0
        self.step = 0
        self.history: list = []
        # step 0 checkpoint so a first-step failure is recoverable
        self.ckpt.save(0, {"params": self.params, "opt": self.opt_state})

    def _restore(self):
        last = self.ckpt.latest_step()
        tree = self.ckpt.restore(
            {"params": self.params, "opt": self.opt_state},
            step=last, target_shardings=self.target_shardings)
        self.params, self.opt_state = tree["params"], tree["opt"]
        self.step = last
        self.restarts += 1
        if self.restarts > self.max_restarts:
            raise RuntimeError("restart budget exhausted")

    def run(self, batches: Callable[[int], Any], n_steps: int) -> Dict:
        """batches(step) -> batch.  Returns summary metrics."""
        losses = []
        while self.step < n_steps:
            batch = batches(self.step)
            t0 = time.time()
            try:
                if self.faults is not None:
                    self.faults.maybe_fail(self.step)
                p, o, metrics = self.train_step(self.params, self.opt_state,
                                                batch)
                loss = float(metrics["loss"])
                if not np.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at {self.step}")
            except Exception as e:  # noqa: BLE001 — any failure -> restart
                self.history.append(("failure", self.step, repr(e)))
                self._restore()
                continue
            dt = time.time() - t0
            ev = self.straggler.observe(self.step, dt)
            if ev is not None:
                self.history.append(("straggler", ev.step, ev.factor))
            self.params, self.opt_state = p, o
            self.step += 1
            losses.append(loss)
            if self.step % self.ckpt_every == 0:
                self.ckpt.async_save(self.step, {"params": self.params,
                                                 "opt": self.opt_state})
        self.ckpt.wait()
        self.ckpt.save(self.step, {"params": self.params,
                                   "opt": self.opt_state})
        return {"final_loss": losses[-1] if losses else None,
                "losses": losses, "restarts": self.restarts,
                "straggler_events": len(self.straggler.events),
                "history": self.history}
