"""Offline batch scoring: a closed loop of ``ExecutionPlan`` calls, back to
back, each on a ``[rows, n_in]`` float32 batch already on the device.

The batches come from a seeded pool; each call takes one in a seeded order.
Outputs stay on the device, and the window ends in a synchronisation, so the
rate counts all the work and all the time.  A seeded sample of the calls'
outputs (reservoir sampling, so every call is as likely to be kept), and the
last call's, are judged against the reference after the window.
"""

from __future__ import annotations

import importlib
import random
import time
from typing import List

import numpy as np
import torch

from .. import traffic as gen
from .. import work
from ..devtrace import Stretch
from ..outcome import (
    Comparison,
    GcPauses,
    Outcome,
    Run,
    free_device_memory,
    memory_peak,
    settle,
)

#: how many call picks are drawn at once; the order repeats after them
PICKS = 1 << 20
#: calls whose host span is timed, right after a synchronisation: so few
#: that no call waits for room in the device's launch queue, which a
#: device-bound loop fills within a second
HOST_CALLS = 128


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Calls:
    """The window's calls: the plan on pool batches in the seeded order,
    counted per batch, with a seeded reservoir of their outputs."""

    def __init__(self, plan, pool: List[torch.Tensor], seed: int, keep: int):
        self.plan = plan
        self.pool = pool
        self.order = gen.picks(seed, PICKS, len(pool)).tolist()
        self.i = 0
        self.counts = np.zeros(len(pool), np.int64)
        self.rng = random.Random(seed * 7 + gen.SAMPLE)
        self.keep = keep
        self.kept: List[tuple] = []
        self.last = None
        self.host_s: List[float] = []

    def until(self, deadline: float, timed: int = 0) -> None:
        """Call until ``deadline``, timing the host span of the first
        ``timed`` calls."""
        plan, pool, order, n = self.plan, self.pool, self.order, len(self.order)
        clock = time.perf_counter
        stop = self.i + timed
        while clock() < deadline:
            b = order[self.i % n]
            if self.i < stop:
                h0 = clock()
                y = plan(pool[b])
                self.host_s.append(clock() - h0)
            else:
                y = plan(pool[b])
            self.counts[b] += 1
            if len(self.kept) < self.keep:
                self.kept.append((b, y))
            else:
                j = self.rng.randrange(self.i + 1)
                if j < self.keep:
                    self.kept[j] = (b, y)
            self.last = (b, y)
            self.i += 1


def run(cell, r: Run) -> Outcome:
    t = cell.traffic
    phases = {"start": time.perf_counter() - r.t_process}
    models = importlib.import_module(
        f"sparsebench.models.{cell.config['model']}")
    model = models.Model(cell.config, r.seed, r.device)
    rows = int(t["rows"])
    pool = [gen.normal_rows(model.gen, rows, model.n_in, r.device)
            for _ in range(int(t["pool_batches"]))]

    phases["inputs"] = time.perf_counter() - r.t_process
    engine = model.engine()
    plan = engine.compile(model.program_layers())
    phases["compile"] = time.perf_counter() - r.t_process
    # the window keeps a reservoir of outputs alive: warm as many, held
    # together, so that the allocator has their blocks before the window
    held = [plan(pool[w % len(pool)]) for w in range(
        max(int(t["warm_calls"]), int(t["sample_outputs"]) + 2))]
    _sync(r.device)
    del held
    phases["warmup"] = time.perf_counter() - r.t_process
    if r.trace:
        Stretch.prepare(r.device)
    settle()

    calls = _Calls(plan, pool, r.seed, int(t["sample_outputs"]))
    stretch = None
    in_stretch = np.zeros(len(pool), np.int64)
    pauses = GcPauses()
    t0 = time.perf_counter()
    setup_s = t0 - r.t_process
    unprofiled_s = None
    with pauses:
        if r.trace:
            # host spans of the window's first calls, device activity in a
            # profiled stretch in its middle; synchronisations bound the
            # stretch, so the time outside it holds only unprofiled work
            stretch_s = min(float(t["trace_stretch_s"]), r.seconds)
            calls.until(t0 + (r.seconds - stretch_s) / 2, timed=HOST_CALLS)
            _sync(r.device)
            unprofiled_s = time.perf_counter() - t0
            before = calls.counts.copy()
            with Stretch(r.device) as stretch:
                calls.until(time.perf_counter() + stretch_s)
            in_stretch = calls.counts - before
            t_after = time.perf_counter()
            calls.until(t0 + r.seconds)
        else:
            calls.until(t0 + r.seconds)
        _sync(r.device)
    t_end = time.perf_counter()
    window_s = t_end - t0
    if unprofiled_s is not None:
        unprofiled_s += t_end - t_after
    n_calls = calls.i

    peak = memory_peak(r.device)
    kept = calls.kept + [calls.last]
    del calls.plan, plan, engine, calls.kept, calls.last
    free_device_memory()

    ref = model.reference()
    cmp = Comparison()
    works = []
    truths = []
    for x in pool:
        inputs = ref.layer_inputs(x)
        works.append(work.forward_work(inputs, ref.masks, model.block))
        truths.append(inputs[-1])
        del inputs
    controls = {}
    for b, y in kept:
        if r.control:
            if b not in controls:
                controls[b] = ref(pool[b], "tf32")
            y = controls[b]
        cmp.add(y, truths[b])
    wrong = cmp.wrong_adds(float(cell.limits["max_err_rel"]))

    info = {"calls": n_calls, "rows_per_call": rows,
            "compared_calls": len(kept),
            "live_blocks_per_call": [w["live_blocks"] for w in works],
            "gc_collections_and_longest_ms": pauses.summary(),
            "setup_phases_s": phases}
    return Outcome(
        end_to_end={"setup_s": setup_s,
                    "rows_per_s": n_calls * rows / window_s},
        attempted=n_calls, failed=wrong,
        compared={"max_err_rel": cmp.max_err_rel},
        memory_peak_bytes=peak,
        obs={"window_s": window_s, "unprofiled_s": unprofiled_s,
             "calls_by_batch": calls.counts.tolist(),
             "stretch_calls_by_batch": in_stretch.tolist(),
             "work_by_batch": works,
             "host_call_s": calls.host_s,
             "stretch": None if stretch is None else stretch.summary()},
        info=info)
