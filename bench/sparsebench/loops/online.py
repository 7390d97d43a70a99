"""Open-loop serving: single-row requests at fixed due times into the
program's server, built as ``repro_torch.launch.serve.build_server`` builds
it.

One generator thread submits each request at its due time; one waiter
thread collects the answers in submission order.  A request's latency runs
from its due time to the moment the harness holds its answer, so a stall
also delays every request queued behind it.  A request that is rejected,
whose answer never comes, or whose answer is wrong has failed; one that is
rejected or never answered counts as infinitely late in the tail (capped at
the longest the harness waits).
"""

from __future__ import annotations

import importlib
import queue
import threading
import time

import numpy as np
import torch

from .. import traffic as gen
from ..devtrace import Stretch
from ..outcome import (
    Comparison,
    Outcome,
    GcPauses,
    Run,
    free_device_memory,
    memory_peak,
    percentile,
    settle,
)

#: rows compared per block, after the window
CHECK_ROWS = 16384
#: the window opens this long after set-up ends, so the first due time is
#: not already late
LEAD_S = 0.05


def run(cell, r: Run) -> Outcome:
    from repro_torch.obs.series import BoundedSeries
    from repro_torch.serving import BucketedPlanSet, SparseServer
    from repro_torch.serving.metrics import ServingMetrics

    t = cell.traffic
    phases = {"start": time.perf_counter() - r.t_process}
    models = importlib.import_module(
        f"sparsebench.models.{cell.config['model']}")
    model = models.Model(cell.config, r.seed, r.device)
    pool_dev = gen.normal_rows(model.gen, int(t["pool_rows"]), model.n_in,
                               r.device)
    pool = pool_dev.cpu().numpy()
    rate = float(r.rate if r.rate is not None else t["rate_per_s"])
    dues = gen.arrivals(r.seed, rate, r.seconds)
    n = len(dues)
    idx = gen.picks(r.seed, n, len(pool))
    phases["inputs"] = time.perf_counter() - r.t_process

    engine = model.engine()
    plans = BucketedPlanSet.compile(model.program_layers(), engine=engine,
                                    max_batch=int(t["max_batch"]))
    phases["compile"] = time.perf_counter() - r.t_process
    plans.warmup()
    phases["warmup"] = time.perf_counter() - r.t_process
    server = SparseServer(plans, slo_ms=float(t["slo_ms"]),
                          max_queue=int(t["max_queue"]),
                          executor_workers=int(t["executor_workers"]))
    server.start()
    answers = np.full((n, plans.n_out), np.nan, np.float32)
    t_sub = np.full(n, np.nan)
    t_ans = np.full(n, np.nan)
    status = np.zeros(n, np.int8)          # 0 answered, 1 rejected, 2 lost
    stretch = None
    pauses = GcPauses()
    try:
        # the server's own path once at traffic's size, outside the window
        warm = [server.submit(pool[i % len(pool)])
                for i in range(int(t["warm_requests"]))]
        for rid in warm:
            if rid is None or server.wait(rid, timeout=t["grace_s"]) is None:
                raise RuntimeError("the server lost a warm-up request")
        # the program's counters start with the window: fresh ones, with
        # every queue wait kept, so its median is exact at any count
        waits = BoundedSeries(exact_cap=n)
        server.metrics = ServingMetrics(queue_wait_s=waits)
        if r.trace:
            Stretch.prepare(r.device)
        settle()
        pauses.__enter__()

        t0 = time.perf_counter() + LEAD_S
        setup_s = t0 - r.t_process
        close = t0 + r.seconds
        give_up = close + float(t["grace_s"])
        handoff: "queue.Queue" = queue.Queue()

        def generate():
            try:
                for i in range(n):
                    wait = t0 + dues[i] - time.perf_counter()
                    if wait > 0:
                        time.sleep(wait)
                    rid, _ = server.submit_ex(pool[idx[i]])
                    t_sub[i] = time.perf_counter()
                    handoff.put((i, rid))
            finally:
                handoff.put(None)

        def collect():
            while True:
                item = handoff.get()
                if item is None:
                    return
                i, rid = item
                if rid is None:
                    status[i] = 1
                    continue
                y = server.wait(rid, timeout=max(0.0, give_up
                                                 - time.perf_counter()))
                t_ans[i] = time.perf_counter()
                if y is None:
                    status[i] = 2
                else:
                    answers[i] = y
                del y

        threads = [threading.Thread(target=generate, name="bench-generate"),
                   threading.Thread(target=collect, name="bench-collect")]
        for th in threads:
            th.start()
        exec_s = batch_rows = queue_waits = None
        t_counted = close
        if r.trace:
            # the program's counters cover the window up to the profiled
            # stretch, which closes it: starting the profiler stalls the
            # host, and the backlog that leaves would distort them
            stretch_s = min(float(t["trace_stretch_s"]), r.seconds)
            time.sleep(max(0.0, close - stretch_s - time.perf_counter()))
            t_counted = time.perf_counter()
            m = server.metrics
            exec_s = (m.exec_s.total, len(m.exec_s))
            batch_rows = (m.batch_sizes.total, len(m.batch_sizes))
            queue_waits = waits.values()
            with Stretch(r.device) as stretch:
                time.sleep(max(0.0, close - time.perf_counter()))
        for th in threads:
            th.join(timeout=max(1.0, give_up + 5.0 - time.perf_counter()))
        if any(th.is_alive() for th in threads):
            raise RuntimeError("the load generator did not finish")
        snap = server.metrics.snapshot()
    finally:
        server.shutdown(drain=True, drain_timeout_s=float(t["grace_s"]))
        pauses.__exit__(None, None, None)

    peak = memory_peak(r.device)
    del server, plans, engine
    free_device_memory()

    # judge every answer against the reference, rows in blocks
    ref = model.reference()
    pool_ref = ref(pool_dev, "tf32" if r.control else "f32")
    truth = ref(pool_dev) if r.control else pool_ref
    cmp = Comparison()
    answered = np.flatnonzero(status == 0)
    for k in range(0, len(answered), CHECK_ROWS):
        rows = answered[k:k + CHECK_ROWS]
        picked = torch.from_numpy(idx[rows]).to(r.device)
        ys = pool_ref[picked] if r.control else torch.from_numpy(
            answers[rows])
        cmp.add(ys, truth[picked])
    wrong = cmp.wrong(float(cell.limits["max_err_rel"]))

    rejected = int((status == 1).sum())
    lost = int((status == 2).sum())
    cap = give_up - t0
    lat = np.where(status == 0, t_ans - (t0 + dues), np.inf)
    lat = np.minimum(lat, cap)
    late = t_sub - (t0 + dues)
    span = np.nanmax(t_sub) - t0 if n else 0.0
    quarter = lat[int(0.75 * n):]
    info = {
        "offered_rate_per_s": rate,
        "achieved_rate_per_s": float(n / span) if span > 0 else 0.0,
        "generator_lateness_p95_ms": 1e3 * percentile(late, 95),
        "latency_ms": {q: 1e3 * percentile(lat, p) for q, p in
                       (("p50", 50), ("p95", 95), ("p99", 99))},
        "latency_p95_last_quarter_ms": 1e3 * percentile(quarter, 95),
        "requests": n, "rejected": rejected, "lost": lost, "wrong": wrong,
        "compared_rows": cmp.rows,
        "max_queue_depth": snap["max_queue_depth"],
        "mean_batch_size": snap["mean_batch_size"],
        "queue_wait_p50_ms": snap["queue_wait_ms"]["p50"],
        "gc_collections_and_longest_ms": pauses.summary(),
        "setup_phases_s": phases,
    }
    return Outcome(
        end_to_end={"setup_s": setup_s,
                    "latency_p95_ms": 1e3 * percentile(lat, 95)},
        attempted=n, failed=rejected + lost + wrong,
        compared={"max_err_rel": cmp.max_err_rel, "lost": float(lost)},
        memory_peak_bytes=peak,
        obs={"batch_exec_s": exec_s, "batch_rows": batch_rows,
             "queue_wait_s": queue_waits,
             "submit_lateness_s": late[t0 + dues < t_counted].tolist(),
             "stretch": None if stretch is None else stretch.summary()},
        info=info)
