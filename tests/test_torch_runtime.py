"""The port's serving runtime: pipeline, swap, router, resilience, front door.

The reference's own concurrent tests (``test_pipeline.py``,
``test_server_async.py``, ``test_chaos.py``) do not all pass against the
reference itself, so these hold the port to its own contract:

  * a pipelined server's answers equal the step-driven server's for the
    same formed batches, bit for bit;
  * no answer mixes the old and the new weights across a swap;
  * no request crosses models in a router;
  * a watchdog restart loses no request;
  * the front door answers 429 when the queue is full;
  * a failing batch is contained and counted, and the breaker degrades to
    the safe twin (per-layer ``bsr_matmul``, never plain PyTorch),
    visibly, and recovers;

and, step-driven with an injected clock, to the reference's snapshot: the
same Prometheus metric names (plus the port's ``io_measure_failed``) and
the same counts.  Every wait is bounded by a timeout; injected hangs are
released in ``finally``.  Answers are held to the safe twin within f32
``rtol = atol = 1e-5`` where batch composition may differ.
"""

import json
import re
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
from conftest import FakeClock

from repro.engine import Engine as JaxEngine
from repro.obs import render_prometheus as jax_render
from repro.serving import BucketedPlanSet as JaxPlanSet
from repro.serving import SparseServer as JaxServer
from repro.sparse import prune_dense_stack
from repro_torch.convert import layers_from_numpy
from repro_torch.engine import Engine
from repro_torch.obs import render_prometheus
from repro_torch.serving import (
    BucketedPlanSet,
    CircuitBreaker,
    DispatchQueues,
    FaultInjector,
    FormedBatch,
    HttpFrontDoor,
    ModelRouter,
    PlanStore,
    RetryPolicy,
    SparseServer,
)

TOL = dict(rtol=1e-5, atol=1e-5)
WAIT_S = 20.0


def engine(**kw):
    return Engine(device="cpu", activation="relu", **kw)


def make_layers(seed=0):
    rng = np.random.default_rng(seed)
    ws = [rng.standard_normal((a, b)).astype(np.float32) * 0.1
          for a, b in ((128, 256), (256, 128))]
    bs = [rng.standard_normal(n).astype(np.float32) * 0.1 for n in (256, 128)]
    return prune_dense_stack(ws, bs, density=0.4, block_m=32, block_n=32)


@pytest.fixture(scope="module")
def plans():
    return BucketedPlanSet.compile(layers_from_numpy(make_layers()),
                                   engine=engine(), max_batch=8,
                                   safe_twin=True).warmup()


def rows(n, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, 128)).astype(np.float32)


def twin(plans, xs):
    """Ground truth within tolerance: the plan's plain PyTorch version."""
    return plans.base.plain()(np.asarray(xs)).numpy()


class Recording(SparseServer):
    """Records each formed batch's request ids, in formation order."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.formed = []
        self._rec = threading.Lock()

    def _run_batch(self, batch, worker=None):
        with self._rec:
            self.formed.append([r.rid for r in batch.reqs])
        return super()._run_batch(batch, worker)


class HeldPlans:
    """Wraps a plan set; every call blocks until the test releases it."""

    def __init__(self, base):
        self._base = base
        self.release = threading.Event()

    def __call__(self, x):
        assert self.release.wait(timeout=WAIT_S), "hold never released"
        return self._base(x)

    def __getattr__(self, name):
        return getattr(self._base, name)


def submitters(runtime, xs, n_threads, answers, rids, model=None):
    """Threads that each submit their share of ``xs`` in bursts of 1-5 and
    wait for every answer: ``answers[i]`` gets row i's, ``rids[rid] = i``.
    ``model(i)`` routes row i through a router."""
    mu = threading.Lock()

    def client(k):
        rng = np.random.default_rng(100 + k)
        mine = list(range(k, len(xs), n_threads))
        pos = 0
        while pos < len(mine):
            burst = mine[pos:pos + int(rng.integers(1, 6))]
            pos += len(burst)
            sent = []
            for i in burst:
                args = (xs[i],) if model is None else (model(i), xs[i])
                rid = runtime.submit(*args)
                assert rid is not None
                with mu:
                    rids[(rid if model is None else (model(i), rid))] = i
                sent.append((i, args[:-1] + (rid,)))
            for i, key in sent:
                answers[i] = runtime.wait(*key, timeout=WAIT_S)

    return [threading.Thread(target=client, args=(k,))
            for k in range(n_threads)]


def run_threads(threads, timeout=60):
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads)


# --------------------------------------------------------------------------- #
# dispatch lanes
# --------------------------------------------------------------------------- #

def test_dispatch_lane_is_serial_fifo_and_bounded():
    d = DispatchQueues(per_lane=2)
    a, b, c = (FormedBatch(reqs=[], plans=None, bucket=1, t_formed=t)
               for t in (0.0, 1.0, 2.0))
    other = FormedBatch(reqs=[], plans=None, bucket=2, t_formed=0.5)
    assert d.put(a) and d.put(b) and not d.put(c)      # lane full
    assert d.put(other)
    assert d.take(timeout=1.0) is a
    assert d.take(timeout=1.0) is other                # lane 1 is busy
    assert d.take(timeout=0.01) is None
    d.complete(a)
    assert d.take(timeout=1.0) is b
    d.complete(b)
    d.complete(other)
    assert d.wait_idle(timeout=1.0)
    d.close()
    assert not d.put(c) and d.take(timeout=0.01) is None


# --------------------------------------------------------------------------- #
# the pipeline
# --------------------------------------------------------------------------- #

def test_pipeline_answers_equal_step_driven_per_formed_batch(plans):
    """4 submitter threads through a 3-worker pipeline: every answer equals
    what the step-driven server answers for the same formed batch."""
    xs = rows(96, seed=1)
    server = Recording(plans, slo_ms=20.0, executor_workers=3)
    answers, rids = {}, {}
    server.start()
    try:
        run_threads(submitters(server, xs, 4, answers, rids))
        pool = server.snapshot()["pool"]
    finally:
        assert server.shutdown(drain=True, drain_timeout_s=WAIT_S)
    assert pool["workers"] == 3 and set(pool["per_worker"]) == {"0", "1", "2"}
    assert len(answers) == 96 and all(y is not None
                                      for y in answers.values())
    assert sorted(sum(server.formed, [])) == sorted(rids)
    m = server.metrics.snapshot()
    assert (m["served"], m["batch_failures"]) == (96, 0)
    assert m["dispatch_wait_ms"]["count"] == m["batches"]
    step = SparseServer(plans, clock=FakeClock())
    for batch in server.formed:
        idx = [rids[r] for r in batch]
        srids = [step.submit(xs[i]) for i in idx]
        assert step.step(flush=True) == len(idx)     # one batch, same rows
        for i, r in zip(idx, srids):
            np.testing.assert_array_equal(step.result(r), answers[i])
    np.testing.assert_allclose(np.stack([answers[i] for i in range(96)]),
                               twin(plans, xs), **TOL)


def test_failed_batch_is_contained_and_counted(plans):
    """A plan call that raises completes its requests as None; ``step``
    returns normally and the server keeps serving."""
    inj = FaultInjector().inject("server.run_batch",
                                 error=RuntimeError("boom"), times=1)
    server = SparseServer(plans, clock=FakeClock(), fault_injector=inj)
    xs = rows(3, seed=2)
    bad = [server.submit(x) for x in xs[:2]]
    assert server.step(flush=True) == 2
    assert [server.status(r) for r in bad] == ["done", "done"]
    assert [server.result(r) for r in bad] == [None, None]
    good = server.submit(xs[2])
    server.drain()
    np.testing.assert_allclose(server.result(good), twin(plans, xs[2:])[0],
                               **TOL)
    m = server.metrics.snapshot()
    assert (m["batch_failures"], m["failed_requests"], m["served"]) == \
        (1, 2, 1)


def test_retry_timeout_and_nan_guard(plans):
    inj = FaultInjector()
    server = SparseServer(plans, clock=FakeClock(), fault_injector=inj,
                          retry=RetryPolicy(max_retries=1, timeout_s=0.5,
                                            backoff_s=0.0))
    x = rows(1, seed=3)[0]
    try:
        inj.inject("server.run_batch", error=RuntimeError("flaky"), times=1)
        rid = server.submit(x)
        server.drain()
        assert server.result(rid) is not None          # the retry served it
        inj.inject("server.result", corrupt=lambda y: y * np.nan, times=2)
        rid = server.submit(x)
        server.drain()                                 # two poisoned tries
        assert server.result(rid) is None
        inj.inject("server.run_batch", hang_s=WAIT_S, times=2)
        rid = server.submit(x)
        server.drain()                                 # two timed-out tries
        assert server.result(rid) is None
    finally:
        inj.release_hangs()
    m = server.metrics.snapshot()
    assert (m["retries"], m["batch_timeouts"], m["nan_guard_failures"],
            m["batch_failures"]) == (3, 2, 2, 2)


def test_breaker_degrades_to_the_safe_twin_and_recovers(plans, monkeypatch):
    from repro_torch.engine import backends
    layer_calls = []
    wrapper = backends.bsr_matmul

    def counting(*a, **kw):
        layer_calls.append(1)
        return wrapper(*a, **kw)

    monkeypatch.setattr(backends, "bsr_matmul", counting)
    clock = FakeClock()
    inj = FaultInjector()
    server = SparseServer(plans, clock=clock, fault_injector=inj,
                          breaker=CircuitBreaker(threshold=2, cooldown_s=1.0))
    xs = rows(4, seed=4)
    inj.inject("server.run_batch", error=RuntimeError("kernel fault"),
               times=2)
    for x in xs[:2]:
        server.submit(x)
        server.step(flush=True)
    snap = server.snapshot()
    assert snap["degraded"] and snap["breaker_state"] == "open"
    assert snap["breaker_trips"] == 1 and server.plans.safe_mode
    safe = server.plans.base                # the kernel route, per layer
    assert (safe.backend, safe.fused, safe.gate) == ("kernel", False, False)
    rid = server.submit(xs[2])
    server.drain()                          # served by the safe twin
    assert len(layer_calls) == len(safe.layers)   # one bsr_matmul per layer
    np.testing.assert_allclose(server.result(rid), twin(plans, xs[2:3])[0],
                               **TOL)
    assert server.metrics.degraded_batches == 1
    clock.advance(1.5)                      # cool-down over: probe fast
    calls = sum(plans.bucket_calls.values())
    rid = server.submit(xs[3])
    server.drain()
    assert server.result(rid) is not None
    assert sum(plans.bucket_calls.values()) == calls + 1
    snap = server.snapshot()
    assert not snap["degraded"] and snap["breaker_state"] == "closed"
    assert (snap["breaker_resets"], snap["degraded_batches"]) == (1, 1)
    with pytest.raises(ValueError, match="safe-mode twin"):
        SparseServer(BucketedPlanSet.compile(
            layers_from_numpy(make_layers()), engine=engine(), max_batch=2),
            breaker=CircuitBreaker())


def test_queue_status_cancel_and_deadline_eviction(plans):
    clock = FakeClock()
    server = SparseServer(plans, clock=clock, slo_ms=1000.0,
                          enforce_deadlines=True)
    x = rows(1, seed=5)[0]
    a, b = server.submit(x), server.submit(x, deadline_ms=10.0)
    c = server.submit(x)
    assert server.status(a) == "pending" and server.status(99) == "unknown"
    assert server.cancel(a) and not server.cancel(a)
    clock.advance(0.05)                     # b's deadline passed
    assert server.wait(c, timeout=0.01) is None       # still queued
    server.drain()
    assert server.result(b) is None and server.result(c) is not None
    m = server.metrics.snapshot()
    assert (m["cancelled"], m["deadline_evictions"], m["served"]) == (1, 1, 1)
    rid, reason = server.submit_ex(x)
    assert reason is None
    server.shutdown(drain=True)
    assert server.submit_ex(x) == (None, "closed")


# --------------------------------------------------------------------------- #
# swap
# --------------------------------------------------------------------------- #

def test_swap_under_traffic_never_mixes_weights(plans):
    """A new-weight swap while 3 threads submit to a 3-worker pipeline:
    each answer equals the old or the new weights' answer, never a mix."""
    new = BucketedPlanSet.compile(layers_from_numpy(make_layers(seed=7)),
                                  engine=engine(), max_batch=8).warmup()
    xs = rows(16, seed=6)
    want_old, want_new = twin(plans, xs), twin(new, xs)
    server = SparseServer(plans, slo_ms=20.0, executor_workers=3)
    stop = threading.Event()
    results, mu = [], threading.Lock()

    def client(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            i = int(rng.integers(len(xs)))
            rid = server.submit(xs[i])
            y = server.wait(rid, timeout=WAIT_S)
            with mu:
                results.append((i, y))

    threads = [threading.Thread(target=client, args=(50 + k,))
               for k in range(3)]
    server.start()
    for t in threads:
        t.start()
    try:
        for _ in range(200):
            with mu:
                if len(results) >= 20:
                    break
            stop.wait(0.01)
        old = server.swap(plans=new)
        with mu:
            n_before = len(results)
        for _ in range(200):
            with mu:
                if len(results) >= n_before + 20:
                    break
            stop.wait(0.01)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=WAIT_S)
        server.shutdown(drain=True, drain_timeout_s=WAIT_S)
    assert old is plans and not any(t.is_alive() for t in threads)
    counts = {"old": 0, "new": 0}
    for i, y in results:
        is_old = np.allclose(y, want_old[i], **TOL)
        is_new = np.allclose(y, want_new[i], **TOL)
        assert is_old != is_new, "answer matches neither or both weights"
        counts["old" if is_old else "new"] += 1
    assert counts["old"] > 0 and counts["new"] > 0
    assert server.metrics.swaps == 1


def test_swap_by_net_builds_off_path_through_the_store(tmp_path):
    store = PlanStore(str(tmp_path))
    eng = engine()
    base = BucketedPlanSet.compile(layers_from_numpy(make_layers()),
                                   engine=eng, max_batch=4,
                                   plan_store=store).warmup()
    server = SparseServer(base, engine=eng, plan_store=store,
                          clock=FakeClock())
    handle = server.swap(layers_from_numpy(make_layers(seed=9)),
                         swap_async=True)
    assert handle.wait(timeout=WAIT_S) is base
    assert server.plans is not base and not server.plans.cache_hit
    server.swap(layers_from_numpy(make_layers()))         # back: a store hit
    assert server.plans.cache_hit
    m = server.metrics.snapshot()
    assert (m["swaps"], m["swap_hits"]) == (2, 1)
    with pytest.raises(ValueError, match="model shape"):
        server.swap(plans=BucketedPlanSet.compile(
            layers_from_numpy(prune_dense_stack(
                [np.ones((64, 64), np.float32)], [np.zeros(64, np.float32)],
                density=1.0, block_m=32, block_n=32)),
            engine=engine(), max_batch=4))


# --------------------------------------------------------------------------- #
# router
# --------------------------------------------------------------------------- #

def test_router_never_crosses_models(tmp_path):
    nets = {f"m{k}": layers_from_numpy(make_layers(seed=k)) for k in (0, 1)}
    router = ModelRouter.compile(nets, engine=engine(), max_batch=8,
                                 plan_store=PlanStore(str(tmp_path)),
                                 executor_workers=2, slo_ms=20.0)
    xs = rows(64, seed=8)
    wants = {name: twin(s.plans, xs) for name, s in router.servers.items()}
    answers, rids = {}, {}
    router.start()
    try:
        run_threads(submitters(router, xs, 4, answers, rids,
                               model=lambda i: f"m{i % 2}"))
        snap = router.snapshot()
    finally:
        assert router.shutdown(drain=True, drain_timeout_s=WAIT_S)
    for i, y in answers.items():
        own, other = f"m{i % 2}", f"m{1 - i % 2}"
        np.testing.assert_allclose(y, wants[own][i], **TOL)
        assert not np.allclose(y, wants[other][i], **TOL)
    assert snap["total"]["served"] == 64 and snap["pool"]["workers"] == 2
    assert {m: s["served"] for m, s in snap["models"].items()} == \
        {"m0": 32, "m1": 32}
    with pytest.raises(KeyError, match="unknown model"):
        router.submit("m7", xs[0])


# --------------------------------------------------------------------------- #
# watchdog and front door
# --------------------------------------------------------------------------- #

@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_watchdog_restart_loses_no_request(plans):
    inj = FaultInjector().inject("server.scheduler",
                                 error=RuntimeError("scheduler crash"),
                                 times=1)
    server = SparseServer(plans, slo_ms=20.0, watchdog_s=0.2,
                          fault_injector=inj, executor_workers=2)
    server.start()                          # dies on its first iteration
    xs = rows(12, seed=10)
    try:
        rids = [server.submit(x) for x in xs]
        got = [server.wait(r, timeout=WAIT_S) for r in rids]
    finally:
        server.shutdown(drain=True, drain_timeout_s=WAIT_S)
    assert all(y is not None for y in got)
    np.testing.assert_allclose(np.stack(got), twin(plans, xs), **TOL)
    assert server.metrics.watchdog_restarts >= 1


def post(url, body):
    req = urllib.request.Request(url + "/v1/infer",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def test_http_front_door_answers_and_backpressures(plans):
    """A synchronous POST is answered; with the executors held and the
    queue full, POSTs get 429 + Retry-After, and everything admitted is
    served once the hold is released."""
    held = HeldPlans(plans)
    server = SparseServer(held, slo_ms=50.0, max_queue=2,
                          executor_workers=2)
    server.start()
    front = HttpFrontDoor(server, port=0).start()
    x = rows(1, seed=11)[0]
    try:
        held.release.set()
        code, body, _ = post(front.url, {"x": x.tolist()})
        assert code == 200
        np.testing.assert_allclose(body["y"], twin(plans, [x])[0], **TOL)
        assert post(front.url, {"x": [1.0, 2.0]})[0] == 400
        assert post(front.url, {"x": x.tolist(), "model": "nope"})[0] == 404
        held.release.clear()
        codes, admitted = [], []
        for _ in range(30):
            code, body, headers = post(front.url, {"x": x.tolist(),
                                                   "wait": False})
            codes.append(code)
            if code == 202:
                admitted.append(body["rid"])
            else:
                assert code == 429 and "Retry-After" in headers
        assert codes.count(429) > 0 and codes.count(202) > 0
        held.release.set()
        for rid in admitted:
            assert server.wait(rid, timeout=WAIT_S) is not None
    finally:
        held.release.set()
        front.stop()
        server.shutdown(drain=True, drain_timeout_s=WAIT_S)
    assert server.metrics.rejected == codes.count(429)


# --------------------------------------------------------------------------- #
# snapshot and Prometheus, against the reference
# --------------------------------------------------------------------------- #

def prom_samples(text):
    """Sample name -> value of a Prometheus text page, labels kept."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out


def test_prometheus_snapshot_matches_the_reference():
    jl = make_layers()
    jplans = JaxPlanSet.compile(jl, engine=JaxEngine(backend="jnp",
                                                     activation="relu",
                                                     gate=True),
                                max_batch=4).warmup()
    tplans = BucketedPlanSet.compile(layers_from_numpy(jl),
                                     engine=engine(gate=True),
                                     max_batch=4).warmup()
    xs = rows(11, seed=12)
    xs[:, :64] = 0.0                        # dead input tiles to gate
    snaps = []
    for cls, p in ((JaxServer, jplans), (SparseServer, tplans)):
        clock = FakeClock()
        server = cls(p, clock=clock, slo_ms=1000.0, measure_dynamic_every=1)
        for n in (3, 1, 4, 2, 1):
            for _ in range(n):
                server.submit(xs[server.metrics.admitted])
            clock.advance(0.3)
            server.poll()
        server.cancel(server.submit(xs[0]))
        server.drain()
        snaps.append(server.snapshot())
    jtext, ttext = jax_render(snaps[0]), render_prometheus(snaps[1])
    names = [set(re.findall(r"^# TYPE (\S+)", t, re.M))
             for t in (jtext, ttext)]
    assert names[1] == names[0] | {"repro_io_measure_failed"}
    js, ts = prom_samples(jtext), prom_samples(ttext)
    ts.pop("repro_io_measure_failed")
    assert ts.keys() == js.keys()
    counts = {k for k in js if not re.search(r"_ms|_s\b|rps|_utilization",
                                             k)}
    assert {k: ts[k] for k in counts} == {k: js[k] for k in counts}
    assert ts["repro_served"] == 11 and ts["repro_cancelled"] == 1


# --------------------------------------------------------------------------- #
# tracing: the batch path's spans, the profiler sink, the totals, the ring
# --------------------------------------------------------------------------- #

BATCH_PHASES = ["batch.stack", "bucket.pad", "plan.input", "plan.launch",
                "bucket.fetch", "batch.finish"]


class TickClock(FakeClock):
    """A fake clock one microsecond further on at every read, so spans
    have lengths and an order."""

    def __call__(self):
        self.t += 1e-6
        return self.t


def test_one_batch_yields_the_span_tree(plans):
    from repro_torch.obs import Tracer

    clock = TickClock()
    tracer = Tracer(clock=clock)
    server = SparseServer(plans, clock=clock, tracer=tracer, name="m")
    rids = [server.submit(x) for x in rows(3)]
    assert server.step(flush=True) == 3
    spans = tracer.spans()
    (ex,) = [s for s in spans if s.name == "batch.execute"]
    kids = [s for s in spans if s.name in BATCH_PHASES]
    assert [s.name for s in sorted(kids, key=lambda s: s.t0)] == BATCH_PHASES
    for a, b in zip(sorted(kids, key=lambda s: s.t0),
                    sorted(kids, key=lambda s: s.t0)[1:]):
        assert a.t1 <= b.t0
    assert all(ex.t0 < s.t0 and s.t1 < ex.t1 for s in kids)
    assert {s.tid for s in kids} == {ex.tid}
    a = ex.attrs
    assert (a["model"], a["bucket"], a["n"], a["attempt"], a["degraded"],
            a["misses"], a["syncs"]) == ("m", 4, 3, 1, False, 0, 0)
    assert 0 < a["wait_min_ms"] <= a["wait_max_ms"]
    assert not any(k.startswith("io_") for k in a)
    (io,) = [s for s in spans if s.name == "io.plan"]
    assert io.phase == "i" and io.attrs["bucket"] == 4
    assert io.attrs["io_tile_reads"] > 0 and io.attrs["backend"]
    for name, phase in (("request.submit", "i"), ("request.queue", "X"),
                        ("request.done", "i")):
        got = [s for s in spans if s.name == name]
        assert sorted(s.attrs["rid"] for s in got) == sorted(rids)
        assert {s.phase for s in got} == {phase}
    queue = {s.attrs["rid"]: s for s in spans if s.name == "request.queue"}
    done = {s.attrs["rid"]: s for s in spans if s.name == "request.done"}
    stack, pad = (next(s for s in kids if s.name == n)
                  for n in ("batch.stack", "bucket.pad"))
    for r in rids:
        # the wait ends as the first attempt starts, after the rows are
        # stacked; the answer is done before the batch's finish
        assert queue[r].t0 < stack.t1 < queue[r].t1 < pad.t0
        assert done[r].t0 < ex.t1
        assert done[r].attrs == {"model": "m", "rid": r, "ok": True,
                                 "miss": False}
    # a second batch on the same bucket records no second io.plan
    for x in rows(4, seed=1):
        server.submit(x)
    server.step(flush=True)
    assert sum(s.name == "io.plan" for s in tracer.spans()) == 1


def test_scheduler_idle_spans_one_per_batch(plans):
    from repro_torch.obs import Tracer

    tracer = Tracer()
    server = SparseServer(plans, tracer=tracer, max_wait_ms=1.0).start()
    try:
        for k in range(4):
            rids = [server.submit(x) for x in rows(3, seed=k)]
            for r in rids:
                assert server.wait(r, timeout=WAIT_S) is not None
    finally:
        server.shutdown(drain=True, drain_timeout_s=WAIT_S)
    spans = tracer.spans()
    idle = [s for s in spans if s.name == "scheduler.idle"]
    execs = [s for s in spans if s.name == "batch.execute"]
    assert len(execs) >= 4 and len(idle) == len(execs)
    # each idle span but the one the shutdown closed ended at a formation
    assert all(s.attrs["depth"] >= 1 for s in idle[:-1])
    assert {s.tid for s in idle} == {s.tid for s in execs}


def test_profiler_sink_and_totals_with_the_null_tracer(plans):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import NULL_TRACER, trace

    server = SparseServer(plans, clock=FakeClock())
    for x in rows(3):
        server.submit(x)
    trace.reset_totals()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert server.step(flush=True) == 3
    names = {e.name for e in prof.events()}
    assert set(BATCH_PHASES) | {"batch.execute"} <= names
    got = trace.totals()
    assert {n: got["spans"][n]["count"]
            for n in BATCH_PHASES + ["batch.execute"]} == \
        {n: 1 for n in BATCH_PHASES + ["batch.execute"]}
    assert all(v["seconds"] >= 0 for v in got["spans"].values())
    assert NULL_TRACER.spans() == []
    # the profiler off again: nothing more is added
    for x in rows(2):
        server.submit(x)
    server.step(flush=True)
    assert trace.totals() == got
    assert not torch.autograd.profiler._is_profiler_enabled


def test_inactive_tracing_creates_nothing(plans, monkeypatch):
    import torch

    from repro_torch.obs import NULL_TRACER, Tracer, trace

    made = {"span": 0, "record_function": 0, "event": 0}

    class CountingSpan(trace._SpanCtx):
        def __init__(self, *a, **kw):
            made["span"] += 1
            super().__init__(*a, **kw)

    def counting(cls, key):
        class Counting(cls):
            def __init__(self, *a, **kw):
                made[key] += 1
                super().__init__(*a, **kw)
        return Counting

    monkeypatch.setattr(trace, "_SpanCtx", CountingSpan)
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        counting(torch.autograd.profiler.record_function,
                                 "record_function"))
    monkeypatch.setattr(torch.cuda, "Event",
                        counting(torch.cuda.Event, "event"))
    trace.reset_totals()
    for tracer in (NULL_TRACER, Tracer(enabled=False)):
        server = SparseServer(plans, clock=FakeClock(), tracer=tracer)
        for x in rows(5):
            server.submit(x)
        server.drain()
        assert tracer.spans() == []
    server = SparseServer(plans, tracer=Tracer(enabled=False)).start()
    try:
        rid = server.submit(rows(1)[0])
        assert server.wait(rid, timeout=WAIT_S) is not None
    finally:
        server.shutdown(drain=True, drain_timeout_s=WAIT_S)
    assert made == {"span": 0, "record_function": 0, "event": 0}
    assert trace.totals() == {"spans": {}, "counters": {}}


def test_counters_add_to_the_totals_and_every_open_span():
    from repro_torch.obs import Tracer, trace

    trace.reset_totals()
    trace.count("syncs")                          # inactive: nothing
    tracer = Tracer()
    with tracer.span("batch.execute") as outer:
        with trace.span("bucket.fetch") as inner:
            trace.count("syncs")
        trace.count("syncs", 2)
    assert outer.recording and inner.recording
    assert trace.totals()["counters"] == {"syncs": 3}
    got = {s.name: s.attrs for s in tracer.spans()}
    assert got == {"batch.execute": {"syncs": 3}, "bucket.fetch": {"syncs": 1}}


def test_router_reports_the_totals_once(plans):
    from repro_torch.obs import Tracer, render_prometheus, trace

    trace.reset_totals()
    clock = FakeClock()
    router = ModelRouter({"a": plans, "b": plans}, clock=clock,
                         tracer=Tracer(clock=clock))
    for name in ("a", "b"):
        for x in rows(2):
            router.submit(name, x)
    router.drain()
    snap = router.snapshot()
    assert snap["tracer"]["totals"]["spans"]["batch.execute"]["count"] == 2
    assert all("totals" not in m["tracer"] for m in snap["models"].values())
    text = render_prometheus(snap)
    name = "repro_tracer_totals_spans_batch_execute_count"
    assert f"\n{name} 2\n" in text and name + "{" not in text
    alone = SparseServer(plans, clock=clock, tracer=Tracer(clock=clock))
    assert alone.snapshot()["tracer"]["totals"] == trace.totals()


def test_enabled_tracer_export_keeps_every_request(plans, tmp_path):
    from repro_torch.obs import Tracer

    clock = FakeClock()
    tracer = Tracer(clock=clock)
    server = SparseServer(plans, clock=clock, tracer=tracer, max_queue=6)
    appends = []
    record = tracer._record
    tracer._record = lambda rec: (appends.append(rec), record(rec))
    admitted, rejected = [], 0
    for k, n in enumerate((3, 8, 1, 5)):
        for x in rows(n, seed=k):
            rid = server.submit(x)
            if rid is None:
                rejected += 1
            else:
                admitted.append(rid)
        clock.advance(0.01)
        server.drain()
    assert rejected == 2
    batches = server.metrics.batches
    # one ring append per batch, one per bucket's io.plan, one per rejection
    n_io = len(server._io_seen)
    assert len(appends) == batches + n_io + rejected
    events = tracer.to_chrome()["traceEvents"]
    json.loads(json.dumps(events))
    by = {}
    for e in events:
        by.setdefault(e["name"], []).append(e)
    assert sorted(e["args"]["rid"] for e in by["request.queue"]) == admitted
    assert all(e["ph"] == "X" for e in by["request.queue"])
    assert sorted(e["args"]["rid"] for e in by["request.done"]) == admitted
    submits = by["request.submit"]
    assert sorted(e["args"]["rid"] for e in submits
                  if e["args"]["admitted"]) == admitted
    assert sum(not e["args"]["admitted"] for e in submits) == rejected
    assert len(by["batch.execute"]) == batches
    assert [e["ts"] for e in events] == sorted(e["ts"] for e in events)
    snap = server.snapshot()["tracer"]
    assert snap["recorded"] == len(events) and snap["dropped"] == 0
    assert snap["totals"]["spans"]["batch.execute"]["count"] >= batches
    lines = open(tracer.export(str(tmp_path / "t.jsonl"))).read().splitlines()
    assert len(lines) == len(events)


@pytest.mark.stress
def test_totals_and_ring_lose_no_update_across_threads():
    import sys

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import Tracer, trace

    threads, spans_each = 12, 300
    tracer = Tracer(capacity=10 ** 6)
    go = threading.Barrier(threads)

    def work(i):
        go.wait(timeout=WAIT_S)
        for k in range(spans_each):
            # alternately the profiler sink alone and an enabled ring
            with (trace.span("x.sink") if k % 2 else
                  tracer.span("x.ring", i=i)):
                with trace.span("x.kid"):
                    trace.count("n")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    trace.reset_totals()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            ts = [threading.Thread(target=work, args=(i,))
                  for i in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=WAIT_S)
            assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    half = threads * spans_each // 2
    got = trace.totals()
    assert {k: v["count"] for k, v in got["spans"].items()} == \
        {"x.sink": half, "x.ring": half, "x.kid": 2 * half}
    assert got["counters"] == {"n": 2 * half}
    spans = tracer.spans()
    assert tracer.recorded == len(spans) == 2 * half
    ring = [s for s in spans if s.name == "x.ring"]
    assert len(ring) == half and all(s.attrs["n"] == 1 for s in ring)
