"""Serve a language model, or the paper's sparse-FFNN workload, on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b
    PYTHONPATH=src python -m repro_torch.launch.serve --sparse-ffnn

Without ``--sparse-ffnn`` it serves ``--arch`` (any registered
architecture; ``--reduced`` is always on, as in the reference's CLI) with
random weights from seed 0, in f32: ``--requests`` prompts of
``--prompt-len`` tokens drawn from ``np.random.default_rng(0)``, served
``--batch`` at a time (continuous batching slots), each prefilled and then
decoded greedily for ``--gen`` tokens.  No hand-written kernel lies on that
path: its products are PyTorch's, as the reference's are ``jnp``'s.

Feature vectors go through a block-magnitude-pruned sparse FFNN — by default
the paper's BERT-large encoder FFNN, 1024 -> 4096 -> 1024, density 0.1,
128x128 tiles, gelu hidden epilogue, Connection Reordering at 300
iterations — compiled once by the engine (or rebuilt from the plan store
with ``--plan-store DIR``, which skips the annealing), fanned out across
power-of-two batch buckets, and served by the wait-or-fire scheduler.
Every forward is one ``bsr_megakernel`` launch; ``--no-fuse`` runs one
``bsr_matmul`` launch per layer instead.  ``--gate`` compiles with runtime
tile-occupancy gating (each forward is one launch of the gated
megakernel), samples the measured dynamic I/O of every batch into the
server's ``IOTelemetry``, and prints the dynamic I/O report of one batch
after serving.  ``--mesh MODELxDATA`` serves a sharded plan instead: the
net's output tiles split over MODEL shards, each with its own schedule, the
batch padded to a multiple of DATA, one ``bsr_matmul`` launch per shard and
layer in a loop on the one card.  ``--device cpu`` runs the kernels' plain
versions on the CPU.

The serving runtime is the reference's:

  * ``--async`` serves through the background scheduler thread (real
    clock, graceful SIGTERM drain); ``--workers N`` runs it as a staged
    pipeline (formation -> per-bucket dispatch lanes -> an N-worker
    executor pool);
  * ``--models K`` serves K differently-pruned variants through one
    ``ModelRouter``;
  * ``--retries``, ``--batch-timeout-ms`` and ``--breaker K`` (degrading to
    the safe twin: per-layer ungated ``bsr_matmul`` launches) contain
    failing batches; ``--safe-mode`` serves that twin directly (plain
    PyTorch only ever runs when ``--backend torch`` asks for it);
  * ``--http-port P`` (implies ``--async``) opens the JSON front door and
    drives the load through ``--http-clients`` real HTTP clients;
  * ``--metrics-port P`` exposes the Prometheus endpoint; ``--trace-out``
    writes the request lifecycle as a Chrome trace.

Port of ``repro.launch.serve``; the same request stream comes from the
same numpy seed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import signal
import threading
import time
import urllib.error
import urllib.request
from collections import Counter, deque
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config, reduced
from ..core.blocksparse import BSRLayer
from ..engine import Engine, Mesh
from ..models import encdec, lm
from ..models.config import ModelConfig
from ..obs import MetricsServer, Tracer
from ..serving import (
    BucketedPlanSet,
    CircuitBreaker,
    HttpFrontDoor,
    ModelRouter,
    PlanStore,
    RetryPolicy,
    SparseServer,
)
from ..sparse import prune_dense_stack
from .steps import make_serve_step

Runtime = Union[SparseServer, ModelRouter]
# how long the driver waits for one answer, or for the drain at the end, in
# async mode
_WAIT_S = 60.0


def make_ffnn_layers(sizes: Sequence[int], density: float, block: int,
                     seed: int = 0) -> List[BSRLayer]:
    """The served net: random dense layers from ``seed``, block-pruned."""
    rng = np.random.default_rng(seed)
    ws = [rng.standard_normal((sizes[i], sizes[i + 1])).astype(np.float32) * 0.03
          for i in range(len(sizes) - 1)]
    bs = [np.zeros(s, np.float32) for s in sizes[1:]]
    return prune_dense_stack(ws, bs, density=density,
                             block_m=block, block_n=block)


@dataclasses.dataclass
class ServeReport:
    """What one serving run did: the requests, their answers, the runtime.

    Requests are keyed by rid, by ``(model, rid)`` with ``--models > 1``,
    or by the client's request index over HTTP.
    """

    server: Runtime
    inputs: Dict[object, np.ndarray]
    outputs: Dict[object, Optional[np.ndarray]]
    forwards: int                              # plan forwards of this run
    http_codes: Dict[int, int] = dataclasses.field(default_factory=dict)


def _engine(args, tracer) -> Engine:
    return Engine(backend=args.backend, activation="gelu", reorder=True,
                  reorder_iters=args.reorder_iters, fuse=not args.no_fuse,
                  gate=args.gate, weight_dtype=args.weight_dtype,
                  device=args.device, tracer=tracer)


def _resilience(args):
    """``(retry, breaker factory)`` from the flags.  A breaker needs the
    safe twin to degrade to; ``--safe-mode`` serves the twin itself, so a
    breaker is moot there."""
    retry = None
    if args.retries > 0 or args.batch_timeout_ms is not None:
        retry = RetryPolicy(
            max_retries=args.retries,
            timeout_s=(args.batch_timeout_ms / 1e3
                       if args.batch_timeout_ms is not None else None))
    breaker = None
    if args.breaker > 0 and not args.safe_mode:
        def breaker():
            return CircuitBreaker(threshold=args.breaker,
                                  cooldown_s=args.breaker_cooldown_ms / 1e3)
    return retry, breaker


def _settings(args):
    """Engine, plan store, tracer and mesh of one run."""
    tracer = Tracer() if args.trace_out else None
    store = (PlanStore(args.plan_store, tracer=tracer)
             if args.plan_store else None)
    mesh = Mesh.parse(args.mesh) if args.mesh else None
    return _engine(args, tracer), store, tracer, mesh


def build_server(args) -> Tuple[BucketedPlanSet, SparseServer]:
    """Compile the net (or hit the plan store) into a warmed bucketed plan
    set and its server."""
    engine, store, tracer, mesh = _settings(args)
    retry, breaker = _resilience(args)
    layers = make_ffnn_layers(args.ffnn_sizes, args.density, args.block)
    t0 = time.time()
    plans = BucketedPlanSet.compile(layers, engine=engine,
                                    max_batch=args.batch, plan_store=store,
                                    mesh=mesh, safe_twin=breaker is not None)
    start = "warm (plan-store hit)" if plans.cache_hit else "cold"
    print(f"engine compile: {time.time() - t0:.1f}s [{start}] — "
          f"{plans.describe()}")
    if args.safe_mode:
        # the degraded path as the primary: per layer, gate off, same
        # backend — the route the breaker would swap to
        plans = plans.build_safe_twin()
        print(f"safe mode: {plans.describe()}")
    plans.warmup()
    # gating makes the measured dynamic-I/O path available: sample every
    # batch into the server's I/O telemetry
    server = SparseServer(
        plans, max_queue=args.max_queue, slo_ms=args.slo_ms, engine=engine,
        plan_store=store, backend=args.backend, mesh=mesh, retry=retry,
        breaker=breaker() if breaker is not None else None, tracer=tracer,
        measure_dynamic_every=1 if args.gate else 0,
        executor_workers=args.workers)
    return plans, server


def build_router(args) -> ModelRouter:
    """``--models K``: K differently-pruned variants of the net (seeds
    0..K-1), one compile or store hit each, behind one shared scheduler."""
    if args.safe_mode:
        raise SystemExit("--safe-mode is single-model only; use --breaker "
                         "to degrade per model instead")
    engine, store, tracer, mesh = _settings(args)
    retry, breaker = _resilience(args)
    nets = {f"m{k}": make_ffnn_layers(args.ffnn_sizes, args.density,
                                      args.block, seed=k)
            for k in range(args.models)}
    router = ModelRouter.compile(
        nets, engine=engine, max_batch=args.batch, plan_store=store,
        backend=args.backend,
        meshes={name: mesh for name in nets} if mesh else None,
        breaker=breaker, max_queue=args.max_queue,
        slo_ms=args.slo_ms, retry=retry, tracer=tracer,
        measure_dynamic_every=1 if args.gate else 0,
        executor_workers=args.workers)
    for name, srv in router.servers.items():
        print(f"[{name}] {srv.plans.describe()}")
    return router


def _plan_sets(runtime: Runtime) -> List[BucketedPlanSet]:
    if isinstance(runtime, ModelRouter):
        return [s.plans for s in runtime.servers.values()]
    return [runtime.plans]


def _calls(runtime: Runtime) -> int:
    return sum(sum(p.bucket_calls.values()) for p in _plan_sets(runtime))


def drive(runtime: Runtime, args, stop: Optional[dict] = None
          ) -> ServeReport:
    """Submit ``args.requests`` rows in random bursts and collect every
    answer.  Step-driven, the caller polls between bursts so the wait-or-
    fire policy forms mixed batch sizes, then drains; with ``--async`` the
    scheduler forms the batches and each answer is waited for.  Requests
    go round-robin over a router's models.  ``stop["flag"]`` (set by a
    signal) ends the submitting early."""
    multi = isinstance(runtime, ModelRouter)
    names = list(runtime.servers) if multi else [None]
    n_in = _plan_sets(runtime)[0].n_in
    rng = np.random.default_rng(0)
    calls0 = _calls(runtime)
    inputs: Dict[object, np.ndarray] = {}
    pending = args.requests
    while pending and not (stop and stop["flag"]):
        burst = int(rng.integers(1, args.batch + 1))
        for _ in range(min(burst, pending)):
            x = rng.standard_normal(n_in).astype(np.float32)
            if multi:
                name = names[len(inputs) % len(names)]
                rid = runtime.submit(name, x)
                key = (name, rid)
            else:
                rid = key = runtime.submit(x)
            if rid is not None:
                inputs[key] = x
            pending -= 1
        if not args.async_mode:
            runtime.poll()
    if args.async_mode:
        outputs = {key: (runtime.wait(*key, timeout=_WAIT_S) if multi
                         else runtime.wait(key, timeout=_WAIT_S))
                   for key in inputs}
    else:
        runtime.drain()
        outputs = {key: (runtime.result(*key) if multi
                         else runtime.result(key)) for key in inputs}
    return ServeReport(server=runtime, inputs=inputs, outputs=outputs,
                       forwards=_calls(runtime) - calls0)


def drive_http(front: HttpFrontDoor, runtime: Runtime, args,
               stop: Optional[dict] = None) -> ServeReport:
    """Drive ``args.requests`` rows through the front door from
    ``args.http_clients`` client threads (stdlib urllib).  A 429 (queue
    full) backs off per ``Retry-After`` and sends the same row again, so
    admission control shapes the load without losing requests."""
    multi = isinstance(runtime, ModelRouter)
    names = list(runtime.servers) if multi else [None]
    n_in = _plan_sets(runtime)[0].n_in
    rng = np.random.default_rng(0)
    calls0 = _calls(runtime)
    rows = [rng.standard_normal(n_in).astype(np.float32)
            for _ in range(args.requests)]
    work = deque(range(args.requests))
    outputs: Dict[object, Optional[np.ndarray]] = {}
    counts: Counter = Counter()
    lock = threading.Lock()

    def client() -> None:
        while not (stop and stop["flag"]):
            with lock:
                if not work:
                    return
                i = work.popleft()
            body = {"x": rows[i].tolist()}
            if multi:
                body["model"] = names[i % len(names)]
            req = urllib.request.Request(
                front.url + "/v1/infer", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"}, method="POST")
            retry_after, y = None, None
            try:
                with urllib.request.urlopen(req, timeout=_WAIT_S) as resp:
                    code = resp.status
                    y = np.asarray(json.loads(resp.read())["y"], np.float32)
            except urllib.error.HTTPError as e:
                code = e.code
                retry_after = e.headers.get("Retry-After")
                e.read()
            except OSError:
                code = -1
            with lock:
                counts[code] += 1
                if code != 429:
                    outputs[i] = y
            if code == 429:
                time.sleep(float(retry_after or 0.05))
                with lock:
                    work.appendleft(i)

    threads = [threading.Thread(target=client, name=f"http-client-{i}")
               for i in range(args.http_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return ServeReport(server=runtime,
                       inputs={i: rows[i] for i in outputs},
                       outputs=outputs, forwards=_calls(runtime) - calls0,
                       http_codes=dict(counts))


def _scrape(url: str) -> None:
    """Read the metrics endpoint once and print what it says."""
    with urllib.request.urlopen(url, timeout=5) as resp:
        lines = resp.read().decode("utf-8").splitlines()
    print(f"metrics scrape: {len(lines)} lines from {url}")
    for ln in lines[:8]:
        print(f"  {ln}")
    for ln in lines:
        if "_io_" in ln and not ln.startswith("#"):
            print(f"  {ln}")


def serve_sparse_ffnn(args) -> ServeReport:
    """Build, serve and report — what ``--sparse-ffnn`` runs.

    SIGTERM and SIGINT (when called from the main thread) stop the
    submitting; everything already queued is served before the run ends.
    """
    if args.http_port is not None:
        args.async_mode = True      # the front door needs a live scheduler
    multi = args.models > 1
    if multi:
        runtime = build_router(args)
        plans = None
    else:
        plans, runtime = build_server(args)
    tracer = next(iter(runtime.servers.values())).tracer if multi \
        else runtime.tracer
    stop = {"flag": False}
    handlers = {}
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            handlers[sig] = signal.signal(
                sig, lambda signum, frame: stop.update(flag=True))
    metrics_srv = front = None
    try:
        if args.metrics_port is not None:
            metrics_srv = MetricsServer(runtime.snapshot,
                                        port=args.metrics_port).start()
            print(f"metrics endpoint: {metrics_srv.url}")
        if args.async_mode:
            runtime.start()
            print("async scheduler thread started"
                  + (f" (pipeline: {args.workers} executor workers)"
                     if args.workers else ""))
        if args.http_port is not None:
            front = HttpFrontDoor(runtime, port=args.http_port).start()
            print(f"http front door: {front.url}  "
                  "(POST /v1/infer, GET /v1/result/<rid>)")
            report = drive_http(front, runtime, args, stop)
            print(f"http clients done: {dict(sorted(report.http_codes.items()))}"
                  f" over {args.http_clients} connections")
        else:
            report = drive(runtime, args, stop)
        if stop["flag"]:
            print("signal received: draining queued requests ...")
        # the pool snapshot lives until shutdown() releases the pipeline
        pool = runtime.snapshot().get("pool") \
            if args.workers and args.async_mode else None
        if front is not None:
            front.stop()
            front = None
        if args.async_mode:
            if not runtime.shutdown(drain=True, drain_timeout_s=_WAIT_S):
                raise RuntimeError(f"the runtime did not drain and stop "
                                   f"within {_WAIT_S:.0f} s")
        else:
            runtime.drain()
    finally:
        if front is not None:
            front.stop()
        for sig, handler in handlers.items():
            signal.signal(sig, handler)
    if pool is not None:
        per = pool.get("per_worker", {})
        util = {w: round(s.get("utilization", 0.0), 3)
                for w, s in sorted(per.items())}
        print(f"executor pool: {pool.get('workers')} workers, batches="
              f"{ {w: s.get('batches') for w, s in sorted(per.items())} } "
              f"utilization={util}")
    collected = sum(y is not None for y in report.outputs.values())
    if multi:
        served = runtime.metrics_snapshot()["total"]["served"]
        print(f"served {served} requests across {args.models} models "
              f"({collected} collected)")
        print(runtime.summary())
    else:
        server = runtime
        print(f"served {server.metrics.served} sparse-FFNN requests "
              f"({collected} collected) — {server.metrics.summary()}")
        if server.breaker is not None or args.retries > 0 \
                or args.batch_timeout_ms is not None:
            m = server.metrics.snapshot()
            print(f"resilience: retries={m['retries']} "
                  f"timeouts={m['batch_timeouts']} "
                  f"breaker trips={m['breaker_trips']} "
                  f"resets={m['breaker_resets']} "
                  f"degraded batches={m['degraded_batches']}")
        print(f"bucket calls: "
              f"{ {b: n for b, n in plans.bucket_calls.items() if n} }")
        base = plans.base
        if args.gate and getattr(base, "_measure", None) is not None:
            # measured dynamic I/O of one representative batch: how many
            # scheduled weight blocks a demand-driven stream actually read
            rng = np.random.default_rng(1)
            xs = rng.standard_normal((min(args.batch, 8), base.n_in)).astype(
                np.float32)
            print(base.measure_dynamic(xs).summary())
    if metrics_srv is not None:
        # scrape our own endpoint once, so the run exercises the whole
        # exposition path
        _scrape(metrics_srv.url)
        metrics_srv.stop()
    if args.trace_out and tracer is not None:
        path = tracer.export(args.trace_out)
        print(f"trace: {tracer.recorded} spans recorded "
              f"({tracer.dropped} dropped) -> {path}")
    return report


@dataclasses.dataclass
class LMServeReport:
    """What one LM serving run did: each request's generated tokens, in
    the order served, and the run's totals."""

    sequences: List[np.ndarray]
    tokens: int
    seconds: float


def _lm_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "LM serving on device 'cuda' needs a CUDA device and none is "
            "available; pass --device cpu to serve on the CPU")
    return device


def serve_lm(cfg: ModelConfig, args, params=None) -> LMServeReport:
    """The reference's LM serving loop on ``args.device``.

    ``params`` is an ``lm.LM`` / ``encdec.EncDec`` on that device (None:
    random f32 weights from seed 0).  Prompts come from
    ``np.random.default_rng(0)``, all drawn before the first batch; the
    encdec family draws each batch's encoder input (``standard_normal *
    0.05``) from the same generator.  Each batch of up to ``args.batch``
    prompts is prefilled (encdec: encoded, its decoder started from token
    0), its caches grown to ``prompt_len + gen``, then decoded greedily;
    the decode step runs under a 1x1 mesh, so ``moe_impl="a2a"`` configs
    take the one-shard expert-parallel body there, as in the reference.
    """
    device = _lm_device(args.device)
    mod = encdec if cfg.family == "encdec" else lm
    if params is None:
        params = mod.init(torch.Generator(device=device).manual_seed(0), cfg,
                          dtype=torch.float32)
    serve_step = make_serve_step(cfg, Mesh(1, 1))

    rng = np.random.default_rng(0)
    window = args.prompt_len + args.gen
    queue = deque(
        rng.integers(0, cfg.vocab, size=args.prompt_len).astype(np.int32)
        for _ in range(args.requests))
    done: List[np.ndarray] = []
    tokens_out = 0
    t0 = time.perf_counter()
    with torch.inference_mode():
        while queue:
            # fill a batch of slots from the queue (continuous batching)
            slot_prompts = [queue.popleft()
                            for _ in range(min(args.batch, len(queue)))]
            B = len(slot_prompts)
            prompts = torch.from_numpy(np.stack(slot_prompts)).to(device)
            if cfg.family == "encdec":
                enc_in = torch.as_tensor(
                    rng.standard_normal((B, args.prompt_len, cfg.d_model)) * 0.05,
                    dtype=torch.float32).to(device)
                enc_out = encdec.encode(params, cfg, enc_in)
                caches = encdec.make_dec_caches(params, cfg, enc_out,
                                                window=window,
                                                dtype=torch.float32)
                cur = torch.zeros((B, 1), dtype=torch.int32, device=device)
            else:
                logits, caches = lm.prefill(params, cfg, tokens=prompts)
                caches = lm.grow_caches(cfg, caches, window)
                cur = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            outs = [cur]
            for _ in range(args.gen - 1):
                cur, caches = serve_step(params, caches, cur)
                outs.append(cur)
            gen = torch.cat(outs, dim=1).cpu().numpy()
            tokens_out += gen.size
            done.extend(list(gen))
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} served {len(done)} sequences, "
          f"{tokens_out} tokens in {dt:.2f}s "
          f"({tokens_out / max(dt, 1e-9):.1f} tok/s greedy)")
    print("sample:", done[0][:16].tolist() if done else "none")
    return LMServeReport(sequences=done, tokens=tokens_out, seconds=dt)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="mamba2-1.3b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--sparse-ffnn", action="store_true",
                    help="serve the paper's sparse-FFNN workload via the "
                         "fused inference engine instead of an LM")
    ap.add_argument("--async", dest="async_mode", action="store_true",
                    help="drive the serving loop from a background "
                         "scheduler thread (real clock) instead of the "
                         "step-driven caller loop; SIGTERM drains gracefully")
    ap.add_argument("--models", type=int, default=1,
                    help="serve N differently-pruned model variants from "
                         "one process through a shared-scheduler ModelRouter")
    ap.add_argument("--ffnn-sizes", type=int, nargs="+",
                    default=[1024, 4096, 1024])
    ap.add_argument("--density", type=float, default=0.1)
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--reorder-iters", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4,
                    help="largest batch the scheduler forms (top bucket); "
                         "LM: prompts served together")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--no-fuse", action="store_true",
                    help="serve with per-layer dispatch (one bsr_matmul "
                         "launch per layer) instead of the megakernel")
    ap.add_argument("--gate", action="store_true",
                    help="runtime tile-occupancy gating: skip weight blocks "
                         "whose input tile is all-zero for the batch "
                         "(bit-exact; prints the measured dynamic I/O report "
                         "after serving)")
    ap.add_argument("--mesh", default=None, metavar="MODELxDATA",
                    help="serve through a sharded execution plan, e.g. 4x2 "
                         "= 4 model shards x 2 data replicas, run as a loop "
                         "over the shards on the one device (one bsr_matmul "
                         "launch per shard and layer)")
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "kernel", "torch"),
                    help="kernel (= auto) runs the CUDA kernels; torch the "
                         "plain segment lowering (the safe twin's path)")
    ap.add_argument("--weight-dtype", default="f32",
                    choices=("f32", "bf16", "fp8"),
                    help="storage dtype of the streamed weight blocks "
                         "(bf16/fp8: one f32 scale per block, dequantized "
                         "in the kernel)")
    ap.add_argument("--plan-store", default=None,
                    help="directory of the persistent plan cache; a warm "
                         "start skips the annealing cost entirely")
    ap.add_argument("--slo-ms", type=float, default=50.0,
                    help="target end-to-end latency SLO of the scheduler")
    ap.add_argument("--max-queue", type=int, default=1024,
                    help="admission bound of the serving queue")
    ap.add_argument("--safe-mode", action="store_true",
                    help="serve the plan's safe-mode twin directly (per-"
                         "layer bsr_matmul, gating off — the forward the "
                         "circuit breaker degrades to, as the primary)")
    ap.add_argument("--breaker", type=int, default=0, metavar="K",
                    help="arm a circuit breaker: K consecutive batch "
                         "failures/timeouts degrade to the precompiled "
                         "safe-mode twin, half-opening back after the "
                         "cool-down (0 = off)")
    ap.add_argument("--breaker-cooldown-ms", type=float, default=1000.0,
                    help="circuit-breaker cool-down before probing the "
                         "fast plan again")
    ap.add_argument("--retries", type=int, default=0,
                    help="bounded per-batch retry attempts (with "
                         "exponential backoff) before a batch fails")
    ap.add_argument("--batch-timeout-ms", type=float, default=None,
                    help="wall-clock bound on one batch execution attempt; "
                         "a hung attempt is abandoned and counted (and "
                         "retried under --retries)")
    ap.add_argument("--workers", type=int, default=0, metavar="N",
                    help="execution-stage worker pool size: the async "
                         "scheduler becomes a staged pipeline (formation "
                         "-> per-bucket dispatch lanes -> N workers); 0 "
                         "keeps the single-threaded scheduler")
    ap.add_argument("--http-port", type=int, default=None, metavar="P",
                    help="open the JSON front door on this port (0 = "
                         "ephemeral) and drive the request load through "
                         "real HTTP clients; queue-full admission becomes "
                         "429 + Retry-After (implies --async)")
    ap.add_argument("--http-clients", type=int, default=4,
                    help="concurrent HTTP client connections used by "
                         "--http-port to drive the load")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="P",
                    help="expose a Prometheus text endpoint (/metrics) on "
                         "this port with the live serving snapshot (0 = "
                         "ephemeral port)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record request/compile/breaker spans and write a "
                         "Chrome-trace JSON (.jsonl for line-delimited "
                         "spans) on exit")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda runs the CUDA kernels; cpu their plain "
                         "versions (LM: the device that serves)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    if args.sparse_ffnn:
        serve_sparse_ffnn(args)
        return
    cfg = get_config(args.arch)
    serve_lm(reduced(cfg) if args.reduced else cfg, args)


if __name__ == "__main__":
    main()
