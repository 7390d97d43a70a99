"""End-to-end serving, on the PyTorch/CUDA port (twin of
``examples/serve_sparse.py``): serve a magnitude-pruned BERT-style FFNN
through the continuous-batching serving runtime (the paper's deployment
scenario: sparse FFNN inference under sustained request traffic).

    PYTHONPATH=src python examples/serve_sparse_torch.py [--requests 64] [--density 0.1]

A request = one feature vector through the pruned 1024-4096-1024 FFNN (the
BERT encoder MLP the paper targets).  The whole network is compiled ONCE
(Theorem-1 ordered and CR-optimized offline) — or restored from a persistent
plan store with ``--plan-store DIR``, skipping the annealing entirely on the
second run — and fanned out across power-of-two batch buckets.  Requests
arrive in bursts; the SLO scheduler forms batches wait-or-fire and routes
each through the smallest bucket that fits, so tail batches don't pay
full-batch latency.  The plan's exact simulated I/O is reported next to the
Theorem-1 bounds alongside the serving metrics.

``--http`` serves the same traffic over the wire: the process opens the
stdlib JSON front door (``HttpFrontDoor``) and the client threads become
real HTTP clients (``urllib`` — no new dependencies) POSTing to
``/v1/infer``; a 429 (queue full) backs off and retries.  Combine with
``--workers N`` to run the staged pipeline behind the front door:

    PYTHONPATH=src python examples/serve_sparse_torch.py --http --workers 2

Every forward runs on ``--device`` (``cuda`` unless given): on the card one
launch of the hand-written CUDA megakernel per batch; with ``--device cpu``
its plain PyTorch version.
"""

import argparse
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from repro_torch.engine import Engine
from repro_torch.serving import (
    BucketedPlanSet,
    HttpFrontDoor,
    PlanStore,
    SparseServer,
)
from repro_torch.sparse import prune_dense_stack


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--density", type=float, default=0.1)
    ap.add_argument("--reorder-iters", type=int, default=500)
    ap.add_argument("--slo-ms", type=float, default=50.0)
    ap.add_argument("--threads", type=int, default=0,
                    help="> 0: serve through the async scheduler thread "
                         "with this many concurrent client threads "
                         "(Future-style wait per request); 0 = the "
                         "deterministic step-driven loop")
    ap.add_argument("--http", action="store_true",
                    help="serve over HTTP: open the JSON front door on an "
                         "ephemeral port and drive the clients through "
                         "urllib POSTs to /v1/infer (implies async mode; "
                         "uses --threads connections, default 4)")
    ap.add_argument("--workers", type=int, default=0,
                    help="> 0: staged pipeline — the scheduler only forms "
                         "batches onto per-bucket dispatch lanes and this "
                         "many executor workers drain them concurrently")
    ap.add_argument("--plan-store", default=None,
                    help="persistent plan cache directory; rerun with the "
                         "same dir for a warm start with zero annealing")
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "kernel", "torch"))
    ap.add_argument("--device", default="cuda",
                    help="where plans run (cuda raises without a card)")
    args = ap.parse_args()

    rng = np.random.default_rng(0)
    w1 = rng.standard_normal((1024, 4096)).astype(np.float32) * 0.03
    w2 = rng.standard_normal((4096, 1024)).astype(np.float32) * 0.03
    b1 = np.zeros(4096, np.float32)
    b2 = np.zeros(1024, np.float32)

    print(f"pruning BERT FFNN to density {args.density} ...")
    layers = prune_dense_stack([w1, w2], [b1, b2], density=args.density,
                               block_m=128, block_n=128)
    engine = Engine(backend=args.backend, activation="gelu",
                    reorder=True, reorder_iters=args.reorder_iters,
                    device=args.device)
    store = PlanStore(args.plan_store) if args.plan_store else None
    t0 = time.time()
    plans = BucketedPlanSet.compile(layers, engine=engine,
                                    max_batch=args.batch, plan_store=store)
    start = "warm start (plan-store hit, zero annealer iters)" \
        if plans.cache_hit else "cold compile (schedule + CR + lowering)"
    print(f"{start}: {time.time()-t0:.1f}s")
    print(plans.describe())
    plans.warmup()

    # bursty request traffic — the wait-or-fire scheduler forms batches and
    # the bucket router serves each through the smallest bucket that fits
    server = SparseServer(plans, slo_ms=args.slo_ms, engine=engine,
                          plan_store=store, executor_workers=args.workers)
    rids = []
    if args.http:
        # over-the-wire mode: same traffic, but each client thread is a
        # real HTTP connection into the front door; admission control
        # arrives as status codes (429 = queue full -> back off + retry)
        server.start()
        front = HttpFrontDoor(server, port=0).start()
        nclients = args.threads or 4
        print(f"http front door: {front.url} ({nclients} client threads"
              + (f", {args.workers} executor workers" if args.workers
                 else "") + ")")
        codes = {}
        samples = []
        lock = threading.Lock()

        def http_client(n, seed):
            crng = np.random.default_rng(seed)
            done = 0
            while done < n:
                x = crng.standard_normal(1024).astype(np.float32)
                req = urllib.request.Request(
                    front.url + "/v1/infer",
                    data=json.dumps({"x": x.tolist()}).encode("utf-8"),
                    headers={"Content-Type": "application/json"},
                    method="POST")
                retry_after = None
                try:
                    with urllib.request.urlopen(req, timeout=60) as resp:
                        code, payload = resp.status, json.load(resp)
                except urllib.error.HTTPError as e:
                    code = e.code
                    retry_after = e.headers.get("Retry-After")
                    payload = {}
                    e.read()
                with lock:
                    codes[code] = codes.get(code, 0) + 1
                if code == 429:          # queue full: back off, same request
                    time.sleep(float(retry_after or 0.05))
                    continue
                if code == 200:
                    with lock:
                        samples.append(payload["y"])
                done += 1

        per = args.requests // nclients
        ts = [threading.Thread(
                  target=http_client,
                  args=(per + (i < args.requests % nclients), 100 + i))
              for i in range(nclients)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        front.stop()
        server.shutdown()
        print(f"http status codes: {dict(sorted(codes.items()))}")
        y = np.asarray(samples[-1], np.float32) if samples else None
    elif args.threads > 0:
        # async mode: the scheduler thread forms batches while concurrent
        # clients submit and block on their own results (Future-style)
        server.start()
        outs = {}

        def client(n, seed):
            crng = np.random.default_rng(seed)   # per-thread generator
            for _ in range(n):
                rid = server.submit(
                    crng.standard_normal(1024).astype(np.float32))
                if rid is not None:
                    rids.append(rid)
                    outs[rid] = server.wait(rid, timeout=30.0)

        per = args.requests // args.threads
        ts = [threading.Thread(
                  target=client,
                  args=(per + (i < args.requests % args.threads), 100 + i))
              for i in range(args.threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        server.shutdown()
        y = outs[rids[-1]]
    else:
        pending = args.requests
        while pending:
            burst = min(int(rng.integers(1, args.batch + 1)), pending)
            for _ in range(burst):
                rid = server.submit(
                    rng.standard_normal(1024).astype(np.float32))
                if rid is not None:
                    rids.append(rid)
            pending -= burst
            server.poll()
        server.drain()
        y = server.result(rids[-1])
    print(server.metrics.summary())
    print(f"bucket calls: { {b: n for b, n in plans.bucket_calls.items() if n} }")
    if y is None:   # timed out waiting, or the uncollected result was evicted
        print("output sample: <not collected>")
    else:
        print("output sample:", np.asarray(y[:4]).round(3).tolist())


if __name__ == "__main__":
    main()
