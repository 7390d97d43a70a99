"""Continuous-batching serving runtime over compiled execution plans.

Port of ``repro.serving``, the production-shaped half of the paper's
compile-once/run-many split:

    from repro_torch.serving import BucketedPlanSet, PlanStore, SparseServer

    store = PlanStore("plans/")                       # persistent plan cache
    plans = BucketedPlanSet.compile(layers, engine=engine,
                                    max_batch=32, plan_store=store)
    server = SparseServer(plans, slo_ms=50.0, engine=engine,
                          plan_store=store)
    server.start()                                    # async scheduler thread
    rid = server.submit(x)                            # admission + queueing
    y = server.wait(rid)                              # Future-style result
    server.swap(new_layers)                           # plan hot-swap
    server.shutdown()                                 # drain + join
    print(server.metrics.summary())

Step-driven mode (no ``start()``: drive ``poll()``/``drain()`` yourself,
collect with ``result(rid)``) is the deterministic test path;
``ModelRouter`` serves several named plan sets through one shared
scheduler.  With ``executor_workers=N`` the async mode runs as a staged
pipeline — HTTP ingress (:class:`HttpFrontDoor`) -> batch formation ->
per-bucket dispatch lanes (:class:`DispatchQueues`) -> a bounded
:class:`ExecutorPool`.  ``resilience`` and ``http`` are verbatim copies of
the reference's modules (stdlib and numpy only).
"""

from .bucketing import (
    BucketedPlanSet,
    DispatchQueues,
    FormedBatch,
    bucket_sizes,
)
from .http import HttpFrontDoor
from .metrics import ServingMetrics, percentile
from .plancache import PlanStore, layers_fingerprint, plan_cache_key
from .resilience import (
    BatchTimeoutError,
    CircuitBreaker,
    FaultInjector,
    OutputGuardError,
    RetryPolicy,
    Watchdog,
)
from .server import (
    ExecutorPool,
    ModelRouter,
    Request,
    SparseServer,
    SwapHandle,
)

__all__ = [
    "BatchTimeoutError",
    "BucketedPlanSet",
    "CircuitBreaker",
    "DispatchQueues",
    "ExecutorPool",
    "FaultInjector",
    "FormedBatch",
    "HttpFrontDoor",
    "ModelRouter",
    "OutputGuardError",
    "PlanStore",
    "Request",
    "RetryPolicy",
    "ServingMetrics",
    "SparseServer",
    "SwapHandle",
    "Watchdog",
    "bucket_sizes",
    "layers_fingerprint",
    "percentile",
    "plan_cache_key",
]
