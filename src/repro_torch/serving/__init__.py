"""Step-driven serving over compiled execution plans.

    from repro_torch.serving import BucketedPlanSet, SparseServer

    plans = BucketedPlanSet.compile(layers, engine=engine, max_batch=32)
    plans.warmup()
    server = SparseServer(plans, slo_ms=50.0)
    rid = server.submit(x)
    server.poll()          # fire what the wait-or-fire policy allows
    server.drain()         # serve the rest
    y = server.result(rid)
"""

from .bucketing import BucketedPlanSet, bucket_sizes
from .metrics import ServingMetrics, percentile
from .server import Request, SparseServer

__all__ = [
    "BucketedPlanSet",
    "Request",
    "ServingMetrics",
    "SparseServer",
    "bucket_sizes",
    "percentile",
]
