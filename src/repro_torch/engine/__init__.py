"""Fused multi-layer sparse inference engine (compile once, run many).

    from repro_torch.engine import Engine

    plan = Engine(reorder=True).compile(layers)   # on "cuda" by default
    y = plan(x)
    print(plan.describe())

    sharded = Engine().compile(layers, mesh=Mesh(model=4, data=2))
    y = sharded(x)                      # same function, partitioned
    print(sharded.io_report().summary())
"""

from .backends import (
    BACKENDS,
    activations_equal,
    make_forward,
    make_fused_forward,
    make_fused_measure,
    make_sharded_forward,
    resolve_backend,
    tile_occupancy,
)
from .engine import ACTIVATIONS, Engine
from .plan import DynamicIOReport, ExecutionPlan, IOReport
from .sharding import (
    Mesh,
    ShardedExecutionPlan,
    ShardedIOReport,
    partition_model,
)

__all__ = [
    "ACTIVATIONS",
    "BACKENDS",
    "DynamicIOReport",
    "Engine",
    "ExecutionPlan",
    "IOReport",
    "Mesh",
    "ShardedExecutionPlan",
    "ShardedIOReport",
    "activations_equal",
    "make_forward",
    "make_fused_forward",
    "make_fused_measure",
    "make_sharded_forward",
    "partition_model",
    "resolve_backend",
    "tile_occupancy",
]
