"""Fused multi-layer sparse inference engine (compile once, run many).

    from repro_torch.engine import Engine

    plan = Engine(reorder=True).compile(layers)   # on "cuda" by default
    y = plan(x)
    print(plan.describe())
"""

from .backends import (
    BACKENDS,
    activations_equal,
    make_forward,
    make_fused_forward,
    make_fused_measure,
    resolve_backend,
    tile_occupancy,
)
from .engine import ACTIVATIONS, Engine
from .plan import DynamicIOReport, ExecutionPlan, IOReport

__all__ = [
    "ACTIVATIONS",
    "BACKENDS",
    "DynamicIOReport",
    "Engine",
    "ExecutionPlan",
    "IOReport",
    "activations_equal",
    "make_forward",
    "make_fused_forward",
    "make_fused_measure",
    "resolve_backend",
    "tile_occupancy",
]
