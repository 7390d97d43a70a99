"""Core library: the paper's contribution (I/O model, bounds, CR, CG, block form).

Paper: "A Theory of I/O-Efficient Sparse Neural Network Inference"
(Gleinig, Ben-Nun, Hoefler — ETH Zürich, 2023).
"""

from .graph import FFNN, from_dense_weights, from_layer_sizes, random_ffnn, relu
from .iosim import IOStats, simulate, simulate_curve
from .bounds import Bounds, theorem1_bounds
from .reorder import ReorderResult, connection_reordering, propose
from .compact_growth import CompactGrown, bandwidth, bandwidth_order, generate
from .blocksparse import (
    BSRLayer,
    BlockFFNN,
    is_contiguous_by_output,
    regroup_by_output,
    schedule_arrays,
    simulated_tile_traffic,
    to_block_ffnn,
    to_bsr,
)

__all__ = [
    "FFNN", "from_dense_weights", "from_layer_sizes", "random_ffnn", "relu",
    "IOStats", "simulate", "simulate_curve",
    "Bounds", "theorem1_bounds",
    "ReorderResult", "connection_reordering", "propose",
    "CompactGrown", "bandwidth", "bandwidth_order", "generate",
    "BSRLayer", "BlockFFNN", "is_contiguous_by_output", "schedule_arrays",
    "simulated_tile_traffic", "to_block_ffnn", "to_bsr",
]
