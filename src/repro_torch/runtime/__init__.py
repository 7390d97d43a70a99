"""Fault tolerance for training (checkpoint/restart, a straggler watch),
elastic resharding, compute/communication overlap and gradient compression
(port of ``repro.runtime``)."""

from .compression import (CompressionState, dequantize_int8, init_compression,
                          quantize_int8, quantized_psum,
                          topk_compress_with_feedback)
from .elastic import reshard_checkpoint, shardings_for
from .failure import FaultInjector, ResilientTrainer, StragglerMonitor
from .overlap import ring_ag_matmul

__all__ = ["CompressionState", "FaultInjector", "ResilientTrainer",
           "StragglerMonitor", "dequantize_int8", "init_compression",
           "quantize_int8", "quantized_psum", "reshard_checkpoint",
           "ring_ag_matmul", "shardings_for", "topk_compress_with_feedback"]
