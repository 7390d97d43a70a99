"""Pruning, the gate/up pair layer and the scheduled sparse FFNN wrapper."""

from .layers import (
    GLULayer,
    ScheduledSparseFFNN,
    pair_mask,
    prune_dense_stack,
    prune_glu_ffn,
)

__all__ = ["GLULayer", "ScheduledSparseFFNN", "pair_mask",
           "prune_dense_stack", "prune_glu_ffn"]
