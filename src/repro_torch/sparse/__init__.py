"""Pruning and the scheduled sparse FFNN wrapper."""

from .layers import ScheduledSparseFFNN, prune_dense_stack

__all__ = ["ScheduledSparseFFNN", "prune_dense_stack"]
