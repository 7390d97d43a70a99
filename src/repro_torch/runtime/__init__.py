"""Fault tolerance for training: checkpoint/restart and a straggler watch
(port of ``repro.runtime.failure``; gradient compression, elastic
resharding and overlap are not ported)."""

from .failure import FaultInjector, ResilientTrainer, StragglerMonitor

__all__ = ["FaultInjector", "ResilientTrainer", "StragglerMonitor"]
