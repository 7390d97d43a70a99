"""Observability substrate of the port: spans, bounded series, I/O telemetry.

``trace``, ``series`` and ``telemetry`` are verbatim copies of
``repro.obs.trace``, ``repro.obs.series`` and ``repro.obs.telemetry``
(stdlib and numpy only).  Prometheus exposition is not ported yet.
"""

from .series import BoundedSeries
from .telemetry import OCC_BINS, IOTelemetry, plan_io_attrs
from .trace import NULL_TRACER, Span, Tracer

__all__ = ["BoundedSeries", "IOTelemetry", "NULL_TRACER", "OCC_BINS", "Span",
           "Tracer", "plan_io_attrs"]
