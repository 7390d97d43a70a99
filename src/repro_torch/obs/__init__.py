"""Observability substrate of the port: spans, bounded series, I/O telemetry,
Prometheus exposition.

``trace``, ``series``, ``telemetry`` and ``prom`` are verbatim copies of
their ``repro.obs`` counterparts (stdlib and numpy only):
:class:`Tracer` records spans, :class:`BoundedSeries` keeps capped-memory
metric series, :class:`IOTelemetry` the per-bucket I/O gauges, and
:func:`render_prometheus` / :class:`MetricsServer` expose a serving
snapshot as Prometheus text.
"""

from .prom import MetricsServer, render_prometheus
from .series import BoundedSeries
from .telemetry import OCC_BINS, IOTelemetry, plan_io_attrs
from .trace import NULL_TRACER, Span, Tracer

__all__ = ["BoundedSeries", "IOTelemetry", "MetricsServer", "NULL_TRACER",
           "OCC_BINS", "Span", "Tracer", "plan_io_attrs",
           "render_prometheus"]
