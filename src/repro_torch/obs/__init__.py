"""Observability substrate of the port: spans, bounded series, I/O telemetry,
Prometheus exposition.

``series``, ``telemetry`` and ``prom`` are verbatim copies of their
``repro.obs`` counterparts (stdlib and numpy only): :class:`BoundedSeries`
keeps capped-memory metric series, :class:`IOTelemetry` the per-bucket I/O
gauges, and :func:`render_prometheus` / :class:`MetricsServer` expose a
serving snapshot as Prometheus text.  ``trace`` keeps the reference's
public API (:class:`Tracer` records spans) and adds to it: tracing is also
active while a ``torch.profiler`` profile collects, each span then opens a
``record_function`` range on the profiler's clock, a process-wide table of
span and counter totals (``trace.totals``), module-level ``trace.span`` and
``trace.count`` for sites with no tracer of their own, and one ring record
per served batch that export expands into each request's spans.
"""

from .prom import MetricsServer, render_prometheus
from .series import BoundedSeries
from .telemetry import OCC_BINS, IOTelemetry, plan_io_attrs
from .trace import NULL_TRACER, Span, Tracer

__all__ = ["BoundedSeries", "IOTelemetry", "MetricsServer", "NULL_TRACER",
           "OCC_BINS", "Span", "Tracer", "plan_io_attrs",
           "render_prometheus"]
