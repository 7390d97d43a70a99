"""Observability substrate of the port: the span recorder and bounded series.

Both modules are verbatim copies of ``repro.obs.trace`` and
``repro.obs.series`` (stdlib and numpy only).  Telemetry and Prometheus
exposition are not ported yet.
"""

from .series import BoundedSeries
from .trace import NULL_TRACER, Span, Tracer

__all__ = ["BoundedSeries", "NULL_TRACER", "Span", "Tracer"]
