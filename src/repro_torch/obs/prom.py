"""Prometheus text exposition for serving snapshots.

:func:`render_prometheus` flattens the nested snapshot dicts produced by
``SparseServer.snapshot()`` / ``ModelRouter.metrics_snapshot()`` into the
Prometheus text format (version 0.0.4): scalars become gauges, percentile
dicts become quantile-labelled summaries, per-model and per-bucket maps
become labels.  :class:`MetricsServer` serves the rendered text over HTTP
(stdlib ``ThreadingHTTPServer`` — no new dependencies) at ``/metrics``,
plus a ``/healthz`` liveness probe.

Metric names and units are documented in ``docs/observability.md``.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["render_prometheus", "MetricsServer"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")

#: keys answered with ``{quantile=...}`` summary lines
_QUANTILE_KEYS = ("p50", "p99")


def _sanitize(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{str(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class _Samples:
    """Samples grouped by metric name (the text format requires each
    name's samples contiguous, after its ``# TYPE`` line)."""

    def __init__(self) -> None:
        self._by_name: Dict[str, List[Tuple[Dict[str, str], object]]] = {}
        self._order: List[str] = []

    def add(self, name: str, labels: Dict[str, str], value) -> None:
        if name not in self._by_name:
            self._by_name[name] = []
            self._order.append(name)
        self._by_name[name].append((dict(labels), value))

    def render(self) -> str:
        lines: List[str] = []
        for name in self._order:
            lines.append(f"# TYPE {name} gauge")
            for labels, value in self._by_name[name]:
                lines.append(f"{name}{_fmt_labels(labels)} {_fmt_value(value)}")
        return "\n".join(lines) + "\n"


def _is_quantile_dict(v) -> bool:
    return (isinstance(v, dict)
            and any(k in v for k in _QUANTILE_KEYS)
            and all(isinstance(x, (int, float)) for x in v.values()))


def _walk(out: _Samples, prefix: str, node: dict,
          labels: Dict[str, str]) -> None:
    for key, v in node.items():
        name = f"{prefix}_{_sanitize(str(key))}"
        if key == "models" and isinstance(v, dict):
            # router snapshot: one sample set per model, model= labelled
            for model, snap in v.items():
                if isinstance(snap, dict):
                    _walk(out, prefix, snap,
                          {**labels, "model": str(model)})
            continue
        if key in ("buckets", "bucket_hist") and isinstance(v, dict):
            # per-bucket maps: bucket= labelled rather than name-mangled
            base = (f"{prefix}_bucket_requests" if key == "bucket_hist"
                    else prefix)
            for bucket, bv in v.items():
                blabels = {**labels, "bucket": str(bucket)}
                if isinstance(bv, dict):
                    _walk(out, base, bv, blabels)
                elif isinstance(bv, (int, float)):
                    out.add(base, blabels, bv)
            continue
        if key == "occupancy_hist" and isinstance(v, dict):
            for bin_name, n in v.items():
                out.add(name, {**labels, "bin": str(bin_name)}, n)
            continue
        if key == "per_worker" and isinstance(v, dict):
            # executor-pool gauges: {"0": {"utilization": ...}, ...} →
            # worker= labelled samples under the parent prefix
            for worker, wv in v.items():
                wlabels = {**labels, "worker": str(worker)}
                if isinstance(wv, dict):
                    _walk(out, f"{prefix}_worker", wv, wlabels)
                elif isinstance(wv, (int, float)):
                    out.add(f"{prefix}_worker", wlabels, wv)
            continue
        if str(key).endswith("_by_dtype") and isinstance(v, dict):
            # {"bf16": bytes, "f32": bytes} → base metric with dtype= label
            base = f"{prefix}_{_sanitize(str(key)[:-len('_by_dtype')])}"
            for dt, n in v.items():
                if isinstance(n, (bool, int, float)):
                    out.add(base, {**labels, "dtype": str(dt)}, n)
            continue
        if _is_quantile_dict(v):
            for qk, qv in v.items():
                if qk == "count":
                    out.add(f"{name}_count", labels, qv)
                elif qk.startswith("p"):
                    q = float(qk[1:]) / 100.0
                    out.add(name, {**labels, "quantile": f"{q:g}"}, qv)
                else:
                    out.add(f"{name}_{_sanitize(qk)}", labels, qv)
            continue
        if isinstance(v, dict):
            _walk(out, name, v, labels)
        elif isinstance(v, (bool, int, float)):
            out.add(name, labels, v)
        # strings / None / lists are descriptive, not metrics — skipped


def render_prometheus(snapshot: dict, prefix: str = "repro") -> str:
    """Render a serving snapshot as Prometheus text exposition format.

    Accepts either a single-server snapshot (``SparseServer.snapshot()``)
    or a router snapshot (``ModelRouter.metrics_snapshot()``, whose
    ``models`` map becomes a ``model=`` label).  Unknown keys flatten
    generically — new counters show up without touching this module.
    """
    out = _Samples()
    _walk(out, _sanitize(prefix), snapshot, {})
    return out.render()


class _Handler(BaseHTTPRequestHandler):
    server_version = "repro-metrics/1.0"

    def do_GET(self) -> None:  # noqa: N802  (http.server API)
        if self.path.split("?", 1)[0] == "/healthz":
            self._reply(200, "ok\n", "text/plain")
            return
        if self.path.split("?", 1)[0] not in ("/metrics", "/"):
            self._reply(404, "not found\n", "text/plain")
            return
        try:
            snap = self.server.snapshot_fn()      # type: ignore[attr-defined]
            body = render_prometheus(snap, self.server.prefix)  # type: ignore
        except Exception as e:                     # surface, don't crash
            self._reply(500, f"snapshot failed: {e!r}\n", "text/plain")
            return
        self._reply(200, body, "text/plain; version=0.0.4; charset=utf-8")

    def _reply(self, code: int, body: str, ctype: str) -> None:
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, fmt, *args) -> None:   # quiet by default
        pass


class MetricsServer:
    """Background HTTP exposition server.

    Args:
      snapshot_fn: zero-arg callable returning the current snapshot dict
        (it is called per scrape, so it must be cheap and thread-safe —
        both snapshot paths in ``repro.serving`` are).
      port: TCP port; ``0`` binds an ephemeral port (read ``.port`` after
        construction).
      host: bind address, loopback by default.
      prefix: metric-name prefix.
    """

    def __init__(self, snapshot_fn: Callable[[], dict], port: int = 0,
                 host: str = "127.0.0.1", prefix: str = "repro"):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.snapshot_fn = snapshot_fn       # type: ignore[attr-defined]
        self._httpd.prefix = prefix                 # type: ignore[attr-defined]
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def start(self) -> "MetricsServer":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="metrics-http", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        if self._thread is None:
            return
        self._httpd.shutdown()
        self._thread.join(timeout=timeout)
        self._httpd.server_close()
        self._thread = None

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
