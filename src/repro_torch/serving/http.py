"""HTTP ingress for the serving pipeline: a stdlib JSON front door.

:class:`HttpFrontDoor` is the pipeline's INGRESS stage (see
docs/serving.md "Pipeline architecture"): a ``ThreadingHTTPServer`` — the
same no-new-dependencies pattern as ``repro.obs.prom.MetricsServer`` —
that turns HTTP requests into ``SparseServer.submit`` calls and maps the
server's admission decisions onto HTTP backpressure:

================================  =====================================
server outcome                    HTTP response
================================  =====================================
admitted + served                 ``200`` with the output row
admitted, ``wait=false``          ``202`` with the request id (poll via
                                  ``GET /v1/result/<rid>``)
queue full (admission control)    ``429`` + ``Retry-After`` — back off,
                                  the queue is the SLO guard
server shut down                  ``503`` (permanent for this process)
deadline-evicted / failed batch   ``503`` (the request was consumed but
                                  could not be served in time)
wait timed out (still in flight)  ``504`` (result may still be
                                  collectable by rid later)
bad JSON / wrong input shape      ``400`` — rejected in the ingress
                                  thread, never reaches formation
unknown model                     ``404``
================================  =====================================

Endpoints:

* ``POST /v1/infer`` — body ``{"x": [...], "model": "name",
  "deadline_ms": 50, "wait": true, "wait_ms": 1000}`` (only ``x`` is
  required; ``model`` defaults to a single-server target's model).
* ``GET  /v1/result/<rid>?model=name`` — poll/collect an async result.
* ``GET  /v1/models`` — served model names.
* ``GET  /healthz`` — liveness (503 once shut down).

The front door holds no queue of its own: every connection thread calls
straight into ``submit_ex`` (bounded by the server's ``max_queue``) and,
for synchronous requests, blocks in ``wait(rid)`` — concurrency is
bounded by ``ThreadingHTTPServer``'s per-connection threads, admission by
the server's own backpressure.  It works identically over a
:class:`~repro.serving.server.SparseServer` or a
:class:`~repro.serving.server.ModelRouter`.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["HttpFrontDoor"]

#: Retry-After seconds suggested on a 429 (one idle tick: by then the
#: scheduler has had a chance to fire at least one batch)
_RETRY_AFTER_S = 0.1


class _Handler(BaseHTTPRequestHandler):
    server_version = "repro-serve/1.0"

    # ------------------------------------------------------------------ #
    def do_POST(self) -> None:  # noqa: N802  (http.server API)
        front: "HttpFrontDoor" = self.server.front  # type: ignore[attr-defined]
        if self.path.split("?", 1)[0] != "/v1/infer":
            self._reply(404, {"error": "not_found"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, TypeError):
            self._reply(400, {"error": "bad_json"})
            return
        code, payload, headers = front.infer(body)
        self._reply(code, payload, headers)

    def do_GET(self) -> None:  # noqa: N802
        front: "HttpFrontDoor" = self.server.front  # type: ignore[attr-defined]
        path, _, query = self.path.partition("?")
        if path == "/healthz":
            if front.closed:
                self._reply(503, {"status": "shutting_down"})
            else:
                self._reply(200, {"status": "ok"})
            return
        if path == "/v1/models":
            self._reply(200, {"models": front.model_names()})
            return
        if path.startswith("/v1/result/"):
            params = dict(p.split("=", 1) for p in query.split("&") if "=" in p)
            try:
                rid = int(path[len("/v1/result/"):])
            except ValueError:
                self._reply(400, {"error": "bad_rid"})
                return
            code, payload = front.collect(rid, params.get("model"))
            self._reply(code, payload)
            return
        self._reply(404, {"error": "not_found"})

    # ------------------------------------------------------------------ #
    def _reply(self, code: int, obj: dict,
               headers: Optional[Dict[str, str]] = None) -> None:
        data = json.dumps(obj).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, fmt, *args) -> None:   # quiet by default
        pass


class HttpFrontDoor:
    """Background HTTP ingress over a ``SparseServer`` or ``ModelRouter``.

    Args:
      target: the server or router requests are submitted to (it should
        already be ``start()``-ed; the front door only does admission and
        collection).
      port: TCP port; ``0`` binds an ephemeral port (read ``.port``).
      host: bind address, loopback by default.
      default_wait_ms: how long a synchronous ``POST /v1/infer`` blocks
        for its result before answering 504.  Default: 40x the target's
        SLO — generous enough that a healthy server never trips it.
    """

    def __init__(self, target, port: int = 0, host: str = "127.0.0.1",
                 default_wait_ms: Optional[float] = None):
        self.target = target
        self._is_router = hasattr(target, "servers")
        if default_wait_ms is None:
            slo_s = (max(s.slo_s for s in target.servers.values())
                     if self._is_router else target.slo_s)
            default_wait_ms = 40.0 * slo_s * 1e3
        self.default_wait_ms = default_wait_ms
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.front = self                    # type: ignore[attr-defined]
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None
        self.closed = False

    # ------------------------------------------------------------------ #
    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def model_names(self) -> list:
        if self._is_router:
            return sorted(self.target.servers)
        return [self.target.name]

    def _server(self, model: Optional[str]):
        """The SparseServer a request routes to, or None for a 404."""
        if self._is_router:
            if model is None and len(self.target.servers) == 1:
                return next(iter(self.target.servers.values()))
            return self.target.servers.get(model)
        if model is not None and model != self.target.name:
            return None
        return self.target

    # ------------------------------------------------------------------ #
    def infer(self, body: dict
              ) -> Tuple[int, dict, Optional[Dict[str, str]]]:
        """Admission + (optionally) synchronous collection for one POST.
        Returns ``(status, payload, extra_headers)``."""
        if self.closed:
            return 503, {"error": "closed"}, None
        model = body.get("model")
        server = self._server(model)
        if server is None:
            return 404, {"error": "unknown_model", "model": model}, None
        try:
            x = np.asarray(body["x"], dtype=server.plans.dtype)
        except (KeyError, TypeError, ValueError):
            return 400, {"error": "bad_input"}, None
        deadline_ms = body.get("deadline_ms")
        try:
            rid, reason = server.submit_ex(x, deadline_ms=deadline_ms)
        except ValueError as e:              # wrong shape — ingress-thread
            return 400, {"error": "bad_input", "detail": str(e)}, None
        if rid is None:
            if reason == "queue_full":
                return (429, {"error": "queue_full"},
                        {"Retry-After": str(_RETRY_AFTER_S)})
            return 503, {"error": reason or "rejected"}, None
        if not body.get("wait", True):
            return 202, {"rid": rid, "model": server.name}, None
        wait_ms = body.get("wait_ms", self.default_wait_ms)
        y = server.wait(rid, timeout=wait_ms / 1e3)
        if y is not None:
            return (200, {"rid": rid, "model": server.name,
                          "y": np.asarray(y).tolist()}, None)
        # None from wait(): either the slot completed as None (failed
        # batch / deadline eviction — the request is consumed and will
        # never be served) or the wait timed out (still in flight)
        if server.status(rid) == "pending":
            return 504, {"rid": rid, "error": "timeout"}, None
        return 503, {"rid": rid, "error": "failed_or_evicted"}, None

    def collect(self, rid: int, model: Optional[str]) -> Tuple[int, dict]:
        """Poll path for ``wait=false`` submissions."""
        server = self._server(model)
        if server is None:
            return 404, {"error": "unknown_model", "model": model}
        status = server.status(rid)
        if status == "pending":
            return 202, {"rid": rid, "status": "pending"}
        y = server.result(rid)
        if y is None:
            # completed-as-None (failed/evicted) or unknown rid
            if status == "done":
                return 503, {"rid": rid, "error": "failed_or_evicted"}
            return 404, {"rid": rid, "error": "unknown_rid"}
        return 200, {"rid": rid, "y": np.asarray(y).tolist()}

    # ------------------------------------------------------------------ #
    def start(self) -> "HttpFrontDoor":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="serve-http", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        """Stop accepting connections (the serving target is NOT shut
        down — that stays the caller's decision)."""
        self.closed = True
        if self._thread is None:
            return
        self._httpd.shutdown()
        self._thread.join(timeout=timeout)
        self._httpd.server_close()
        self._thread = None

    def __enter__(self) -> "HttpFrontDoor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
