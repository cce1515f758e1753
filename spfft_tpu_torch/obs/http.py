"""HTTP scrape endpoint: ``/metrics``, ``/healthz``, ``/configz``,
``/incidentz`` (the port of ``spfft_tpu/obs/http.py``).

A stdlib ``ThreadingHTTPServer`` that serves

* ``GET /metrics`` — ``obs.prometheus_text()`` over the bound metrics
  and registry plus the process-global counters, in the text exposition
  format;
* ``GET /healthz`` — a health snapshot as JSON (200 while servable, 503
  once ``failed``; ``{"state": "unknown"}`` with nothing bound);
* ``GET /configz`` — a bound executor's live knob values (404 without
  one);
* ``GET /incidentz`` — an incident capture now; the written bundle's
  path as JSON, 503 when the recorder is disarmed or the capture failed.

Opt-in: nothing listens unless a server is started, or
``SPFFT_TPU_METRICS_PORT`` names a port (:func:`port_from_env`); port 0
binds an ephemeral port (returned by :meth:`MetricsServer.start`). It
binds ``127.0.0.1`` unless the caller passes another ``host``.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .exporters import prometheus_text

#: Env opt-in (embedders read it through port_from_env).
METRICS_PORT_ENV = "SPFFT_TPU_METRICS_PORT"

#: Content type of the Prometheus text exposition format.
PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: Health states a readiness check should treat as servable.
SERVABLE_STATES = ("healthy", "degraded", "draining")


def port_from_env() -> Optional[int]:
    """The ``SPFFT_TPU_METRICS_PORT`` opt-in, or None (unset/invalid
    values disable rather than crash a server boot)."""
    raw = os.environ.get(METRICS_PORT_ENV)
    if not raw:
        return None
    try:
        port = int(raw)
    except ValueError:
        return None
    return port if 0 <= port <= 65535 else None


class MetricsServer:
    """Background scrape endpoint over one executor's telemetry.

    ``executor`` binds ``/healthz`` (pool detail + knob values) and
    ``/configz``; ``metrics``/``registry`` feed ``/metrics`` (both
    default to the executor's when an executor is given). Use as a
    context manager, or :meth:`start` / :meth:`stop`.
    """

    def __init__(self, metrics=None, registry=None, executor=None,
                 port: int = 0, host: str = "127.0.0.1",
                 text_fn=None, health_fn=None, incident_fn=None):
        if executor is not None:
            metrics = metrics if metrics is not None else executor.metrics
            registry = registry if registry is not None \
                else executor.registry
        self.metrics = metrics
        self.registry = registry
        self.executor = executor
        # Aggregation hooks: a pod frontend overrides what /metrics
        # renders (its merged multi-host exposition), what /healthz
        # reports (worst-lane-health-wins) and what /incidentz
        # captures (the pod-wide bundle) without subclassing the
        # handler; None keeps the single-process defaults.
        self.text_fn = text_fn
        self.health_fn = health_fn
        self.incident_fn = incident_fn
        self.host = host
        self.port = int(port)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- handler -----------------------------------------------------------
    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet by design
                pass

            def _send(self, code: int, body: str, ctype: str) -> None:
                data = body.encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        if server.text_fn is not None:
                            body = server.text_fn()
                        else:
                            body = prometheus_text(
                                metrics=server.metrics,
                                registry=server.registry)
                        self._send(200, body, PROM_CONTENT_TYPE)
                    elif path == "/healthz":
                        if server.health_fn is not None:
                            snap = server.health_fn()
                        elif server.executor is not None:
                            snap = server.executor.health()
                        elif server.metrics is not None:
                            snap = server.metrics.health()
                        else:
                            snap = {"state": "unknown"}
                        code = 200 if snap.get("state",
                                               "unknown") \
                            in SERVABLE_STATES else 503
                        self._send(code, json.dumps(snap, default=str),
                                   "application/json")
                    elif path == "/configz":
                        if server.executor is None:
                            self._send(404, "no executor bound\n",
                                       "text/plain")
                        else:
                            self._send(200, json.dumps(
                                server.executor.config.snapshot()),
                                "application/json")
                    elif path == "/incidentz":
                        from . import recorder as _recorder
                        if server.incident_fn is not None:
                            path_ = server.incident_fn("http")
                        elif _recorder.recorder_active():
                            path_ = _recorder.capture_incident("http")
                        else:
                            self._send(503, json.dumps(
                                {"error": "recorder disarmed"}),
                                "application/json")
                            return
                        if path_ is None:
                            self._send(503, json.dumps(
                                {"error": "capture failed"}),
                                "application/json")
                        else:
                            self._send(200, json.dumps(
                                {"path": path_}), "application/json")
                    else:
                        self._send(404, "try /metrics, /healthz, "
                                        "/configz, /incidentz\n",
                                   "text/plain")
                except Exception as exc:  # a broken scrape must not
                    try:                  # kill the handler thread
                        self._send(500, f"{type(exc).__name__}: "
                                        f"{exc}\n", "text/plain")
                    except Exception:
                        pass

        return Handler

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> int:
        """Bind and serve on a daemon thread; returns the bound port
        (meaningful with ``port=0``). Idempotent."""
        if self._httpd is None:
            self._httpd = ThreadingHTTPServer(
                (self.host, self.port), self._make_handler())
            self._httpd.daemon_threads = True
            self.port = self._httpd.server_address[1]
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                name="spfft-metrics-http", daemon=True)
            self._thread.start()
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def __enter__(self) -> "MetricsServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
