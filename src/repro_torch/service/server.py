"""Stdlib HTTP front-end for the semantic query service.

``http.server.ThreadingHTTPServer`` + ``BaseHTTPRequestHandler`` — no
new dependencies, per the service's design constraint.  Handler threads
never touch an engine: they parse the request, run admission, enqueue
the job, and then *stream* the job's event queue back as NDJSON
(one JSON object per line, flushed per event) so the client sees rows
as the pump emits them.  Responses are close-delimited (HTTP/1.0
framing): no Content-Length is needed for a stream whose end is the
connection close, and every stdlib client can read it.

Endpoints:

  GET  /healthz            -> {"ok": true, "uptime_s": ...}
  GET  /stats              -> full stats JSON (core.stats_dict)
  GET  /stats?format=text  -> EXPLAIN-style text (serving/metrics.py)
  POST /query              -> body {"tenant": ..., "spec": ...};
                              200 + NDJSON event stream, or
                              429 + Retry-After on SLO shed, or
                              400 on a malformed spec
  POST /checkpoint         -> body {"dir": ...}; warm-state save
  POST /shutdown           -> acknowledge, then stop serving

A 429 body carries the machine-readable shed verdict
(reason / retry_after_s / detail) so clients can back off precisely.

The reference's ``repro/service/server.py`` over the port's service,
with ``/stats?format=text`` rendered by the port's
``serving/metrics.render_stats``.  After a kernel fault has stopped the
pump (``core.py``), ``/healthz`` answers 503 with ``"ok": false`` and
the fault, and ``/query`` answers 500 naming it.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

from repro_torch.kernels.build import KernelError
from repro_torch.serving.metrics import render_stats
from repro_torch.service.checkpoint import save_warm_state
from repro_torch.service.core import SemanticQueryService
from repro_torch.service.slo import Shed


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.0"      # close-delimited streaming
    server_version = "iolm-service/1"

    # quiet by default; serve(verbose=True) logs every request
    def log_message(self, fmt, *args):
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    @property
    def svc(self) -> SemanticQueryService:
        return self.server.service

    def _send_json(self, code: int, obj, *, headers=()) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self):
        n = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(n) or b"{}")

    def do_GET(self) -> None:
        url = urlparse(self.path)
        if url.path == "/healthz":
            uptime = self.svc.stats_dict()["service"]["uptime_s"]
            fault = self.svc.fault
            if fault is not None:
                self._send_json(503, {"ok": False, "uptime_s": uptime,
                                      "fault": str(fault)})
            else:
                self._send_json(200, {"ok": True, "uptime_s": uptime})
            return
        if url.path == "/stats":
            stats = self.svc.stats_dict()
            fmt = parse_qs(url.query).get("format", ["json"])[0]
            if fmt == "text":
                body = render_stats(stats).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._send_json(200, stats)
            return
        self._send_json(404, {"error": f"no route {url.path}"})

    def do_POST(self) -> None:
        url = urlparse(self.path)
        if url.path == "/query":
            self._handle_query()
            return
        if url.path == "/checkpoint":
            body = self._read_body()
            path = save_warm_state(self.svc.session, body["dir"])
            self._send_json(200, {"ok": True, "dir": path})
            return
        if url.path == "/shutdown":
            self._send_json(200, {"ok": True})
            # shut down from another thread: shutdown() blocks until
            # serve_forever returns, which can't happen on this thread
            threading.Thread(target=self.server.shutdown,
                             daemon=True).start()
            return
        self._send_json(404, {"error": f"no route {url.path}"})

    def _handle_query(self) -> None:
        try:
            body = self._read_body()
            tenant = body["tenant"]
            res = self.svc.submit_spec(tenant, body["spec"])
        except KernelError as e:
            self._send_json(500, {"error": str(e),
                                  "kind": type(e).__name__})
            return
        except (KeyError, ValueError, TypeError) as e:
            self._send_json(400, {"error": str(e),
                                  "kind": type(e).__name__})
            return
        if isinstance(res, Shed):
            self._send_json(
                429,
                {"error": "shed", "reason": res.reason,
                 "retry_after_s": res.retry_after_s,
                 "detail": res.detail},
                headers=(("Retry-After", f"{res.retry_after_s:.3f}"),))
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.end_headers()
        try:
            for ev in res.stream():
                self.wfile.write(json.dumps(ev).encode() + b"\n")
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            pass        # client went away; the pump finishes the job


class ServiceHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr, service: SemanticQueryService, *,
                 verbose: bool = False):
        self.service = service
        self.verbose = verbose
        super().__init__(addr, _Handler)


def serve(service: SemanticQueryService, *, host: str = "127.0.0.1",
          port: int = 0, block: bool = True,
          verbose: bool = False) -> Tuple[ServiceHTTPServer,
                                          Optional[threading.Thread]]:
    """Bind and serve.  ``port=0`` picks a free port (read it back from
    ``server.server_address``).  ``block=False`` serves on a background
    thread and returns immediately — the test-suite/CI mode; callers
    stop it with ``server.shutdown()`` then ``service.stop()``."""
    service.start()
    server = ServiceHTTPServer((host, port), service, verbose=verbose)
    if block:
        try:
            server.serve_forever()
        finally:
            server.server_close()
            service.stop()
        return server, None
    t = threading.Thread(target=server.serve_forever,
                         name="service-http", daemon=True)
    t.start()
    return server, t
