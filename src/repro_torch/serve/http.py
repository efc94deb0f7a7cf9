"""Stdlib HTTP front end for `LogdetService`.

Counterpart of `repro.serve.http`: the same endpoints and JSON keys.

Endpoints (JSON in, JSON out)::

    POST /v1/logdet    {"matrix": [[...]], "method": "auto", "rtol": null}
                       or {"matrices": [[[...]], ...], ...} for several
                       independent requests in one call (each is admitted
                       separately; the server may batch them with other
                       traffic).
    GET  /healthz      {"status": "ok", ...}
    GET  /stats        LogdetService.stats() snapshot
    GET  /metrics      Prometheus text (the repro_torch.obs registry)

The handler threads only do admission + JSON; every matrix still flows
through the service's single drain thread, so HTTP concurrency feeds the
batcher instead of racing it.  Malformed requests get a 400 with an
``{"error": ...}`` body; execution failures surface as 500 with the
exception text.
"""
from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict

import numpy as np

from repro_torch import obs
from repro_torch.serve.service import LogdetService

__all__ = ["serve_http", "make_handler"]

_MAX_BODY = 512 * 1024 * 1024  # refuse absurd request bodies outright


def _result_json(res) -> Dict[str, Any]:
    d = res.diagnostics
    return {
        "sign": float(res.sign),
        "logabsdet": float(res.logabsdet),
        "sem": None if res.sem is None or not np.isfinite(res.sem)
        else float(res.sem),
        "method": res.method_used,
        "bucket": d.padded_n,
    }


def make_handler(service: LogdetService):
    """Build the request-handler class bound to one service instance."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        # ------------------------------------------------------ plumbing
        def _send(self, code: int, payload: Dict[str, Any]) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):      # keep stdout for the operator
            pass

        # ------------------------------------------------------- routes
        def do_GET(self):  # noqa: N802 (stdlib casing)
            path = self.path.split("?", 1)[0].rstrip("/") or "/"
            if path in ("/", "/healthz"):
                self._send(200, {"status": "ok",
                                 "buckets": list(service.ladder.buckets),
                                 "dtype": service.config.dtype})
            elif path == "/stats":
                self._send(200, service.stats())
            elif path == "/metrics":
                body = obs.prometheus_text().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._send(404, {"error": f"no such path {self.path!r}"})

        def do_POST(self):  # noqa: N802
            path = self.path.split("?", 1)[0].rstrip("/")
            if path != "/v1/logdet":
                self._send(404, {"error": f"no such path {self.path!r}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                if not 0 < length <= _MAX_BODY:
                    raise ValueError(
                        f"Content-Length must be in (0, {_MAX_BODY}]")
                req = json.loads(self.rfile.read(length))
                if "matrix" in req:
                    mats, single = [req["matrix"]], True
                elif "matrices" in req:
                    mats, single = list(req["matrices"]), False
                    if not mats:
                        raise ValueError("'matrices' is empty")
                else:
                    raise ValueError(
                        "body must contain 'matrix' or 'matrices'")
                method = req.get("method")
                rtol = req.get("rtol")
                # admit everything before waiting on anything, so one
                # HTTP call's matrices can share a drain batch
                futures = [service.submit(m, method=method, rtol=rtol)
                           for m in mats]
            except (ValueError, TypeError, json.JSONDecodeError) as exc:
                self._send(400, {"error": str(exc)})
                return
            try:
                results = [_result_json(f.result()) for f in futures]
            except Exception as exc:       # noqa: BLE001 -- report upstream
                self._send(500, {"error": f"{type(exc).__name__}: {exc}"})
                return
            self._send(200, results[0] if single
                       else {"results": results})

    return Handler


def serve_http(service: LogdetService, host: str = "127.0.0.1",
               port: int = 8080) -> ThreadingHTTPServer:
    """Bind and return the server (caller runs ``serve_forever``)."""
    return ThreadingHTTPServer((host, port), make_handler(service))
