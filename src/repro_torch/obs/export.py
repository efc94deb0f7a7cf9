"""Exporters: Chrome-trace JSON, JSONL event log, Prometheus text.

Counterpart of `repro.obs.export` (pure Python there too; the port keeps
its own copy).  Chrome-trace output is the standard ``traceEvents`` array of complete
(``ph: "X"``) events -- load it at https://ui.perfetto.dev or
``chrome://tracing``.  Perfetto reconstructs nesting from time
containment per ``(pid, tid)``, which matches how the span stack
records.

When ``REPRO_OBS`` is set (not ``off``) in the environment, an atexit
hook writes all three artifacts to ``REPRO_OBS_DIR`` (default
``obs_out/``) under the port's own names, ``torch_trace.json``,
``torch_events.jsonl`` and ``torch_metrics.prom`` (`ARTIFACTS`), so that
a process importing both packages never overwrites the JAX package's
``trace.json`` / ``events.jsonl`` / ``metrics.prom``.  That is how
``REPRO_OBS=trace python examples/quickstart_torch.py`` produces a
loadable trace with no code changes.

``python -m repro_torch.obs validate <trace.json>`` checks an artifact
from the command line.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List, Optional

from repro_torch.obs import config as _cfg
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import telemetry as _telemetry
from repro_torch.obs import trace as _trace

# artifact kind -> file name in the output directory (the JAX package
# writes trace.json, events.jsonl and metrics.prom)
ARTIFACTS = {"trace": "torch_trace.json", "events": "torch_events.jsonl",
             "metrics": "torch_metrics.prom"}


def chrome_trace(events: Optional[List[Dict[str, Any]]] = None) -> dict:
    """Render span events as a Chrome-trace dict."""
    evs = _trace.events() if events is None else events
    pid = os.getpid()
    out = []
    for ev in evs:
        te = {"name": ev["name"], "cat": ev.get("cat", "host"), "ph": "X",
              "ts": round(ev["ts"], 3), "dur": round(max(ev["dur"], 0.0), 3),
              "pid": pid, "tid": ev.get("tid", 0)}
        args = dict(ev.get("args") or {})
        args["depth"] = ev.get("depth", 0)
        te["args"] = args
        out.append(te)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def export_chrome_trace(path: str) -> str:
    doc = chrome_trace()
    _ensure_parent(path)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return path


def export_jsonl(path: str) -> str:
    """One JSON object per line: spans, then metrics, then telemetry."""
    _ensure_parent(path)
    with open(path, "w") as f:
        for ev in _trace.events():
            f.write(json.dumps({"kind": "span", **ev}) + "\n")
        snap = _metrics.snapshot()
        for group in ("counters", "gauges"):
            for name, val in snap[group].items():
                f.write(json.dumps(
                    {"kind": group[:-1], "name": name, "value": val}) + "\n")
        for name, h in snap["histograms"].items():
            f.write(json.dumps(
                {"kind": "histogram", "name": name, **h}) + "\n")
        for name, n in _telemetry.peek().items():
            f.write(json.dumps(
                {"kind": "stream", "name": name, "buffered": n}) + "\n")
    return path


def export_metrics(path: str) -> str:
    _ensure_parent(path)
    with open(path, "w") as f:
        f.write(_metrics.prometheus_text())
    return path


def _ensure_parent(path: str) -> None:
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)


# ----------------------------------------------------------- validation
def validate_chrome_trace(path: str) -> Dict[str, Any]:
    """Validate a Chrome-trace JSON file; raise ValueError on problems.

    Returns a summary: event count, distinct span names, max depth.
    """
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError(f"{path}: missing top-level 'traceEvents'")
    evs = doc["traceEvents"]
    if not isinstance(evs, list) or not evs:
        raise ValueError(f"{path}: 'traceEvents' must be a non-empty list")
    names = set()
    max_depth = 0
    for i, ev in enumerate(evs):
        for field in ("name", "ph", "ts", "pid", "tid"):
            if field not in ev:
                raise ValueError(f"{path}: event {i} missing {field!r}")
        if ev["ph"] == "X":
            if "dur" not in ev or ev["dur"] < 0:
                raise ValueError(
                    f"{path}: event {i} ({ev['name']}) has bad 'dur'")
        names.add(ev["name"])
        max_depth = max(max_depth, int(ev.get("args", {}).get("depth", 0)))
    return {"events": len(evs), "names": sorted(names),
            "max_depth": max_depth}


# ------------------------------------------------------- atexit install
def write_all(out_dir: Optional[str] = None) -> Dict[str, str]:
    """Write the three `ARTIFACTS` into ``out_dir`` (default
    ``REPRO_OBS_DIR``); returns their paths by kind."""
    d = out_dir or _cfg.out_dir()
    _telemetry.flush()
    writers = {"trace": export_chrome_trace, "events": export_jsonl,
               "metrics": export_metrics}
    return {kind: writers[kind](os.path.join(d, name))
            for kind, name in ARTIFACTS.items()}


_atexit_installed = False


def install_atexit() -> None:
    """Register a best-effort artifact dump at interpreter exit."""
    global _atexit_installed
    if _atexit_installed:
        return
    _atexit_installed = True
    import atexit

    def _dump() -> None:
        if _cfg.mode() == "off":
            return
        try:
            paths = write_all()
        except Exception as exc:          # never fail the host program
            print(f"[repro_torch.obs] artifact export failed: {exc}")
            return
        print(f"[repro_torch.obs] wrote {paths['trace']}")

    atexit.register(_dump)


# -------------------------------------------------------- /metrics HTTP
def start_metrics_server(port: int = 0, host: str = "127.0.0.1"):
    """Serve the metrics registry over HTTP on a daemon thread.

    ``GET /metrics`` returns Prometheus text; ``GET /`` a tiny index.
    Returns the ``ThreadingHTTPServer`` -- read the bound port from
    ``server.server_address[1]`` (useful with ``port=0``), stop with
    ``server.shutdown()``.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802  (stdlib casing)
            if self.path.rstrip("/") in ("", "/index.html"):
                body = b"repro_torch.obs metrics endpoint; see /metrics\n"
                ctype = "text/plain; charset=utf-8"
            elif self.path == "/metrics":
                body = _metrics.prometheus_text().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):     # keep stdout clean
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name="repro-torch-obs-metrics")
    thread.start()
    return server


def add_metrics_cli(parser) -> None:
    """Install the standard ``--metrics-port`` / ``--metrics-hold`` flags.

    The JAX package's serving entry points spell the scrape surface so;
    the port's take the same flags.  Pair with `start_metrics_from_args`.
    """
    parser.add_argument(
        "--metrics-port", type=int, default=None, metavar="PORT",
        help="serve repro_torch.obs metrics on "
             "http://127.0.0.1:PORT/metrics "
             "(0 picks a free port)")
    parser.add_argument(
        "--metrics-hold", type=float, default=0.0, metavar="S",
        help="keep the process alive S seconds after the run so the "
             "/metrics endpoint can be scraped")


def start_metrics_from_args(args):
    """Start (and announce) the metrics server if ``--metrics-port`` was
    given; returns the server or ``None``."""
    if getattr(args, "metrics_port", None) is None:
        return None
    server = start_metrics_server(args.metrics_port)
    host, port = server.server_address[:2]
    print(f"metrics: http://{host}:{port}/metrics")
    return server
