"""Metrics registry + embedded HTTP dashboard.

The reference ships a `DashboardServer` HTTP dashboard on :8080 whose
methods are all bodiless except the HTML template
(include/keyhunt/core/dashboard.h:102-387) and a 1 Hz printf stats loop
(keyhunt.cpp:2154-2252). This module is the working equivalent:

- `Metrics`: a process-global, thread-safe registry of counters and
  gauges the engines update (keys covered, device steps, chunk latency,
  found keys).
- `MetricsServer`: stdlib http.server exposing
    GET /metrics.json  — full snapshot
    GET /metrics       — Prometheus text exposition (scrape target)
    GET /healthz       — liveness
    GET /              — minimal auto-refreshing HTML view
  Runs on a daemon thread; zero third-party deps.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._info: Dict[str, str] = {}
        self.started_at = time.time()

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def set_info(self, name: str, value: str) -> None:
        with self._lock:
            self._info[name] = value

    def snapshot(self) -> dict:
        with self._lock:
            up = time.time() - self.started_at
            keys = self._counters.get("keys_covered", 0.0)
            return {
                "uptime_s": up,
                "keys_per_sec": keys / up if up > 0 else 0.0,
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "info": dict(self._info),
            }


_global = Metrics()


def get_metrics() -> Metrics:
    return _global


_HTML = """<!doctype html><meta charset=utf-8>
<title>keyhunt</title>
<meta http-equiv=refresh content=2>
<style>body{font:14px monospace;margin:2em}td{padding:.2em 1em}</style>
<h2>keyhunt</h2><table id=t>%ROWS%</table>
"""


def _prom_name(name: str) -> str:
    out = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    return "keyhunt_" + (out if not out[:1].isdigit() else "_" + out)


def prometheus_text(snap: dict) -> str:
    """Prometheus text exposition format of a Metrics snapshot: counters
    as counters, gauges + derived rates as gauges, info as a labeled
    keyhunt_info 1-gauge (the standard *_info convention)."""
    lines = []
    for k, v in sorted(snap["counters"].items()):
        n = _prom_name(k)
        lines += [f"# TYPE {n} counter", f"{n} {v!r}"]
    derived = {"uptime_seconds": snap["uptime_s"],
               "keys_per_sec": snap["keys_per_sec"]}
    for k, v in sorted({**snap["gauges"], **derived}.items()):
        n = _prom_name(k)
        lines += [f"# TYPE {n} gauge", f"{n} {v!r}"]
    if snap["info"]:
        labels = ",".join(
            f'{_prom_name(k)[8:]}="{str(v)[:120]}"'
            for k, v in sorted(snap["info"].items())
        )
        lines += ["# TYPE keyhunt_info gauge", "keyhunt_info{%s} 1" % labels]
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802
        snap = self.server.metrics.snapshot()  # type: ignore[attr-defined]
        if self.path == "/metrics.json":
            self._send(200, json.dumps(snap, indent=1).encode(), "application/json")
        elif self.path == "/metrics":
            self._send(200, prometheus_text(snap).encode(),
                       "text/plain; version=0.0.4")
        elif self.path == "/healthz":
            self._send(200, b"ok", "text/plain")
        elif self.path == "/":
            rows = [f"<tr><td>uptime_s</td><td>{snap['uptime_s']:.1f}</td></tr>",
                    f"<tr><td>keys/s</td><td>{snap['keys_per_sec']:.3e}</td></tr>"]
            for src in ("counters", "gauges", "info"):
                for k, v in sorted(snap[src].items()):
                    rows.append(f"<tr><td>{k}</td><td>{v}</td></tr>")
            body = _HTML.replace("%ROWS%", "".join(rows)).encode()
            self._send(200, body, "text/html")
        else:
            self._send(404, b"not found", "text/plain")

    def log_message(self, *a):  # silence default request logging
        pass


class MetricsServer:
    def __init__(self, port: int, metrics: Optional[Metrics] = None,
                 host: str = "127.0.0.1"):
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.metrics = metrics or get_metrics()  # type: ignore[attr-defined]
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    def start(self) -> "MetricsServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
