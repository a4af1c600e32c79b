"""Prometheus text exposition and a stdlib HTTP exporter for the recorder.

A copy of ``repro.obs.export``.

Three endpoints, all served off a daemon thread so the serving loop is
never blocked by a scrape:

- ``/metrics``       Prometheus text exposition (format 0.0.4).  Histogram
                     families emit sparse cumulative ``_bucket{le=...}``
                     lines plus ``_sum``/``_count``, and derived
                     ``<name>_p50``/``_p99``/``_p999`` gauge families so
                     quantiles are grep-able without a PromQL engine.
- ``/metrics.json``  The registry snapshot (same dict that is merged into
                     ``StreamServer.report`` / ``fleet_report``).
- ``/trace``         The span ring as Chrome trace-event JSON (load in
                     Perfetto).

No third-party client library: the exposition writer and HTTP server are
stdlib-only, matching the repo's no-new-deps policy.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from repro_torch.obs.metrics import MetricsRegistry, bucket_bounds

__all__ = ["PROM_CONTENT_TYPE", "prometheus_text", "ObsHTTPServer", "start_exporter"]

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_QUANTILE_GAUGES = (("p50", 0.5), ("p99", 0.99), ("p999", 0.999))


def _fmt(v: float) -> str:
    """Prometheus sample value: shortest float that round-trips enough."""
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _labels(inst, extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in sorted(getattr(inst, "labels", {}).items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def prometheus_text(registry: MetricsRegistry) -> str:
    """Render the registry in Prometheus text exposition format 0.0.4."""
    lines = []
    derived = []  # quantile gauge families, appended after the real families
    for name, insts in registry.families():
        kind = insts[0].kind
        help_text = next((i.help for i in insts if i.help), "")
        if help_text:
            lines.append(f"# HELP {name} {help_text}")
        if kind == "counter":
            lines.append(f"# TYPE {name} counter")
            for inst in insts:
                lines.append(f"{name}{_labels(inst)} {_fmt(inst.read())}")
        elif kind == "gauge":
            lines.append(f"# TYPE {name} gauge")
            for inst in insts:
                lines.append(f"{name}{_labels(inst)} {_fmt(inst.read())}")
        elif kind == "histogram":
            lines.append(f"# TYPE {name} histogram")
            for inst in insts:
                s = inst.scale
                cum = 0
                for idx, c in inst.nonzero_buckets():
                    cum += c
                    _, hi = bucket_bounds(idx)
                    le = 'le="%.9g"' % (hi * s)
                    lines.append(f"{name}_bucket{_labels(inst, le)} {cum}")
                inf = 'le="+Inf"'
                lines.append(f"{name}_bucket{_labels(inst, inf)} {inst.count}")
                lines.append(f"{name}_sum{_labels(inst)} {_fmt(inst.total * s)}")
                lines.append(f"{name}_count{_labels(inst)} {inst.count}")
                for suffix, q in _QUANTILE_GAUGES:
                    derived.append((f"{name}_{suffix}", _labels(inst),
                                    inst.quantile(q) * s))
    for qname, lbl, val in derived:
        lines.append(f"# TYPE {qname} gauge")
        lines.append(f"{qname}{lbl} {_fmt(val)}")
    return "\n".join(lines) + "\n"


class ObsHTTPServer:
    """Daemon-thread HTTP exporter bound to (host, port); port 0 = ephemeral."""

    def __init__(self, obs, host: str = "127.0.0.1", port: int = 0):
        self._obs = obs
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # silence per-request stderr spam
                pass

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path in ("/metrics", "/"):
                    body = prometheus_text(outer._obs.metrics).encode()
                    ctype = PROM_CONTENT_TYPE
                elif path == "/metrics.json":
                    body = json.dumps(outer._obs.snapshot()).encode()
                    ctype = "application/json"
                elif path == "/trace":
                    body = json.dumps(outer._obs.tracer.chrome_trace()).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-exporter", daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def start_exporter(obs, port: int, host: str = "127.0.0.1") -> Optional[ObsHTTPServer]:
    """Start the exporter if ``port`` is set; ``None`` disables it."""
    if port is None:
        return None
    return ObsHTTPServer(obs, host=host, port=port)
