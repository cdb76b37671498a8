"""Prometheus text-exposition rendering + the opt-in scrape endpoint.

Rendering follows the text exposition format 0.0.4: one ``# HELP`` /
``# TYPE`` pair per metric family, histograms expanded to cumulative
``_bucket{le=...}`` series plus ``_sum``/``_count``.  Every instrument
declared in the catalog is rendered — declared-but-unbound families
emit their HELP/TYPE header with no samples, so a scrape always shows
the full registered surface (the acceptance contract: a scrape during a
running query returns all registered instruments).

The endpoint is a stdlib ``ThreadingHTTPServer`` on a daemon thread,
opt-in via ``EngineConfig(prometheus_port=...)`` (0 = ephemeral port,
read it back from ``PrometheusServer.port``).  No dependencies — the
container has no prometheus_client, and the engine does not need one.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from denormalized_tpu_torch.obs.catalog import INSTRUMENTS
from denormalized_tpu_torch.obs.registry import Histogram, MetricsRegistry


def _escape_label(v: str) -> str:
    return (
        str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
    )


def _labels_str(labels: tuple, extra: tuple = ()) -> str:
    parts = [f'{k}="{_escape_label(v)}"' for k, v in labels] + [
        f'{k}="{_escape_label(v)}"' for k, v in extra
    ]
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt(v) -> str:
    if v is None:
        return "0"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render(registry: MetricsRegistry) -> str:
    """The full text exposition for one registry."""
    by_name: dict[str, list] = {name: [] for name in INSTRUMENTS}
    for inst in registry.instruments():
        by_name.setdefault(inst.name, []).append(inst)
    lines: list[str] = []
    for name, (kind, help_str, *_rest) in INSTRUMENTS.items():
        lines.append(f"# HELP {name} {help_str}")
        lines.append(f"# TYPE {name} {kind}")
        for inst in by_name.get(name, []):
            if isinstance(inst, Histogram):
                acc = 0
                for i, bound in enumerate(inst.bounds):
                    acc += inst.counts[i]
                    lines.append(
                        f"{name}_bucket"
                        f"{_labels_str(inst.labels, (('le', _fmt(bound)),))}"
                        f" {acc}"
                    )
                lines.append(
                    f"{name}_bucket"
                    f"{_labels_str(inst.labels, (('le', '+Inf'),))}"
                    f" {inst.count}"
                )
                lines.append(
                    f"{name}_sum{_labels_str(inst.labels)} {_fmt(inst.sum)}"
                )
                lines.append(
                    f"{name}_count{_labels_str(inst.labels)} {inst.count}"
                )
            else:
                lines.append(
                    f"{name}{_labels_str(inst.labels)} {_fmt(inst.value)}"
                )
    return "\n".join(lines) + "\n"


class PrometheusServer:
    """Scrape endpoint serving ``render(registry)`` at ``/metrics``
    (and ``/`` for convenience) on a daemon thread — plus the pipeline
    doctor's introspection surface (``/healthz``, ``/queries``,
    ``/queries/<id>/plan|lineage|profile`` — see obs/doctor/http.py).

    Resilience contract (pinned by the concurrent-teardown test): a
    scrape racing operator/exporter teardown never gets a 5xx or a
    hung socket — the doctor router is total, and the exposition
    renderer reads single-writer instruments without locks."""

    CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

    def __init__(self, registry: MetricsRegistry, port: int = 0,
                 host: str = "127.0.0.1"):
        self._registry = registry
        server = self

        class Handler(BaseHTTPRequestHandler):
            def _respond(self, status, ctype, body):
                try:
                    self.send_response(status)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except OSError:
                    pass  # client went away mid-write: their problem

            def _handle(self, method):
                from denormalized_tpu_torch.obs.doctor import http as doctor_http

                if self.path.split("?")[0] in ("/", "/metrics"):
                    if method != "GET":
                        self.send_error(405)
                        return
                    self._respond(
                        200, server.CONTENT_TYPE,
                        render(server._registry).encode(),
                    )
                    return
                routed = doctor_http.route(self.path, method)
                if routed is None:
                    self.send_error(404)
                    return
                self._respond(*routed)

            def do_GET(self):  # noqa: N802 (http.server API)
                self._handle("GET")

            def do_POST(self):  # noqa: N802 (http.server API)
                self._handle("POST")

            def log_message(self, fmt, *args):
                pass  # scrapes must not spam the engine's stderr

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            daemon=True,
            name=f"obs-prometheus-{self.port}",
        )

    def start(self) -> "PrometheusServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
