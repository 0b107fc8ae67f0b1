"""Live metrics export: Prometheus text rendering + the /metrics endpoint.

The port's copy of ``cfk_tpu/telemetry/export.py`` (pure Python, no JAX).
``serve --metrics-port`` answers ``GET /metrics`` with the registry
rendered in the Prometheus text exposition format (0.0.4):

- counters  → ``cfk_<name>_total`` (TYPE counter)
- gauges    → ``cfk_<name>``       (TYPE gauge)
- phases    → ``cfk_phase_seconds{phase="<name>"}`` (TYPE gauge)
- histograms→ ``cfk_<name>{quantile="..."}`` + ``_sum``/``_count``
              (TYPE summary — the bounded-reservoir latency histograms)

Free-text notes are deliberately not exported (they are diagnostics, not
time series; they stay in the JSON line / flight dumps).

``MetricsHTTPServer`` is a ThreadingHTTPServer on its own daemon thread:
requests snapshot the registry under its lock, so scraping under load
reads a consistent view while worker threads keep mutating.
"""

from __future__ import annotations

import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from cfk_tpu_torch.telemetry.metrics import Metrics

PREFIX = "cfk"

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_FIRST_RE = re.compile(r"^[^a-zA-Z_:]")


def sanitize_metric_name(name: str) -> str:
    """Map a registry key onto the Prometheus name charset."""
    name = _NAME_RE.sub("_", name)
    if _FIRST_RE.match(name):
        name = "_" + name
    return name


def _fmt(v: float) -> str:
    f = float(v)
    if f != f:  # NaN
        return "NaN"
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    return repr(f) if f != int(f) else str(int(f))


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def prometheus_text(metrics: Metrics, prefix: str = PREFIX,
                    labels: dict[str, object] | None = None) -> str:
    """Render the registry in the text exposition format.  One snapshot
    per call (the registry lock guards each family's copy), TYPE line
    before its samples, trailing newline — the conformance test walks
    these properties line by line.

    ``labels`` attaches constant labels to every counter/gauge sample —
    the attribution seam: a multi-process host exports with
    ``labels={"process": rank}`` so one scrape target per host aggregates
    cleanly (phase/histogram samples keep their own label
    sets; Prometheus merges per-target constant labels upstream)."""
    lines: list[str] = []
    lbl = ""
    if labels:
        pairs = ",".join(
            f'{sanitize_metric_name(str(k))}="{_escape_label(str(v))}"'
            for k, v in sorted(labels.items())
        )
        lbl = "{" + pairs + "}"
    with metrics._lock:
        counters = sorted(metrics.counters.items())
        gauges = sorted(metrics.gauges.items())
        phases = sorted(metrics.phases.items())
        hists = sorted(metrics.histograms.items())
    for name, value in counters:
        m = f"{prefix}_{sanitize_metric_name(name)}_total"
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m}{lbl} {_fmt(value)}")
    for name, value in gauges:
        try:
            v = _fmt(value)
        except (TypeError, ValueError):
            continue  # non-numeric gauge (provenance strings etc.)
        m = f"{prefix}_{sanitize_metric_name(name)}"
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m}{lbl} {v}")
    if phases:
        m = f"{prefix}_phase_seconds"
        lines.append(f"# TYPE {m} gauge")
        for name, value in phases:
            lines.append(
                f'{m}{{phase="{_escape_label(name)}"}} {_fmt(value)}'
            )
    for name, h in hists:
        m = f"{prefix}_{sanitize_metric_name(name)}"
        lines.append(f"# TYPE {m} summary")
        snap = h.snapshot()  # ONE consistent instant per family
        if snap["count"]:
            for q, key in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
                lines.append(f'{m}{{quantile="{q}"}} {_fmt(snap[key])}')
        lines.append(f"{m}_sum {_fmt(snap['sum'] if snap['count'] else 0.0)}")
        lines.append(f"{m}_count {snap['count']}")
    return "\n".join(lines) + "\n"


class MetricsHTTPServer:
    """Serve ``GET /metrics`` (Prometheus text) for a registry.

    ``port=0`` binds an ephemeral port (tests); the bound port is
    ``self.port`` after construction.  ``start()`` runs the accept loop
    on a daemon thread; ``stop()`` shuts it down and releases the
    socket.  Also answers ``GET /healthz`` with ``ok`` (the liveness
    probe a supervisor wants next to the scrape target) and — liveness
    and readiness are DIFFERENT questions — ``GET /readyz``:
    200 only while ``ready_fn()`` is true (an engine that is alive but
    still prewarming or mid-epoch-load must not receive traffic; the
    a rollover gate polls exactly this).  ``ready_fn=None`` means
    always ready; a ``ready_fn`` that raises
    reads as NOT ready rather than killing the probe."""

    def __init__(self, metrics: Metrics, *, port: int = 0,
                 host: str = "127.0.0.1",
                 labels: dict[str, object] | None = None,
                 ready_fn=None) -> None:
        self.metrics = metrics
        self.labels = dict(labels) if labels else None
        self.ready_fn = ready_fn
        registry = metrics
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path.split("?", 1)[0] == "/metrics":
                    body = prometheus_text(
                        registry, labels=outer.labels
                    ).encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    outer.scrapes += 1
                elif self.path.split("?", 1)[0] == "/healthz":
                    body = b"ok\n"
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path.split("?", 1)[0] == "/readyz":
                    try:
                        ready = (outer.ready_fn is None
                                 or bool(outer.ready_fn()))
                    except Exception:
                        ready = False
                    body = b"ready\n" if ready else b"not ready\n"
                    self.send_response(200 if ready else 503)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()

            def log_message(self, *args):  # silence per-request stderr
                pass

        self.scrapes = 0
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def start(self) -> "MetricsHTTPServer":
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                name="cfk-metrics-http", daemon=True,
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "MetricsHTTPServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
