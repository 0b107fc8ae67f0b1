"""The port's telemetry: span tracing, the fault flight recorder, metrics
and their export — own copies of ``cfk_tpu/telemetry`` (pure Python).

- ``trace`` — hierarchical, thread-aware host span tracing exported as
  Chrome-trace/Perfetto JSON (``--trace-dir``; next to ``--profile-dir``'s
  torch.profiler trace so host and device timelines line up).  Off by
  default and near-free when off.
- ``recorder`` — the fault flight recorder: a bounded ring of recent events
  dumped atomically on a fault or a crash.
- ``metrics`` / ``export`` — the thread-safe registry (counters, gauges,
  phases, bounded-reservoir histograms), its periodic JSONL emitter
  (``--metrics-jsonl``) and the Prometheus-text ``/metrics`` endpoint
  (``serve --metrics-port``).

Nothing here touches device values: telemetry on and off give the same
factors, bit for bit.
"""

from cfk_tpu_torch.telemetry.export import (
    MetricsHTTPServer,
    prometheus_text,
    sanitize_metric_name,
)
from cfk_tpu_torch.telemetry.metrics import (
    Histogram,
    Metrics,
    MetricsEmitter,
    MetricsRegistry,
)
from cfk_tpu_torch.telemetry.recorder import (
    FlightRecorder,
    dump_flight,
    get_recorder,
    install_crash_hooks,
    record_event,
)
from cfk_tpu_torch.telemetry.trace import (
    Tracer,
    begin_span,
    configure,
    end_span,
    get_tracer,
    instant,
    shutdown,
    span,
    stage_overlap_from_events,
    validate_span_tree,
)

__all__ = [
    "FlightRecorder",
    "Histogram",
    "Metrics",
    "MetricsEmitter",
    "MetricsHTTPServer",
    "MetricsRegistry",
    "Tracer",
    "begin_span",
    "configure",
    "dump_flight",
    "end_span",
    "get_recorder",
    "get_tracer",
    "install_crash_hooks",
    "instant",
    "prometheus_text",
    "record_event",
    "sanitize_metric_name",
    "shutdown",
    "span",
    "stage_overlap_from_events",
    "validate_span_tree",
]
