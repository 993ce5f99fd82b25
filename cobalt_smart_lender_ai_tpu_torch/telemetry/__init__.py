"""Telemetry of the port: metrics registry, structured logs, spans, the
flight recorder and SLOs, the kernel cost table, device memory and the run
ledger — the reference's ``telemetry`` package, module for module where
the module is ported, with no dependency beyond torch.

- `telemetry.metrics` — labeled Counter/Gauge/Histogram families in a
  thread-safe `MetricsRegistry`, rendered in Prometheus text exposition
  format at ``GET /metrics`` (the reference's text byte for byte).
- `telemetry.logging` — one-JSON-object-per-line logs with a
  contextvar-propagated request id (honoring/emitting ``X-Request-ID``).
- `telemetry.tracing` — `span()` with parent/child nesting, an injectable
  clock and a bounded ring buffer; spans enter
  ``torch.profiler.record_function`` while a profiler session captures.
- `telemetry.flight` — per-request flight recorder with phase breakdowns
  (``GET /debug/requests``, ``GET /debug/slowest``).
- `telemetry.traceexport` — the span ring as Chrome Trace Event / Perfetto
  JSON (``GET /debug/trace``, the training CLI's ``--trace-out``).
- `telemetry.slo` — objectives evaluated as multi-window error-budget burn
  rates (``GET /slo``, ``cobalt_slo_*`` gauges).
- `telemetry.programs` — the kernel entries' dispatch counts, CUDA-event
  seconds, FLOPs, bytes and roofline (``GET /debug/programs``,
  ``cobalt_program_*``).
- `telemetry.devices` — device/host memory gauges and the `DeviceSampler`
  feeding Perfetto counter tracks.
- `telemetry.runledger` — one JSON `RunLedger` per run, in the reference's
  schema (its ``tools/obs_report.py`` renders and diffs it).
- `telemetry.events` — the control-plane `EventJournal` (``GET /events``,
  ``cobalt_events_*``): typed, causally linked reload, breaker and canary
  events, shipped as md5-pinned segments and read back by `load_events`.
- `telemetry.drift` — per-feature `FeatureSketch` histograms and their
  population stability index (``GET /drift``, ``cobalt_drift_*``).
- `telemetry.timeseries` — `TimeSeriesStore`: a sampler scraping any
  registry into tiered downsampled rings (counter rates, per-window
  histogram quantiles, gauges), with md5-pinned segments and the
  ``GET /dashboard`` renderer (``GET /history``).
- `telemetry.aggregate` — merge N `parse_exposition` snapshots into
  fleet-level series (counter sums, histogram bucket merges, label joins)
  for a `ReplicaSet`'s history.
"""

from __future__ import annotations

from cobalt_smart_lender_ai_tpu_torch.telemetry.aggregate import (
    fleet_scraper,
    merge_expositions,
    merge_registries,
)
from cobalt_smart_lender_ai_tpu_torch.telemetry.devices import (
    DeviceSampler,
    default_device_sampler,
    device_info,
    host_rss_bytes,
    install_device_metrics,
)
from cobalt_smart_lender_ai_tpu_torch.telemetry.drift import (
    FeatureSketch,
    psi,
)
from cobalt_smart_lender_ai_tpu_torch.telemetry.events import (
    EVENT_KINDS,
    EventJournal,
    current_event_id,
    event_context,
    load_events,
    merge_events,
)
from cobalt_smart_lender_ai_tpu_torch.telemetry.flight import (
    META_ROUTES,
    FlightRecorder,
    add_phase,
    collect_phases,
)
from cobalt_smart_lender_ai_tpu_torch.telemetry.logging import (
    StructuredLogger,
    current_request_id,
    get_logger,
    new_request_id,
    request_context,
)
from cobalt_smart_lender_ai_tpu_torch.telemetry.metrics import (
    EXPOSITION_CONTENT_TYPE,
    LATENCY_BUCKETS_S,
    OPENMETRICS_CONTENT_TYPE,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    log_buckets,
    parse_exposition,
    render,
)
from cobalt_smart_lender_ai_tpu_torch.telemetry.programs import (
    ProgramHandle,
    ProgramRegistry,
    default_program_registry,
    install_program_metrics,
)
from cobalt_smart_lender_ai_tpu_torch.telemetry.runledger import (
    RunLedger,
    load_ledger,
)
from cobalt_smart_lender_ai_tpu_torch.telemetry.slo import (
    Objective,
    SLOEngine,
    default_objectives,
)
from cobalt_smart_lender_ai_tpu_torch.telemetry.timeseries import (
    TimeSeriesStore,
    load_segments,
    render_dashboard,
)
from cobalt_smart_lender_ai_tpu_torch.telemetry.traceexport import (
    TRACE_CONTENT_TYPE,
    chrome_trace,
    render_chrome_trace,
)
from cobalt_smart_lender_ai_tpu_torch.telemetry.tracing import (
    Span,
    Tracer,
    current_trace_ids,
    default_tracer,
    record_span,
    span,
)

__all__ = [
    "EVENT_KINDS",
    "EXPOSITION_CONTENT_TYPE",
    "LATENCY_BUCKETS_S",
    "META_ROUTES",
    "OPENMETRICS_CONTENT_TYPE",
    "TRACE_CONTENT_TYPE",
    "Counter",
    "DeviceSampler",
    "EventJournal",
    "FeatureSketch",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Objective",
    "ProgramHandle",
    "ProgramRegistry",
    "RunLedger",
    "SLOEngine",
    "Span",
    "StructuredLogger",
    "TimeSeriesStore",
    "Tracer",
    "add_phase",
    "chrome_trace",
    "collect_phases",
    "current_event_id",
    "current_request_id",
    "current_trace_ids",
    "default_device_sampler",
    "default_objectives",
    "default_program_registry",
    "default_registry",
    "default_tracer",
    "device_info",
    "event_context",
    "fleet_scraper",
    "get_logger",
    "host_rss_bytes",
    "install_device_metrics",
    "install_program_metrics",
    "load_events",
    "load_ledger",
    "load_segments",
    "log_buckets",
    "merge_events",
    "merge_expositions",
    "merge_registries",
    "new_request_id",
    "parse_exposition",
    "psi",
    "record_span",
    "render",
    "render_chrome_trace",
    "render_dashboard",
    "request_context",
    "span",
]
