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
- `telemetry.trend` — the TREND.json ledger over benchmark records and run
  ledgers, its per-metric gates against a rolling baseline and its HTML
  page (`tools.perf_sentinel` is its CLI).

`snapshot` is one JSON-able dump of the metric values and recent spans.
The names above load their module at first use (module ``__getattr__``),
so a tool that needs only a torch-free module, such as
`tools.perf_sentinel` over `trend`, starts without importing torch.
"""

from __future__ import annotations

import importlib
from typing import Any

#: Each exported name and the submodule that defines it.
_EXPORTS: dict[str, str] = {
    "fleet_scraper": "aggregate",
    "merge_expositions": "aggregate",
    "merge_registries": "aggregate",
    "DeviceSampler": "devices",
    "default_device_sampler": "devices",
    "device_info": "devices",
    "host_rss_bytes": "devices",
    "install_device_metrics": "devices",
    "FeatureSketch": "drift",
    "psi": "drift",
    "EVENT_KINDS": "events",
    "EventJournal": "events",
    "current_event_id": "events",
    "event_context": "events",
    "load_events": "events",
    "merge_events": "events",
    "FlightRecorder": "flight",
    "META_ROUTES": "flight",
    "add_phase": "flight",
    "collect_phases": "flight",
    "StructuredLogger": "logging",
    "current_request_id": "logging",
    "get_logger": "logging",
    "new_request_id": "logging",
    "request_context": "logging",
    "Counter": "metrics",
    "EXPOSITION_CONTENT_TYPE": "metrics",
    "Gauge": "metrics",
    "Histogram": "metrics",
    "LATENCY_BUCKETS_S": "metrics",
    "MetricsRegistry": "metrics",
    "OPENMETRICS_CONTENT_TYPE": "metrics",
    "default_registry": "metrics",
    "log_buckets": "metrics",
    "parse_exposition": "metrics",
    "render": "metrics",
    "ProgramHandle": "programs",
    "ProgramRegistry": "programs",
    "default_program_registry": "programs",
    "install_program_metrics": "programs",
    "program_table": "programs",
    "RunLedger": "runledger",
    "load_ledger": "runledger",
    "Objective": "slo",
    "SLOEngine": "slo",
    "default_objectives": "slo",
    "TimeSeriesStore": "timeseries",
    "load_segments": "timeseries",
    "render_dashboard": "timeseries",
    "TRACE_CONTENT_TYPE": "traceexport",
    "chrome_trace": "traceexport",
    "render_chrome_trace": "traceexport",
    "Span": "tracing",
    "Tracer": "tracing",
    "current_trace_ids": "tracing",
    "default_tracer": "tracing",
    "record_span": "tracing",
    "span": "tracing",
}
#: The submodules, loaded as attributes at first use too.
_SUBMODULES = frozenset(
    {"aggregate", "devices", "drift", "events", "flight", "logging", "metrics", "programs",
     "runledger", "slo", "timeseries", "traceexport", "tracing", "trend"}
)


def __getattr__(name: str) -> Any:
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    globals()[name] = value
    return value


def __dir__() -> list[str]:
    return sorted(set(globals()) | set(_EXPORTS) | _SUBMODULES)


def snapshot(registry: Any | None = None, tracer: Any | None = None, *, span_limit: int = 64) -> dict:
    """One JSON-able telemetry dump: the metric values and the recent
    spans. Bench harnesses attach it beside their one JSON line, so a
    committed record carries the run's internal timings, not just the
    headline."""
    from cobalt_smart_lender_ai_tpu_torch.telemetry.metrics import default_registry
    from cobalt_smart_lender_ai_tpu_torch.telemetry.tracing import default_tracer

    return {
        "metrics": (registry or default_registry()).snapshot(),
        "spans": (tracer or default_tracer()).export(limit=span_limit),
    }


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
    "program_table",
    "psi",
    "record_span",
    "render",
    "render_chrome_trace",
    "render_dashboard",
    "request_context",
    "snapshot",
    "span",
]
