"""Render the Tracer's span ring as Chrome Trace Event / Perfetto JSON.

The span ring (`telemetry.tracing`) already holds the most recent ~2048
finished spans with parent/child nesting and thread identity; this module
turns it into the Trace Event Format that ``ui.perfetto.dev`` and
``chrome://tracing`` open natively, so a tail spike caught by the flight
recorder can be inspected on a real timeline — and laid side by side with
a ``torch.profiler`` trace of the card's kernels (the spans pass through
``torch.profiler.record_function`` during a session, so the names line
up).

Served at ``GET /debug/trace`` by the HTTP server; the training CLI's
``--trace-out`` writes the same JSON as a file.

Format notes (Trace Event Format, "JSON Object Format" flavor):

- every finished span becomes one complete event (``"ph": "X"``) with
  microsecond ``ts``/``dur`` taken straight from the tracer's monotonic
  clock — Perfetto only needs timestamps to share an origin, not to be
  wall-clock;
- events carry ``pid``/``tid`` so spans group into per-thread tracks
  (request threads vs the micro-batcher worker — exactly the boundary a
  queue-wait investigation needs to see);
- ``args`` carries span_id / parent_id / trace_id plus the span's own
  attrs, so a flight record's ``trace_id`` is searchable in the Perfetto
  query box and events join back to log lines;
- one metadata event (``"ph": "M"``, ``thread_name``) per thread names the
  tracks;
- sampled series from `telemetry.devices.DeviceSampler` (queue depth,
  device memory, host RSS) become **counter tracks** (``"ph": "C"``) —
  Perfetto draws them as area charts on the same timeline, sharing the
  spans' monotonic clock origin.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping, Sequence

from cobalt_smart_lender_ai_tpu_torch.telemetry.tracing import (
    Tracer,
    default_tracer,
)

__all__ = ["chrome_trace", "render_chrome_trace", "TRACE_CONTENT_TYPE"]

#: Content-Type for ``GET /debug/trace`` (a plain JSON document).
TRACE_CONTENT_TYPE = "application/json"


def chrome_trace(
    tracer: Tracer | None = None,
    *,
    limit: int | None = None,
    counters: Mapping[str, Sequence[tuple[float, float]]] | None = None,
    journal: Any | None = None,
    journal_limit: int | None = 512,
) -> dict[str, Any]:
    """JSON-able Chrome Trace Event document for the tracer's span ring.

    ``counters`` maps series name -> [(t_monotonic_s, value), ...]; None
    pulls whatever `telemetry.devices.default_device_sampler` has sampled
    (empty unless something started/ticked it — exporting never spawns a
    thread). ``journal`` (an `telemetry.events.EventJournal`) adds its
    control-plane events as **instant events** (``"ph": "i"``, process
    scope) on the same monotonic origin — a reload or a promotion appears
    as a pin on the request-span timeline."""
    spans = (tracer or default_tracer()).export(limit=limit)
    if counters is None:
        from cobalt_smart_lender_ai_tpu_torch.telemetry.devices import (
            default_device_sampler,
        )

        counters = default_device_sampler().series()
    pid = os.getpid()
    events: list[dict[str, Any]] = []
    seen_threads: dict[int, str] = {}
    for sp in spans:
        if sp.get("duration_s") is None:
            continue  # unfinished spans have no extent to draw
        tid = sp.get("thread_id", 0)
        if tid not in seen_threads:
            seen_threads[tid] = sp.get("thread_name") or f"thread-{tid}"
        args: dict[str, Any] = {
            "span_id": sp["span_id"],
            "parent_id": sp["parent_id"],
            "trace_id": sp["trace_id"],
        }
        args.update(sp.get("attrs") or {})
        events.append(
            {
                "name": sp["name"],
                "cat": "span",
                "ph": "X",
                "ts": round(sp["start_s"] * 1e6, 3),
                "dur": round(sp["duration_s"] * 1e6, 3),
                "pid": pid,
                "tid": tid,
                "args": args,
            }
        )
    for tid, tname in seen_threads.items():
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "args": {"name": tname},
            }
        )
    counter_count = 0
    for name in sorted(counters or {}):
        for t, value in counters[name]:
            events.append(
                {
                    "name": name,
                    "cat": "counter",
                    "ph": "C",
                    "ts": round(float(t) * 1e6, 3),
                    "pid": pid,
                    "args": {"value": float(value)},
                }
            )
            counter_count += 1
    journal_count = 0
    if journal is not None:
        for ev in journal.events(limit=journal_limit):
            args = {
                "event_id": ev["event_id"],
                "cause_id": ev.get("cause_id"),
                "replica": ev.get("replica"),
                "model": ev.get("model"),
                "trace_id": ev.get("trace_id"),
            }
            args.update(ev.get("payload") or {})
            events.append(
                {
                    "name": f"{ev['component']}.{ev['kind']}",
                    "cat": "event",
                    "ph": "i",
                    "s": "p",
                    "ts": round(float(ev["t_mono"]) * 1e6, 3),
                    "pid": pid,
                    "tid": 0,
                    "args": args,
                }
            )
            journal_count += 1
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "source": "cobalt_smart_lender_ai_tpu_torch.telemetry",
            "span_count": sum(1 for e in events if e.get("ph") == "X"),
            "counter_event_count": counter_count,
            "journal_event_count": journal_count,
        },
    }


def render_chrome_trace(
    tracer: Tracer | None = None,
    *,
    limit: int | None = None,
    counters: Mapping[str, Sequence[tuple[float, float]]] | None = None,
    journal: Any | None = None,
) -> str:
    """`chrome_trace` serialized — what ``GET /debug/trace`` sends and
    the training CLI's ``--trace-out`` writes."""
    return json.dumps(
        chrome_trace(tracer, limit=limit, counters=counters, journal=journal)
    )
