"""The port's metrics registry, spans, Perfetto export and structured logs
against the JAX package's ``telemetry``, on the CPU.

The same operations, made from a seed with numpy, go into both modules:

- `MetricsRegistry.render()` gives byte-identical exposition text (the
  classic 0.0.4 format and the OpenMetrics variant with exemplars, the
  clock pinned), and each package's `parse_exposition` reads the other's
  text as it reads its own;
- `log_buckets` gives the same floats, and the default buckets and content
  types are the reference's;
- an injected clock drives both tracers through the same spans (nested,
  after-the-fact, unfinished) and counter series: their `chrome_trace`
  documents are equal apart from the fields the reference takes from the
  process or its package — each event's ``pid`` and ``tid``, the thread
  names, and ``otherData.source`` (the package's name); each package's
  event journal, fed the same emits on the same clock, adds the same
  instant events (their ``event_id``s ranked, as each package mints its
  own) and the same ``otherData.journal_event_count``;
- `request_context` honours a client's id and mints one where there is
  none, and `StructuredLogger` writes the reference's JSON line, with the
  trace and span ids of the span in scope.
"""

from __future__ import annotations

import json
import logging
import time

import numpy as np
import pytest

import cobalt_smart_lender_ai_tpu.telemetry.events as jax_events
import cobalt_smart_lender_ai_tpu.telemetry.logging as jax_logging
import cobalt_smart_lender_ai_tpu.telemetry.metrics as jax_metrics
import cobalt_smart_lender_ai_tpu.telemetry.traceexport as jax_traceexport
import cobalt_smart_lender_ai_tpu.telemetry.tracing as jax_tracing
import cobalt_smart_lender_ai_tpu_torch.telemetry.events as port_events
import cobalt_smart_lender_ai_tpu_torch.telemetry.logging as port_logging
import cobalt_smart_lender_ai_tpu_torch.telemetry.metrics as port_metrics
import cobalt_smart_lender_ai_tpu_torch.telemetry.traceexport as port_traceexport
import cobalt_smart_lender_ai_tpu_torch.telemetry.tracing as port_tracing

SEEDS = (0, 1, 2, 3)
ROUTES = ("/predict", "/predict_bulk_csv", 'we"ird\\route\nx')


def _drive_registry(mod, seed: int):
    """One seeded sequence of counter incs, gauge sets and labelled
    histogram observes (exemplars on some) into a fresh registry of
    ``mod``."""
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    req = reg.counter("cobalt_requests_total", "requests by route", ("route", "status"))
    plain = reg.counter("cobalt_plain_total", "an unlabelled counter")
    depth = reg.gauge("cobalt_queue_depth", "a gauge", ("pool",))
    high = reg.gauge("cobalt_high_water", "set_max")
    lat = reg.histogram("cobalt_latency_seconds", "latency", ("route",))
    rows = reg.histogram(
        "cobalt_rows", "rows", buckets=mod.log_buckets(1.0, 4096.0, per_decade=3)
    )
    reg.gauge("cobalt_callback", "a collect-time gauge").set_function(lambda: 42.5)
    for i in range(200):
        route = ROUTES[int(rng.integers(len(ROUTES)))]
        op = int(rng.integers(6))
        if op == 0:
            req.labels(route=route, status=str(int(rng.choice([200, 422, 500])))).inc()
        elif op == 1:
            plain.inc(float(rng.integers(1, 5)))
        elif op == 2:
            depth.labels(pool=f"p{int(rng.integers(3))}").set(float(rng.normal() * 10))
        elif op == 3:
            high.set_max(float(rng.integers(0, 100)))
        elif op == 4:
            ex = f"t{i}" if rng.random() < 0.3 else None
            lat.labels(route=route).observe(float(rng.lognormal(-5, 2)), exemplar=ex)
        else:
            rows.observe(float(rng.integers(1, 5000)))
    return reg


@pytest.fixture
def pinned_time(monkeypatch):
    """Exemplars carry ``time.time()``: pin it for both packages."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)


@pytest.mark.parametrize("openmetrics", [False, True], ids=["classic", "openmetrics"])
@pytest.mark.parametrize("seed", SEEDS)
def test_exposition_is_byte_identical(seed, openmetrics, pinned_time):
    jax_text = _drive_registry(jax_metrics, seed).render(openmetrics=openmetrics)
    port_text = _drive_registry(port_metrics, seed).render(openmetrics=openmetrics)
    assert port_text == jax_text
    assert "cobalt_latency_seconds_bucket" in port_text


@pytest.mark.parametrize("seed", SEEDS)
def test_each_parser_reads_the_others_text(seed, pinned_time):
    jax_text = _drive_registry(jax_metrics, seed).render(openmetrics=True)
    port_text = _drive_registry(port_metrics, seed).render(openmetrics=True)
    ours = port_metrics.parse_exposition(port_text)
    assert port_metrics.parse_exposition(jax_text) == ours
    assert jax_metrics.parse_exposition(port_text) == ours
    assert jax_metrics.parse_exposition(jax_text) == ours


@pytest.mark.parametrize(
    "lo,hi,per_decade", [(5e-4, 30.0, 4), (1e-2, 7200.0, 2), (1e-5, 120.0, 3), (1.0, 4096.0, 3)]
)
def test_log_buckets_give_the_same_floats(lo, hi, per_decade):
    port = port_metrics.log_buckets(lo, hi, per_decade=per_decade)
    assert port == jax_metrics.log_buckets(lo, hi, per_decade=per_decade)


def test_defaults_and_content_types_are_the_references():
    assert port_metrics.LATENCY_BUCKETS_S == jax_metrics.LATENCY_BUCKETS_S
    assert port_metrics.EXPOSITION_CONTENT_TYPE == jax_metrics.EXPOSITION_CONTENT_TYPE
    assert port_metrics.OPENMETRICS_CONTENT_TYPE == jax_metrics.OPENMETRICS_CONTENT_TYPE
    assert port_traceexport.TRACE_CONTENT_TYPE == jax_traceexport.TRACE_CONTENT_TYPE


def test_conflicting_registrations_raise_alike():
    for mod in (jax_metrics, port_metrics):
        reg = mod.MetricsRegistry()
        reg.counter("cobalt_x_total", "x", ("a",))
        with pytest.raises(ValueError):
            reg.gauge("cobalt_x_total", "x", ("a",))
        with pytest.raises(ValueError):
            reg.counter("cobalt_x_total", "x", ("b",))


class FakeClock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _drive_tracer(tracer, clock: FakeClock, seed: int) -> None:
    """Seeded nested spans, after-the-fact spans and one span left open."""
    rng = np.random.default_rng(seed)
    with tracer.span("pipeline.run", resume=False):
        for stage in ("host_frontier", "device_ingest", "rfe", "search", "eval"):
            t0 = clock()
            clock.advance(float(rng.uniform(0.001, 2.0)))
            tracer.record_span(f"pipeline.{stage}", t0, clock())
    for i in range(int(rng.integers(3, 8))):
        with tracer.span("http.request", route="/predict", request_id=f"r{i}"):
            clock.advance(float(rng.uniform(1e-4, 1e-3)))
            with tracer.span("serve.dispatch", rows=int(rng.integers(1, 65))):
                clock.advance(float(rng.uniform(1e-4, 1e-2)))
            clock.advance(1e-5)
    open_cm = tracer.span("serve.unfinished")
    open_cm.__enter__()  # never exits: the export skips it
    clock.advance(0.5)


#: Fields the reference takes from the process or its package.
PROCESS_FIELDS = ("pid", "tid")


def _normalized(doc: dict) -> dict:
    doc = json.loads(json.dumps(doc))
    for ev in doc["traceEvents"]:
        for key in PROCESS_FIELDS:
            ev.pop(key, None)
        if ev.get("name") == "thread_name":
            ev["args"].pop("name")
    doc["otherData"].pop("source")
    instants = [ev for ev in doc["traceEvents"] if ev.get("cat") == "event"]
    rank = {eid: i for i, eid in enumerate(sorted(ev["args"]["event_id"] for ev in instants))}
    for ev in instants:
        ev["args"]["event_id"] = rank[ev["args"]["event_id"]]
        if ev["args"]["cause_id"] is not None:
            ev["args"]["cause_id"] = rank[ev["args"]["cause_id"]]
    return doc


def _drive_journal(events, clock: FakeClock, seed: int):
    """A journal on ``clock`` with a seeded handful of reload, breaker and
    canary events, one caused by another."""
    rng = np.random.default_rng(seed)
    journal = events.EventJournal(capacity=64, clock=clock, mono=clock)
    first = journal.emit("reload", "publish", model="models/gbdt/v2", payload={"status": "ok"})
    for i in range(int(rng.integers(2, 6))):
        clock.advance(float(rng.uniform(0.001, 0.5)))
        journal.emit("breaker", ("open", "half_open", "close")[i % 3], cause_id=first,
                     payload={"n": i})
    journal.emit("canary", "reject", model="v3", payload={"reasons": ["score_delta"]})
    return journal


@pytest.mark.parametrize("seed", SEEDS)
def test_chrome_trace_equals_the_references(seed):
    docs = []
    series = {
        "microbatch_queue_depth": [(100.0 + i * 0.25, float(i % 5)) for i in range(12)],
        "host_rss_bytes": [(100.1, 2.5e8), (100.6, 2.6e8)],
    }
    for tracing, traceexport, events, kw in (
        (jax_tracing, jax_traceexport, jax_events, {"jax_annotations": False}),
        (port_tracing, port_traceexport, port_events, {}),
    ):
        clock = FakeClock()
        tracer = tracing.Tracer(clock=clock, **kw)
        _drive_tracer(tracer, clock, seed)
        journal = _drive_journal(events, clock, seed)
        docs.append(traceexport.chrome_trace(tracer, counters=series, journal=journal))
    jax_doc, port_doc = docs
    assert port_doc["otherData"]["source"] == "cobalt_smart_lender_ai_tpu_torch.telemetry"
    assert _normalized(port_doc) == _normalized(jax_doc)
    assert port_doc["otherData"]["span_count"] > 0
    assert port_doc["otherData"]["counter_event_count"] == 14
    count = port_doc["otherData"]["journal_event_count"]
    assert count == jax_doc["otherData"]["journal_event_count"]
    assert count == sum(1 for ev in port_doc["traceEvents"] if ev.get("cat") == "event") >= 4


def test_record_span_parents_under_the_open_span():
    clock = FakeClock()
    tracer = port_tracing.Tracer(clock=clock, capacity=4)
    with tracer.span("pipeline.run") as run:
        tracer.record_span("pipeline.rfe", 100.0, 101.0)
    spans = tracer.export()
    assert [s["name"] for s in spans] == ["pipeline.rfe", "pipeline.run"]
    assert spans[0]["parent_id"] == run.span_id and spans[0]["trace_id"] == run.trace_id
    for i in range(6):
        tracer.record_span(f"s{i}", 0.0, 1.0)
    assert len(tracer.export()) == 4  # the ring is bounded


def test_spans_enter_record_function_only_while_profiling():
    import torch
    from torch.profiler import ProfilerActivity, profile

    tracer = port_tracing.Tracer()
    with tracer.span("outside.profiler"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("inside.profiler"):
            torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert "inside.profiler" in names and "outside.profiler" not in names


def test_request_context_honours_and_mints_ids():
    for mod in (jax_logging, port_logging):
        assert mod.current_request_id() is None
        with mod.request_context("client-id-1") as rid:
            assert rid == "client-id-1" == mod.current_request_id()
        with mod.request_context() as minted:
            assert minted and mod.current_request_id() == minted
        assert mod.current_request_id() is None
    assert len(port_logging.new_request_id()) == len(jax_logging.new_request_id())


def test_structured_log_line_is_the_references(caplog):
    lines = []
    for mod, tracing in ((jax_logging, jax_tracing), (port_logging, port_tracing)):
        caplog.clear()
        log = mod.StructuredLogger(logging.getLogger("cobalt.test"), clock=lambda: 12.5)
        with caplog.at_level(logging.INFO, logger="cobalt.test"):
            with mod.request_context("rid-7"), tracing.span("http.request") as sp:
                log.info("request_error", route="/predict", status=422, detail={"x": 1})
        (rec,) = caplog.records
        line = json.loads(rec.getMessage())
        assert (line["trace_id"], line["span_id"]) == (sp.trace_id, sp.span_id)
        del line["trace_id"], line["span_id"]
        lines.append(line)
    assert lines[1] == lines[0]
