"""The port's telemetry history against the JAX package's.

`telemetry/aggregate.py` and `telemetry/timeseries.py` are the reference's
module for module, so the same inputs must give the same outputs bit for
bit (the arithmetic is plain Python floats in both):

- the reference's sampling cases (windowed counter rates, counter resets,
  last-gauge-wins, histogram quantiles, empty windows, tier selection, a
  scrape fault) give the same points in both packages, and the reference's
  values;
- `merge_expositions` over the same snapshots is equal dict for dict, and
  keeps the reference's properties (commutative, associative, NaN skipped,
  type conflicts refused, per-source series under joined labels);
- seeded exposition sequences fed into both packages' `TimeSeriesStore`
  give equal `series_names`, `tiers` and `query` results, and equal
  `sparkline_svg` and `render_dashboard` strings;
- shipped segments round-trip through `load_segments` (either package
  reads the other's), a failed ship re-ships, a torn pointer is a gap,
  and GC keeps the newest;
- ``GET /history`` and ``GET /dashboard`` over HTTP give the reference's
  codes and bodies (the 422 details and the 404 ``history_disabled``
  included), and a live served history holds latency quantiles;
- a two-replica port fleet and the JAX fleet sample the same history
  series after the same requests, but for the program rows (each backend
  names its own programs), the model's ``kernel`` label and the JAX
  package's sharded-bulk gauge.
"""

from __future__ import annotations

import json
import math
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from cobalt_smart_lender_ai_tpu.config import ServeConfig as JaxServeConfig
from cobalt_smart_lender_ai_tpu.data import schema as jax_schema
from cobalt_smart_lender_ai_tpu.io import GBDTArtifact as JaxArtifact
from cobalt_smart_lender_ai_tpu.io import ObjectStore as JaxStore
from cobalt_smart_lender_ai_tpu.models.gbdt import GBDTClassifier as JaxClassifier
from cobalt_smart_lender_ai_tpu.serve.http_asyncio import make_async_server as jax_make_server
from cobalt_smart_lender_ai_tpu.serve.replicas import ReplicaSet as JaxReplicaSet
from cobalt_smart_lender_ai_tpu.serve.service import ScorerService as JaxScorerService
import cobalt_smart_lender_ai_tpu.telemetry.aggregate as jax_agg
import cobalt_smart_lender_ai_tpu.telemetry.metrics as jax_metrics
import cobalt_smart_lender_ai_tpu.telemetry.timeseries as jax_ts
from cobalt_smart_lender_ai_tpu_torch.config import ServeConfig
from cobalt_smart_lender_ai_tpu_torch.data import schema
from cobalt_smart_lender_ai_tpu_torch.io import ObjectStore
from cobalt_smart_lender_ai_tpu_torch.io.store import PTR_SUFFIX
from cobalt_smart_lender_ai_tpu_torch.reliability import FaultInjectingStore, FaultSpec
from cobalt_smart_lender_ai_tpu_torch.serve.http_asyncio import make_async_server
from cobalt_smart_lender_ai_tpu_torch.serve.replicas import ReplicaSet
from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService
import cobalt_smart_lender_ai_tpu_torch.telemetry as port_telemetry
import cobalt_smart_lender_ai_tpu_torch.telemetry.aggregate as port_agg
import cobalt_smart_lender_ai_tpu_torch.telemetry.metrics as port_metrics
import cobalt_smart_lender_ai_tpu_torch.telemetry.timeseries as port_ts

KEY = "models/gbdt/model_tree"
#: (timeseries module, aggregate module, metrics module) of each package.
SIDES = {"port": (port_ts, port_agg, port_metrics), "jax": (jax_ts, jax_agg, jax_metrics)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _expo(counters=None, gauges=None, hist=None):
    """A parse_exposition-shaped snapshot from plain dicts. ``hist`` maps
    family -> ({le: cumulative}, count)."""
    out = {}
    for name, v in (counters or {}).items():
        out[name] = {"type": "counter", "samples": {name: float(v)}}
    for name, v in (gauges or {}).items():
        out[name] = {"type": "gauge", "samples": {name: float(v)}}
    for fam, (buckets, count) in (hist or {}).items():
        samples = {}
        for le, c in buckets.items():
            tag = "+Inf" if math.isinf(le) else f"{le:g}"
            samples[f"{fam}_bucket|le={tag}"] = float(c)
        samples[f"{fam}_count"] = float(count)
        samples[f"{fam}_sum"] = 0.0
        out[fam] = {"type": "histogram", "samples": samples}
    return out


def _both(script, **kw):
    """Run ``script(store, clock)`` on a `TimeSeriesStore` of each package
    (same keyword arguments, a clock each); returns {side: result}."""
    out = {}
    for side, (ts, _, _) in SIDES.items():
        clock = FakeClock()
        out[side] = script(ts.TimeSeriesStore(clock=clock, **kw), clock)
    return out


def _dump(obj) -> str:
    """Exact comparison of float-bearing results (repr of every float)."""
    return json.dumps(obj, sort_keys=True)


# -- the reference's sampling cases, through both packages -------------------------------


def test_counter_becomes_windowed_rate():
    def script(ts, clock):
        snap = {"cum": 0.0}
        ts._scrape = lambda: _expo(counters={"reqs_total": snap["cum"]})
        ts.sample_once()  # the baseline: no point
        clock.t, snap["cum"] = 1.0, 5.0
        ts.sample_once()
        clock.t, snap["cum"] = 2.0, 15.0
        ts.sample_once()
        return ts.query("reqs_total:rate", step_s=1.0), ts.query("reqs_total:rate", step_s=10.0)

    got = _both(script, scrape=dict, tiers=((1.0, 16), (10.0, 16)))
    assert got["port"] == got["jax"]
    fine, coarse = got["port"]
    assert fine["tier_s"] == 1.0 and fine["points"] == [[1.0, 5.0], [2.0, 10.0]]
    assert coarse["points"] == [[0.0, 7.5]]  # 15 observations over 2 s in one bucket


def test_counter_reset_treated_as_fresh_delta():
    def script(ts, clock):
        snap = {"cum": 100.0}
        ts._scrape = lambda: _expo(counters={"reqs_total": snap["cum"]})
        ts.sample_once()
        clock.t, snap["cum"] = 1.0, 3.0  # the process restarted behind the scrape
        ts.sample_once()
        return ts.query("reqs_total:rate")["points"]

    got = _both(script, scrape=dict, tiers=((1.0, 16),))
    assert got["port"] == got["jax"] == [[1.0, 3.0]]


def test_gauge_last_value_wins_within_bucket():
    def script(ts, clock):
        snap = {"v": 1.0}
        ts._scrape = lambda: _expo(gauges={"depth": snap["v"]})
        for t, v in ((0.0, 1.0), (4.0, 9.0), (8.0, 2.0), (12.0, 7.0)):
            clock.t, snap["v"] = t, v
            ts.sample_once()
        return ts.query("depth")["points"]

    got = _both(script, scrape=dict, tiers=((10.0, 8),))
    assert got["port"] == got["jax"] == [[0.0, 2.0], [10.0, 7.0]]


def test_histogram_quantiles_interpolate_within_window():
    def script(ts, clock):
        state = {"buckets": {0.1: 0.0, 1.0: 0.0, math.inf: 0.0}, "count": 0.0}
        ts._scrape = lambda: _expo(hist={"lat": (state["buckets"], state["count"])})
        ts.sample_once()
        clock.t = 1.0  # window 1: all 10 observations under 0.1 s
        state["buckets"], state["count"] = {0.1: 10.0, 1.0: 10.0, math.inf: 10.0}, 10.0
        ts.sample_once()
        first = {q: ts.query(f"lat:{q}")["points"][-1] for q in ("p50", "p99")}
        clock.t = 2.0  # window 2: 8 in (0.1, 1], 2 in (1, +Inf)
        state["buckets"], state["count"] = {0.1: 10.0, 1.0: 18.0, math.inf: 20.0}, 20.0
        ts.sample_once()
        second = {q: ts.query(f"lat:{q}")["points"][-1] for q in ("p50", "p999")}
        return first, second, ts.query("lat:rate")["points"], ts.series_names()

    got = _both(script, scrape=dict, tiers=((1.0, 16),))
    assert _dump(got["port"]) == _dump(got["jax"])
    first, second, rate, _ = got["port"]
    assert first["p50"] == [1.0, pytest.approx(0.05)]
    assert first["p99"] == [1.0, pytest.approx(0.099)]
    assert second["p50"] == [2.0, pytest.approx(0.1 + 0.9 * 5 / 8)]
    assert second["p999"] == [2.0, pytest.approx(1.0)]  # the +Inf bucket's lower edge
    assert rate == [[1.0, 10.0], [2.0, 10.0]]  # the count is the QPS series


def test_empty_window_emits_no_quantile_point():
    def script(ts, clock):
        ts._scrape = lambda: _expo(hist={"lat": ({1.0: 5.0, math.inf: 5.0}, 5.0)})
        ts.sample_once()
        clock.t = 1.0  # no new observations
        ts.sample_once()
        with pytest.raises(KeyError):
            ts.query("lat:p50")
        return ts.series_names()

    got = _both(script, scrape=dict, tiers=((1.0, 16),))
    assert got["port"] == got["jax"] == ["lat:rate"]


def test_query_tier_selection_and_unknown_series():
    def script(ts, clock):
        ts._scrape = lambda: _expo(gauges={"g": 1.0})
        ts.sample_once()
        with pytest.raises(KeyError):
            ts.query("nope")
        return (ts.query("g")["tier_s"], ts.query("g", window_s=5000.0)["tier_s"],
                ts.query("g", step_s=60.0)["tier_s"], ts.series_names(), ts.tiers())

    got = _both(script, scrape=dict, tiers=((10.0, 360), (60.0, 720)))
    assert got["port"] == got["jax"]
    assert got["port"] == (10.0, 60.0, 60.0, ["g"],
                           [{"width_s": 10.0, "capacity": 360}, {"width_s": 60.0, "capacity": 720}])


def test_scrape_fault_never_kills_the_sampler():
    def script(ts, clock):
        calls = {"n": 0}

        def scrape():
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("transient scrape fault")
            return _expo(gauges={"g": float(calls["n"])})

        ts._scrape = scrape
        for t in (0.0, 1.0, 2.0):
            clock.t = t
            ts.sample_once()
        return ts.sample_errors, ts.query("g")["points"]

    got = _both(script, scrape=dict, tiers=((1.0, 8),))
    assert got["port"] == got["jax"] == (1, [[0.0, 1.0], [2.0, 3.0]])


def test_exactly_one_of_registry_or_scrape():
    for ts, _, metrics in SIDES.values():
        with pytest.raises(ValueError):
            ts.TimeSeriesStore()
        with pytest.raises(ValueError):
            ts.TimeSeriesStore(registry=metrics.MetricsRegistry(), scrape=lambda: {})
        with pytest.raises(ValueError, match="tier"):
            ts.TimeSeriesStore(scrape=dict, tiers=())


# -- fleet aggregation ----------------------------------------------------------------------


def _snap_a():
    return _expo(counters={"reqs_total": 10.0}, gauges={"depth": 2.0})


def _snap_b():
    return _expo(counters={"reqs_total": 32.0}, gauges={"depth": 5.0})


def test_merge_is_commutative_and_sums_counters():
    ab = port_agg.merge_expositions([_snap_a(), _snap_b()])
    assert ab == port_agg.merge_expositions([_snap_b(), _snap_a()])
    assert ab == jax_agg.merge_expositions([_snap_a(), _snap_b()])
    assert ab["reqs_total"]["samples"]["reqs_total"] == 42.0
    assert ab["depth"]["samples"]["depth"] == 7.0


def test_merge_is_associative():
    snaps = [_snap_a(), _snap_b(), _expo(counters={"reqs_total": 0.5})]
    once = port_agg.merge_expositions(snaps)
    assert once == port_agg.merge_expositions([port_agg.merge_expositions(snaps[:2]), snaps[2]])
    assert once == jax_agg.merge_expositions(snaps)


def test_merge_keeps_per_source_series_under_joined_labels():
    kw = dict(extra_labels=[{"replica": "0"}, {"replica": "1"}], keep_sources=True)
    merged = port_agg.merge_expositions([_snap_a(), _snap_b()], **kw)
    assert merged == jax_agg.merge_expositions([_snap_a(), _snap_b()], **kw)
    samples = merged["reqs_total"]["samples"]
    assert samples == {"reqs_total": 42.0, "reqs_total|replica=0": 10.0, "reqs_total|replica=1": 32.0}
    with pytest.raises(ValueError, match="extra_labels"):
        port_agg.merge_expositions([_snap_a()], extra_labels=[])


def test_merge_skips_nan_and_rejects_type_conflicts():
    snaps = [_expo(gauges={"depth": 3.0}), _expo(gauges={"depth": math.nan})]
    merged = port_agg.merge_expositions(snaps)
    assert merged == jax_agg.merge_expositions(snaps)
    assert merged["depth"]["samples"]["depth"] == 3.0
    conflict = [{"x": {"type": "counter", "samples": {"x": 1.0}}},
                {"x": {"type": "histogram", "samples": {}}}]
    for agg in (port_agg, jax_agg):
        with pytest.raises(ValueError, match="conflicts"):
            agg.merge_expositions(conflict)


def test_sample_key_round_trip():
    key = "lat_bucket|le=0.5|route=/predict"
    name, labels = port_agg.split_sample_key(key)
    assert (name, labels) == jax_agg.split_sample_key(key)
    assert (name, labels) == ("lat_bucket", {"le": "0.5", "route": "/predict"})
    assert port_agg.join_sample_key(name, labels) == key == jax_agg.join_sample_key(name, labels)


def _random_expositions(seed: int, n: int) -> list[dict]:
    """``n`` seeded snapshots of counters, gauges (some NaN) and histograms
    with labels, parsed from registries' text exposition."""
    rng = np.random.default_rng(seed)
    snaps = []
    for i in range(n):
        reg = port_metrics.MetricsRegistry()
        c = reg.counter("cobalt_requests_total", "requests", ("route", "status"))
        for route in ("/predict", "/readyz"):
            c.labels(route=route, status="200").inc(float(rng.integers(0, 50)))
        reg.gauge("cobalt_microbatch_queue_depth", "depth").set(
            math.nan if rng.random() < 0.2 else float(rng.integers(0, 9)))
        h = reg.histogram("cobalt_request_latency_seconds", "latency", ("route",))
        for v in rng.exponential(0.01, size=int(rng.integers(0, 30))):
            h.labels(route="/predict").observe(float(v))
        snaps.append(port_metrics.parse_exposition(reg.render()))
    return snaps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_over_parsed_snapshots_is_the_references(seed):
    snaps = _random_expositions(seed, 3)
    assert port_metrics.parse_exposition is not jax_metrics.parse_exposition
    extra = [{"replica": str(i)} for i in range(3)]
    for kw in ({}, {"extra_labels": extra, "keep_sources": True}):
        got = port_agg.merge_expositions(snaps, **kw)
        assert _dump(got) == _dump(jax_agg.merge_expositions(snaps, **kw))
    # and the text of each registry parses alike in both packages
    reg = port_metrics.MetricsRegistry()
    reg.histogram("lat", "latency").observe(0.004)
    assert port_metrics.parse_exposition(reg.render()) == jax_metrics.parse_exposition(reg.render())


def test_two_replica_fleet_counter_equals_sum_of_members():
    """The fleet counter series is the sum of the per-replica series, in a
    merged scrape and through a history store."""
    regs = [port_metrics.MetricsRegistry(), port_metrics.MetricsRegistry()]
    for i, reg in enumerate(regs):
        reg.counter("cobalt_requests_total", "requests").inc(10.0 * (i + 1))
    merged = port_agg.merge_registries(regs)
    assert merged == jax_agg.merge_registries(regs)
    samples = merged["cobalt_requests_total"]["samples"]
    assert samples["cobalt_requests_total"] == (samples["cobalt_requests_total|replica=0"]
                                                + samples["cobalt_requests_total|replica=1"])
    clock = FakeClock()
    ts = port_ts.TimeSeriesStore(scrape=port_agg.fleet_scraper(regs), clock=clock, tiers=((1.0, 8),))
    ts.sample_once()
    clock.t = 1.0
    regs[0].counter("cobalt_requests_total", "requests").inc(4.0)
    regs[1].counter("cobalt_requests_total", "requests").inc(6.0)
    ts.sample_once()

    def rate(s):
        return ts.query(s)["points"][-1][1]

    assert rate("cobalt_requests_total:rate") == 10.0
    assert rate("cobalt_requests_total:rate|replica=0") + rate("cobalt_requests_total:rate|replica=1") == 10.0


# -- seeded sequences, bit for bit ---------------------------------------------------------


def _sequence(seed: int, steps: int = 40) -> tuple[list[float], list[dict]]:
    """Seeded (times, snapshots): counters that grow and once reset, gauges
    with NaN holes, latency histograms, at uneven intervals."""
    rng = np.random.default_rng(100 + seed)
    times, snaps = [], []
    t, cum, reset_at = 1000.0 * seed, {"a": 0.0, "b": 0.0}, int(rng.integers(10, 30))
    buckets = (0.001, 0.005, 0.025, 0.1, math.inf)
    hist = {le: 0.0 for le in buckets}
    for i in range(steps):
        t += float(np.round(rng.uniform(0.2, 3.0), 3))
        cum = {k: (0.0 if i == reset_at and k == "a" else v) + float(rng.integers(0, 40))
               for k, v in cum.items()}
        new = rng.exponential(0.01, size=int(rng.integers(0, 12)))
        for le in buckets:
            hist[le] += float((new <= le).sum())
        snap = {
            "cobalt_requests_total": {"type": "counter", "samples": {
                f"cobalt_requests_total|route=/{k}": v for k, v in cum.items()}},
            "cobalt_microbatch_queue_depth": {"type": "gauge", "samples": {
                "cobalt_microbatch_queue_depth": math.nan if rng.random() < 0.1 else float(rng.integers(0, 9))}},
            "cobalt_device_mem_bytes": {"type": "gauge", "samples": {
                "cobalt_device_mem_bytes|device=cpu": float(rng.integers(1, 1 << 30))}},
            "cobalt_slo_burn_rate": {"type": "gauge", "samples": {
                "cobalt_slo_burn_rate|objective=p99|window=60s": float(np.round(rng.uniform(0, 20), 4))}},
            "cobalt_request_latency_seconds": _expo(hist={"cobalt_request_latency_seconds": (
                dict(hist), hist[math.inf])})["cobalt_request_latency_seconds"],
        }
        times.append(t)
        snaps.append(snap)
    return times, snaps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scripted_sequence_gives_the_references_history_bit_for_bit(seed):
    times, snaps = _sequence(seed)
    tiers = ((1.0, 16), (5.0, 8), (30.0, 4))

    def script(ts, clock):
        feed = iter(snaps)
        ts._scrape = lambda: next(feed)
        for t in times:
            clock.t = t
            ts.sample_once()
        names = ts.series_names()
        queries = {n: [ts.query(n), ts.query(n, window_s=20.0), ts.query(n, step_s=5.0),
                       ts.query(n, window_s=500.0, now=times[-1])] for n in names}
        svgs = {n: port_ts.sparkline_svg(q[0]["points"]) for n, q in queries.items()}
        return names, ts.tiers(), queries, svgs, port_ts.render_dashboard(ts, window_s=60.0)

    got = _both(script, scrape=dict, tiers=tiers)
    assert _dump(got["port"]) == _dump(got["jax"])
    names, _, queries, _, html = got["port"]
    assert "cobalt_request_latency_seconds:p99" in names and "cobalt_requests_total:rate|route=/a" in names
    assert sum(len(q[0]["points"]) for q in queries.values()) > 0 and "<svg" in html
    for side, (ts, _, _) in SIDES.items():  # each package's own renderers
        clock = FakeClock()
        store = ts.TimeSeriesStore(scrape=dict, clock=clock, tiers=tiers)
        feed = iter(snaps)
        store._scrape = lambda: next(feed)
        for t in times:
            clock.t = t
            store.sample_once()
        assert ts.render_dashboard(store, window_s=60.0) == html, side
        assert [ts.sparkline_svg(queries[n][0]["points"]) for n in names] == [
            port_ts.sparkline_svg(queries[n][0]["points"]) for n in names]


def test_sparkline_and_dashboard_edge_cases_are_the_references():
    cases = [[], [[0.0, 1.0]], [[0.0, 1.0], [1.0, 1.0]], [[0.0, math.nan], [1.0, 2.0], [2.0, math.inf]],
             [[0.0, -3.5], [2.5, 1e9], [5.0, 4e-4]]]
    for pts in cases:
        assert port_ts.sparkline_svg(pts) == jax_ts.sparkline_svg(pts)
        assert port_ts.sparkline_svg(pts, width=100, height=20, stroke="#000") == jax_ts.sparkline_svg(
            pts, width=100, height=20, stroke="#000")
    empty = {side: ts.render_dashboard(ts.TimeSeriesStore(scrape=dict), title="t<&>")
             for side, (ts, _, _) in SIDES.items()}
    assert empty["port"] == empty["jax"] and "no samples yet" in empty["port"]


def test_render_dashboard_with_samples():
    def script(ts, clock):
        state = {"buckets": {0.1: 0.0, math.inf: 0.0}, "count": 0.0}
        ts._scrape = lambda: _expo(
            hist={"cobalt_request_latency_seconds": (state["buckets"], state["count"])},
            gauges={"cobalt_microbatch_queue_depth": 3.0},
        )
        for t in (0.0, 1.0, 2.0):
            clock.t = t
            state["buckets"] = {0.1: 5.0 * t, math.inf: 5.0 * t}
            state["count"] = 5.0 * t
            ts.sample_once()
        return port_ts.render_dashboard(ts)

    got = _both(script, scrape=dict, tiers=((1.0, 32),))
    assert got["port"] == got["jax"]
    html = got["port"]
    assert "cobalt_request_latency_seconds:p99" in html and "<svg" in html
    assert "cobalt_microbatch_queue_depth" in html


# -- durable segments ----------------------------------------------------------------------


def _gauge_store(clock, store, ts=port_ts, **kw):
    snap = {"v": 0.0}
    hist = ts.TimeSeriesStore(
        scrape=lambda: _expo(gauges={"g": snap["v"]}),
        clock=clock,
        tiers=((1.0, 64),),
        store=store,
        ship_interval_s=0.0,  # ship only when the test says so
        **kw,
    )
    return hist, snap


def test_segment_ship_and_load_round_trip(tmp_path):
    store = ObjectStore(str(tmp_path / "lake"))
    clock = FakeClock()
    ts, snap = _gauge_store(clock, store)
    for t in (0.0, 1.0, 2.0):
        clock.t, snap["v"] = t, t * 10
        ts.sample_once()
    key = ts.ship()
    assert key == "telemetry/history/segment-00000001.json" and store.verify_pointer(key)
    assert ts.ship() is None  # nothing new since
    clock.t, snap["v"] = 3.0, 30.0
    ts.sample_once()
    assert ts.ship() is not None  # an append-only second segment
    want = [[0.0, 0.0], [1.0, 10.0], [2.0, 20.0], [3.0, 30.0]]
    assert port_ts.load_segments(store)["g"] == want
    # the reference reads the port's segments, and the port the reference's
    assert jax_ts.load_segments(JaxStore(str(tmp_path / "lake")))["g"] == want
    jstore = JaxStore(str(tmp_path / "jax_lake"))
    jclock = FakeClock()
    jts, jsnap = _gauge_store(jclock, jstore, ts=jax_ts)
    for t in (0.0, 1.0, 2.0, 3.0):
        jclock.t, jsnap["v"] = t, t * 10
        jts.sample_once()
    jts.ship()
    assert port_ts.load_segments(ObjectStore(str(tmp_path / "jax_lake"))) == port_ts.load_segments(store)
    with pytest.raises(ValueError):
        port_ts.TimeSeriesStore(scrape=dict).ship()


def test_failed_ship_reships_same_points(tmp_path):
    inner = ObjectStore(str(tmp_path / "lake"))
    faulty = FaultInjectingStore(inner, faults={"put": FaultSpec(fail_after=0, max_faults=2)})
    clock = FakeClock()
    ts, snap = _gauge_store(clock, faulty)
    ts.ship_interval_s = 0.5  # every tick is due
    for t in (0.0, 1.0, 2.0):
        clock.t, snap["v"] = t, t
        ts.sample_once()  # shipping faults are swallowed and counted
    assert ts.ship_failures >= 1
    clock.t, snap["v"] = 3.0, 3.0
    ts.sample_once()  # the fault budget is spent: this ship lands
    assert port_ts.load_segments(inner)["g"] == [[0.0, 0.0], [1.0, 1.0], [2.0, 2.0], [3.0, 3.0]]


def test_torn_segment_is_a_gap_not_a_crash(tmp_path):
    store = ObjectStore(str(tmp_path / "lake"))
    clock = FakeClock()
    ts, snap = _gauge_store(clock, store)
    ts.sample_once()
    first = ts.ship()
    clock.t, snap["v"] = 1.0, 5.0
    ts.sample_once()
    second = ts.ship()
    store.put_bytes(first, b'{"torn')  # its md5 pointer no longer verifies
    assert port_ts.load_segments(store)["g"] == [[1.0, 5.0]]
    assert jax_ts.load_segments(JaxStore(str(tmp_path / "lake")))["g"] == [[1.0, 5.0]]
    assert store.verify_pointer(second)


def test_segment_gc_retains_newest(tmp_path):
    store = ObjectStore(str(tmp_path / "lake"))
    clock = FakeClock()
    ts, snap = _gauge_store(clock, store, retain_segments=2)
    for t in range(5):
        clock.t, snap["v"] = float(t), float(t)
        ts.sample_once()
        ts.ship()
    segs = [k for k in store.list("telemetry/history/") if not k.endswith(PTR_SUFFIX)]
    assert len(segs) == 2
    assert port_ts.load_segments(store)["g"] == [[3.0, 3.0], [4.0, 4.0]]


def test_sampler_thread_starts_and_stops():
    ts = port_ts.TimeSeriesStore(scrape=lambda: _expo(gauges={"g": 1.0}), interval_s=0.01,
                                 tiers=((0.01, 64),))
    with ts:
        deadline = time.monotonic() + 10.0
        while not ts.series_names() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert ts.start() is ts  # idempotent
    assert ts.series_names() == ["g"] and ts._thread is None
    assert port_telemetry.TimeSeriesStore is port_ts.TimeSeriesStore
    assert port_telemetry.merge_registries is port_agg.merge_registries


# -- over HTTP --------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def store_root(tmp_path_factory):
    """A small forest trained by the JAX package on the 20 serving features,
    saved by its artifact writer; both packages serve it."""
    rng = np.random.default_rng(43)
    F = len(jax_schema.SERVING_FEATURES)
    X = rng.normal(size=(1024, F)).astype(np.float32)
    X[:, 12:] = rng.integers(0, 2, size=(1024, F - 12))
    y = X[:, 0] - 0.6 * X[:, 2] + 0.4 * X[:, 13] + 0.3 * rng.normal(size=1024) > 0
    model = JaxClassifier(n_estimators=6, max_depth=3, n_bins=32)
    model.fit(X, y.astype(np.int32))
    root = tmp_path_factory.mktemp("torch_history") / "lake"
    JaxArtifact(
        forest=model.forest, bin_spec=model.bin_spec, feature_names=tuple(jax_schema.SERVING_FEATURES)
    ).save(JaxStore(str(root)), KEY)
    return str(root)


HISTORY = dict(microbatch_enabled=False, history_interval_s=0.03,
               history_tiers=((0.05, 400), (1.0, 120), (60.0, 60)))


def _services(root: str, **kw):
    port = ScorerService.from_store(ObjectStore(root), ServeConfig(**{**HISTORY, **kw}), device="cpu")
    ref = JaxScorerService.from_store(JaxStore(root), JaxServeConfig(**{**HISTORY, **kw},
                                                                      prewarm_all_buckets=False))
    return port, ref


def _get(url: str):
    try:
        with urllib.request.urlopen(url) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read()


def _payload(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {
        n: int(rng.integers(0, 2)) if n in schema.SERVING_INT_FEATURES else float(np.round(rng.normal(), 3))
        for n in schema.SERVING_FEATURES
    }


def test_bare_service_builds_history_but_starts_no_thread(store_root):
    port, ref = _services(store_root)
    try:
        assert isinstance(port.history, port_ts.TimeSeriesStore) and port.history._thread is None
        assert port.history.tiers() == ref.history.tiers() == [
            {"width_s": 0.05, "capacity": 400}, {"width_s": 1.0, "capacity": 120},
            {"width_s": 60.0, "capacity": 60}]
        assert port.history.interval_s == ref.history.interval_s == 0.03
        port.predict_single(_payload())
        assert port.history._thread is None
    finally:
        port.close()
        ref.close()
    assert port.history._thread is None


def test_live_history_latency_quantiles_span_windows(store_root):
    """A served history fills as requests arrive: a latency-quantile series
    over at least 3 windows of the finest tier, and a QPS series."""
    service = ScorerService.from_store(ObjectStore(store_root), ServeConfig(**HISTORY), device="cpu")
    server = make_async_server(service, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{server.port}"
    series = "cobalt_request_latency_seconds:p99|route=/predict|status=200"
    try:
        assert service.history._thread is not None and service.history._thread.is_alive()
        body = json.dumps(_payload()).encode()
        deadline = time.monotonic() + 30.0
        points = []
        while time.monotonic() < deadline:
            for _ in range(8):
                req = urllib.request.Request(url + "/predict", data=body,
                                             headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req) as r:
                    assert r.status == 200
            status, _, raw = _get(url + "/history?series=" + urllib.parse.quote(series))
            if status == 200:
                doc = json.loads(raw)
                points = doc["points"]
                if len(points) >= 3:
                    break
        assert len(points) >= 3, f"only {len(points)} windows sampled"
        assert len({t for t, _ in points}) == len(points) and all(v >= 0 for _, v in points)
        assert doc["tier_s"] == 0.05
        qps = "cobalt_request_latency_seconds:rate|route=/predict|status=200"
        status, _, raw = _get(url + "/history?series=" + urllib.parse.quote(qps))
        assert status == 200 and len(json.loads(raw)["points"]) >= 1
    finally:
        server.close()
        service.close()
    assert service.history._thread is None  # close stops the sampler


#: The /history and /dashboard queries both servers answer; the scripted
#: history makes the 200 bodies comparable byte for byte.
HTTP_SCRIPT = (
    "/history",
    "/history?series=cobalt_request_latency_seconds%3Ap99",
    "/history?series=cobalt_request_latency_seconds%3Ap99&window=20",
    "/history?series=cobalt_request_latency_seconds%3Ap99&window=3000",
    "/history?series=cobalt_requests_total%3Arate%7Croute%3D%2Fa&step=5",
    "/history?series=no_such_series",
    "/history?series=x&window=abc",
    "/history?series=x&window=-5",
    "/history?series=x&step=0",
    "/history?series=x&window=inf",
    "/history?window=nan",
    "/dashboard",
    "/dashboard?window=30",
    "/dashboard?window=nope",
)


def _http_drill(service, make_server, ts_module) -> list:
    times, snaps = _sequence(4, steps=30)
    clock = FakeClock()
    feed = iter(snaps)
    service.history = ts_module.TimeSeriesStore(scrape=lambda: next(feed), clock=clock,
                                                tiers=((1.0, 16), (5.0, 8), (60.0, 4)))
    for t in times:
        clock.t = t
        service.history.sample_once()
    server = make_server(service, "127.0.0.1", 0)
    try:
        return [(path, *_get(f"http://127.0.0.1:{server.port}{path}")) for path in HTTP_SCRIPT]
    finally:
        server.close()


def test_history_and_dashboard_over_http_are_the_references(store_root):
    port, ref = _services(store_root)
    try:
        got = _http_drill(port, make_async_server, port_ts)
        want = _http_drill(ref, jax_make_server, jax_ts)
    finally:
        port.close()
        ref.close()
    assert got == want
    codes = [status for _, status, _, _ in got]
    assert codes == [200] * 5 + [422] * 6 + [200, 200, 422]
    for path, status, ctype, body in got:
        if status == 422:
            doc = json.loads(body)
            assert doc["error"] == "invalid_input" and ctype.startswith("application/json"), path
        elif path.startswith("/dashboard"):
            assert ctype.startswith("text/html") and b"<svg" in body and b"Latency quantiles" in body
    assert "unknown series" in json.loads(got[5][3])["detail"]
    assert set(json.loads(got[0][3])) == {"series", "tiers"}
    assert json.loads(got[3][3])["tier_s"] == 60.0  # a window past the finest ring escalates


def test_history_disabled_404_is_the_references(store_root):
    port, ref = _services(store_root, history_enabled=False)
    out = {}
    try:
        assert port.history is None and ref.history is None
        for side, svc, make in (("port", port, make_async_server), ("jax", ref, jax_make_server)):
            server = make(svc, "127.0.0.1", 0)
            try:
                out[side] = [_get(f"http://127.0.0.1:{server.port}{r}") for r in ("/history", "/dashboard")]
            finally:
                server.close()
    finally:
        port.close()
        ref.close()
    assert out["port"] == out["jax"]
    assert [(s, json.loads(b)["error"]) for s, _, b in out["port"]] == [(404, "history_disabled")] * 2


def _fleet_series(fleet, clock, payloads) -> set[str]:
    fleet.history._clock = clock
    fleet.history.sample_once()
    for p in payloads:
        fleet.predict_single(p)
    clock.t += 10.0
    fleet.history.sample_once()
    return set(fleet.history.series_names())


def _normalised(names: set[str]) -> set[str]:
    """Series names but for what each backend names its own way: the
    program rows (the port's are its kernels, the reference's its XLA
    executables) and the model-info ``kernel`` label."""
    out = set()
    for n in names:
        if n.startswith("cobalt_program_"):
            continue
        out.add(n.replace("|kernel=plain|", "|kernel=").replace("|kernel=fused|", "|kernel="))
    return out


def test_fleet_history_series_are_the_references(store_root):
    kw = dict(replicas=2, microbatch_enabled=False, score_cache_size=0,
              supervisor_probe_interval_s=3600.0)
    port = ReplicaSet.from_store(ObjectStore(store_root), ServeConfig(**kw), device="cpu")
    ref = JaxReplicaSet.from_store(JaxStore(store_root), JaxServeConfig(
        **kw, precompile_batch_buckets=(), prewarm_all_buckets=False))
    try:
        payloads = [_payload(i) for i in range(6)]
        got = _fleet_series(port, FakeClock(100.0), payloads)
        want = _fleet_series(ref, FakeClock(100.0), payloads)
    finally:
        port.close()
        ref.close()
    # the JAX package's sharded bulk path (ROADMAP A6) has a gauge the port lacks
    jax_only = {n for n in _normalised(want) - _normalised(got) if n.startswith("cobalt_bulk_shards")}
    assert jax_only == {"cobalt_bulk_shards", "cobalt_bulk_shards|replica=0", "cobalt_bulk_shards|replica=1"}
    assert _normalised(got) == _normalised(want) - jax_only
    # fleet sums beside per-replica series, as the reference samples them
    for name in ("cobalt_replica_count", "cobalt_supervisor_state|replica=1",
                 "cobalt_bulk_rows_total:rate", "cobalt_bulk_rows_total:rate|replica=1",
                 "cobalt_host_rss_bytes", "cobalt_host_rss_bytes|replica=0",
                 "cobalt_slo_burn_rate|objective=predict_latency_p99|replica=1|window=60s"):
        assert name in got, name
    assert any(n.startswith("cobalt_program_dispatches_total:rate|program=score_forest_plain/") for n in got)
