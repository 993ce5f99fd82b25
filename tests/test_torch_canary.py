"""The port's canary loop (`serve/canary.py`, `telemetry/drift.py`, the
service's lifecycle and routes) against the JAX package's.

Held to the JAX package within 1e-12 on seeded data: `psi`,
`FeatureSketch` (edges and counts exact, ``observe_row`` by name, its JSON)
and `rank_correlation`, NaN cases included. The promotion gate fed the same
(champion, canary, latency) windows gives the same checks within 1e-6 and
the same ``reasons``.

Then the loop on CPU services at a small size (3,000 loans, 20 trees of
depth 3, retrained by the port's `tools.retrain`), over HTTP, on a manual
clock, with ``flush()`` and never a wall-clock wait: bootstrap to
``latest``, a canary shadow-scored (each shadow probability is the host
sigmoid of the JAX package's margin for that row on the canary's forest,
bit for bit), promoted (200, ``model_version`` moves, ``cobalt_model_info``
too), a label-shuffled candidate rejected (409 ``promotion_rejected`` with
the gate's reasons, ``latest`` unchanged), a manual rollback, a forced
promotion rolled back by an SLO fast burn inside the guard window, the
breaker tripping and closing on a failing store, and every action on
``/events`` in order with its log lines carrying its ``event_id``; the drift
alarm fires once; the routes answer 409 and ``disabled`` without a canary.
"""

from __future__ import annotations

import json
import logging
import math
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from cobalt_smart_lender_ai_tpu.config import ServeConfig as JaxServeConfig
from cobalt_smart_lender_ai_tpu.io import GBDTArtifact as JaxArtifact
from cobalt_smart_lender_ai_tpu.io import ObjectStore as JaxStore
from cobalt_smart_lender_ai_tpu.models.gbdt import predict_margin as jax_predict_margin
from cobalt_smart_lender_ai_tpu.serve.canary import CanaryController as JaxCanary
from cobalt_smart_lender_ai_tpu.serve.canary import rank_correlation as jax_rank_correlation
from cobalt_smart_lender_ai_tpu.telemetry import MetricsRegistry as JaxMetrics
from cobalt_smart_lender_ai_tpu.telemetry.drift import FeatureSketch as JaxSketch
from cobalt_smart_lender_ai_tpu.telemetry.drift import psi as jax_psi
from cobalt_smart_lender_ai_tpu_torch.config import ReliabilityConfig, ServeConfig
from cobalt_smart_lender_ai_tpu_torch.data import (
    clean_raw_frame,
    engineer_features,
    prepare_cleaned_frame,
    schema,
    synthetic_lendingclub_frame,
)
from cobalt_smart_lender_ai_tpu_torch.data.features import drop_training_leakage
from cobalt_smart_lender_ai_tpu_torch.io import ModelRegistry, ObjectStore
from cobalt_smart_lender_ai_tpu_torch.reliability import FaultInjectingStore, FaultSpec
from cobalt_smart_lender_ai_tpu_torch.serve.canary import CanaryController, rank_correlation
from cobalt_smart_lender_ai_tpu_torch.serve.http_asyncio import make_async_server
from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService
from cobalt_smart_lender_ai_tpu_torch.telemetry import (
    FeatureSketch,
    MetricsRegistry,
    load_events,
    parse_exposition,
    psi,
)
from cobalt_smart_lender_ai_tpu_torch.tools.retrain import retrain_candidate

TOL_EXACT = 1e-12
TOL_GATE = 1e-6
MINI = dict(rows=3000, n_estimators=20, max_depth=3, train_mlp=False, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- drift and rank correlation ---------------------------------------------------


def _drift_data(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(1500, 5))
    X[:, 1] = np.round(X[:, 1] * 2)  # few distinct values: fewer edges
    X[:, 2] = 3.0  # constant
    X[rng.random(1500) < 0.1, 3] = np.nan
    X[:, 4] = rng.exponential(size=1500)
    return X


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_psi_is_the_references(seed):
    rng = np.random.default_rng(seed)
    for _ in range(8):
        bins = int(rng.integers(2, 14))
        e = rng.integers(0, 50, size=bins)
        a = rng.integers(0, 50, size=bins)
        assert abs(psi(e, a) - jax_psi(e, a)) <= TOL_EXACT
    assert psi(e, e) == jax_psi(e, e) and abs(psi(e, e)) <= TOL_EXACT
    assert psi(np.zeros(4), np.zeros(4)) == jax_psi(np.zeros(4), np.zeros(4))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_feature_sketch_is_the_references(seed):
    X = _drift_data(seed)
    names = ["a", "b", "c", "d", "e"]
    for bins in (4, 10):
        port = FeatureSketch.from_data(X, names, bins=bins)
        ref = JaxSketch.from_data(X, names, bins=bins)
        assert len(port.edges) == len(ref.edges)
        for pe, re in zip(port.edges, ref.edges):
            np.testing.assert_array_equal(pe, re)
        np.testing.assert_array_equal(port.counts, ref.counts)
        assert port.n == ref.n == 1500 and port.to_json() == ref.to_json()
        live_p, live_r = port.empty_like(), ref.empty_like()
        Y = _drift_data(seed + 10)
        Y[:, 0] += 2.0
        live_p.observe(Y)
        live_r.observe(Y)
        rows = [{"a": 0.5, "c": 3.0, "e": float("nan")}, {"b": -1.0, "zzz": 5.0}, {}]
        for row in rows:
            live_p.observe_row(row)
            live_r.observe_row(row)
        np.testing.assert_array_equal(live_p.counts, live_r.counts)
        got, want = port.psi_vs(live_p), ref.psi_vs(live_r)
        assert got.keys() == want.keys()
        assert all(abs(got[k] - want[k]) <= TOL_EXACT for k in got)
        assert got["a"] > 0.25  # the shifted feature drifts
        back = FeatureSketch.from_json(json.loads(json.dumps(ref.to_json())))
        np.testing.assert_array_equal(back.counts, port.counts)


def test_rank_correlation_is_the_references():
    rng = np.random.default_rng(4)
    a = rng.random(200)
    cases = [
        (a, a), (a, 1.0 - a), (a, a + 0.1 * rng.normal(size=200)), (a, rng.random(200)),
        (a, np.full(200, 0.3)), (np.full(200, 0.3), a), (np.array([1.0]), np.array([1.0])),
        (np.array([]), np.array([])), (np.round(a, 1), np.round(a * 3, 1)),
        (np.where(a < 0.1, np.nan, a), a), (a, np.where(a > 0.9, np.nan, a)),
        (np.full(5, np.nan), np.arange(5.0)),
    ]
    for x, y in cases:
        got, want = rank_correlation(x, y), jax_rank_correlation(x, y)
        assert (math.isnan(got) and math.isnan(want)) or abs(got - want) <= TOL_EXACT, (got, want)
    assert rank_correlation(a, np.full(200, 0.3)) == 0.0
    assert rank_correlation(a, a) == pytest.approx(1.0)


# -- the gate ---------------------------------------------------------------------------


class _Facade:
    """The least a controller needs of its service to judge a window."""

    def __init__(self, registry):
        self.registry = registry
        self.device = torch.device("cpu")
        self.journal = None


def _windows():
    rng = np.random.default_rng(9)
    champ = rng.random(120)
    lat = list(rng.uniform(1e-3, 2e-3, 120))
    fast = list(rng.uniform(1e-4, 5e-4, 120))
    slow = list(rng.uniform(1e-2, 2e-2, 120))
    some_none = [None if i % 3 == 0 else v for i, v in enumerate(lat)]
    return {
        "good": (list(zip(champ, champ + rng.normal(0, 0.01, 120), lat, fast)), 120, 0, True),
        "degraded": (list(zip(champ, rng.random(120), lat, fast)), 120, 0, True),
        "few": (list(zip(champ[:5], champ[:5], lat[:5], fast[:5])), 5, 0, True),
        "shifted": (list(zip(champ, champ * 0.5 + 0.4, some_none, fast)), 120, 0, True),
        "errors": (list(zip(champ[:90], champ[:90], lat[:90], fast[:90])), 90, 10, True),
        "constant": (list(zip(champ, np.full(120, 0.3), lat, fast)), 120, 0, True),
        "slow": (list(zip(champ, champ, lat, slow)), 120, 0, True),
        "empty": ([], 0, 0, False),
    }


def _judge(ctrl, window, shadowed, errors, loaded) -> dict:
    ctrl._window.extend(window)
    ctrl._win_shadowed, ctrl._win_errors = shadowed, errors
    ctrl._canary_model = object() if loaded else None
    try:
        return ctrl.evaluate_gate()
    finally:
        ctrl._canary_model = None
        ctrl.reset_window()


@pytest.mark.parametrize("case", list(_windows()))
def test_gate_is_the_references(case, tmp_path):
    window, shadowed, errors, loaded = _windows()[case]
    port = CanaryController(_Facade(MetricsRegistry()), ObjectStore(str(tmp_path / "p")),
                            config=ServeConfig(), compile_fn=lambda art: None)
    ref = JaxCanary(_Facade(JaxMetrics()), JaxStore(str(tmp_path / "j")),
                    config=JaxServeConfig(), compile_fn=lambda art: None)
    try:
        got = _judge(port, window, shadowed, errors, loaded)
        want = _judge(ref, window, shadowed, errors, loaded)
    finally:
        port.close()
        ref.close()
    assert got["reasons"] == want["reasons"] and got["eligible"] == want["eligible"]
    assert got["checks"].keys() == want["checks"].keys()
    for key, value in got["checks"].items():
        assert abs(value - want["checks"][key]) <= TOL_GATE, key
    expected = {"good": [], "few": ["insufficient_samples:5<50"], "empty": ["no_canary_loaded"]}
    if case in expected:
        assert got["reasons"] == expected[case] or got["reasons"][: len(expected[case])] == expected[case]
    if case in ("degraded", "constant"):
        assert any(r.startswith("score_correlation") for r in got["reasons"])


# -- the loop on CPU services -------------------------------------------------------------


class ManualClock:
    def __init__(self, start: float = 100.0):
        self.now = start

    def __call__(self) -> float:
        return self.now

    def advance(self, s: float) -> None:
        self.now += s


@pytest.fixture(scope="module")
def fresh_rows() -> list[dict]:
    """Rows of a fresh synthetic table through the host path, the 20
    serving features by name: the training distribution, NaN cells kept."""
    cleaned, _ = clean_raw_frame(synthetic_lendingclub_frame(n_rows=1200, seed=99))
    tree, _, _ = engineer_features(prepare_cleaned_frame(cleaned), device="cpu")
    X = drop_training_leakage(tree).select(schema.SERVING_FEATURES).X.numpy()
    return [dict(zip(schema.SERVING_FEATURES, map(float, x))) for x in X]


@pytest.fixture(scope="module")
def traffic_rows(fresh_rows) -> list[dict]:
    """`fresh_rows` as valid /predict bodies: NaN cells as 0, the
    indicators as ints."""
    return [
        {k: (int(v) if k in schema.SERVING_INT_FEATURES else v)
         for k, v in ((k, v if np.isfinite(v) else 0.0) for k, v in row.items())}
        for row in fresh_rows
    ]


@pytest.fixture(scope="module")
def lake_root(tmp_path_factory) -> str:
    root = tmp_path_factory.mktemp("torch_canary") / "lake"
    report = retrain_candidate(ObjectStore(str(root)), seed=5, bootstrap=True, **MINI)
    assert report["bootstrapped"] and report["channel"] == "latest" and report["version"] == 1
    return str(root)


def _http(base: str, path: str, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _loop_config(**kw) -> ServeConfig:
    base = dict(
        canary_enabled=True,
        canary_min_samples=16,
        # shadow and request timings are both sub-ms on the CPU; the ratio
        # is still computed and reported
        canary_max_latency_ratio=1000.0,
        drift_min_samples=8,
        # the guard window reacts to availability: latency objectives so
        # loose that only the driven 5xx burn
        slo_p99_ms=5000.0,
        slo_p999_ms=5000.0,
        reliability=ReliabilityConfig(breaker_failure_threshold=3, breaker_reset_s=0.5),
    )
    base.update(kw)
    return ServeConfig(**base)


def _shadow(base: str, rows: list[dict], version: str) -> list[float]:
    probs = []
    for row in rows:
        status, body = _http(base, "/predict", row)
        assert status == 200 and body["model_version"] == version, body
        assert "canary" not in json.dumps(body)
        probs.append(body["prob_default"])
    return probs


def _canary_margins(store_root: str, key: str, rows: list[dict], service) -> np.ndarray:
    """The JAX package's margins for ``rows`` on the forest at ``key``."""
    art = JaxArtifact.load(JaxStore(store_root), key)
    X = np.stack([service._model.rows_array([r])[0] for r in rows])
    return np.asarray(jax_predict_margin(art.forest, X))


def test_the_loop_on_cpu_services(lake_root, traffic_rows, tmp_path, caplog):
    import shutil

    root = str(tmp_path / "lake")
    shutil.copytree(lake_root, root)
    inner = ObjectStore(root)
    flaky = FaultInjectingStore(inner, faults={}, registry=MetricsRegistry())
    clock = ManualClock()
    reg = ModelRegistry(inner)
    svc = ScorerService.from_store(flaky, _loop_config(), device="cpu", clock=clock)
    server = make_async_server(svc, "127.0.0.1", 0)
    base = f"http://127.0.0.1:{server.port}"
    rows = iter(traffic_rows)
    caplog.set_level(logging.INFO, logger="cobalt")
    try:
        assert svc._model_key == "models/gbdt/v1"
        assert svc.model_info == {"version": "v1", "channel": "latest",
                                  "provenance_md5": reg.channel("gbdt", "latest")["md5"]}
        status, ready = _http(base, "/readyz")
        assert ready["model"]["version"] == "v1" and not ready["canary"]["loaded"]
        assert ready["events"]["emitted"] == 0

        # a good candidate in canary, shadow-scored, promoted
        retrain_candidate(inner, seed=6, **MINI)
        svc.canary.refresh()
        _, ready = _http(base, "/readyz")
        assert ready["canary"]["loaded"] and ready["canary"]["canary"]["version"] == 2
        batch = [next(rows) for _ in range(40)]
        champ = _shadow(base, batch, "v1")
        assert svc.canary.flush()
        window = list(svc.canary._window)
        assert len(window) == 40 and int(svc.canary._m_shadow.value) == 40
        assert [w[0] for w in window] == champ
        margins = _canary_margins(root, "models/gbdt/v2", batch, svc)
        assert [w[1] for w in window] == [float(1.0 / (1.0 + np.exp(-float(m)))) for m in margins]
        status, body = _http(base, "/admin/promote", {})
        assert status == 200 and body["status"] == "promoted", body
        assert body["promoted_version"] == 2 and body["previous_version"] == 1
        assert body["gate"]["checks"]["score_rank_correlation"] >= svc.config.canary_min_score_corr
        assert _shadow(base, [next(rows)], "v2")
        text = svc.registry.render()
        assert 'cobalt_model_info{version="v2",channel="latest"' in text
        assert 'cobalt_model_info{version="v1",channel="latest",' in text and ' 0' in text
        assert reg.channel("gbdt", "latest")["version"] == 2 and reg.channel("gbdt", "canary") is None

        # a label-shuffled candidate: rejected, nothing moves
        retrain_candidate(inner, seed=7, degrade=True, **MINI)
        svc.canary.refresh()
        _shadow(base, [next(rows) for _ in range(40)], "v2")
        assert svc.canary.flush()
        status, body = _http(base, "/admin/promote", {})
        assert status == 409 and body["error"] == "promotion_rejected", body
        assert any(r.startswith(("score_correlation", "score_delta")) for r in body["report"]["reasons"])
        assert reg.channel("gbdt", "latest")["version"] == 2 and svc.model_info["version"] == "v2"

        # manual rollback, then a forced promotion rolled back by a fast burn
        status, body = _http(base, "/admin/rollback", {"reason": "drill"})
        assert status == 200 and body["restored_version"] == 1 and body["trigger"] == "manual"
        assert reg.channel("gbdt", "previous")["version"] == 2
        assert _shadow(base, [next(rows)], "v1")
        status, body = _http(base, "/admin/promote", {"force": True})
        assert status == 200 and body["promoted_version"] == 3 and not body["gate"]["eligible"]
        assert svc.canary.status()["guard"]["promoted_version"] == 3
        for _ in range(20):
            if svc.model_info["version"] == "v1":
                break
            clock.advance(0.5)  # past the SLO engine's 0.25 s cache
            svc.observe_request("/predict", 500, 0.001, code="internal")
        assert svc.model_info["version"] == "v1"
        latest = reg.channel("gbdt", "latest")
        assert latest["version"] == 1 and latest["rolled_back_from"] == 3
        _, ready = _http(base, "/readyz")
        assert ready["canary"]["guard"] is None
        assert ready["canary"]["last_promotion"]["trigger"] == "slo_fast_burn"

        # the breaker, on a store whose reads fail
        flaky.faults["get"] = FaultSpec(rate=1.0)
        reloads = [_http(base, "/admin/reload", {})[0] for _ in range(4)]
        del flaky.faults["get"]
        clock.advance(1.0)
        reloads.append(_http(base, "/admin/reload", {})[0])
        assert reloads == [500, 500, 500, 503, 200]
        assert svc.store_breaker.transitions == ["open", "half_open", "closed"]

        text = svc.registry.render()
        parse_exposition(text)
        for line in ('cobalt_canary_promotions_total{outcome="rejected"} 1',
                     'cobalt_canary_promotions_total{outcome="promoted"} 2',
                     'cobalt_canary_rollbacks_total{trigger="slo_fast_burn"} 1',
                     'cobalt_canary_rollbacks_total{trigger="manual"} 1',
                     # 40 + 40 shadowed, and one row after the manual rollback,
                     # with v3 still in the canary channel
                     "cobalt_canary_shadow_total 81", "cobalt_canary_errors_total 0",
                     'cobalt_events_total{component="breaker",kind="open"} 1'):
            assert line in text, line

        status, body = _http(base, "/events")
        assert status == 200
        got = [(e["component"], e["kind"], e["model"]) for e in body["events"]]
        v = {n: f"models/gbdt/v{n}" for n in (1, 2, 3)}
        assert got == [
            ("reload", "publish", v[2]), ("canary", "promote", "v2"),
            ("canary", "reject", "v3"),
            ("reload", "publish", v[1]), ("canary", "rollback", "v1"),
            ("reload", "publish", v[3]), ("canary", "promote", "v3"),
            ("reload", "publish", v[1]), ("canary", "rollback", "v1"),
            ("reload", "rollback", v[1]), ("reload", "rollback", v[1]),
            ("breaker", "open", None), ("reload", "rollback", v[1]),
            ("breaker", "half_open", None), ("breaker", "close", None),
            ("reload", "publish", v[1]),
        ], got
        evs = body["events"]
        assert evs[8]["cause"]["trigger"] == "slo_fast_burn" and evs[6]["cause"]["forced"] is True
        assert evs[2]["payload"]["reasons"] == evs[2]["cause"]["gate"]["reasons"]
        assert evs[11]["cause"]["consecutive_failures"] == 3
        assert evs[9]["cause"]["error"].startswith("InjectedFault")
        assert [e["event_id"] for e in evs] == sorted(e["event_id"] for e in evs)
        # each action's log line carries its event's id
        lines = [json.loads(r.getMessage()) for r in caplog.records if r.name.startswith("cobalt")]
        logged = {(line["event"], line.get("event_id")) for line in lines}
        for e, name in ((evs[0], "model_reload"), (evs[1], "canary_promoted"),
                        (evs[2], "canary_promotion_rejected"), (evs[4], "model_rollback"),
                        (evs[9], "model_reload"), (evs[8], "model_rollback")):
            assert (name, e["event_id"]) in logged, (name, e["event_id"])
        n_events = len(evs)
    finally:
        server.close()
        svc.close()
    # shipped at the first emit and at stop: the whole journal reads back
    assert [e["event_id"] for e in load_events(inner)] == [e["event_id"] for e in evs]
    assert n_events == 16


def test_drift_alarm_fires_once(lake_root, fresh_rows, tmp_path):
    import shutil

    root = str(tmp_path / "lake")
    shutil.copytree(lake_root, root)
    alarms = []
    # judged from 500 live rows on: fewer give a rare category's bin the
    # noise of an alarm
    svc = ScorerService.from_store(ObjectStore(root), _loop_config(drift_min_samples=500),
                                   device="cpu", enable_canary=False)
    try:
        assert svc.canary is None and svc.drift_report() == {"status": "disabled"}
        svc.enable_canary(on_drift=alarms.append)
        report = svc.drift_report()
        assert report["status"] == "ok" and report["n_live"] == 0 and report["max_psi"] is None

        def tap(rows):
            for start in range(0, len(rows), 256):
                for row in rows[start:start + 256]:
                    svc.canary.tap(row, 0.5, None)
                assert svc.canary.flush()

        tap(fresh_rows[:600])
        report = svc.drift_report()
        assert report["n_live"] == 600 and not report["alarm"], report
        assert report["max_psi"] < svc.config.drift_psi_alert and not alarms
        shifted = [dict(r, loan_amnt=r["loan_amnt"] + 1e7) for r in fresh_rows[600:1200]] * 3
        tap(shifted)
        report = svc.drift_report()
        assert report["alarm"] and report["features"]["loan_amnt"] > svc.config.drift_psi_alert
        others = {k: v for k, v in report["features"].items() if k != "loan_amnt"}
        assert max(others.values()) < svc.config.drift_psi_alert, others
        assert len(alarms) == 1 and alarms[0]["status"] == "ok"
        tap(shifted[:100])  # staying in alarm does not fire again
        assert len(alarms) == 1
        text = svc.registry.render()
        assert "cobalt_drift_alarm 1" in text and 'cobalt_drift_psi{feature="loan_amnt"}' in text
    finally:
        svc.close()


def test_routes_without_a_canary_answer_typed_409s(lake_root, tmp_path):
    import shutil

    root = str(tmp_path / "lake")
    shutil.copytree(lake_root, root)
    answers = {}
    for enabled in (True, False):
        # without the loop, the static model key is served
        svc = ScorerService.from_store(
            ObjectStore(root), _loop_config(canary_enabled=enabled, model_key="models/gbdt/v1"),
            device="cpu")
        server = make_async_server(svc, "127.0.0.1", 0)
        base = f"http://127.0.0.1:{server.port}"
        try:
            answers[enabled] = [_http(base, "/admin/promote", {}),
                                _http(base, "/admin/rollback", {"reason": "x"}),
                                _http(base, "/drift"), _http(base, "/readyz")]
        finally:
            server.close()
            svc.close()
    (p, r, d, ready) = answers[True]
    assert p[0] == 409 and p[1]["error"] == "promotion_rejected" and p[1]["report"]["reasons"] == ["no_canary"]
    assert r[0] == 409 and r[1]["error"] == "rollback_failed"
    assert d == (200, d[1]) and d[1]["status"] == "ok"
    assert ready[1]["model"]["version"] == "v1" and ready[1]["canary"]["enabled"]
    (p, r, d, ready) = answers[False]
    assert p[0] == 409 and p[1]["report"]["reasons"] == ["canary_not_enabled"]
    assert r[0] == 409 and r[1]["error"] == "rollback_failed"
    assert d == (200, {"status": "disabled"})
    assert ready[1]["model"] == {"version": "unversioned", "channel": "direct", "provenance_md5": None}
    assert "canary" not in ready[1]


def test_two_burning_callers_roll_back_once(lake_root, tmp_path):
    """The HTTP server's post-response hook and a request can both see a
    fast burn inside the guard window: exactly one demotes ``latest``, and
    the other does not flip it back to the demoted version."""
    import shutil
    import threading

    root = str(tmp_path / "lake")
    shutil.copytree(lake_root, root)
    inner = ObjectStore(root)
    svc = ScorerService.from_store(inner, _loop_config(), device="cpu", clock=ManualClock())
    try:
        retrain_candidate(inner, seed=6, **MINI)
        svc.canary.refresh()
        assert svc.promote_canary(force=True)["promoted_version"] == 2
        both = threading.Barrier(2)

        def burning(*args, **kwargs):
            both.wait(timeout=30)  # both callers past the burn check first
            return {"fast_burn": True}

        svc.slo.evaluate = burning
        results = []
        callers = [threading.Thread(target=lambda: results.append(svc.canary.maybe_auto_rollback()))
                   for _ in range(2)]
        for t in callers:
            t.start()
        for t in callers:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in callers)
        assert sorted(r is None for r in results) == [False, True]
        assert int(svc.canary._m_rollbacks.labels(trigger="slo_fast_burn").value) == 1
        latest = ModelRegistry(inner).channel("gbdt", "latest")
        assert latest["version"] == 1 and latest["rolled_back_from"] == 2
        assert svc.model_info["version"] == "v1" and svc.canary._guard is None
    finally:
        svc.close()
