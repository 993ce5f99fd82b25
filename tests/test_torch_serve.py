"""The PyTorch port's scoring service against the JAX package's.

Both services restore the same artifact (a small forest trained by the JAX
`GBDTClassifier` on the 20 serving features and saved by the JAX
`GBDTArtifact`); the port runs on the CPU (``device="cpu"``, the plain
versions of its kernel) behind its live asyncio HTTP server, the JAX service
in-process. Same payloads in, and:

- ``prob_default`` within 1e-6, ``shap_values`` and ``base_value`` within
  1e-5, identical feature lists and request echoes;
- bulk CSV records with the same keys and cell types, ``prob_default``
  within 1e-6 and echoed floats within 1e-12 relative (pandas' default CSV
  float parser is not correctly rounded; the port's ``float()`` is);
- identical ``top_features``;
- typed errors: 422 invalid input, 400 empty importance data, 413 oversized
  bulk payloads.

Telemetry, with both services on the committed model behind their HTTP
servers and the same requests sent to each: every family the port
publishes has the reference's name, type and label names; the request and
error counts per route and status are equal (batching may coalesce
differently, so rows per batch are not compared); ``X-Request-ID`` is
echoed and minted where the client sent none; ``/debug/*`` rejects the
same bad limits and phases with the same 422 bodies; ``/debug/*`` and
``/slo`` answer bodies with the reference's keys.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from cobalt_smart_lender_ai_tpu.config import ServeConfig as JaxServeConfig
from cobalt_smart_lender_ai_tpu.data import schema as jax_schema
from cobalt_smart_lender_ai_tpu.io import GBDTArtifact as JaxArtifact
from cobalt_smart_lender_ai_tpu.io import ObjectStore as JaxStore
from cobalt_smart_lender_ai_tpu.models.gbdt import GBDTClassifier
from cobalt_smart_lender_ai_tpu.serve.service import ScorerService as JaxScorerService
from cobalt_smart_lender_ai_tpu_torch.config import ReliabilityConfig, ServeConfig
from cobalt_smart_lender_ai_tpu_torch.data import schema
from cobalt_smart_lender_ai_tpu_torch.io import GBDTArtifact, ObjectStore
from cobalt_smart_lender_ai_tpu_torch.models.gbdt import predict_margin
from cobalt_smart_lender_ai_tpu_torch.reliability import Deadline, DeadlineExceeded
from cobalt_smart_lender_ai_tpu_torch.serve.http_asyncio import make_async_server
from cobalt_smart_lender_ai_tpu_torch.ops.score import SHAP_FIXED_LIMIT
from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService, _CompiledModel

TOL_PROB = 1e-6
TOL_SHAP = 1e-5
KEY = "models/gbdt/model_tree"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU tests: the suite shares its
    cores with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def store_root(tmp_path_factory):
    rng = np.random.default_rng(17)
    F = len(jax_schema.SERVING_FEATURES)
    X = rng.normal(size=(2048, F)).astype(np.float32)
    X[:, 12:] = rng.integers(0, 2, size=(2048, F - 12))
    y = (X[:, 0] - 0.7 * X[:, 3] + 0.5 * X[:, 12] + 0.3 * rng.normal(size=2048) > 0)
    model = GBDTClassifier(n_estimators=12, max_depth=4, n_bins=32)
    model.fit(X, y.astype(np.int32))
    root = tmp_path_factory.mktemp("torch_serve") / "lake"
    JaxArtifact(
        forest=model.forest,
        bin_spec=model.bin_spec,
        feature_names=tuple(jax_schema.SERVING_FEATURES),
    ).save(JaxStore(str(root)), KEY)
    return str(root)


@pytest.fixture(scope="module")
def jax_service(store_root):
    svc = JaxScorerService.from_store(
        JaxStore(store_root),
        JaxServeConfig(prewarm_all_buckets=False, score_cache_size=0),
    )
    yield svc
    svc.close()


@pytest.fixture(scope="module")
def service(store_root):
    svc = ScorerService.from_store(ObjectStore(store_root), ServeConfig(), device="cpu")
    yield svc
    svc.close()


@pytest.fixture(scope="module")
def base_url(service):
    server = make_async_server(service, "127.0.0.1", 0)
    yield f"http://127.0.0.1:{server.port}"
    server.close()


def _payloads(n: int, seed: int) -> list[dict]:
    """Valid /predict bodies: floats, 0/1 ints for the indicators, and the
    aliases for the two names with spaces."""
    rng = np.random.default_rng(seed)
    alias = {v: k for k, v in schema.SERVING_FIELD_ALIASES.items()}
    out = []
    for _ in range(n):
        body = {}
        for name in schema.SERVING_FEATURES:
            key = alias.get(name, name)
            if name in schema.SERVING_INT_FEATURES:
                body[key] = int(rng.integers(0, 2))
            else:
                body[key] = float(np.round(rng.normal() * 2, 4))
        out.append(body)
    return out


def _post(url: str, body: bytes, content_type: str = "application/json"):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": content_type})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url: str):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def test_predict_matches_jax_service(base_url, jax_service, service):
    payloads = _payloads(12, seed=1)
    with ThreadPoolExecutor(max_workers=len(payloads)) as pool:
        results = list(
            pool.map(lambda p: _post(base_url + "/predict", json.dumps(p).encode()), payloads)
        )
    for payload, (status, got) in zip(payloads, results):
        assert status == 200, got
        want = jax_service.predict_single(payload)
        assert set(got) == set(want)
        assert got["features"] == want["features"]
        assert got["input_row"] == want["input_row"]
        assert abs(got["prob_default"] - want["prob_default"]) <= TOL_PROB
        np.testing.assert_allclose(got["shap_values"], want["shap_values"], rtol=0, atol=TOL_SHAP)
        assert abs(got["base_value"] - want["base_value"]) <= TOL_SHAP
    stats = service.ready()[1]["microbatch"]
    assert stats["coalesced_rows"] >= len(payloads)


def test_microbatcher_coalesces_into_one_bucket(service, jax_service):
    """Held behind `pause`, concurrent requests leave as ONE padded batch."""
    payloads = _payloads(5, seed=2)
    batcher = service.batcher
    before = batcher.batches
    with ThreadPoolExecutor(max_workers=5) as pool:
        with batcher.pause():
            futs = [pool.submit(service.predict_single, p) for p in payloads]
            while batcher.queue_depth() < len(payloads):
                threading.Event().wait(0.005)
        got = [f.result(timeout=60) for f in futs]
    assert batcher.batches == before + 1
    for p, g in zip(payloads, got):
        assert abs(g["prob_default"] - jax_service.predict_single(p)["prob_default"]) <= TOL_PROB


def _bulk_csv(n: int) -> bytes:
    rng = np.random.default_rng(3)
    names = list(schema.SERVING_FEATURES)
    lines = [",".join(["loan_id", "note"] + [f'"{n}"' if " " in n else n for n in names])]
    for i in range(n):
        cells = [str(1000 + i), "" if i % 4 == 0 else f"n{i}"]
        for j, name in enumerate(names):
            if name in schema.SERVING_INT_FEATURES:
                cells.append(str(int(rng.integers(0, 2))))
            elif (i + j) % 7 == 0:
                cells.append("")  # missing: scored as NaN, echoed as "null"
            else:
                cells.append(repr(float(np.float32(rng.normal() * 3))))
        lines.append(",".join(cells))
    return ("\n".join(lines) + "\n").encode()


def test_bulk_csv_matches_jax_service(base_url, jax_service):
    body = _bulk_csv(300)  # two buckets' worth of padding: 300 -> 512
    status, got = _post(base_url + "/predict_bulk_csv", body, "text/csv")
    assert status == 200, got
    want = jax_service.predict_bulk_csv(body)
    assert len(got["predictions"]) == len(want["predictions"]) == 300
    for g, w in zip(got["predictions"], want["predictions"]):
        assert abs(g.pop("prob_default") - w.pop("prob_default")) <= TOL_PROB
        assert list(g) == list(w)
        for k, v in w.items():
            assert type(g[k]) is type(v), k
            if isinstance(v, float):
                assert g[k] == pytest.approx(v, rel=1e-12, abs=0)
            else:
                assert g[k] == v


def test_bulk_csv_multipart_upload(base_url, service):
    body = _bulk_csv(5)
    boundary = "torchportboundary"
    multipart = (
        f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
        f"filename=\"rows.csv\"\r\nContent-Type: text/csv\r\n\r\n"
    ).encode() + body + f"\r\n--{boundary}--\r\n".encode()
    status, got = _post(
        base_url + "/predict_bulk_csv", multipart, f"multipart/form-data; boundary={boundary}"
    )
    assert status == 200, got
    assert [r["loan_id"] for r in got["predictions"]] == list(range(1000, 1005))


def test_feature_importance_matches_jax_service(base_url, jax_service):
    status, got = _post(base_url + "/feature_importance_bulk", json.dumps({"data": [{"a": 1}]}).encode())
    assert status == 200
    want = jax_service.feature_importance_bulk({"data": [{"a": 1}]})
    assert [t["feature"] for t in got["top_features"]] == [t["feature"] for t in want["top_features"]]
    np.testing.assert_allclose(
        [t["importance"] for t in got["top_features"]],
        [t["importance"] for t in want["top_features"]],
        rtol=1e-6,
    )


@pytest.mark.parametrize(
    "route, body, status, code",
    [
        ("/predict", b'{"loan_amnt": 1.0}', 422, "invalid_input"),
        ("/predict", b"not json", 422, "invalid_input"),
        ("/feature_importance_bulk", b'{"data": []}', 400, "invalid_input"),
        ("/predict_bulk_csv", b"loan_amnt,term\n1,2\n", 422, "invalid_input"),
    ],
)
def test_typed_errors(base_url, route, body, status, code):
    got_status, got = _post(base_url + route, body)
    assert got_status == status
    assert got["error"] == code


def test_predict_rejects_non_integer_indicator(base_url):
    payload = _payloads(1, seed=4)[0]
    payload["grade_E"] = 0.5
    status, got = _post(base_url + "/predict", json.dumps(payload).encode())
    assert status == 422 and "integer" in got["detail"]


def test_oversized_bulk_is_413(store_root):
    svc = ScorerService.from_store(
        ObjectStore(store_root),
        ServeConfig(max_bulk_rows=3, microbatch_enabled=False),
        device="cpu",
    )
    server = make_async_server(svc, "127.0.0.1", 0)
    try:
        status, got = _post(f"http://127.0.0.1:{server.port}/predict_bulk_csv", _bulk_csv(4), "text/csv")
    finally:
        server.close()
        svc.close()
    assert status == 413 and got["error"] == "payload_too_large"
    small = ScorerService.from_store(
        ObjectStore(store_root),
        ServeConfig(max_bulk_bytes=10, microbatch_enabled=False),
        device="cpu",
    )
    with pytest.raises(Exception) as info:
        small.predict_bulk_csv(_bulk_csv(1))
    assert getattr(info.value, "status", None) == 413


def test_health_ready_and_404(base_url):
    assert _get(base_url + "/healthz") == (200, {"status": "ok"})
    status, ready = _get(base_url + "/readyz")
    assert status == 200
    assert ready["device"] == "cpu" and ready["kernel"] == "plain"
    assert ready["shap"] == "ok" and ready["n_features"] == 20
    assert ready["warm_buckets"]["shap"] == [1, 2, 4, 8, 16, 32, 64]
    assert ready["warm_buckets"]["margin"] == [256]
    assert _post(base_url + "/nope", b"{}")[0] == 404


def test_direct_path_matches_batched(store_root, service):
    """With the batcher off, each request scores on its own (1, F) launch."""
    direct = ScorerService.from_store(
        ObjectStore(store_root), ServeConfig(microbatch_enabled=False), device="cpu"
    )
    for p in _payloads(3, seed=5):
        a, b = direct.predict_single(p), service.predict_single(p)
        assert a["prob_default"] == b["prob_default"]
        np.testing.assert_allclose(a["shap_values"], b["shap_values"], rtol=0, atol=TOL_SHAP)


def test_expired_deadline_is_504(service):
    now = [0.0]
    dl = Deadline(1.0, clock=lambda: now[0])
    now[0] = 2.0
    with pytest.raises(DeadlineExceeded):
        service.predict_single(_payloads(1, seed=6)[0], deadline=dl)


def test_bulk_probabilities_match_plain_scoring(service):
    X = np.random.default_rng(7).normal(size=(5000, 20)).astype(np.float32)
    prob = service.predict_proba(X)  # chunks of 4096, padded to buckets
    want = torch.sigmoid(predict_margin(service._model.artifact.forest, torch.from_numpy(X)))
    np.testing.assert_array_equal(prob, want.numpy())


def _boom(*args, **kwargs):
    raise RuntimeError("SHAP launch failed at run time")


@pytest.mark.parametrize("path", ["batched", "direct"])
def test_runtime_shap_failure_degrades(store_root, service, monkeypatch, path):
    """A SHAP launch that raises at run time answers 200 with
    ``"shap_values": null`` and ``"degraded": true``, with the prob of the
    margin-only launch on the same row, as the JAX service does; the
    degraded answers are counted in /readyz."""
    svc = service
    if path == "direct":
        svc = ScorerService.from_store(
            ObjectStore(store_root), ServeConfig(microbatch_enabled=False), device="cpu"
        )
    monkeypatch.setattr(svc._model, "shap_fn", _boom)
    server = make_async_server(svc, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{server.port}"
    try:
        before = _get(url + "/readyz")[1]
        payload = _payloads(1, seed=11)[0]
        status, got = _post(url + "/predict", json.dumps(payload).encode())
        after = _get(url + "/readyz")[1]
    finally:
        server.close()
        if path == "direct":
            svc.close()
    assert status == 200, got
    assert got["degraded"] is True
    assert got["shap_values"] is None and got["base_value"] is None
    row = svc._model.rows_array([_canonical(payload)])
    assert got["prob_default"] == float(svc._model.score(row, with_shap=False)[0][0])
    if path == "batched":
        assert after["microbatch"]["degraded_batches"] == before["microbatch"]["degraded_batches"] + 1
    else:
        assert after["degraded_direct"] == before["degraded_direct"] + 1


@pytest.mark.parametrize("microbatch", [True, False], ids=["batched", "direct"])
def test_failing_margin_launch_still_fails(store_root, monkeypatch, microbatch):
    """Degrading needs the margin-only launch: if it fails too, the request
    fails (500 over HTTP)."""
    svc = ScorerService.from_store(
        ObjectStore(store_root), ServeConfig(microbatch_enabled=microbatch), device="cpu"
    )
    monkeypatch.setattr(svc._model, "shap_fn", _boom)
    monkeypatch.setattr(svc._model, "margin_fn", _boom)
    server = make_async_server(svc, "127.0.0.1", 0)
    try:
        status, _ = _post(f"http://127.0.0.1:{server.port}/predict",
                          json.dumps(_payloads(1, seed=12)[0]).encode())
        with pytest.raises(RuntimeError, match="at run time"):
            svc.predict_single(_payloads(1, seed=13)[0])
    finally:
        server.close()
        svc.close()
    assert status == 500


def test_forest_outside_the_shap_range_degrades(store_root):
    """A forest whose phis would overflow the SHAP kernel's fixed-point
    totals serves probabilities with SHAP degraded, or is refused when
    degrading is off."""
    art = GBDTArtifact.load(ObjectStore(store_root), KEY, "cpu")
    leaf = art.forest.leaf_value
    factor = SHAP_FIXED_LIMIT / (2.0 * float(leaf.abs().max()) * leaf.shape[0])
    big = dataclasses.replace(
        art, forest=dataclasses.replace(art.forest, leaf_value=leaf * (2.0 * factor))
    )
    model = _CompiledModel(big, ServeConfig(), torch.device("cpu"))
    assert model.shap_fn is None and "fixed-point" in model.shap_error
    with pytest.raises(ValueError, match="fixed-point"):
        _CompiledModel(big, ServeConfig(reliability=ReliabilityConfig(degrade_shap=False)), torch.device("cpu"))
    assert _CompiledModel(art, ServeConfig(), torch.device("cpu")).shap_error is None


def _canonical(payload: dict) -> dict:
    alias = schema.SERVING_FIELD_ALIASES
    return {alias.get(k, k): float(v) for k, v in payload.items()}


# -- telemetry: the same traffic through both services' HTTP servers ------------

COMMITTED = str(Path(__file__).resolve().parent.parent / "artifacts")
BAD_DEBUG_QUERIES = (
    "/debug/requests?limit=0",
    "/debug/requests?limit=1001",
    "/debug/requests?n=abc",
    "/debug/requests?phase=bogus",
    "/debug/slowest?k=-1",
    "/debug/slowest?limit=5000",
    "/debug/slowest?phase=validate&k=x",
)


def _request(url: str, body: bytes | None = None, headers: dict | None = None):
    """(status, headers, body bytes) of one request, errors included."""
    req = urllib.request.Request(url, data=body, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _traffic(url: str) -> list[tuple[int, dict, bytes]]:
    """The same requests to either server: valid and invalid /predict, a
    bulk CSV, an importance request, a 404 and the probes."""
    out = []
    for i, body in enumerate(_payloads(6, seed=21)):
        headers = {"Content-Type": "application/json"}
        if i % 2:
            headers["X-Request-ID"] = f"client-{i}"
        out.append(_request(url + "/predict", json.dumps(body).encode(), headers))
    bad = dict(_payloads(1, seed=22)[0], loan_amnt="many")
    out.append(_request(url + "/predict", json.dumps(bad).encode(), {"Content-Type": "application/json"}))
    out.append(_request(url + "/predict", b"{not json", {"Content-Type": "application/json"}))
    out.append(_request(url + "/predict_bulk_csv", _bulk_csv(40), {"Content-Type": "text/csv"}))
    out.append(_request(url + "/feature_importance_bulk", json.dumps({"data": []}).encode(),
                        {"Content-Type": "application/json"}))
    out.append(_request(url + "/nope"))
    out.append(_request(url + "/healthz"))
    out.append(_request(url + "/readyz"))
    return out


@pytest.fixture(scope="module")
def telemetry_pair():
    """(port responses, port scrape, JAX responses, JAX scrape, port and
    JAX services' registries, both base URLs' bad-query answers) for the
    committed model on the CPU."""
    from cobalt_smart_lender_ai_tpu.serve import make_async_server as jax_make_async_server

    out = {}
    jax_svc = JaxScorerService.from_store(
        JaxStore(COMMITTED), JaxServeConfig(prewarm_all_buckets=False, score_cache_size=0)
    )
    port_svc = ScorerService.from_store(ObjectStore(COMMITTED), ServeConfig(), device="cpu")
    # The continuous-training loop attached to both (the committed store has
    # no model registry, so no canary loads): its families join the scrape.
    jax_svc.enable_canary()
    port_svc.enable_canary()
    servers = {"jax": jax_make_async_server(jax_svc, "127.0.0.1", 0),
               "port": make_async_server(port_svc, "127.0.0.1", 0)}
    try:
        for side, server in servers.items():
            url = f"http://127.0.0.1:{server.port}"
            out[side] = _traffic(url)
            out[side + "_bad"] = [_request(url + q) for q in BAD_DEBUG_QUERIES]
            out[side + "_metrics"] = _request(url + "/metrics")
            out[side + "_slowest"] = _request(url + "/debug/slowest")
            out[side + "_requests"] = _request(url + "/debug/requests?limit=3&phase=dispatch")
            out[side + "_programs"] = _request(url + "/debug/programs")
            out[side + "_slo"] = _request(url + "/slo")
            out[side + "_trace"] = _request(url + "/debug/trace")
    finally:
        for server in servers.values():
            server.close()
        jax_svc.close()
        port_svc.close()
    out["port_registry"], out["jax_registry"] = port_svc.registry, jax_svc.registry
    return out


def test_every_port_family_is_the_references(telemetry_pair):
    from cobalt_smart_lender_ai_tpu.telemetry import parse_exposition as jax_parse

    from cobalt_smart_lender_ai_tpu_torch.telemetry import parse_exposition

    status, headers, text = telemetry_pair["port_metrics"]
    assert status == 200 and headers["Content-Type"] == telemetry_pair["jax_metrics"][1]["Content-Type"]
    port = parse_exposition(text.decode())
    ref = jax_parse(telemetry_pair["jax_metrics"][2].decode())
    ref_fams = {f.name: f for f in telemetry_pair["jax_registry"].families()}
    published = {f.name: f for f in telemetry_pair["port_registry"].families()}
    assert set(published) <= set(ref_fams), sorted(set(published) - set(ref_fams))
    for name, fam in published.items():
        assert (fam.kind, tuple(fam.labelnames)) == (ref_fams[name].kind, tuple(ref_fams[name].labelnames)), name
        assert port[name]["type"] == ref[name]["type"], name
    for family in ("cobalt_request_latency_seconds", "cobalt_microbatch_batches_total",
                   "cobalt_bulk_dispatches_total", "cobalt_program_dispatches_total",
                   "cobalt_device_mem_bytes", "cobalt_slo_burn_rate", "cobalt_model_info",
                   "cobalt_shap_degraded_total", "cobalt_request_phase_seconds",
                   "cobalt_admission_shed_total", "cobalt_breaker_state",
                   "cobalt_score_cache_hits_total", "cobalt_model_reloads_total",
                   "cobalt_microbatch_worker_restarts_total",
                   "cobalt_events_total", "cobalt_events_dropped_total", "cobalt_events_ring_depth",
                   "cobalt_canary_shadow_total", "cobalt_canary_shadow_dropped_total",
                   "cobalt_canary_errors_total", "cobalt_canary_score_delta",
                   "cobalt_canary_latency_seconds", "cobalt_canary_promotions_total",
                   "cobalt_canary_rollbacks_total", "cobalt_canary_loaded",
                   "cobalt_canary_window_size", "cobalt_drift_max_psi", "cobalt_drift_alarm",
                   "cobalt_drift_psi"):
        assert family in published, family
    # The fleet's facade registry (two replicas, a chaos plan and a
    # supervision pass on it) against the reference fleet's.
    from cobalt_smart_lender_ai_tpu.reliability import ChaosPlan as JaxChaosPlan
    from cobalt_smart_lender_ai_tpu.serve.replicas import ReplicaSet as JaxReplicaSet

    from cobalt_smart_lender_ai_tpu_torch.reliability import ChaosPlan
    from cobalt_smart_lender_ai_tpu_torch.serve.replicas import ReplicaSet

    # replicas sharing one device (the test host forces eight JAX devices):
    # one process-wide program table on both sides
    fleet_kw = dict(replicas=2, replica_devices=False, microbatch_enabled=False, score_cache_size=0)
    fleets = {
        "port": ReplicaSet.from_store(ObjectStore(COMMITTED), ServeConfig(**fleet_kw), device="cpu"),
        "jax": JaxReplicaSet.from_store(JaxStore(COMMITTED), JaxServeConfig(
            **fleet_kw, precompile_batch_buckets=(), prewarm_all_buckets=False, history_enabled=False)),
    }
    try:
        for (side, fleet), plan in zip(fleets.items(), (ChaosPlan, JaxChaosPlan)):
            plan(registry=fleet.registry)
            fleet.supervisor._m_heal_s.labels(replica="0").set(0.0)
            fleet._m_hedges.labels(outcome="rescued").inc(0)
        port_fams = {f.name: f for f in fleets["port"].registry.families()}
        jax_fams = {f.name: f for f in fleets["jax"].registry.families()}
        assert set(port_fams) <= set(jax_fams), sorted(set(port_fams) - set(jax_fams))
        for name, fam in port_fams.items():
            assert (fam.kind, tuple(fam.labelnames)) == (jax_fams[name].kind, tuple(jax_fams[name].labelnames)), name
        fleet_text = parse_exposition(fleets["port"].registry.render())
        for family in ("cobalt_replica_count", "cobalt_replica_routed_total", "cobalt_replica_hedges_total",
                       "cobalt_replica_in_flight", "cobalt_replica_queue_depth", "cobalt_supervisor_state",
                       "cobalt_supervisor_error_ewma", "cobalt_supervisor_probes_total",
                       "cobalt_supervisor_quarantines_total", "cobalt_supervisor_rebuilds_total",
                       "cobalt_supervisor_heal_seconds", "cobalt_supervisor_ticks_total",
                       "cobalt_supervisor_transitions_total", "cobalt_chaos_events_total",
                       "cobalt_brownout_level"):
            assert family in port_fams and family in fleet_text, family
    finally:
        for fleet in fleets.values():
            fleet.close()


def _counts(registry, family: str, kind: str) -> dict:
    fam = next(f for f in registry.families() if f.name == family)
    return {
        labels: (child.count if kind == "histogram" else child.value)
        for labels, child in fam._items()
    }


def test_request_and_error_counts_match_the_references(telemetry_pair):
    port, ref = telemetry_pair["port_registry"], telemetry_pair["jax_registry"]
    assert _counts(port, "cobalt_request_errors_total", "counter") == _counts(
        ref, "cobalt_request_errors_total", "counter"
    )
    port_lat = _counts(port, "cobalt_request_latency_seconds", "histogram")
    ref_lat = _counts(ref, "cobalt_request_latency_seconds", "histogram")
    data_plane = {k: v for k, v in ref_lat.items() if k[0] != "/metrics"}
    assert {k: v for k, v in port_lat.items() if k[0] != "/metrics"} == data_plane
    assert data_plane[("/predict", "200")] == 6 and data_plane[("unmatched", "404")] == 1
    statuses = [r[0] for r in telemetry_pair["port"]]
    assert statuses == [r[0] for r in telemetry_pair["jax"]]


def test_request_ids_are_echoed_and_minted(telemetry_pair):
    for side in ("port", "jax"):
        for i, (status, headers, _) in enumerate(telemetry_pair[side][:6]):
            rid = headers.get("X-Request-ID")
            assert rid == (f"client-{i}" if i % 2 else rid) and rid, (side, i)
        minted = [telemetry_pair[side][i][1]["X-Request-ID"] for i in (0, 2, 4)]
        assert len(set(minted)) == 3
    assert telemetry_pair["port_metrics"][1].get("X-Request-ID")


def test_debug_routes_reject_bad_queries_as_the_reference(telemetry_pair):
    port = [(s, json.loads(b)) for s, _, b in telemetry_pair["port_bad"]]
    ref = [(s, json.loads(b)) for s, _, b in telemetry_pair["jax_bad"]]
    assert port == ref and {s for s, _ in port} == {422}


def test_debug_and_slo_bodies_have_the_references_shape(telemetry_pair):
    for route in ("slowest", "requests", "slo", "programs"):
        port_status, _, port_body = telemetry_pair[f"port_{route}"]
        ref_status, _, ref_body = telemetry_pair[f"jax_{route}"]
        assert port_status == ref_status == 200, route
        assert set(json.loads(port_body)) == set(json.loads(ref_body)), route
    slowest = json.loads(telemetry_pair["port_slowest"][2])["slowest"]
    predict = [r for r in slowest if r["route"] == "/predict" and r["status"] == 200]
    assert predict and all({"validate", "dispatch"} <= set(r["phases_ms"]) for r in predict)
    recent = json.loads(telemetry_pair["port_requests"][2])["recent"]
    assert len(recent) == 3 and all("dispatch" in r["phases_ms"] for r in recent)
    trace = json.loads(telemetry_pair["port_trace"][2])
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"http.request", "serve.dispatch", "serve.microbatch_dispatch", "serve.validate"} <= names
    programs = json.loads(telemetry_pair["port_programs"][2])["programs"]
    assert any(p["name"].startswith("score_forest_plain/f32/") for p in programs)
