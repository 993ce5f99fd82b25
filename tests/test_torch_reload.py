"""The port's hot reload and store circuit breaker against the JAX package's.

Both services restore the same artifact and run behind their own HTTP
servers (the port on the CPU); each probe goes to both, and each answer has
the reference's status, typed ``error`` code and body keys:

- ``POST /admin/reload`` to another model swaps it (the all-zero forest
  then scores 0.5), and with no key reloads the model being served;
- a poisoned artifact, a forest with NaN leaves and a forest whose feature
  names changed roll back with 500 ``reload_failed``, and the previous
  model keeps serving with the same bits;
- a service built without a store answers a reload 500 ``internal``;
- a store whose reads fail trips the breaker: two rollbacks, then 503
  ``circuit_open`` with the same ``Retry-After`` and no store read, while
  ``/predict`` keeps answering; once the reset time has passed on the fake
  clock and the store is back, the reload swaps and the breaker walks
  open -> half_open -> closed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from cobalt_smart_lender_ai_tpu.config import ReliabilityConfig as JaxReliabilityConfig
from cobalt_smart_lender_ai_tpu.config import ServeConfig as JaxServeConfig
from cobalt_smart_lender_ai_tpu.data import schema as jax_schema
from cobalt_smart_lender_ai_tpu.io import GBDTArtifact as JaxArtifact
from cobalt_smart_lender_ai_tpu.io import ObjectStore as JaxStore
from cobalt_smart_lender_ai_tpu.models.gbdt import GBDTClassifier as JaxClassifier
from cobalt_smart_lender_ai_tpu.reliability import FaultInjectingStore as JaxFaultStore
from cobalt_smart_lender_ai_tpu.reliability import FaultSpec as JaxFaultSpec
from cobalt_smart_lender_ai_tpu.serve.http_asyncio import make_async_server as jax_make_server
from cobalt_smart_lender_ai_tpu.serve.service import ScorerService as JaxScorerService
from cobalt_smart_lender_ai_tpu_torch.config import ReliabilityConfig, ServeConfig
from cobalt_smart_lender_ai_tpu_torch.data import schema
from cobalt_smart_lender_ai_tpu_torch.io import GBDTArtifact, ObjectStore
from cobalt_smart_lender_ai_tpu_torch.reliability import FaultInjectingStore, FaultSpec
from cobalt_smart_lender_ai_tpu_torch.serve.http_asyncio import make_async_server
from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService

TOL_PROB = 1e-6
KEY = "models/gbdt/model_tree"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class ManualClock:
    def __init__(self, start: float = 0.0):
        self.now = start

    def __call__(self) -> float:
        return self.now

    def advance(self, s: float) -> None:
        self.now += s


@pytest.fixture(scope="module")
def store_root(tmp_path_factory):
    """The serving artifact (a small forest trained by the JAX package), and
    beside it: the all-zero forest, a forest with NaN leaves, one whose
    first feature was renamed, and a poisoned ``.npz``."""
    rng = np.random.default_rng(53)
    F = len(jax_schema.SERVING_FEATURES)
    X = rng.normal(size=(1024, F)).astype(np.float32)
    X[:, 12:] = rng.integers(0, 2, size=(1024, F - 12))
    y = X[:, 1] + 0.8 * X[:, 5] - 0.5 * X[:, 14] + 0.3 * rng.normal(size=1024) > 0
    model = JaxClassifier(n_estimators=8, max_depth=3, n_bins=32)
    model.fit(X, y.astype(np.int32))
    root = tmp_path_factory.mktemp("torch_reload") / "lake"
    store = JaxStore(str(root))
    art = JaxArtifact(
        forest=model.forest, bin_spec=model.bin_spec, feature_names=tuple(jax_schema.SERVING_FEATURES)
    )
    art.save(store, KEY)
    leaves = art.forest.leaf_value
    for key, forest in (
        ("models/gbdt/zero", dataclasses.replace(art.forest, leaf_value=leaves * 0.0)),
        ("models/gbdt/nan", dataclasses.replace(art.forest, leaf_value=leaves * np.nan)),
    ):
        dataclasses.replace(art, forest=forest).save(store, key)
    dataclasses.replace(
        art, feature_names=("zzz_not_a_feature",) + tuple(art.feature_names[1:])
    ).save(store, "models/gbdt/renamed")
    store.put_bytes("models/poison.npz", b"\x00poisoned")
    return str(root)


def _payload() -> dict:
    alias = {v: k for k, v in schema.SERVING_FIELD_ALIASES.items()}
    return {
        alias.get(n, n): 1 if n in schema.SERVING_INT_FEATURES else 1.5
        for n in schema.SERVING_FEATURES
    }


def _request(url: str, data: bytes | None = None):
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _port_config(**rel) -> ServeConfig:
    return ServeConfig(score_cache_size=0, reliability=ReliabilityConfig(**rel))


def _ref_config(**rel) -> JaxServeConfig:
    return JaxServeConfig(
        precompile_batch_buckets=(),
        prewarm_all_buckets=False,
        score_cache_size=0,
        reliability=JaxReliabilityConfig(**rel),
    )


@contextlib.contextmanager
def _both(root: str, **rel):
    """Both services from ``root`` behind their servers: ``{side: (service,
    base url)}``."""
    port = ScorerService.from_store(ObjectStore(root), _port_config(**rel), device="cpu")
    ref = JaxScorerService.from_store(JaxStore(root), _ref_config(**rel))
    servers = {"port": make_async_server(port, "127.0.0.1", 0),
               "ref": jax_make_server(ref, "127.0.0.1", 0)}
    try:
        yield {side: (svc, f"http://127.0.0.1:{servers[side].port}")
               for side, svc in (("port", port), ("ref", ref))}
    finally:
        for server in servers.values():
            server.close()
        port.close()
        ref.close()


def _reload(url: str, key: str | None) -> tuple[int, dict, dict]:
    return _request(url + "/admin/reload", json.dumps({} if key is None else {"model_key": key}).encode())


def _shape(answer: tuple) -> tuple:
    """What must agree between the two services: status, typed code, keys."""
    status, body, _ = answer
    return status, body.get("error"), sorted(body)


def test_reload_swaps_the_served_model(store_root):
    """A swap to the all-zero forest over ``/admin/reload``: 200 with the
    reference's body; ``/predict`` then scores 0.5 and ``/readyz`` names
    the new key; a reload without a key reloads the key being served."""
    out = {}
    with _both(store_root) as sides:
        for side, (svc, url) in sides.items():
            before = _request(url + "/predict", json.dumps(_payload()).encode())
            swap = _reload(url, "models/gbdt/zero")
            after = _request(url + "/predict", json.dumps(_payload()).encode())
            ready = _request(url + "/readyz")[1]
            again = _reload(url, None)
            out[side] = (before, swap, after, ready, again)
    p, r = out["port"], out["ref"]
    assert p[1][:2] == r[1][:2] == (200, {"status": "ok", "model_key": "models/gbdt/zero",
                                          "n_features": 20})
    assert abs(p[0][1]["prob_default"] - r[0][1]["prob_default"]) <= TOL_PROB
    assert p[0][1]["prob_default"] != 0.5
    assert p[2][1]["prob_default"] == r[2][1]["prob_default"] == 0.5
    assert p[3]["model_key"] == r[3]["model_key"] == "models/gbdt/zero"
    assert p[3]["last_reload"] == r[3]["last_reload"]
    assert p[4][:2] == r[4][:2] and p[4][1]["model_key"] == "models/gbdt/zero"


@pytest.mark.parametrize(
    "key, reason",
    [("models/poison", None), ("models/gbdt/nan", None),
     ("models/gbdt/renamed", "feature contract changed")],
    ids=["poisoned", "non_finite", "feature_contract"],
)
def test_rejected_candidate_rolls_back(store_root, key, reason):
    """A candidate that does not load, scores the smoke row to NaN or
    changes the feature contract: 500 ``reload_failed`` with the
    reference's keys, the rollback in ``/readyz``, and the previous model
    still serving bit for bit."""
    out = {}
    with _both(store_root) as sides:
        for side, (svc, url) in sides.items():
            before = _request(url + "/predict", json.dumps(_payload()).encode())[1]
            answer = _reload(url, key)
            after = _request(url + "/predict", json.dumps(_payload()).encode())[1]
            ready = _request(url + "/readyz")[1]
            out[side] = (before, answer, after, ready)
    for side, (before, answer, after, ready) in out.items():
        status, body, _ = answer
        assert (status, body["error"], body["status"], body["model_key"]) == (
            500, "reload_failed", "rolled_back", key), side
        assert body["detail"].startswith("reload rolled back: "), side
        if reason:
            assert reason in body["detail"], side
        assert after["prob_default"] == before["prob_default"], side
        assert ready["model_key"] == KEY and ready["last_reload"]["status"] == "rolled_back"
        assert set(ready["last_reload"]) == {"status", "model_key", "error"}
    assert _shape(out["port"][1]) == _shape(out["ref"][1])
    assert abs(out["port"][2]["prob_default"] - out["ref"][2]["prob_default"]) <= TOL_PROB


def test_reload_without_a_store_is_an_error(store_root):
    port = ScorerService(GBDTArtifact.load(ObjectStore(store_root), KEY, "cpu"), _port_config(),
                         device="cpu")
    ref = JaxScorerService(JaxArtifact.load(JaxStore(store_root), KEY), _ref_config())
    answers = {}
    try:
        for side, svc, make in (("port", port, make_async_server), ("ref", ref, jax_make_server)):
            with pytest.raises(RuntimeError, match="no store bound"):
                svc.reload_from_store()
            server = make(svc, "127.0.0.1", 0)
            try:
                answers[side] = _reload(f"http://127.0.0.1:{server.port}", None)
            finally:
                server.close()
    finally:
        port.close()
        ref.close()
    assert _shape(answers["port"]) == _shape(answers["ref"])
    assert answers["port"][0] == 500 and answers["port"][1]["error"] == "internal"


def test_breaker_opens_on_a_failing_store_and_recovers(store_root):
    out = {}
    for side in ("port", "ref"):
        clk = ManualClock()
        rel = {"breaker_failure_threshold": 2, "breaker_reset_s": 5.0}
        if side == "port":
            flaky = FaultInjectingStore(ObjectStore(store_root), faults={})
            svc = ScorerService.from_store(flaky, _port_config(**rel), device="cpu", clock=clk)
            server = make_async_server(svc, "127.0.0.1", 0)
            spec = FaultSpec(fail_after=0)
        else:
            flaky = JaxFaultStore(JaxStore(store_root), faults={})
            svc = JaxScorerService.from_store(flaky, _ref_config(**rel), clock=clk)
            server = jax_make_server(svc, "127.0.0.1", 0)
            spec = JaxFaultSpec(fail_after=0)
        url = f"http://127.0.0.1:{server.port}"
        try:
            flaky.faults["get"] = spec  # the store goes down
            answers = [_reload(url, None), _reload(url, None)]
            gets = flaky.calls["get"]
            answers.append(_reload(url, None))  # open: no store read
            untouched = flaky.calls["get"] == gets
            ready = _request(url + "/readyz")[1]
            predict = _request(url + "/predict", json.dumps(_payload()).encode())
            clk.advance(5.0)
            del flaky.faults["get"]
            answers.append(_reload(url, None))
            out[side] = {
                "shapes": [_shape(a) for a in answers],
                "retry_after": answers[2][2].get("Retry-After"),
                "circuit": answers[2][1],
                "untouched": untouched,
                "breaker_open": ready["breaker"],
                "predict": predict[0],
                "state": svc.store_breaker.state,
                "transitions": list(svc.store_breaker.transitions),
                "fast_failures": svc.store_breaker.fast_failures,
            }
        finally:
            server.close()
            svc.close()
    port, ref = out["port"], out["ref"]
    assert port == ref
    assert [s[0] for s in port["shapes"]] == [500, 500, 503, 200]
    assert port["circuit"] == {"detail": "store circuit open", "error": "circuit_open"}
    assert port["retry_after"] == "5" and port["untouched"] and port["breaker_open"] == "open"
    assert port["predict"] == 200 and port["state"] == "closed"
    assert port["transitions"] == ["open", "half_open", "closed"]
