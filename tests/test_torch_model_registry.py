"""The port's model registry (`io/model_registry.py`) against the JAX
package's.

The same publish / promote / rollback / gc scripts on a port store and a
JAX store give the same keys, the same version records and channel pointers
byte for byte, and the same md5 for the same artifact (the ``.npz`` holds
its zip entries' write times, so both serialize under one frozen zip clock;
the artifact bytes of the two packages are then equal). A registry written
by the JAX package resolves and serves in the port, and one written by the
port is read, verified and served by the JAX package. Under a
`FaultInjectingStore` behind `ResilientStore` retries, the same seeded
fault schedule gives the same injected faults in both, every step
completes, and no channel pointer is ever torn or dangling; with retries
exhausted, a step raises only the store's typed fault.
"""

from __future__ import annotations

import hashlib
import json
import time
import types
import zipfile

import numpy as np
import pytest

from cobalt_smart_lender_ai_tpu.config import ServeConfig as JaxServeConfig
from cobalt_smart_lender_ai_tpu.io import GBDTArtifact as JaxArtifact
from cobalt_smart_lender_ai_tpu.io import ObjectStore as JaxStore
from cobalt_smart_lender_ai_tpu.io.model_registry import CHANNELS as JAX_CHANNELS
from cobalt_smart_lender_ai_tpu.io.model_registry import ModelRegistry as JaxRegistry
from cobalt_smart_lender_ai_tpu.reliability import ResilientStore as JaxResilientStore
from cobalt_smart_lender_ai_tpu.reliability import RetryPolicy as JaxRetryPolicy
from cobalt_smart_lender_ai_tpu.reliability.faults import FaultInjectingStore as JaxFaultStore
from cobalt_smart_lender_ai_tpu.reliability.faults import FaultSpec as JaxFaultSpec
from cobalt_smart_lender_ai_tpu.serve.service import ScorerService as JaxScorerService
from cobalt_smart_lender_ai_tpu.telemetry import MetricsRegistry as JaxMetrics
from cobalt_smart_lender_ai_tpu_torch.config import ServeConfig
from cobalt_smart_lender_ai_tpu_torch.data import schema
from cobalt_smart_lender_ai_tpu_torch.io import CHANNELS, GBDTArtifact, ModelRegistry, ModelVersion, ObjectStore
from cobalt_smart_lender_ai_tpu_torch.models.gbdt import GBDTClassifier
from cobalt_smart_lender_ai_tpu_torch.reliability import (
    FaultInjectingStore,
    FaultSpec,
    InjectedFault,
    ResilientStore,
    RetryPolicy,
)
from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService
from cobalt_smart_lender_ai_tpu_torch.telemetry import MetricsRegistry
from cobalt_smart_lender_ai_tpu_torch.tools import registry_gc

TOL_PROB = 1e-6
F = len(schema.SERVING_FEATURES)


@pytest.fixture(autouse=True)
def frozen_zip_clock(monkeypatch):
    """One zip write time for every ``.npz`` the test serializes."""
    monkeypatch.setattr(zipfile, "time", types.SimpleNamespace(time=lambda: 1.7e9, localtime=time.localtime))


@pytest.fixture(scope="module")
def artifact_bytes() -> bytes:
    """A small forest on the 20 serving features, fit by the port on the CPU."""
    rng = np.random.default_rng(61)
    X = rng.normal(size=(800, F)).astype(np.float32)
    y = (X[:, 0] + 0.7 * X[:, 3] - 0.4 * X[:, 9] + 0.3 * rng.normal(size=800) > 0).astype(np.float32)
    model = GBDTClassifier(n_estimators=6, max_depth=3, n_bins=32, device="cpu").fit(X, y)
    art = GBDTArtifact(
        forest=model.forest,
        feature_names=tuple(schema.SERVING_FEATURES),
        bin_edges=model.bin_spec.edges.numpy(),
        metrics={"test_auc": 0.9},
    )
    return art.to_bytes()


def _artifacts(artifact_bytes: bytes) -> dict:
    return {"port": GBDTArtifact.from_bytes(artifact_bytes, "cpu"),
            "jax": JaxArtifact.from_bytes(artifact_bytes)}


def _pair(tmp_path, artifact_bytes) -> dict:
    """(registry, store, artifact) per package over its own empty store."""
    arts = _artifacts(artifact_bytes)
    port, jax = ObjectStore(str(tmp_path / "port")), JaxStore(str(tmp_path / "jax"))
    return {"port": (ModelRegistry(port), port, arts["port"]),
            "jax": (JaxRegistry(jax), jax, arts["jax"])}


def _tree(store) -> dict:
    """Every object of a store, by key: JSON parsed, bytes as their md5."""
    out = {}
    for key in sorted(store.list("")):
        data = store.get_bytes(key)
        out[key] = json.loads(data) if key.endswith(".json") else hashlib.md5(data).hexdigest()
    return out


def _script(reg, art) -> list:
    """Publish, promote, publish, promote, rollback, publish without a
    channel, gc; the return values of every call."""
    out = [reg.publish("gbdt", art, provenance={"dataset_md5": "abc", "config_hash": "ff"}).to_json()]
    out.append(reg.promote("gbdt"))
    out.append(reg.publish("gbdt", art).to_json())
    out.append(reg.promote("gbdt"))
    out.append(reg.rollback("gbdt", reason="slo burn"))
    out.append(reg.publish("gbdt", art, channel=None).to_json())
    out.append(reg.publish("gbdt_other", art).to_json())
    out.append(reg.gc(keep_last=1, dry_run=True))
    out.append([reg.channel("gbdt", ch) for ch in CHANNELS])
    out.append([reg.resolve("gbdt", ch) for ch in CHANNELS])
    out.append([reg.verify("gbdt", v) for v in reg.versions("gbdt")])
    out.append(reg.names())
    out.append(reg.channel_record("gbdt", "latest").to_json())
    out.append(reg.gc(keep_last=0, dry_run=False))
    return out


def test_scripts_give_the_references_keys_records_and_pointers(tmp_path, artifact_bytes):
    assert CHANNELS == JAX_CHANNELS
    pair = _pair(tmp_path, artifact_bytes)
    results = {side: _script(reg, art) for side, (reg, _, art) in pair.items()}
    results["jax"][-1] = json.loads(json.dumps(results["jax"][-1]))  # sorted-int keys as JSON
    results["port"][-1] = json.loads(json.dumps(results["port"][-1]))
    assert results["port"] == results["jax"]
    trees = {side: _tree(store) for side, (_, store, _) in pair.items()}
    assert trees["port"] == trees["jax"]
    first = results["port"][0]
    assert first["md5"] == hashlib.md5(artifact_bytes).hexdigest() and first["kind"] == "GBDTArtifact"
    assert results["port"][4]["restored_version"] == 1 and results["port"][-1]["models"]["gbdt"] == {
        "kept": [1, 2], "deleted": [3]}
    assert sorted(trees["port"]) == sorted(trees["jax"]) and "registry/channels/gbdt/latest.json" in trees["port"]


def test_records_read_across_packages(tmp_path, artifact_bytes):
    pair = _pair(tmp_path, artifact_bytes)
    for side, (reg, _, art) in pair.items():
        reg.publish("gbdt", art, provenance={"feature_sketch": {"n": 1}})
    port_reader = ModelRegistry(ObjectStore(str(tmp_path / "jax")))
    jax_reader = JaxRegistry(JaxStore(str(tmp_path / "port")))
    assert port_reader.record("gbdt", 1).to_json() == jax_reader.record("gbdt", 1).to_json()
    assert isinstance(port_reader.record("gbdt", 1), ModelVersion)
    assert port_reader.verify("gbdt", 1) and jax_reader.verify("gbdt", 1)
    assert port_reader.resolve("gbdt", "canary") == jax_reader.resolve("gbdt", "canary") == "models/gbdt/v1"


def test_registry_guards_are_the_references(tmp_path, artifact_bytes):
    pair = _pair(tmp_path, artifact_bytes)
    for side, (reg, store, art) in pair.items():
        with pytest.raises(LookupError, match="no canary published"):
            reg.promote("gbdt")
        reg.publish("gbdt", art)
        reg.promote("gbdt")
        with pytest.raises(LookupError, match="no previous version"):
            reg.rollback("gbdt")
        with pytest.raises(ValueError, match="unknown channel"):
            reg.set_channel("gbdt", "prod", 1)
        with pytest.raises(FileNotFoundError):
            reg.set_channel("gbdt", "latest", 99)
        reg._next_version = lambda name: 1
        with pytest.raises(FileExistsError):
            reg.publish("gbdt", art)
        assert reg.versions("gbdt") == [1], side


def test_gc_cli_is_the_references(tmp_path, artifact_bytes, capsys):
    from tools.registry_gc import main as jax_gc_main

    pair = _pair(tmp_path, artifact_bytes)
    reports = {}
    for side, (reg, store, art) in pair.items():
        for _ in range(3):
            reg.publish("gbdt", art, channel=None)
        (registry_gc.main if side == "port" else jax_gc_main)(["--store", store.uri, "--keep-last", "1"])
        reports[side] = json.loads(capsys.readouterr().out)
        assert store.exists("models/gbdt/v1.npz")  # a dry run deletes nothing
    assert reports["port"] == reports["jax"]
    assert reports["port"]["dry_run"] is True and reports["port"]["models"]["gbdt"]["deleted"] == [1, 2]
    registry_gc.main(["--store", pair["port"][1].uri, "--keep-last", "1", "--apply"])
    assert json.loads(capsys.readouterr().out)["dry_run"] is False
    assert pair["port"][0].versions("gbdt") == [3]


def _payload(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    alias = {v: k for k, v in schema.SERVING_FIELD_ALIASES.items()}
    return {alias.get(n, n): int(rng.integers(0, 2)) if n in schema.SERVING_INT_FEATURES
            else float(np.round(rng.normal(), 4)) for n in schema.SERVING_FEATURES}


def _jax_service(root: str):
    return JaxScorerService.from_store(
        JaxStore(root),
        JaxServeConfig(canary_enabled=True, precompile_batch_buckets=(), prewarm_all_buckets=False,
                       microbatch_enabled=False, score_cache_size=0),
    )


def _port_service(root: str):
    return ScorerService.from_store(
        ObjectStore(root), ServeConfig(canary_enabled=True, microbatch_enabled=False, score_cache_size=0),
        device="cpu",
    )


def test_each_package_serves_the_others_registry(tmp_path, artifact_bytes):
    """v1 promoted to ``latest`` and v2 left in ``canary`` by one package;
    the other's service resolves ``latest`` over the static ``model_key``,
    answers with ``model_version`` ``v1``, loads v2 as its canary, and
    scores as the writer's own service does (prob within 1e-6)."""
    pair = _pair(tmp_path, artifact_bytes)
    for side, (reg, _, art) in pair.items():
        reg.publish("gbdt", art)
        reg.promote("gbdt")
        reg.publish("gbdt", art)
    payloads = [_payload(s) for s in range(3)]
    probs = {}
    for writer in ("port", "jax"):
        root = str(tmp_path / writer)
        for reader, build in (("port", _port_service), ("jax", _jax_service)):
            svc = build(root)
            try:
                assert svc._model_key == "models/gbdt/v1", (writer, reader)
                assert svc.model_info["version"] == "v1" and svc.model_info["channel"] == "latest"
                assert svc.canary.status()["loaded"] and svc.canary.status()["canary"]["version"] == 2
                answers = [svc.predict_single(p) for p in payloads]
                assert all(a["model_version"] == "v1" for a in answers)
                probs[(writer, reader)] = [a["prob_default"] for a in answers]
            finally:
                svc.close()
    ref = probs[("port", "port")]
    for key, got in probs.items():
        np.testing.assert_allclose(got, ref, rtol=0, atol=TOL_PROB, err_msg=str(key))


FAULTS = {
    "put": {"rate": 0.2, "max_faults": 40},
    "get": {"rate": 0.15, "max_faults": 40},
    "exists": {"rate": 0.1, "max_faults": 20},
    "delete": {"rate": 0.2, "max_faults": 10},
}


def _whole(store, reg, art_cls) -> None:
    """Every channel pointer that exists parses, names a version whose
    record exists, and its artifact restores: stale is allowed, torn or
    dangling is not."""
    for name in reg.names():
        for ch in CHANNELS:
            key = reg._channel_key(name, ch)
            if not store.exists(key):
                continue
            ptr = json.loads(store.get_bytes(key).decode())
            assert {"name", "channel", "version", "key", "md5"} <= set(ptr)
            assert reg.record(name, int(ptr["version"])).key == ptr["key"]
            if art_cls is GBDTArtifact:
                art_cls.load(store, ptr["key"], "cpu")
            else:
                art_cls.load(store, ptr["key"])


def _drill(side: str, root, art, attempts: int = 6):
    if side == "port":
        flaky = FaultInjectingStore(ObjectStore(str(root)), seed=13, sleep=lambda s: None,
                                    registry=MetricsRegistry(),
                                    faults={k: FaultSpec(**v) for k, v in FAULTS.items()})
        store = ResilientStore(flaky, RetryPolicy(max_attempts=attempts, base_delay_s=0.0, jitter=0.0),
                               verify_reads=True)
        return flaky, store, ModelRegistry(store), GBDTArtifact
    flaky = JaxFaultStore(JaxStore(str(root)), seed=13, sleep=lambda s: None, registry=JaxMetrics(),
                          faults={k: JaxFaultSpec(**v) for k, v in FAULTS.items()})
    store = JaxResilientStore(flaky, JaxRetryPolicy(max_attempts=attempts, base_delay_s=0.0, jitter=0.0),
                              verify_reads=True)
    return flaky, store, JaxRegistry(store), JaxArtifact


def test_lifecycle_under_faults_completes_as_the_references(tmp_path, artifact_bytes):
    arts = _artifacts(artifact_bytes)
    injected = {}
    for side in ("port", "jax"):
        flaky, store, reg, art_cls = _drill(side, tmp_path / side, arts[side])
        art = arts[side]
        reg.publish("gbdt", art)
        _whole(store, reg, art_cls)
        reg.promote("gbdt")
        _whole(store, reg, art_cls)
        for cycle in range(2):
            for step in (lambda: reg.publish("gbdt", art), lambda: reg.promote("gbdt"),
                         lambda c=cycle: reg.rollback("gbdt", reason=f"cycle {c}")):
                step()
                _whole(store, reg, art_cls)
        injected[side] = dict(flaky.injected)
        assert flaky.injected.total() > 0
    assert injected["port"] == injected["jax"]
    assert _tree(ObjectStore(str(tmp_path / "port"))) == _tree(JaxStore(str(tmp_path / "jax")))


def test_lifecycle_with_retries_exhausted_raises_only_typed_faults(tmp_path, artifact_bytes):
    """One attempt per call: steps fail with the store's `InjectedFault`
    (a `ConnectionError`) and nothing else, and after every step, failed or
    not, the pointers are whole."""
    art = _artifacts(artifact_bytes)["port"]
    flaky, store, reg, _ = _drill("port", tmp_path / "port", art, attempts=1)
    failures = []
    steps = [lambda: reg.publish("gbdt", art), lambda: reg.promote("gbdt")] * 6 + [
        lambda: reg.rollback("gbdt", reason="drill")] * 3
    clean = ModelRegistry(flaky.inner)
    for step in steps:
        try:
            step()
        except LookupError:
            pass  # a channel a failed step never set: the registry's own answer
        except Exception as exc:
            failures.append(exc)
        _whole(clean.store, clean, GBDTArtifact)
    assert failures and all(isinstance(e, InjectedFault) for e in failures), failures
