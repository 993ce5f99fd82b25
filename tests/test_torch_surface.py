"""The last of the JAX package's public surface in the port, on the CPU.

- Config classes: every config dataclass of the reference has its
  counterpart in the port, whose fields are the reference's, less the few
  listed in ``NOT_PORTED`` (each with its reason); no field lives on
  another class than the reference's (the serving ``degrade_shap`` and ``request_deadline_s`` are
  `ReliabilityConfig`'s). Each port class builds from the reference's field
  names and default values, and equals its own default but where
  ``OTHER_DEFAULTS`` says why not.
- ``ServeConfig(reliability=ReliabilityConfig(request_deadline_s=5.0,
  degrade_shap=False))`` governs the service: its requests' deadlines are
  5 s and the brownout's SHAP rung no longer sheds SHAP.
- `Forest.n_internal`, ``n_leaves`` and ``is_real_split()`` and
  `FeatureFrame.column` give what the reference's give on the same forest
  and frame.
- `telemetry.snapshot` round-trips through JSON and holds the registry's
  values and the tracer's spans; `telemetry.program_table` is the default
  program registry's table, also by ``kind``.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cobalt_smart_lender_ai_tpu.config as jax_config
from cobalt_smart_lender_ai_tpu.data.features import FeatureFrame as JaxFeatureFrame
from cobalt_smart_lender_ai_tpu.io import GBDTArtifact as JaxGBDTArtifact
from cobalt_smart_lender_ai_tpu.io import ObjectStore as JaxObjectStore
import cobalt_smart_lender_ai_tpu_torch.config as port_config
from cobalt_smart_lender_ai_tpu_torch import telemetry
from cobalt_smart_lender_ai_tpu_torch.data.features import FeatureFrame
from cobalt_smart_lender_ai_tpu_torch.io import GBDTArtifact, ObjectStore
from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService

ROOT = Path(__file__).resolve().parent.parent
KEY = "models/gbdt/model_tree"

#: Reference fields the port leaves out, and why (``ROADMAP.md``).
NOT_PORTED = {
    # Read by no module of the reference but its fastapi adapter.
    "DataConfig": {"store_uri"},
    # The host-stepped RFE's dispatch budget: the calibration ratchet (A5).
    "RFEConfig": {"steps_per_dispatch"},
    # XLA program choices and a directory no module reads ("Not queued").
    "ServeConfig": {"history_dir", "precompile_batch_buckets", "prewarm_all_buckets", "fused_kernels"},
    # Read by no module of the reference.
    "TuneConfig": {"scoring"},
}
#: Port defaults that differ from the reference's, and why: an nvcc build
#: is cached whatever it took (the reference's 5 s is XLA's threshold).
OTHER_DEFAULTS = {("CompileCacheConfig", "min_compile_time_secs")}


def _config_classes(module) -> dict[str, type]:
    return {n: c for n, c in vars(module).items()
            if inspect.isclass(c) and dataclasses.is_dataclass(c) and c.__module__ == module.__name__}


PAIRS = sorted(_config_classes(jax_config))


def test_every_reference_config_class_is_in_the_port():
    assert set(_config_classes(port_config)) == set(PAIRS)
    assert {"ReliabilityConfig", "ServeConfig"} <= set(PAIRS)


@pytest.mark.parametrize("name", PAIRS)
def test_fields_are_the_references_on_the_same_class(name):
    ref = [f.name for f in dataclasses.fields(getattr(jax_config, name))]
    port = [f.name for f in dataclasses.fields(getattr(port_config, name))]
    assert set(port) == set(ref) - NOT_PORTED.get(name, set()) and len(port) == len(set(port))
    elsewhere = {f: other for other in PAIRS if other != name
                 for f in (f.name for f in dataclasses.fields(getattr(port_config, other)))}
    assert not [f for f in ref if f in elsewhere and f not in port]


def _port_kwargs(ref_obj) -> dict:
    """The reference object's fields that the port has, as port values."""
    name = type(ref_obj).__name__
    port_names = {f.name for f in dataclasses.fields(getattr(port_config, name))}
    out = {}
    for f in dataclasses.fields(ref_obj):
        if f.name not in port_names:
            continue
        value = getattr(ref_obj, f.name)
        if dataclasses.is_dataclass(value):
            value = getattr(port_config, type(value).__name__)(**_port_kwargs(value))
        out[f.name] = value
    return out


def _leaves(obj) -> dict[tuple[str, str], object]:
    """(class, field) -> value of every non-config field, nested ones too."""
    out = {}
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        if dataclasses.is_dataclass(value):
            out.update({(k[0], f"{f.name}.{k[1]}"): v for k, v in _leaves(value).items()})
        else:
            out[(type(obj).__name__, f.name)] = value
    return out


@pytest.mark.parametrize("name", PAIRS)
def test_each_port_class_builds_from_the_references_names_and_defaults(name):
    built = _leaves(getattr(port_config, name)(**_port_kwargs(getattr(jax_config, name)())))
    default = _leaves(getattr(port_config, name)())
    assert built.keys() == default.keys()
    for (cls, path), value in default.items():
        if (cls, path.rsplit(".", 1)[-1]) not in OTHER_DEFAULTS:
            assert built[cls, path] == value, path


def test_reliability_settings_govern_the_service():
    rel = port_config.ReliabilityConfig(request_deadline_s=5.0, degrade_shap=False)
    cfg = port_config.ServeConfig(reliability=rel)
    svc = ScorerService.from_store(ObjectStore(str(ROOT / "artifacts")), cfg, device="cpu")
    try:
        assert 4.0 < svc._new_deadline().remaining() <= 5.0

        class Rung2:
            level = 2

        svc.brownout = Rung2()
        assert not svc._shed_shap()
        svc.config = port_config.ServeConfig()
        assert svc._shed_shap()
        assert 29.0 < svc._new_deadline().remaining() <= 30.0
    finally:
        svc.close()


def test_forest_residues_are_the_references():
    ref = JaxGBDTArtifact.load(JaxObjectStore(str(ROOT / "artifacts")), KEY).forest
    port = GBDTArtifact.load(ObjectStore(str(ROOT / "artifacts")), KEY, "cpu").forest
    assert (port.n_internal, port.n_leaves) == (ref.n_internal, ref.n_leaves) == (127, 128)
    real = port.is_real_split()
    assert real.dtype == torch.bool and real.shape == (300, 127)
    np.testing.assert_array_equal(real.numpy(), np.asarray(ref.is_real_split()))
    assert 0 < int(real.sum()) < real.numel()


def test_feature_frame_column_is_the_references():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(50, 4)).astype(np.float32)
    names = ("a", "b", "c", "d")
    port = FeatureFrame(names, torch.from_numpy(X))
    ref = JaxFeatureFrame(names, jnp.asarray(X))
    for name in names:
        assert port.column(name).numpy().tobytes() == np.asarray(ref.column(name)).tobytes()
    with pytest.raises(ValueError):
        port.column("e")


def test_snapshot_round_trips_through_json():
    registry = telemetry.MetricsRegistry()
    registry.counter("cobalt_test_total", "a test counter", ("route",)).labels(route="/x").inc(3)
    tracer = telemetry.Tracer()
    with tracer.span("test.outer", rows=4):
        with tracer.span("test.inner"):
            pass
    snap = telemetry.snapshot(registry, tracer, span_limit=1)
    text = json.dumps(snap)
    assert json.dumps(json.loads(text)) == text
    assert snap["metrics"] == registry.snapshot()
    assert [s["name"] for s in snap["spans"]] == [tracer.export(limit=1)[0]["name"]]
    assert len(telemetry.snapshot(registry, tracer)["spans"]) == 2
    text = json.dumps(telemetry.snapshot())  # the process defaults: NaN gauges, tuple attrs
    assert json.dumps(json.loads(text)) == text


def test_program_table_is_the_default_registrys():
    from cobalt_smart_lender_ai_tpu_torch.ops.score import fused_score, pack_forest
    from cobalt_smart_lender_ai_tpu_torch.telemetry.programs import default_program_registry

    art = GBDTArtifact.load(ObjectStore(str(ROOT / "artifacts")), KEY, "cpu")
    pack = pack_forest(art.forest, 20, "f32")
    fused_score(pack, torch.zeros((3, 20)), n_features=20)
    table = telemetry.program_table()
    assert table == default_program_registry().table()
    rows = [r for r in table if r["name"].startswith("score_forest")]
    assert rows and all(r["dispatches"] >= 1 for r in rows)
    kinds = {r["kind"] for r in table}
    for kind in kinds:
        assert telemetry.program_table(kind=kind) == default_program_registry().table(kind=kind)
    assert "program_table" in telemetry.__all__ and "snapshot" in telemetry.__all__
