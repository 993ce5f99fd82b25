"""The port's `run_pipeline` against the JAX package's, on the CPU.

Both packages train from ``synthetic_lendingclub_frame(6000, seed=5)`` with
``today`` pinned, under the configuration of ``tests/test_pipeline.py``
(64 bins, RFE to 12 features in steps of 30 with a 20-tree depth-3
selector, a 2 x 2 search), the JAX package on a one-device mesh. Held to
the reference:

- the same selected features (RFE's fits draw nothing at random, and the
  port grows the reference's trees);
- the same candidates, and the same ``best_params`` wherever the
  reference's best and second-best mean CV AUC differ by more than 0.005
  (the reference's vmapped CV fits cast g/h/w to bf16, so its CV scores
  are not the unbatched fits'; `tests/test_torch_tune.py` holds the port's
  jobs to unbatched JAX fits);
- the held-out AUC within 0.005;
- the artifact the port writes loads in the JAX package and gives the
  port's margins bit for bit; ``.features.json`` and ``metrics.json`` as
  `tests/test_pipeline.py` checks them; the confusion-matrix and
  feature-importance PNGs are the reference's renders of the run's
  confusion matrix and gains, byte for byte;
- without a raw table or a store it raises the reference's ``ValueError``;
- each stage observes ``cobalt_pipeline_stage_seconds`` once with its
  ``timings`` seconds and records a ``pipeline.<stage>`` span under
  ``pipeline.run``; the CLI's ``--ledger-out`` and ``--trace-out`` write a
  ledger with the JAX CLI's top-level keys and a Perfetto trace.

Checkpoints and resume, as ``tests/test_reliability.py`` holds the
reference's, under a smaller configuration (3000 loans, RFE to 10 in one
step, a 2 x 2 search of 40 trees):

- a run killed in the search (``randomized_search`` made to raise) leaves
  the ``clean``, ``engineer`` and ``rfe`` manifests; resumed without a raw
  table it skips those stages, runs ``search`` and ``eval``, and publishes
  the uninterrupted run's forest bit for bit;
- resuming a finished run skips every stage up to the search (timings
  ``restore``, ``refit``, ``eval``) and refits the same forest; a change to
  RFE's configuration alone reruns ``rfe`` and ``search`` and nothing
  upstream; ``resume=False`` recomputes every stage;
- with the raw table saved at ``data.raw_key``, ``raw=None`` trains the
  model that the table itself trains.
"""

from __future__ import annotations

import functools
import json
from datetime import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cobalt_smart_lender_ai_tpu import pipeline as jax_pipeline
from cobalt_smart_lender_ai_tpu.config import GBDTConfig as JaxGBDTConfig
from cobalt_smart_lender_ai_tpu.config import MeshConfig
from cobalt_smart_lender_ai_tpu.config import PipelineConfig as JaxPipelineConfig
from cobalt_smart_lender_ai_tpu.config import RFEConfig as JaxRFEConfig
from cobalt_smart_lender_ai_tpu.config import TuneConfig as JaxTuneConfig
from cobalt_smart_lender_ai_tpu.data.synthetic import synthetic_lendingclub_frame as jax_synthetic
from cobalt_smart_lender_ai_tpu.io import GBDTArtifact as JaxArtifact
from cobalt_smart_lender_ai_tpu.io import ObjectStore as JaxStore
from cobalt_smart_lender_ai_tpu.io.plots import render_confusion_matrix as jax_render_cm
from cobalt_smart_lender_ai_tpu.io.plots import render_feature_importance as jax_render_fi
from cobalt_smart_lender_ai_tpu.models.gbdt import predict_margin as jax_predict_margin
from cobalt_smart_lender_ai_tpu.parallel.mesh import make_mesh
from cobalt_smart_lender_ai_tpu_torch import pipeline
from cobalt_smart_lender_ai_tpu_torch.config import (
    GBDTConfig,
    PipelineConfig,
    ReliabilityConfig,
    RFEConfig,
    TuneConfig,
)
from cobalt_smart_lender_ai_tpu_torch.data.features import drop_training_leakage
from cobalt_smart_lender_ai_tpu_torch.data.split import train_test_split_hashed
from cobalt_smart_lender_ai_tpu_torch.data.synthetic import synthetic_lendingclub_frame
from cobalt_smart_lender_ai_tpu_torch.io import GBDTArtifact, ObjectStore
from cobalt_smart_lender_ai_tpu_torch.models.gbdt import gain_importances
from cobalt_smart_lender_ai_tpu_torch.ops.metrics import confusion_matrix
from cobalt_smart_lender_ai_tpu_torch.reliability import PipelineCheckpoint
from cobalt_smart_lender_ai_tpu_torch.telemetry import (
    default_registry,
    default_tracer,
    load_ledger,
)

TODAY = datetime(2026, 8, 1)
N_ROWS, SEED = 6000, 5
AUC_TOL = 0.005
SPACE = {"n_estimators": (100, 150), "max_depth": (3,), "learning_rate": (0.1,)}
KEY = "models/gbdt/model_tree"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: What the port's run in `runs` left in the process-wide telemetry.
TELEMETRY: dict = {}


def _stage_histogram() -> dict[str, tuple[int, float]]:
    """``{stage: (count, sum)}`` of ``cobalt_pipeline_stage_seconds``."""
    fam = next(f for f in default_registry().families() if f.name == "cobalt_pipeline_stage_seconds")
    return {labels[0]: (child.count, child.sum) for labels, child in fam._items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port result, port store, JAX result), ``today`` pinned (in the
    reference's tokenizer for the run: its pipeline takes no date)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(
        jax_pipeline,
        "tokenize_raw_frame",
        functools.partial(jax_pipeline.tokenize_raw_frame, today=TODAY),
    )
    try:
        jcfg = JaxPipelineConfig(
            save_intermediate=False,
            gbdt=JaxGBDTConfig(n_bins=64),
            rfe=JaxRFEConfig(n_select=12, step=30, n_estimators=20, max_depth=3),
            tune=JaxTuneConfig(n_iter=2, cv_folds=2, param_space=SPACE),
        )
        one = make_mesh(MeshConfig(dp=1, hp=1), devices=jax.devices()[:1])
        jres = jax_pipeline.run_pipeline(jcfg, raw=jax_synthetic(N_ROWS, seed=SEED), mesh=one)
        cfg = PipelineConfig(
            gbdt=GBDTConfig(n_bins=64),
            rfe=RFEConfig(n_select=12, step=30, n_estimators=20, max_depth=3),
            tune=TuneConfig(n_iter=2, cv_folds=2, param_space=SPACE),
        )
        store = ObjectStore(str(tmp_path_factory.mktemp("port_pipeline")))
        TELEMETRY["stages_before"] = _stage_histogram()
        res = pipeline.run_pipeline(
            cfg, raw=synthetic_lendingclub_frame(N_ROWS, seed=SEED), store=store,
            device="cpu", today=TODAY,
        )
        TELEMETRY["stages_after"] = _stage_histogram()
        TELEMETRY["spans"] = default_tracer().export()
    finally:
        mp.undo()
    return res, store, jres


def test_selected_features_and_candidates_match_jax(runs):
    res, _, jres = runs
    assert len(res.selected_features) == 12
    assert res.selected_features == jres.selected_features
    assert res.search.cv_results_["params"] == jres.search.cv_results_["params"]


def test_best_params_and_aucs_match_jax(runs):
    res, _, jres = runs
    means = np.sort(np.asarray(jres.search.cv_results_["mean_test_score"]))[::-1]
    if means[0] - means[1] > AUC_TOL:
        assert res.best_params == jres.best_params
    assert abs(res.test_auc - jres.test_auc) <= AUC_TOL
    assert abs(res.cv_auc - jres.cv_auc) <= AUC_TOL
    assert res.test_auc >= 0.93 and abs(res.cv_auc - res.test_auc) < 0.05


def test_stages_are_timed(runs):
    res, _, _ = runs
    assert list(res.timings) == ["host_frontier", "device_ingest", "rfe", "search", "eval"]
    assert all(t >= 0.0 for t in res.timings.values())
    # The plain histogram runs on the CPU: no kernel launch anywhere.
    assert set(res.hist_launches.values()) == {0}


def test_each_stage_observes_the_stage_histogram_once(runs):
    res, _, _ = runs
    before, after = TELEMETRY["stages_before"], TELEMETRY["stages_after"]
    for stage, seconds in res.timings.items():
        count, total = after[stage]
        count0, total0 = before.get(stage, (0, 0.0))
        assert count - count0 == 1, stage
        assert total - total0 == pytest.approx(seconds, abs=1e-9), stage
    assert {s for s in after if after[s] != before.get(s)} == set(res.timings)


def test_stage_spans_nest_under_the_run_span(runs):
    res, _, _ = runs
    spans = TELEMETRY["spans"]
    run = [sp for sp in spans if sp["name"] == "pipeline.run"][-1]
    children = [sp for sp in spans if sp["parent_id"] == run["span_id"]]
    assert [sp["name"] for sp in children] == [f"pipeline.{s}" for s in res.timings]
    for sp, seconds in zip(children, res.timings.values()):
        assert sp["trace_id"] == run["trace_id"]
        assert sp["duration_s"] == pytest.approx(seconds, abs=2e-6)
        assert run["start_s"] <= sp["start_s"] <= sp["start_s"] + sp["duration_s"] <= (
            run["start_s"] + run["duration_s"] + 1e-6
        )


def test_cli_ledger_and_trace_have_the_references_keys(runs, tmp_path, monkeypatch):
    """The port's CLI with ``--ledger-out`` and ``--trace-out`` on a small
    quick run, and the JAX CLI's own ledger code around the reference's run
    of this module (its ``run_pipeline`` made to return that result): the
    same top-level ledger keys, the port's trace a Perfetto document with
    ``pipeline.run`` and its stages."""
    _, _, jres = runs
    port_ledger, port_trace = tmp_path / "port.json", tmp_path / "port_trace.json"
    res = pipeline.main([
        "--synthetic-rows", "3000", "--quick", "--device", "cpu",
        "--ledger-out", str(port_ledger), "--trace-out", str(port_trace),
    ])
    jax_ledger, jax_trace = tmp_path / "jax.json", tmp_path / "jax_trace.json"
    monkeypatch.setattr(jax_pipeline, "run_pipeline", lambda *a, **k: jres)
    jax_pipeline.main(["--ledger-out", str(jax_ledger), "--trace-out", str(jax_trace)])
    doc, ref = load_ledger(str(port_ledger)), json.loads(jax_ledger.read_text())
    assert set(doc) == set(ref)
    assert doc["stages"] == {k: round(v, 6) for k, v in res.timings.items()}
    assert doc["final_metrics"]["n_selected"] == 20
    assert doc["stages_run"] == {"run": list(res.stages_run), "skipped": []}
    assert doc["meta"]["device"] == "cpu" and doc["kind"] == ref["kind"] == "pipeline"
    hist = [p for p in doc["programs"] if p["name"].startswith("gradient_histogram_plain/")]
    assert hist and all(p["dispatches"] > 0 and p["roofline_utilization"] is None for p in hist)
    assert "cobalt_pipeline_stage_seconds" in doc["metrics"]
    trace = json.loads(port_trace.read_text())
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"pipeline.run"} | {f"pipeline.{s}" for s in res.timings} <= names
    assert set(trace) == set(json.loads(jax_trace.read_text()))


def test_metrics_and_features_json_reference_schema(runs):
    res, store, _ = runs
    assert store.get_json(KEY + ".features.json") == list(res.selected_features)
    metrics = store.get_json(KEY + ".metrics.json")
    assert set(metrics) == {"auc", "classification_report", "best_params"}
    assert metrics["auc"] == pytest.approx(res.test_auc)
    report = metrics["classification_report"]
    assert set(report) == {"0", "1", "accuracy", "macro avg", "weighted avg"}
    assert set(report["1"]) == {"precision", "recall", "f1-score", "support"}
    assert metrics["best_params"] == res.best_params
    assert set(metrics["best_params"]) <= set(SPACE)


def test_port_artifact_loads_in_jax_with_the_same_margins(runs):
    res, store, _ = runs
    jart = JaxArtifact.load(JaxStore(str(store.root)), KEY)
    assert jart.feature_names == res.selected_features
    assert jart.plan is not None and jart.plan.tree_feature_names == res.artifact.plan.tree_feature_names
    assert jart.plan.asof == res.artifact.plan.asof == TODAY.strftime("%Y-%m-%d")
    assert jart.metrics["auc"] == pytest.approx(res.test_auc)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, len(jart.feature_names))).astype(np.float32) * 1e3
    X[rng.random(X.shape) < 0.1] = np.nan
    port_margin = res.search.best_estimator_.predict_margin(X).numpy()
    np.testing.assert_array_equal(port_margin, np.asarray(jax_predict_margin(jart.forest, jnp.asarray(X))))
    back = GBDTArtifact.load(store, KEY, "cpu")
    assert back.plan == res.artifact.plan
    assert torch.equal(back.forest.thr_float, res.artifact.forest.thr_float)


def test_plots_are_the_reference_renders(runs):
    res, store, _ = runs
    cfg = PipelineConfig()
    tree = pipeline.table_features(store.load_frame(cfg.data.tree_key), torch.device("cpu"))
    ff = drop_training_leakage(tree)
    _, X_test, _, y_test = train_test_split_hashed(ff.X, ff.y)
    idx = torch.tensor([ff.feature_names.index(n) for n in res.selected_features])
    pred = res.search.best_estimator_.predict(X_test.index_select(1, idx))
    cm = confusion_matrix(y_test, pred).numpy()
    gains, _ = gain_importances(res.artifact.forest, len(res.selected_features))
    assert store.get_bytes(KEY + ".confusion_matrix.png") == jax_render_cm(cm)
    assert store.get_bytes(KEY + ".feature_importance.png") == jax_render_fi(
        res.selected_features, gains.numpy()
    )


def test_unported_options_raise():
    """Without a raw table or a store there is nothing to train on: the
    reference's ``ValueError`` (the name is kept from when ``raw=None`` and
    ``resume=True`` raised as not ported)."""
    with pytest.raises(ValueError, match="provide a raw frame or an object store"):
        pipeline.run_pipeline(PipelineConfig(), raw=None, device="cpu")
    with pytest.raises(ValueError, match="provide a raw frame or an object store"):
        pipeline.run_pipeline(PipelineConfig(), raw=None, resume=True, device="cpu")
    with pytest.raises(ValueError, match="provide a raw frame or an object store"):
        jax_pipeline.run_pipeline(JaxPipelineConfig(), raw=None)


# -- checkpoints and resume -------------------------------------------------------

RESUME_ROWS = 3000
FOREST_FIELDS = ("feature", "thr_bin", "thr_float", "missing_left", "gain", "cover", "leaf_value")


def _resume_config(**rfe_kw) -> PipelineConfig:
    rfe_cfg = dict(n_select=10, step=200, n_estimators=8, max_depth=3)
    rfe_cfg.update(rfe_kw)
    return PipelineConfig(
        gbdt=GBDTConfig(n_bins=32),
        rfe=RFEConfig(**rfe_cfg),
        tune=TuneConfig(
            n_iter=2, cv_folds=2,
            param_space={"n_estimators": (40,), "max_depth": (3,), "learning_rate": (0.1, 0.3)},
        ),
        reliability=ReliabilityConfig(base_delay_s=0.0, max_delay_s=0.0, jitter=0.0),
    )


def _run(store, raw=None, resume=None, **rfe_kw):
    return pipeline.run_pipeline(
        _resume_config(**rfe_kw), raw=raw, store=store, resume=resume, device="cpu", today=TODAY
    )


def _same_forest(a, b) -> bool:
    return all(torch.equal(getattr(a.artifact.forest, f), getattr(b.artifact.forest, f))
               for f in FOREST_FIELDS)


@pytest.fixture(scope="module")
def small_raw():
    return synthetic_lendingclub_frame(RESUME_ROWS, seed=11)


@pytest.fixture(scope="module")
def finished(small_raw, tmp_path_factory):
    """An uninterrupted run and its store."""
    store = ObjectStore(str(tmp_path_factory.mktemp("finished")))
    return _run(store, raw=small_raw), store


def test_resume_after_crash_skips_completed_stages(finished, small_raw, tmp_path, monkeypatch):
    full, _ = finished
    store = ObjectStore(str(tmp_path))

    def boom(*args, **kwargs):
        raise RuntimeError("killed mid-search")

    monkeypatch.setattr(pipeline, "randomized_search", boom)
    with pytest.raises(RuntimeError, match="killed mid-search"):
        _run(store, raw=small_raw)
    monkeypatch.undo()
    ckpt = PipelineCheckpoint(store)
    for stage in ("clean", "engineer", "rfe"):
        assert ckpt.load(stage) is not None, stage
    assert ckpt.load("search") is None
    res = _run(store, resume=True)  # no raw table needed
    assert res.stages_skipped == ("clean", "engineer", "rfe")
    assert res.stages_run == ("search", "eval")
    assert list(res.timings) == ["restore", "search", "eval"]
    assert res.selected_features == full.selected_features and len(res.selected_features) == 10
    assert _same_forest(res, full) and res.test_auc == full.test_auc
    assert res.search.cv_results_["params"] == full.search.cv_results_["params"]
    np.testing.assert_array_equal(
        res.search.cv_results_["split_test_scores"], full.search.cv_results_["split_test_scores"]
    )


def test_resume_full_run_then_config_change(finished):
    full, store = finished
    assert full.stages_run == ("clean", "engineer", "rfe", "search", "eval")
    assert full.stages_skipped == ()
    assert set(full.intermediates["bytes"]) == {
        "dataset/2-intermediate/cleaned_01.csv",
        "dataset/2-intermediate/cleaned_02_tree.csv",
        "dataset/2-intermediate/cleaned_02_nn.csv",
    }
    res = _run(store, resume=True)
    assert res.stages_skipped == ("clean", "engineer", "rfe", "search")
    assert res.stages_run == ("eval",)
    assert list(res.timings) == ["restore", "refit", "eval"]
    assert res.best_params == full.best_params and res.cv_auc == full.cv_auc
    assert _same_forest(res, full) and res.test_auc == full.test_auc
    assert res.intermediates == {}
    changed = _run(store, resume=True, n_estimators=9)  # RFE's configuration alone
    assert changed.stages_skipped == ("clean", "engineer")
    assert changed.stages_run == ("rfe", "search", "eval")


def test_resume_off_recomputes(finished, small_raw, tmp_path):
    _, store = finished
    fresh = ObjectStore(str(tmp_path))
    _run(fresh, raw=small_raw)
    res = _run(fresh, raw=small_raw, resume=False)
    assert res.stages_run == ("clean", "engineer", "rfe", "search", "eval")
    assert res.stages_skipped == ()


def test_raw_table_from_the_store(finished, small_raw, tmp_path):
    full, _ = finished
    store = ObjectStore(str(tmp_path))
    store.save_frame(PipelineConfig().data.raw_key, small_raw)
    res = _run(store)
    assert res.selected_features == full.selected_features
    assert _same_forest(res, full) and res.test_auc == full.test_auc
