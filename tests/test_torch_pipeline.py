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
  `tests/test_pipeline.py` checks them;
- what is not ported raises: ``raw=None``, ``resume=True``.
"""

from __future__ import annotations

import functools
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
from cobalt_smart_lender_ai_tpu.models.gbdt import predict_margin as jax_predict_margin
from cobalt_smart_lender_ai_tpu.parallel.mesh import make_mesh
from cobalt_smart_lender_ai_tpu_torch import pipeline
from cobalt_smart_lender_ai_tpu_torch.config import (
    GBDTConfig,
    PipelineConfig,
    RFEConfig,
    TuneConfig,
)
from cobalt_smart_lender_ai_tpu_torch.data.synthetic import synthetic_lendingclub_frame
from cobalt_smart_lender_ai_tpu_torch.io import GBDTArtifact, ObjectStore

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
        res = pipeline.run_pipeline(
            cfg, raw=synthetic_lendingclub_frame(N_ROWS, seed=SEED), store=store,
            device="cpu", today=TODAY,
        )
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


def test_unported_options_raise():
    frame = synthetic_lendingclub_frame(50, seed=1)
    with pytest.raises(NotImplementedError, match="A3"):
        pipeline.run_pipeline(PipelineConfig(), raw=None, device="cpu")
    with pytest.raises(NotImplementedError, match="A4"):
        pipeline.run_pipeline(PipelineConfig(), raw=frame, resume=True, device="cpu")
