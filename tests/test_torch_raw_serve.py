"""Raw-row serving and the feature plan's artifact format, against the JAX
package's, on the CPU.

- `plan_to_json` / `plan_from_json` round-trip a `FeaturePlan`, with the
  one-hot vocabularies kept as ordered pairs; an artifact with a plan
  written by the port loads in JAX with an equal plan, and the reverse.
- `ScorerService.predict_raw` keeps the reference's contract: a
  `ValidationError` for a model saved without a plan, for a plan that does
  not produce the model's features and for a body that is not an object;
  ``prob_default``, ``features`` and ``engineered_row`` in the answer.
- Missing and unknown raw values follow training: NaN for a missing
  numeric, an all-zero one-hot block for an unknown category, the hardship
  fill for a missing status.
- A raw row of the table reproduces its row of the port's batch ingest bit
  for bit, and scores exactly as that row does on the /predict path's
  margin-only launch.
- Against a JAX-trained artifact: a raw row whose engineered values are
  bit-identical on both sides gets JAX's margin bit for bit, and its
  probability within 1e-6 (torch's sigmoid and XLA's differ in the last
  bit, as on the port's /predict path).
"""

from __future__ import annotations

import dataclasses
import json
from datetime import datetime

import numpy as np
import pytest
import torch

from cobalt_smart_lender_ai_tpu.config import ServeConfig as JaxServeConfig
from cobalt_smart_lender_ai_tpu.data import device_pipeline as jax_dp
from cobalt_smart_lender_ai_tpu.data.synthetic import synthetic_lendingclub_frame as jax_synthetic
from cobalt_smart_lender_ai_tpu.io import GBDTArtifact as JaxArtifact
from cobalt_smart_lender_ai_tpu.io import ObjectStore as JaxStore
from cobalt_smart_lender_ai_tpu.io.artifacts import plan_to_json as jax_plan_to_json
from cobalt_smart_lender_ai_tpu.models.gbdt import GBDTClassifier as JaxClassifier
from cobalt_smart_lender_ai_tpu.serve.service import ScorerService as JaxScorerService
from cobalt_smart_lender_ai_tpu_torch.config import ServeConfig
from cobalt_smart_lender_ai_tpu_torch.data import schema
from cobalt_smart_lender_ai_tpu_torch.data.device_pipeline import (
    run_device_ingest,
    tokenize_raw_frame,
    transform_raw_rows,
)
from cobalt_smart_lender_ai_tpu_torch.data.frame import row_dicts
from cobalt_smart_lender_ai_tpu_torch.data.synthetic import synthetic_lendingclub_frame
from cobalt_smart_lender_ai_tpu_torch.io import GBDTArtifact, ObjectStore, plan_from_json, plan_to_json
from cobalt_smart_lender_ai_tpu_torch.models.gbdt import GBDTClassifier
from cobalt_smart_lender_ai_tpu_torch.reliability.errors import ValidationError
from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService

TODAY = datetime(2026, 8, 1)
N_ROWS, SEED = 3000, 11
KEY = "models/gbdt/model_tree"
#: Rows of the raw table checked against their batch rows.
CHECK_ROWS = 48
TOL_PROB = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frame():
    return synthetic_lendingclub_frame(N_ROWS, SEED)


@pytest.fixture(scope="module")
def ingest(frame):
    return run_device_ingest(tokenize_raw_frame(frame, today=TODAY), device="cpu")


def _fit_and_save(ff, plan, root) -> None:
    """A small port forest on the 20 serving features, saved with ``plan``."""
    sel = ff.select(schema.SERVING_FEATURES)
    model = GBDTClassifier(n_estimators=12, max_depth=4, n_bins=32, device="cpu")
    model.fit(sel.X, sel.y)
    GBDTArtifact(
        forest=model.forest,
        feature_names=tuple(schema.SERVING_FEATURES),
        bin_edges=model.bin_spec.edges.numpy(),
        plan=plan,
    ).save(ObjectStore(str(root)), KEY)


@pytest.fixture(scope="module")
def port_root(ingest, tmp_path_factory):
    root = tmp_path_factory.mktemp("raw_serve") / "lake"
    _fit_and_save(ingest.tree, ingest.plan, root)
    return root


@pytest.fixture(scope="module")
def service(port_root):
    svc = ScorerService.from_store(ObjectStore(str(port_root)), ServeConfig(), device="cpu")
    yield svc
    svc.close()


def test_plan_json_round_trips(ingest):
    plan = ingest.plan
    text = json.dumps(plan_to_json(plan), sort_keys=True)
    back = plan_from_json(json.loads(text))
    assert back == plan
    assert list(back.categorical_vocab) == list(schema.ONE_HOT_COLS)


def test_port_artifact_with_plan_loads_in_jax(ingest, port_root):
    art = JaxArtifact.load(JaxStore(str(port_root)), KEY)
    assert jax_plan_to_json(art.plan) == plan_to_json(ingest.plan)
    assert list(art.plan.categorical_vocab) == list(ingest.plan.categorical_vocab)


@pytest.fixture(scope="module")
def jax_trained(tmp_path_factory):
    """A JAX-trained artifact with the JAX device ingest's plan."""
    df = jax_synthetic(N_ROWS, SEED)
    res = jax_dp.run_device_ingest(jax_dp.tokenize_raw_frame(df, today=TODAY))
    ff = res.tree.select(schema.SERVING_FEATURES)
    model = JaxClassifier(n_estimators=12, max_depth=4, n_bins=32)
    model.fit(np.asarray(ff.X), np.asarray(ff.y))
    root = tmp_path_factory.mktemp("raw_serve_jax") / "lake"
    JaxArtifact(
        forest=model.forest,
        bin_spec=model.bin_spec,
        feature_names=tuple(schema.SERVING_FEATURES),
        plan=res.plan,
    ).save(JaxStore(str(root)), KEY)
    return root, res.plan


def test_jax_artifact_with_plan_loads_in_port(jax_trained):
    root, plan = jax_trained
    art = GBDTArtifact.load(ObjectStore(str(root)), KEY, "cpu")
    assert plan_to_json(art.plan) == jax_plan_to_json(plan)
    assert list(art.plan.categorical_vocab) == list(plan.categorical_vocab)


def test_predict_raw_needs_a_plan(ingest, tmp_path):
    _fit_and_save(ingest.tree, None, tmp_path)
    svc = ScorerService.from_store(ObjectStore(str(tmp_path)), ServeConfig(), device="cpu")
    try:
        with pytest.raises(ValidationError, match="feature plan"):
            svc.predict_raw({"loan_amnt": 1000.0})
    finally:
        svc.close()


def test_predict_raw_needs_the_serving_features_in_the_plan(ingest, tmp_path):
    plan = ingest.plan
    hs = [n for n in plan.tree_feature_names if n.startswith("hardship_status_")]
    narrow = dataclasses.replace(
        plan,
        categorical_vocab={k: v for k, v in plan.categorical_vocab.items() if k != "hardship_status"},
        tree_feature_names=tuple(n for n in plan.tree_feature_names if n not in hs),
    )
    _fit_and_save(ingest.tree, narrow, tmp_path)
    svc = ScorerService.from_store(ObjectStore(str(tmp_path)), ServeConfig(), device="cpu")
    try:
        with pytest.raises(ValidationError, match="serving features"):
            svc.predict_raw({"loan_amnt": 1000.0})
    finally:
        svc.close()


@pytest.mark.parametrize("body", [["loan_amnt", 1.0], "raw", 3.0])
def test_predict_raw_needs_an_object(service, body):
    with pytest.raises(ValidationError, match="JSON object"):
        service.predict_raw(body)


def test_raw_missing_and_unknown_values(ingest):
    """Missing numerics -> NaN, unknown categories -> an all-zero one-hot
    block, a missing hardship status -> the clean-stage fill."""
    plan = ingest.plan
    payload = {"loan_amnt": 10000.0, "term": " 36 months", "int_rate": "11.5%",
               "grade": "ZZZ-not-a-grade"}
    out = transform_raw_rows(plan, [payload], device="cpu")[0].numpy()
    names = list(plan.tree_feature_names)
    assert out[names.index("loan_amnt")] == np.float32(np.log1p(10000.0))
    assert out[names.index("term")] == 36.0
    assert out[names.index("int_rate")] == np.float32(np.log1p(np.float32(0.115)))
    grade = [j for j, n in enumerate(names) if n.startswith("grade_")]
    assert grade and (out[grade] == 0.0).all()
    fill = names.index(f"hardship_status_{schema.HARDSHIP_FILL}")
    for j, n in enumerate(names):
        if n.startswith("hardship_status_"):
            assert out[j] == (1.0 if j == fill else 0.0), n
    assert np.isnan(out[names.index("annual_inc")])
    # The missing-means-zero columns are filled as in cleaning.
    assert out[names.index("inq_last_12m")] == 0.0


def _batch_index(tree: np.ndarray, row: np.ndarray) -> int | None:
    eq = (tree == row[None, :]) | (np.isnan(tree) & np.isnan(row[None, :]))
    match = np.flatnonzero(eq.all(axis=1))
    return int(match[0]) if match.size else None


def test_raw_rows_reproduce_their_batch_rows_and_scores(frame, ingest, service):
    tree = ingest.tree.X.numpy()
    plan = ingest.plan
    sel = [plan.tree_feature_names.index(n) for n in schema.SERVING_FEATURES]
    payloads = row_dicts(frame, np.arange(CHECK_ROWS))
    feats = transform_raw_rows(plan, payloads, device="cpu").numpy()
    model = service._model
    checked = 0
    for payload, raw in zip(payloads, feats):
        i = _batch_index(tree, raw)
        if i is None:
            continue  # dropped by cleaning: no batch row to compare
        resp = service.predict_raw(payload)
        assert resp["features"] == list(schema.SERVING_FEATURES)
        got = np.array([resp["engineered_row"][n] for n in schema.SERVING_FEATURES], np.float32)
        want = tree[i, sel]
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
        prob = model.score(want[None, :], with_shap=False)[0][0]
        assert resp["prob_default"] == float(prob)
        checked += 1
    assert checked >= 0.9 * CHECK_ROWS


def test_jax_trained_artifact_scores_raw_rows_as_jax(jax_trained, frame):
    root, _ = jax_trained
    jax_svc = JaxScorerService.from_store(
        JaxStore(str(root)), JaxServeConfig(prewarm_all_buckets=False, score_cache_size=0)
    )
    svc = ScorerService.from_store(ObjectStore(str(root)), ServeConfig(), device="cpu")
    try:
        payloads = row_dicts(frame, np.arange(CHECK_ROWS))
        same = 0
        for payload in payloads:
            want, got = jax_svc.predict_raw(payload), svc.predict_raw(payload)
            assert got["features"] == want["features"]
            a = np.array(list(want["engineered_row"].values()), np.float32)
            b = np.array(list(got["engineered_row"].values()), np.float32)
            if np.array_equal(a.view(np.int32), b.view(np.int32)):
                want_margin = np.asarray(jax_svc._model.margin_fn(a[None, :]))
                margin, prob = svc._model.margin_fn(torch.from_numpy(b[None, :]))
                assert np.array_equal(margin.numpy().view(np.int32), want_margin.view(np.int32))
                assert got["prob_default"] == float(prob[0])
                assert abs(got["prob_default"] - want["prob_default"]) <= TOL_PROB
                same += 1
            else:
                np.testing.assert_allclose(b, a, rtol=3e-7, atol=0)
        assert same >= CHECK_ROWS // 2
    finally:
        jax_svc.close()
        svc.close()
