"""The port's `explain.TreeExplainer` against the JAX package's, on the CPU.

A JAX `GBDTClassifier` fitted on seeded rows (1,000 x 6, ~3% NaN; 12 trees
of depth 4) is carried across with `convert.forest_from_numpy` into a port
classifier. On the same rows:

- the port's phis are within ``TOL_SHAP`` of the JAX facade's (the port's
  test tolerance of SHAP: the same algebra, summed in another order);
- ``expected_value + Σ phi`` is the port's margin within ``TOL_ADDITIVITY``;
- the two ``expected_value`` agree within ``TOL_SHAP`` before and after a
  call, and equal the base value the scoring entry returns;
- chunk sizes 1, 7, 256 and the whole set give the same phis bit for bit
  (each row's phis depend on that row only), and each chunk is one call of
  the scoring entry (one dispatch of the plain version's program here).

``gain_importances`` is re-exported from `models.gbdt`, and an unfitted
model is refused.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cobalt_smart_lender_ai_tpu.explain import TreeExplainer as JaxTreeExplainer
from cobalt_smart_lender_ai_tpu.models.gbdt import GBDTClassifier as JaxGBDTClassifier
from cobalt_smart_lender_ai_tpu_torch import explain
from cobalt_smart_lender_ai_tpu_torch.convert import forest_from_numpy
from cobalt_smart_lender_ai_tpu_torch.models import gbdt
from cobalt_smart_lender_ai_tpu_torch.telemetry.programs import default_program_registry

TOL_SHAP = 1e-5
TOL_ADDITIVITY = 1e-4
FIELDS = ("feature", "thr_bin", "thr_float", "missing_left", "gain", "cover", "leaf_value")


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(1000, 6)).astype(np.float32)
    logit = 1.2 * X[:, 0] - 0.8 * X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
    y = (rng.random(1000) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    X[rng.random(X.shape) < 0.03] = np.nan
    jax_model = JaxGBDTClassifier(n_estimators=12, max_depth=4, n_bins=16).fit(X, y)
    forest = jax_model.forest
    port = gbdt.GBDTClassifier(device="cpu")
    port.forest = forest_from_numpy({k: np.asarray(getattr(forest, k)) for k in FIELDS}, forest.depth)
    port.n_features_ = X.shape[1]
    return jax_model, port, X


def test_phis_and_base_match_the_jax_facade(models):
    jax_model, port, X = models
    ours, ref = explain.TreeExplainer(port), JaxTreeExplainer(jax_model)
    assert abs(ours.expected_value - ref.expected_value) <= TOL_SHAP
    phis = ours.shap_values(X[:100], chunk_size=32)
    want = ref.shap_values(X[:100], chunk_size=32)
    assert phis.shape == (100, 6) and phis.dtype == np.float32
    np.testing.assert_allclose(phis, want, rtol=0, atol=TOL_SHAP)
    assert abs(ours.expected_value - ref.expected_value) <= TOL_SHAP
    margin = gbdt.predict_margin(port.forest, torch.from_numpy(X[:100])).numpy()
    np.testing.assert_allclose(ours.expected_value + phis.sum(axis=1), margin, rtol=0,
                               atol=TOL_ADDITIVITY)


def test_chunking_does_not_change_the_result_and_each_chunk_is_one_call(models):
    _, port, X = models
    ours = explain.TreeExplainer(port)
    whole = ours.shap_values(X, chunk_size=len(X))
    registry = default_program_registry()

    def calls() -> int:
        return sum(r["dispatches"] for r in registry.table() if r["name"].startswith("score_forest_plain/")
                   or r["name"].startswith("score_forest/"))

    for chunk in (1, 7, 256):
        before = calls()
        got = ours.shap_values(X[:300], chunk_size=chunk)
        assert calls() - before == -(-300 // chunk)
        assert got.tobytes() == whole[:300].tobytes(), chunk
    base = explain.TreeExplainer(port)
    base.shap_values(X[:1])
    assert base.expected_value == float(ours._packed().base) == ours.expected_value
    assert ours.shap_values(X[:0]).shape == (0, 6)
    with pytest.raises(ValueError, match="chunk_size"):
        ours.shap_values(X, chunk_size=0)


def test_gain_importances_is_reexported_and_unfitted_is_refused():
    assert explain.gain_importances is gbdt.gain_importances
    assert set(explain.__all__) == {"shap_values", "TreeExplainer", "gain_importances"}
    with pytest.raises(RuntimeError, match="fit"):
        explain.TreeExplainer(gbdt.GBDTClassifier(device="cpu"))
