"""The port's `rfe_select` against the JAX package's, on the CPU.

Seeded rows (4000 x 30: a few informative columns of decreasing weight, a
0/1 column, noise, ~5% NaN). The selector draws nothing at random
(subsample = colsample_bytree = 1), so the port's refits grow the
reference's trees and eliminate the same features: ``support_`` and
``ranking_`` equal the reference's host-stepped loop
(``steps_per_dispatch=0``) exactly, and each refit's total gain per
feature is within rtol 1e-5 of the reference's (the two sigmoids differ in
the last bit, which moves margins from the second tree on). Chunked
selector refits (``RFEConfig.chunk_trees``) eliminate alike.

RFECV (``cv_folds=3``):

- on other seeded rows (1500 x 40: six informative columns, the rest
  noise, which a depth-5 selector overfits), where the winning feature
  count (16 of 40, 28, 16, 4) leads every other by more than 0.005:
  ``support_`` and ``ranking_`` (re-based on the winning mask) equal the
  reference's ``rfe_select(cv_folds=3)``;
- on the rows above with a depth-3 selector of 10 trees: each count's
  ``cv_scores_`` is within 1e-6 of the mean fold AUC of unbatched JAX fits
  (direct histograms) of the selector over that count's mask. Not of the
  reference's own scores, whose vmapped fits cast g/h/w to bf16. Not on
  the overfit rows either: there each package's sibling subtraction
  (parent - left) rounds its own way and flips near-tie splits of the deep
  trees, moving a fold AUC by up to ~3e-3 from a direct fit's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cobalt_smart_lender_ai_tpu.config import GBDTConfig as JaxGBDTConfig
from cobalt_smart_lender_ai_tpu.config import RFEConfig as JaxRFEConfig
from cobalt_smart_lender_ai_tpu.models import gbdt as jax_gbdt
from cobalt_smart_lender_ai_tpu.ops.metrics import roc_auc as jax_roc_auc
from cobalt_smart_lender_ai_tpu.parallel import rfe as jax_rfe
from cobalt_smart_lender_ai_tpu_torch.config import RFEConfig
from cobalt_smart_lender_ai_tpu_torch.ops.binning import compute_bin_edges, transform
from cobalt_smart_lender_ai_tpu_torch.parallel import rfe
from cobalt_smart_lender_ai_tpu_torch.parallel.tune import stratified_kfold_masks

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    N, F = 4000, 30
    X = rng.normal(size=(N, F)).astype(np.float32)
    X[:, 5] = rng.integers(0, 2, N)
    X[:, 7] = rng.lognormal(size=N)
    weights = np.zeros(F, np.float32)
    weights[[0, 3, 5, 7, 11, 12, 19, 26]] = [1.5, -1.1, 0.9, 0.7, 0.5, -0.4, 0.3, 0.2]
    logit = np.nan_to_num(X) @ weights - 1.2
    y = (rng.random(N) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    return X, y


def _recording(module, monkeypatch) -> list[np.ndarray]:
    """Record each refit's total gains as ``module``'s loop takes them."""
    seen: list[np.ndarray] = []
    inner = module.gain_importances

    def record(forest, n_features):
        out = inner(forest, n_features)
        seen.append(np.array(out[0], dtype=np.float64))
        return out

    monkeypatch.setattr(module, "gain_importances", record)
    return seen


@pytest.mark.parametrize(
    "kw",
    [
        dict(n_select=8, step=3, n_estimators=10, max_depth=3, scale_pos_weight=2.0),
        dict(n_select=20, step=1, n_estimators=6, max_depth=3),
    ],
    ids=["step3", "step1"],
)
def test_rfe_matches_jax(data, kw, monkeypatch):
    X, y = data
    port_gains = _recording(rfe, monkeypatch)
    jax_gains = _recording(jax_rfe, monkeypatch)
    got = rfe.rfe_select(X, y, RFEConfig(**kw), device="cpu")
    ref = jax_rfe.rfe_select(jnp.asarray(X), jnp.asarray(y), JaxRFEConfig(**kw, steps_per_dispatch=0))
    np.testing.assert_array_equal(got.support_, np.asarray(ref.support_))
    np.testing.assert_array_equal(got.ranking_, np.asarray(ref.ranking_))
    assert got.n_features_ == ref.n_features_ == kw["n_select"]
    assert got.cv_scores_ is None
    n_iters = -(-(X.shape[1] - kw["n_select"]) // kw["step"])
    assert len(port_gains) == len(jax_gains) == n_iters
    assert sorted(set(got.ranking_.tolist())) == list(range(1, n_iters + 2))
    for i, (a, b) in enumerate(zip(port_gains, jax_gains)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=0.0, err_msg=f"refit {i}")


def test_rfe_keeps_everything_when_nothing_to_drop(data):
    X, y = data
    got = rfe.rfe_select(X[:500, :6], y[:500], RFEConfig(n_select=6, n_estimators=2), device="cpu")
    assert got.support_.all() and (got.ranking_ == 1).all()


def test_chunked_selector_refits_eliminate_alike(data):
    X, y = data
    kw = dict(n_select=8, step=7, n_estimators=9, max_depth=3)
    whole = rfe.rfe_select(X, y, RFEConfig(**kw), device="cpu")
    chunked = rfe.rfe_select(X, y, RFEConfig(**kw, chunk_trees=4), device="cpu")
    np.testing.assert_array_equal(whole.ranking_, chunked.ranking_)


@pytest.fixture(scope="module")
def rfecv_data():
    rng = np.random.default_rng(1)
    N, F, informative = 1500, 40, 6
    X = rng.normal(size=(N, F)).astype(np.float32)
    w = np.zeros(F, np.float32)
    w[:informative] = rng.uniform(0.5, 1.0, informative) * rng.choice([-1, 1], informative)
    y = (rng.random(N) < 1.0 / (1.0 + np.exp(-(X @ w - 0.5)))).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    return X, y


RFECV = dict(n_select=4, step=12, n_estimators=20, max_depth=5)


def test_rfecv_is_not_ported(rfecv_data):
    """RFECV is ported: it selects as the reference does (the name is kept
    from when it raised)."""
    X, y = rfecv_data
    got = rfe.rfe_select(X, y, RFEConfig(**RFECV), cv_folds=3, device="cpu")
    ref = jax_rfe.rfe_select(jnp.asarray(X), jnp.asarray(y), JaxRFEConfig(**RFECV), cv_folds=3)
    scores = sorted(ref.cv_scores_.values(), reverse=True)
    assert scores[0] - scores[1] > 0.005  # the winner is clear despite bf16 scores
    assert sorted(got.cv_scores_) == sorted(ref.cv_scores_) == [4, 16, 28, 40]
    np.testing.assert_array_equal(got.support_, np.asarray(ref.support_))
    np.testing.assert_array_equal(got.ranking_, np.asarray(ref.ranking_))
    assert got.n_features_ == ref.n_features_ == 16


def test_rfecv_scores_match_unbatched_jax_fits(data):
    X, y = data
    cfg = RFEConfig(n_select=4, step=6, n_estimators=10, max_depth=3)
    got = rfe.rfe_select(X, y, cfg, cv_folds=3, device="cpu")
    assert sorted(got.cv_scores_) == [4, 6, 12, 18, 24, 30]
    # Each count's mask, from the plain elimination's ranking.
    plain = rfe.rfe_select(X, y, cfg, device="cpu")
    n_iters = int(plain.ranking_.max()) - 1
    masks = [np.ones(X.shape[1], bool)] + [plain.ranking_ <= n_iters - i for i in range(n_iters)]
    best = max(got.cv_scores_, key=lambda n: (got.cv_scores_[n], -n))
    assert np.array_equal(got.support_, next(m for m in masks if m.sum() == best))
    Xt = torch.from_numpy(X)
    bins = jnp.asarray(transform(compute_bin_edges(Xt, n_bins=rfe.SELECTOR_BINS), Xt).numpy())
    jy = jnp.asarray(y)
    val = stratified_kfold_masks(y, 3, cfg.seed)
    jcfg = JaxGBDTConfig(n_estimators=10, max_depth=3, n_bins=rfe.SELECTOR_BINS)
    for mask in masks:
        aucs = []
        for k in range(3):
            vk = jnp.asarray(val[k], jnp.float32)
            _, margin = jax_gbdt.fit_binned_resumable(
                bins, jy, 1.0 - vk, jnp.asarray(mask), jax_gbdt.GBDTHyperparams.from_config(jcfg),
                jax.random.PRNGKey(0), n_trees_cap=10, depth_cap=3, n_bins=rfe.SELECTOR_BINS,
                hist_subtract=False,
            )
            aucs.append(float(jax_roc_auc(jy, margin, weight=vk)))
        want = float(np.asarray(aucs, np.float32).mean())
        assert abs(got.cv_scores_[int(mask.sum())] - want) <= 1e-6, (int(mask.sum()), want)
