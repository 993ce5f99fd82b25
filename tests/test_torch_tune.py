"""The port's randomized CV search against the JAX package's, on the CPU.

- `sample_candidates`, `stratified_kfold_masks` and `search_buckets` equal
  the reference's exactly, over several seeds and grids: the dense
  permutation branch, the rejection-sampling branch and the draw with
  replacement (a grid smaller than ``n_iter``).
- `roc_auc` with fold weights is within 1e-6 of the reference's.
- `cross_validate_gbdt`, with candidates that draw nothing at random
  (subsample = colsample_bytree = 1): each job's AUC, with direct or
  sibling-subtracted histograms, is within 1e-6 of an unbatched JAX fit
  (``models.gbdt.fit_binned_resumable``) with direct histograms on the same
  bins with weights ``w * (1 - val)``, scored on the fold. Not of the
  reference's own ``cross_validate_gbdt``: its vmapped fits cast g/h/w to
  bf16. Not of the reference's subtracted fits either: there a bin that
  holds none of a node's training rows keeps the last-bit residue of
  parent - left, which picks among thresholds that split the training rows
  alike, and the fold's rows (weight 0) that fall in such bins follow that
  pick; the port zeroes those bins, as a direct histogram leaves them.
  Scores are the same whether the candidates run in one bucket or in
  several.
- `randomized_search` against the reference's: the same candidates; each
  candidate's mean CV AUC, and the refit's held-out AUC, within 0.005 (the
  tolerance of sampled fits, whose random streams differ by design).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cobalt_smart_lender_ai_tpu.config import GBDTConfig as JaxGBDTConfig
from cobalt_smart_lender_ai_tpu.config import TuneConfig as JaxTuneConfig
from cobalt_smart_lender_ai_tpu.models import gbdt as jax_gbdt
from cobalt_smart_lender_ai_tpu.ops.metrics import roc_auc as jax_roc_auc
from cobalt_smart_lender_ai_tpu.parallel import tune as jax_tune
from cobalt_smart_lender_ai_tpu_torch.config import GBDTConfig, TuneConfig
from cobalt_smart_lender_ai_tpu_torch.models.gbdt import GBDTHyperparams
from cobalt_smart_lender_ai_tpu_torch.ops.binning import compute_bin_edges, transform
from cobalt_smart_lender_ai_tpu_torch.ops.metrics import roc_auc
from cobalt_smart_lender_ai_tpu_torch.parallel import tune

AUC_TOL = 1e-6
SEARCH_TOL = 0.005
N_BINS = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    """(X, y): 3000 rows x 8 columns, NaN cells, a 0/1 column, a logistic
    label with a ~25% positive rate."""
    rng = np.random.default_rng(5)
    N, F = 3000, 8
    X = rng.normal(size=(N, F)).astype(np.float32)
    X[:, 2] = rng.integers(0, 2, N)
    logit = 1.1 * X[:, 0] - 0.9 * X[:, 1] + 0.8 * X[:, 2] + 0.4 * X[:, 4] - 1.4
    y = (rng.random(N) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    X[rng.random(X.shape) < 0.06] = np.nan
    return X, y


SPACES = {
    "reference": TuneConfig().param_space,  # 648 combinations: rejection sampling
    "dense": {"max_depth": (3, 5), "learning_rate": (0.05, 0.1, 0.2), "gamma": (0.0, 1.0)},
    "tiny": {"n_estimators": (100, 200), "max_depth": (3,)},  # fewer than n_iter
}


@pytest.mark.parametrize("space", SPACES, ids=str)
@pytest.mark.parametrize("n_iter,seed", [(20, 22), (4, 0), (9, 7), (12, 123)])
def test_sample_candidates_match_jax(space, n_iter, seed):
    got = tune.sample_candidates(SPACES[space], n_iter, seed)
    assert got == jax_tune.sample_candidates(SPACES[space], n_iter, seed)
    assert len(got) == n_iter


def test_reference_defaults_draw_as_documented():
    """The default search: 20 candidates, 11 of them at depth 9."""
    cands = tune.sample_candidates(TuneConfig().param_space, 20, TuneConfig().seed)
    assert cands == jax_tune.sample_candidates(JaxTuneConfig().param_space, 20, 22)
    assert sum(c["max_depth"] == 9 for c in cands) == 11
    assert sum(c["n_estimators"] for c in cands) * 3 == 11_100


@pytest.mark.parametrize("k,seed", [(2, 0), (3, 22), (5, 9)])
def test_stratified_kfold_masks_match_jax(data, k, seed):
    _, y = data
    got = tune.stratified_kfold_masks(y, k, seed)
    np.testing.assert_array_equal(got, jax_tune.stratified_kfold_masks(y, k, seed))
    assert (got.sum(axis=0) == 1).all()


@pytest.mark.parametrize("seed", [22, 3])
def test_search_buckets_match_jax(seed):
    cands = tune.sample_candidates(TuneConfig().param_space, 20, seed)
    for base_kw in ({}, {"n_estimators": 50, "max_depth": 4}):
        assert tune.search_buckets(cands, GBDTConfig(**base_kw)) == jax_tune.search_buckets(
            cands, JaxGBDTConfig(**base_kw)
        )


def test_weighted_auc_with_fold_weights_matches_jax():
    rng = np.random.default_rng(2)
    N = 20_000
    y = (rng.random(N) < 0.2).astype(np.float32)
    s = (rng.normal(size=N) + 1.5 * y).astype(np.float32)
    s[::7] = np.round(s[::7], 1)  # ties
    w = rng.random(N).astype(np.float32)
    val = tune.stratified_kfold_masks(y, 3, 22).astype(np.float32)
    for k in range(3):
        got = float(roc_auc(torch.from_numpy(y), torch.from_numpy(s), torch.from_numpy(val[k] * w)))
        ref = float(jax_roc_auc(jnp.asarray(y), jnp.asarray(s), weight=jnp.asarray(val[k] * w)))
        assert abs(got - ref) <= AUC_TOL, (k, got, ref)


#: Candidates that draw nothing at random, over two (depth, n_estimators)
#: buckets.
CV_CANDIDATES = [
    {"n_estimators": 12, "max_depth": 3, "learning_rate": 0.1},
    {"n_estimators": 8, "max_depth": 4, "learning_rate": 0.3, "gamma": 1.0},
    {"n_estimators": 12, "max_depth": 3, "learning_rate": 0.3, "min_child_weight": 5.0},
]


@pytest.fixture(scope="module")
def cv_setup(data):
    X, y = data
    Xt = torch.from_numpy(X)
    bins = transform(compute_bin_edges(Xt, n_bins=N_BINS), Xt)
    val = tune.stratified_kfold_masks(y, 3, 22)
    base = GBDTConfig(n_bins=N_BINS, scale_pos_weight=2.5)
    return bins, torch.from_numpy(y), val, base


@pytest.mark.parametrize("subtract", [False, True], ids=["direct", "subtract"])
def test_cross_validate_matches_unbatched_jax_fits(cv_setup, subtract):
    bins, y, val, base = cv_setup
    hps = [GBDTHyperparams.from_config(base.replace(**c)) for c in CV_CANDIDATES]
    got = tune.cross_validate_gbdt(
        bins, y, hps, torch.from_numpy(val), 22, n_bins=N_BINS, hist_subtract=subtract
    )
    assert got.shape == (len(CV_CANDIDATES), 3)
    jbins, jy = jnp.asarray(bins.numpy()), jnp.asarray(y.numpy())
    fm = jnp.ones(bins.shape[1], bool)
    jbase = JaxGBDTConfig(n_bins=N_BINS, scale_pos_weight=2.5)
    for c, cand in enumerate(CV_CANDIDATES):
        cfg = jbase.replace(**cand)
        for k in range(3):
            vk = jnp.asarray(val[k], jnp.float32)
            _, margin = jax_gbdt.fit_binned_resumable(
                jbins, jy, 1.0 - vk, fm, jax_gbdt.GBDTHyperparams.from_config(cfg),
                jax.random.PRNGKey(0), n_trees_cap=cfg.n_estimators,
                depth_cap=cfg.max_depth, n_bins=N_BINS, hist_subtract=False,
            )
            ref = float(jax_roc_auc(jy, margin, weight=vk))
            assert abs(got[c, k] - ref) <= AUC_TOL, (cand, k, got[c, k], ref)


def test_cross_validate_does_not_depend_on_bucketing(cv_setup):
    bins, y, val, base = cv_setup
    cands = [dict(c, subsample=0.8, colsample_bytree=0.5) for c in CV_CANDIDATES]
    hps = [GBDTHyperparams.from_config(base.replace(**c)) for c in cands]
    masks = torch.from_numpy(val[:2])
    joint = tune.cross_validate_gbdt(bins, y, hps, masks, 7, n_bins=N_BINS)
    split = np.zeros_like(joint)
    for idxs in tune.search_buckets(cands, base):
        split[idxs] = tune.cross_validate_gbdt(
            bins, y, [hps[i] for i in idxs], masks, 7, n_bins=N_BINS, cand_ids=idxs
        )
    np.testing.assert_array_equal(joint, split)
    assert len(tune.search_buckets(cands, base)) == 2


def test_randomized_search_matches_jax(data):
    X, y = data
    n_train = 2400
    space = {
        "n_estimators": (10, 20),
        "max_depth": (3, 4),
        "learning_rate": (0.1, 0.3),
        "subsample": (0.8, 1.0),
    }
    got = tune.randomized_search(
        X[:n_train], y[:n_train], GBDTConfig(n_bins=N_BINS),
        TuneConfig(n_iter=3, cv_folds=2, seed=4, param_space=space), device="cpu",
    )
    ref = jax_tune.randomized_search(
        jnp.asarray(X[:n_train]), jnp.asarray(y[:n_train]), JaxGBDTConfig(n_bins=N_BINS),
        JaxTuneConfig(n_iter=3, cv_folds=2, seed=4, param_space=space),
    )
    assert got.cv_results_["params"] == ref.cv_results_["params"]
    np.testing.assert_allclose(
        got.cv_results_["mean_test_score"], ref.cv_results_["mean_test_score"], atol=SEARCH_TOL
    )
    assert got.cv_results_["split_test_scores"].shape == (3, 2)
    np.testing.assert_array_equal(
        got.cv_results_["val_masks"], jax_tune.stratified_kfold_masks(y[:n_train], 2, 4)
    )
    assert got.best_score_ == got.cv_results_["mean_test_score"].max()
    assert got.best_params_ == got.cv_results_["params"][int(np.argmax(got.cv_results_["mean_test_score"]))]
    held_out = float(roc_auc(torch.from_numpy(y[n_train:]), got.best_estimator_.predict_margin(X[n_train:])))
    ref_held_out = float(
        jax_roc_auc(jnp.asarray(y[n_train:]), ref.best_estimator_.predict_margin(jnp.asarray(X[n_train:])))
    )
    assert abs(held_out - ref_held_out) <= SEARCH_TOL
