"""The port's successive-halving search against the JAX package's, on the CPU.

- `halving_ladder` equals the reference's over the grid of
  ``tests/test_halving.py``.
- `randomized_search` on a chunked schedule (explicit ``chunk_trees`` of 12,
  and of 10, where a rung's whole chunks overshoot its budget: 20 trees
  scored at a budget of 12), on 3000 seeded rows with four candidates that
  draw nothing at random (subsample = colsample = 1):
  - the halving report equals the reference's ``randomized_search``
    report: budgets, per-rung live and pruned counts, ``survivors``,
    ``scored_at_trees``, ``dispatches``; and so do the winner and the
    candidates. The data and candidates are such that at every rung the
    kept and the pruned candidates' mean AUCs differ by more than 0.005
    (asserted), since the reference's vmapped scores carry bf16 error;
  - each candidate's scores at its last rung are within 1e-6 of unbatched
    JAX fits (``models.gbdt.fit_binned_resumable``, direct histograms)
    truncated at ``min(chunk * ceil(budget / chunk), n_estimators)``
    trees, as ``tests/test_torch_tune.py`` holds the exhaustive jobs;
  - the survivors' split scores are bitwise the port's exhaustive scores
    (``halving_enabled=False``), which has no report and boosts every
    candidate to its full ``n_estimators``.
- The engage rules return None where the reference's do: no chunk, a chunk
  as long as the fit, fewer rungs than ``halving_min_rungs``, one
  candidate.
- ``quick_config()`` is the reference CLI's ``--quick`` profile (``"auto"``
  chunks, halving on); ``--no-halving`` turns it off.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cobalt_smart_lender_ai_tpu.config import GBDTConfig as JaxGBDTConfig
from cobalt_smart_lender_ai_tpu.config import MeshConfig
from cobalt_smart_lender_ai_tpu.config import TuneConfig as JaxTuneConfig
from cobalt_smart_lender_ai_tpu.models import gbdt as jax_gbdt
from cobalt_smart_lender_ai_tpu.ops.metrics import roc_auc as jax_roc_auc
from cobalt_smart_lender_ai_tpu.parallel import tune as jax_tune
from cobalt_smart_lender_ai_tpu.parallel.mesh import make_mesh
from cobalt_smart_lender_ai_tpu_torch import pipeline
from cobalt_smart_lender_ai_tpu_torch.config import GBDTConfig, TuneConfig
from cobalt_smart_lender_ai_tpu_torch.ops.binning import compute_bin_edges, transform
from cobalt_smart_lender_ai_tpu_torch.parallel import tune

N_BINS = 32
AUC_TOL = 1e-6
MARGIN = 0.005
SPACE = {"n_estimators": (24, 48), "max_depth": (2, 4), "learning_rate": (0.02, 0.3)}
REPORT_KEYS = ("eta", "budgets", "rungs", "pruned_candidates", "survivors", "scored_at_trees",
               "dispatches")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize(
    "cap,cands,eta,min_rungs",
    [(300, 20, 2, 2), (27, 9, 3, 2), (40, 1, 2, 2), (1, 8, 2, 2), (300, 0, 2, 2),
     (100, 2, 2, 2), (100, 2, 2, 3), (300, 4, 2, 2)]
    + [(cap, c, 2, 2) for cap in (7, 48, 300) for c in (2, 6, 20)],
)
def test_halving_ladder_matches_jax(cap, cands, eta, min_rungs):
    assert tune.halving_ladder(cap, cands, eta=eta, min_rungs=min_rungs) == (
        jax_tune.halving_ladder(cap, cands, eta=eta, min_rungs=min_rungs)
    )


@pytest.fixture(scope="module")
def data():
    """(X, y): 3000 rows x 8 columns, NaN cells, a 0/1 column, a logistic
    label with an interaction."""
    rng = np.random.default_rng(5)
    N, F = 3000, 8
    X = rng.normal(size=(N, F)).astype(np.float32)
    X[:, 2] = rng.integers(0, 2, N)
    logit = 1.1 * X[:, 0] - 0.9 * X[:, 1] + 0.8 * X[:, 2] + 0.4 * X[:, 4] * X[:, 5] - 1.4
    y = (rng.random(N) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    X[rng.random(X.shape) < 0.06] = np.nan
    return X, y


def _tune(chunk, halving=True, **kw) -> TuneConfig:
    return TuneConfig(n_iter=4, cv_folds=2, seed=5, chunk_trees=chunk, halving_enabled=halving,
                      param_space=SPACE, **kw)


@pytest.fixture(scope="module", params=[12, 10], ids=["chunk12", "chunk10"])
def searches(request, data):
    """(chunk, port halving, port exhaustive, reference halving)."""
    X, y = data
    chunk = request.param
    base = GBDTConfig(n_bins=N_BINS)
    hv = tune.randomized_search(X, y, base, _tune(chunk), device="cpu")
    ex = tune.randomized_search(X, y, base, _tune(chunk, halving=False), device="cpu")
    tq = JaxTuneConfig(n_iter=4, cv_folds=2, seed=5, chunk_trees=chunk, param_space=SPACE)
    ref = jax_tune.randomized_search(jnp.asarray(X), jnp.asarray(y), JaxGBDTConfig(n_bins=N_BINS), tq)
    return chunk, hv, ex, ref


@pytest.fixture(scope="module")
def unbatched(data):
    """Mean and per-fold validation AUC of an unbatched JAX fit of a
    candidate, truncated at ``trees``."""
    X, y = data
    Xt = torch.from_numpy(X)
    bins = jnp.asarray(transform(compute_bin_edges(Xt, n_bins=N_BINS), Xt).numpy())
    jy = jnp.asarray(y)
    val = tune.stratified_kfold_masks(y, 2, 5)
    cache: dict = {}

    def scores(cand: dict, trees: int) -> np.ndarray:
        key = (tuple(sorted(cand.items())), trees)
        if key not in cache:
            cfg = JaxGBDTConfig(n_bins=N_BINS).replace(**cand)
            out = []
            for k in range(2):
                vk = jnp.asarray(val[k], jnp.float32)
                _, margin = jax_gbdt.fit_binned_resumable(
                    bins, jy, 1.0 - vk, jnp.ones(X.shape[1], bool),
                    jax_gbdt.GBDTHyperparams.from_config(cfg), jax.random.PRNGKey(0),
                    n_trees_cap=trees, depth_cap=cfg.max_depth, n_bins=N_BINS, hist_subtract=False,
                )
                out.append(float(jax_roc_auc(jy, margin, weight=vk)))
            cache[key] = np.asarray(out)
        return cache[key]

    return scores


def test_report_matches_jax(searches):
    chunk, hv, _, ref = searches
    got, want = hv.cv_results_["halving"], ref.cv_results_["halving"]
    for k in REPORT_KEYS:
        assert got[k] == want[k], k
    assert got["budgets"] == [12, 24, 48] and got["pruned_candidates"] == 3
    assert got["chunk_trees"] == {2: chunk, 4: chunk}
    assert hv.cv_results_["params"] == ref.cv_results_["params"]
    assert hv.best_params_ == ref.best_params_
    assert len({(c["max_depth"], c["learning_rate"]) for c in hv.cv_results_["params"]}) == 4


def test_rung_scores_match_unbatched_jax_fits(searches, unbatched):
    """Each rung's live candidates, at the trees their whole chunks reached:
    the kept and the pruned differ by more than the margin, and each
    candidate's last-rung scores are within 1e-6 of the JAX fits."""
    chunk, hv, _, _ = searches
    report = hv.cv_results_["halving"]
    cands = hv.cv_results_["params"]
    live = list(range(len(cands)))
    for rung in report["rungs"]:
        b = rung["budget_trees"]
        mean = {c: float(np.float32(unbatched(cands[c], min(chunk * math.ceil(b / chunk),
                                                             cands[c]["n_estimators"]))).mean())
                for c in live}
        order = sorted(live, key=lambda c: (-mean[c], c))
        n_keep = len(live) - rung["pruned"] if rung["pruned"] else 1
        if len(order) > n_keep:
            assert mean[order[n_keep - 1]] - mean[order[n_keep]] > MARGIN, (b, mean)
        live = order[:n_keep]
    assert live == report["survivors"]
    for c, cand in enumerate(cands):
        at = report["scored_at_trees"][c]
        trees = min(chunk * math.ceil(at / chunk), cand["n_estimators"])
        np.testing.assert_allclose(
            hv.cv_results_["split_test_scores"][c], unbatched(cand, trees), rtol=0, atol=AUC_TOL,
            err_msg=f"candidate {c} at {trees} trees",
        )


def test_rung_overshoot_reports_the_budget(searches):
    """A rung reports its budget, capped at each candidate's
    ``n_estimators``, however many trees its whole chunks reached."""
    chunk, hv, _, _ = searches
    report = hv.cv_results_["halving"]
    budgets = {r["rung"]: r["budget_trees"] for r in report["rungs"]}
    cands = hv.cv_results_["params"]
    for c, at in enumerate(report["scored_at_trees"]):
        assert at in {min(b, cands[c]["n_estimators"]) for b in budgets.values()}
    if chunk == 10:
        assert min(report["scored_at_trees"]) == 12  # its margins hold 20 trees


def test_survivors_are_bitwise_the_exhaustive_scores(searches):
    _, hv, ex, _ = searches
    assert "halving" not in ex.cv_results_
    surv = hv.cv_results_["halving"]["survivors"]
    np.testing.assert_array_equal(
        hv.cv_results_["split_test_scores"][surv], ex.cv_results_["split_test_scores"][surv]
    )
    assert hv.best_params_ == ex.best_params_ and hv.best_score_ == ex.best_score_
    assert hv.best_score_ == max(hv.cv_results_["mean_test_score"][surv])
    pruned = [c for c in range(4) if c not in surv]
    assert not np.array_equal(
        hv.cv_results_["split_test_scores"][pruned], ex.cv_results_["split_test_scores"][pruned]
    )


@pytest.fixture(scope="module")
def cv_inputs(data):
    X, y = data
    Xt = torch.from_numpy(X)
    bins = transform(compute_bin_edges(Xt, n_bins=N_BINS), Xt)
    val = torch.from_numpy(tune.stratified_kfold_masks(y, 2, 5))
    return bins, torch.from_numpy(y), val


@pytest.mark.parametrize(
    "chunk,kw,n_iter",
    [(None, {}, 4), (48, {}, 4), (100, {}, 4), (12, {"halving_min_rungs": 4}, 4), (12, {}, 1)],
    ids=["unchunked", "chunk-as-long-as-the-fit", "chunk-longer", "too-few-rungs", "one-candidate"],
)
def test_engage_rules_match_jax(cv_inputs, chunk, kw, n_iter):
    bins, y, val = cv_inputs
    t = dataclasses.replace(_tune(chunk, **kw), n_iter=n_iter)
    cands = tune.sample_candidates(SPACE, n_iter, 5)
    base = GBDTConfig(n_bins=N_BINS)
    assert tune.successive_halving_search(bins, y, cands, base, t, val, 5) is None
    jt = JaxTuneConfig(n_iter=n_iter, cv_folds=2, seed=5, chunk_trees=chunk, param_space=SPACE, **kw)
    assert jax_tune.successive_halving_search(
        make_mesh(MeshConfig(hp=1)), jnp.asarray(bins.numpy()), jnp.asarray(y.numpy()), cands,
        JaxGBDTConfig(n_bins=N_BINS), jt, jnp.asarray(val.numpy()), jax.random.PRNGKey(5),
    ) is None


def test_quick_profile_is_the_reference_cli_quick():
    q = pipeline.quick_config()
    assert q.tune.chunk_trees == "auto" and q.tune.halving_enabled
    assert (q.tune.n_iter, q.tune.cv_folds, q.tune.halving_eta, q.tune.halving_min_rungs) == (4, 2, 2, 2)
    assert dict(q.tune.param_space) == {
        "n_estimators": (150, 300), "max_depth": (3,), "learning_rate": (0.05, 0.1),
        "subsample": (0.8,),
    }
    assert (q.rfe.n_select, q.rfe.step, q.rfe.n_estimators, q.rfe.max_depth) == (20, 20, 20, 3)
    assert pipeline.parse_args(["--quick", "--no-halving"]).no_halving
