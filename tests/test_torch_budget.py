"""The port's dispatch-budget cost model against the JAX package's, on the CPU.

- ``est_tree_seconds``, ``auto_chunk_trees``, ``resolve_chunk_trees`` and
  ``auto_steps_per_dispatch`` equal the reference's over a grid of shapes,
  with the reference's calibration file pointed at an empty temporary file
  (its module global ``_CALIBRATION_PATH``): the port has no calibration,
  which equals the reference on a machine without measured walls.
- The quick profile's search at 1.84M training rows (F=20, 255 bins, depth
  3, 4 jobs, sibling subtraction) resolves ``"auto"`` to 26, and its
  halving ladder is ``[75, 150, 300]``: the cost model alone, no fit.
- ``_pow2_jobs`` equals the reference's.
- ``GBDTConfig(chunk_trees="auto")`` fits the same forest as one chunk.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cobalt_smart_lender_ai_tpu.parallel import budget as jax_budget
from cobalt_smart_lender_ai_tpu.parallel import tune as jax_tune
from cobalt_smart_lender_ai_tpu_torch.config import GBDTConfig
from cobalt_smart_lender_ai_tpu_torch.models import gbdt
from cobalt_smart_lender_ai_tpu_torch.models.gbdt import GBDTClassifier
from cobalt_smart_lender_ai_tpu_torch.parallel import budget, tune
from cobalt_smart_lender_ai_tpu_torch.pipeline import quick_config

#: (n_rows, n_feats, n_bins, depth, n_jobs): the reference's calibration
#: points, the quick search, RFE's selector, and small shapes that never
#: chunk.
SHAPES = [
    (2_300_000, 100, 64, 3, 1),
    (2_300_000, 20, 255, 9, 33),
    (130_000, 20, 255, 9, 33),
    (40_000, 20, 255, 9, 33),
    (1_840_000, 20, 255, 3, 4),
    (1_840_000, 20, 255, 3, 8),
    (1_840_000, 104, 64, 3, 1),
    (1_840_000, 20, 255, 7, 1),
    (40_000, 20, 255, 3, 4),
    (3_000, 8, 32, 4, 6),
]


@pytest.fixture(autouse=True)
def _no_reference_calibration(tmp_path, monkeypatch):
    empty = tmp_path / "dispatch_walls.json"
    empty.write_text("")
    monkeypatch.setattr(jax_budget, "_CALIBRATION_PATH", str(empty))


def test_constants_match_jax():
    for name in ("DISPATCH_BUDGET_S", "A_LEVEL", "B_NODE", "C_FIX", "AUTO"):
        assert getattr(budget, name) == getattr(jax_budget, name), name


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("subtract", [False, True], ids=["direct", "subtract"])
def test_cost_model_matches_jax(shape, subtract):
    n_rows, n_feats, n_bins, depth, n_jobs = shape
    args = (n_rows, n_feats, n_bins, depth, n_jobs)
    assert budget.est_tree_seconds(*args, hist_subtract=subtract) == jax_budget.est_tree_seconds(
        *args, hist_subtract=subtract
    )
    assert jax_budget.calibration_factor(*args) == 1.0
    kw = dict(n_rows=n_rows, n_feats=n_feats, n_bins=n_bins, depth=depth, n_jobs=n_jobs,
              hist_subtract=subtract)
    for n_trees in (20, 50, 150, 300):
        assert budget.auto_chunk_trees(n_trees, **kw) == jax_budget.auto_chunk_trees(n_trees, **kw)
        for chunk in ("auto", None, 12):
            assert budget.resolve_chunk_trees(chunk, n_trees=n_trees, **kw) == (
                jax_budget.resolve_chunk_trees(chunk, n_trees=n_trees, **kw)
            )


def test_resolve_rejects_other_strings():
    with pytest.raises(ValueError, match="auto"):
        budget.resolve_chunk_trees("fast", n_trees=10, n_rows=10, n_feats=2, n_bins=4, depth=2)


@pytest.mark.parametrize("n_steps", [0, 1, 4, 84])
@pytest.mark.parametrize("fit_seconds", [0.01, 3.0, 40.0])
def test_steps_per_dispatch_match_jax(n_steps, fit_seconds):
    assert budget.auto_steps_per_dispatch(n_steps, fit_seconds=fit_seconds) == (
        jax_budget.auto_steps_per_dispatch(n_steps, fit_seconds=fit_seconds)
    )


@pytest.mark.parametrize("n_jobs,hp_size", [(1, 1), (3, 1), (4, 1), (6, 1), (8, 1), (5, 2), (1, 4)])
def test_pow2_jobs_match_jax(n_jobs, hp_size):
    assert tune._pow2_jobs(n_jobs, hp_size) == jax_tune._pow2_jobs(n_jobs, hp_size)


def test_quick_search_at_full_scale_resolves_to_26_and_three_rungs():
    """The cost model and the ladder of the quick profile's search on the
    ~1.84M training rows of the 2.3M-loan table: two buckets of depth 3
    with two candidates each, K = 2 folds."""
    tq = quick_config().tune
    assert tq.chunk_trees == "auto" and tq.halving_enabled
    jobs = tune._pow2_jobs(2 * tq.cv_folds, 1)
    chunk = budget.resolve_chunk_trees(
        tq.chunk_trees, n_trees=300, n_rows=1_840_000, n_feats=20, n_bins=255, depth=3,
        n_jobs=jobs, hist_subtract=True,
    )
    assert chunk == 26 == jax_budget.resolve_chunk_trees(
        "auto", n_trees=300, n_rows=1_840_000, n_feats=20, n_bins=255, depth=3, n_jobs=4,
        hist_subtract=True,
    )
    assert tune.halving_ladder(300, tq.n_iter, eta=tq.halving_eta, min_rungs=tq.halving_min_rungs) == (
        [75, 150, 300]
    )
    # At 40k rows the whole fit fits one budget: no chunk, so no halving.
    assert budget.resolve_chunk_trees(
        "auto", n_trees=300, n_rows=40_000, n_feats=20, n_bins=255, depth=3, n_jobs=4,
        hist_subtract=True,
    ) is None


def test_auto_chunked_fit_equals_one_chunk(monkeypatch):
    """``"auto"`` resolves through the cost model inside the fit; under a
    budget this small every tree is a chunk of its own, and the forest is
    the one-chunk fit's bit for bit."""
    rng = np.random.default_rng(1)
    X = rng.normal(size=(600, 5)).astype(np.float32)
    y = (X[:, 0] + rng.normal(size=600) > 0).astype(np.float32)
    cfg = GBDTConfig(n_estimators=9, max_depth=3, n_bins=16)
    one = GBDTClassifier(cfg, device="cpu").fit(X, y)
    chunks = []

    def tiny_budget(*args, **kw):
        chunks.append(budget.resolve_chunk_trees(*args, budget_s=1e-9, **kw))
        return chunks[-1]

    monkeypatch.setattr(gbdt, "resolve_chunk_trees", tiny_budget)
    auto = GBDTClassifier(cfg.replace(chunk_trees="auto"), device="cpu").fit(X, y)
    assert chunks == [1]
    for f in ("feature", "thr_bin", "thr_float", "missing_left", "leaf_value", "gain", "cover"):
        assert torch.equal(getattr(one.forest, f), getattr(auto.forest, f)), f
