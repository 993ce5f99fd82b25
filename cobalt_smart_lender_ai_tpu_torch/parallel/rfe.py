"""Recursive feature elimination to exactly ``n_select`` features.

The reference trainer's ``RFE(XGBClassifier(...), n_features_to_select=20,
step=1)``, as the reference package computes it: a light selector GBDT is
refit on the surviving features, and the ``step`` surviving features of
least total gain are dropped, until ``n_select`` remain. Dropped features
are masked, never cut out of the binned matrix, so every refit reads the
same ``(N, F)`` bins (the histogram kernel sums the masked columns too; the
split search ignores them). The loop is stepped on the host: each refit's
gains come back to the host, which picks the drops.

With ``cv_folds`` it is the reference's RFECV: after the elimination, the
full feature set and the mask after each step are scored by k-fold
validation AUC (`parallel.tune.cross_validate_gbdt` with the selector's
hyperparameters), and the best-scoring feature count wins, ties going to
fewer features; ``ranking_`` is re-based on the winning mask.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from cobalt_smart_lender_ai_tpu_torch.config import GBDTConfig, RFEConfig
from cobalt_smart_lender_ai_tpu_torch.device import resolve_device
from cobalt_smart_lender_ai_tpu_torch.models.gbdt import (
    GBDTHyperparams,
    fit_binned,
    fit_binned_chunked,
    fold_in,
    gain_importances,
)
from cobalt_smart_lender_ai_tpu_torch.ops.binning import compute_bin_edges, transform
from cobalt_smart_lender_ai_tpu_torch.parallel.budget import resolve_chunk_trees
from cobalt_smart_lender_ai_tpu_torch.parallel.tune import (
    cross_validate_gbdt,
    stratified_kfold_masks,
)

__all__ = ["RFEResult", "SELECTOR_BINS", "rfe_select"]

logger = logging.getLogger("cobalt_smart_lender_ai_tpu_torch.rfe")

#: Bins of the selector's features; the final model bins at full resolution.
SELECTOR_BINS = 64


@dataclasses.dataclass
class RFEResult:
    support_: np.ndarray  # (F,) bool: the selected features
    #: (F,) int: 1 for selected; the features dropped at one iteration share
    #: a rank, the last iteration's 2 and the first's n_iterations + 1
    #: (sklearn RFE's convention for any ``step``).
    ranking_: np.ndarray
    n_features_: int
    #: Mean CV AUC per surviving feature count (RFECV only).
    cv_scores_: dict[int, float] | None = None


def rfe_select(
    X,
    y,
    config: RFEConfig | None = None,
    *,
    cv_folds: int | None = None,
    device: torch.device | str = "cuda",
) -> RFEResult:
    """Eliminate to exactly ``config.n_select`` features by refitting the
    selector GBDT and dropping the ``step`` surviving features of least
    total gain, on ``device`` (``cuda`` unless the caller asks for
    ``cpu``). Refit ``i`` draws from ``fold_in(config.seed, i)``. With
    ``cv_folds``, every surviving mask (the full set included) is scored by
    ``cv_folds``-fold validation AUC (folds ``stratified_kfold_masks(y,
    cv_folds, config.seed)``, seed ``config.seed + 1``) and the
    best-scoring count, at least ``n_select``, wins."""
    cfg = config or RFEConfig()
    dev = resolve_device(device)
    X = torch.as_tensor(X).to(device=dev, dtype=torch.float32)
    y = torch.as_tensor(y).to(device=dev, dtype=torch.float32)
    N, F = X.shape
    bins = transform(compute_bin_edges(X, n_bins=SELECTOR_BINS), X)
    hp = GBDTHyperparams.from_config(
        GBDTConfig(
            n_estimators=cfg.n_estimators,
            max_depth=cfg.max_depth,
            n_bins=SELECTOR_BINS,
            scale_pos_weight=cfg.scale_pos_weight,
        )
    )
    sw = torch.ones(N, dtype=torch.float32, device=dev)
    n_iters = max(0, -(-(F - cfg.n_select) // cfg.step))
    chunk = resolve_chunk_trees(
        cfg.chunk_trees, n_trees=cfg.n_estimators, n_rows=N, n_feats=F,
        n_bins=SELECTOR_BINS, depth=cfg.max_depth, hist_subtract=True,
    )
    kw = dict(n_trees_cap=cfg.n_estimators, depth_cap=cfg.max_depth, n_bins=SELECTOR_BINS)

    mask = np.ones(F, dtype=bool)
    ranking = np.ones(F, dtype=np.int64)
    next_rank = n_iters + 1  # the first iteration's drops get the worst rank
    history = []  # the mask after each step
    it = 0
    while mask.sum() > cfg.n_select:
        fm = torch.from_numpy(mask).to(dev)
        if chunk is not None:
            forest = fit_binned_chunked(
                bins, y, sw, fm, hp, fold_in(cfg.seed, it), chunk_trees=chunk, **kw
            )
        else:
            forest = fit_binned(bins, y, sw, fm, hp, fold_in(cfg.seed, it), **kw)
        # Summed on the host: index_add_ on the card adds in no fixed order,
        # and a last-bit difference could reorder two features.
        total_gain, _ = gain_importances(forest.to("cpu"), F)
        imp = total_gain.numpy().copy()
        imp[~mask] = np.inf  # dropped features cannot be dropped again
        k = int(min(cfg.step, mask.sum() - cfg.n_select))
        drop = np.argsort(imp, kind="stable")[:k]
        mask[drop] = False
        ranking[drop] = next_rank
        next_rank -= 1
        it += 1
        history.append(mask.copy())
        logger.info("RFE refit %d of %d: %d features left", it, n_iters, int(mask.sum()))

    cv_scores: dict[int, float] | None = None
    if cv_folds:
        val = torch.from_numpy(stratified_kfold_masks(y.cpu().numpy(), cv_folds, cfg.seed)).to(dev)
        cv_scores, cv_masks = {}, {}
        for fm_np in [np.ones(F, dtype=bool), *history]:
            n = int(fm_np.sum())
            if n in cv_scores:  # F == n_select: the full mask is the final one
                continue
            aucs = cross_validate_gbdt(
                bins, y, [hp], val, cfg.seed + 1, n_bins=SELECTOR_BINS, chunk_trees="auto",
                feature_mask=torch.from_numpy(fm_np).to(dev),
            )
            cv_scores[n] = float(aucs.mean())
            cv_masks[n] = fm_np
            logger.info("RFECV: %d features, mean CV AUC %.6f", n, cv_scores[n])
        # The best mean wins; ties go to fewer features.
        mask = cv_masks[min(cv_scores, key=lambda n: (-cv_scores[n], n))].copy()
        # Re-base the ranking on the winning mask: re-included features get
        # rank 1, the remaining eliminated ranks close up to 2, 3, ...
        elim = {int(r): i + 2 for i, r in enumerate(np.unique(ranking[~mask]))}
        ranking = np.where(mask, 1, [elim.get(int(r), 1) for r in ranking]).astype(np.int64)
    return RFEResult(
        support_=mask, ranking_=ranking, n_features_=int(mask.sum()), cv_scores_=cv_scores
    )
