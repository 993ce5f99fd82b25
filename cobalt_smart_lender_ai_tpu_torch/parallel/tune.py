"""The randomized hyperparameter search with stratified k-fold CV.

The stand-in for the reference trainer's ``RandomizedSearchCV(n_iter=20,
cv=StratifiedKFold(3))``, as the reference package computes it: candidates
are drawn from the literal grid, every (candidate, fold) job is one fit over
all training rows with the fold's rows at training weight 0, and the fit's
own margin over all rows is the fold's prediction, scored by weighted
ROC-AUC. The candidate with the best mean AUC is refit on all rows.

Jobs run one after another on one device, each through the fit's level loop
(the histogram kernel on the card); rows of weight 0 are inactive in every
histogram launch. Each job's random stream is keyed on ``(seed, cand_id * K
+ fold)``, so a score does not depend on which jobs ran before it or on how
candidates are grouped.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from cobalt_smart_lender_ai_tpu_torch.config import GBDTConfig, TuneConfig
from cobalt_smart_lender_ai_tpu_torch.data.split import stratified_fold_ids
from cobalt_smart_lender_ai_tpu_torch.device import resolve_device
from cobalt_smart_lender_ai_tpu_torch.models.gbdt import (
    GBDTClassifier,
    GBDTHyperparams,
    fit_binned_resumable,
    fold_in,
)
from cobalt_smart_lender_ai_tpu_torch.ops.binning import compute_bin_edges, transform
from cobalt_smart_lender_ai_tpu_torch.ops.metrics import roc_auc

__all__ = [
    "SearchResult",
    "cross_validate_gbdt",
    "randomized_search",
    "sample_candidates",
    "search_buckets",
    "stratified_kfold_masks",
]

logger = logging.getLogger("cobalt_smart_lender_ai_tpu_torch.tune")


def sample_candidates(
    space: Mapping[str, Sequence[Any]], n_iter: int, seed: int
) -> list[dict[str, Any]]:
    """Uniform draws from a discrete grid, without replacement whenever the
    grid has at least ``n_iter`` combinations (as sklearn's
    ``ParameterSampler`` over a list grid): the reference's draws, bit for
    bit."""
    rng = np.random.default_rng(seed)
    keys = list(space.keys())
    sizes = [len(space[k]) for k in keys]
    total = math.prod(sizes) if sizes else 0
    if 0 < total < 2**63 and n_iter <= total:
        if n_iter > total // 2:
            # Most of the grid: one permutation (total is small here).
            flat = rng.permutation(total)[:n_iter]
        else:
            # A few of a large grid: rejection-sample distinct codes.
            seen: dict[int, None] = {}
            while len(seen) < n_iter:
                seen.setdefault(int(rng.integers(total)), None)
            flat = np.fromiter(seen, dtype=np.int64)
        out = []
        for code in flat:
            cand = {}
            for k, sz in zip(keys, sizes):
                cand[k] = space[k][int(code % sz)]
                code //= sz
            out.append(cand)
        return out
    return [{k: v[int(rng.integers(len(v)))] for k, v in space.items()} for _ in range(n_iter)]


def stratified_kfold_masks(y: np.ndarray, k: int, seed: int) -> np.ndarray:
    """(k, N) boolean validation masks, class-stratified: the reference's
    ``StratifiedKFold(n_splits=k, shuffle=True)`` stand-in."""
    fold = stratified_fold_ids(np.asarray(y), k, seed)
    return np.stack([fold == f for f in range(k)])


def search_buckets(
    candidates: Sequence[Mapping[str, Any]], base: GBDTConfig
) -> list[list[int]]:
    """Candidate indices grouped by resolved ``(max_depth, n_estimators)``,
    ascending: the order in which `randomized_search` scores them."""
    by_key: dict[tuple[int, int], list[int]] = {}
    for i, cand in enumerate(candidates):
        cfg = base.replace(**dict(cand))
        by_key.setdefault((cfg.max_depth, cfg.n_estimators), []).append(i)
    return [by_key[k] for k in sorted(by_key)]


@dataclasses.dataclass
class SearchResult:
    """The ``RandomizedSearchCV`` attributes the reference trainer reads.
    ``cv_results_`` holds ``params`` (the candidates), ``mean_test_score``
    (C,), ``split_test_scores`` (C, K) and ``val_masks`` (K, N), the folds."""

    best_params_: dict[str, Any]
    best_score_: float
    best_estimator_: GBDTClassifier
    cv_results_: dict[str, Any]


def cross_validate_gbdt(
    bins: torch.Tensor,  # (N, F) binned training rows
    y: torch.Tensor,  # (N,)
    hps: Sequence[GBDTHyperparams],
    val_masks: torch.Tensor,  # (K, N) bool
    seed: int,
    *,
    n_bins: int,
    cand_ids: Sequence[int] | None = None,
    hist_subtract: bool = True,
) -> np.ndarray:
    """Validation ROC-AUC of every (candidate, fold) job, shape ``(C, K)``,
    on ``bins``' device.

    Job (c, k) fits ``hps[c]`` on all rows with training weight ``1 -
    val_masks[k]`` and scores its margin over all rows with weight
    ``val_masks[k]``. ``cand_ids`` are the candidates' global indices
    (default ``0 .. C-1``); job (c, k)'s random stream is ``fold_in(seed,
    cand_ids[c] * K + k)``."""
    dev = bins.device
    K = val_masks.shape[0]
    y = y.to(device=dev, dtype=torch.float32)
    fm = torch.ones(bins.shape[1], dtype=torch.bool, device=dev)
    val = val_masks.to(device=dev, dtype=torch.float32)
    ids = list(range(len(hps))) if cand_ids is None else [int(i) for i in cand_ids]
    aucs = torch.zeros((len(hps), K), dtype=torch.float32, device=dev)
    for c, hp in enumerate(hps):
        for k in range(K):
            _, margin = fit_binned_resumable(
                bins, y, 1.0 - val[k], fm, hp, fold_in(seed, ids[c] * K + k),
                n_trees_cap=hp.n_estimators, depth_cap=hp.max_depth, n_bins=n_bins,
                hist_subtract=hist_subtract,
            )
            aucs[c, k] = roc_auc(y, margin, weight=val[k])
    return aucs.cpu().numpy()


def randomized_search(
    X,
    y,
    base: GBDTConfig | None = None,
    tune: TuneConfig | None = None,
    *,
    device: torch.device | str = "cuda",
) -> SearchResult:
    """Randomized search with stratified k-fold CV, then the refit of the
    best candidate on all rows, on ``device`` (``cuda`` unless the caller
    asks for ``cpu``): the reference trainer's ``RandomizedSearchCV(...).fit``
    block. Every candidate runs to its full ``n_estimators`` on every fold."""
    base = base or GBDTConfig()
    tune = tune or TuneConfig()
    dev = resolve_device(device)
    X = torch.as_tensor(X).to(device=dev, dtype=torch.float32)
    y = torch.as_tensor(y).to(device=dev, dtype=torch.float32)
    spec = compute_bin_edges(X, n_bins=base.n_bins)
    bins = transform(spec, X)

    candidates = sample_candidates(tune.param_space, tune.n_iter, tune.seed)
    val_np = stratified_kfold_masks(y.cpu().numpy(), tune.cv_folds, tune.seed)
    val_masks = torch.from_numpy(val_np).to(dev)

    split_scores = np.zeros((len(candidates), tune.cv_folds))
    for idxs in search_buckets(candidates, base):
        hps = [GBDTHyperparams.from_config(base.replace(**candidates[i])) for i in idxs]
        split_scores[idxs] = cross_validate_gbdt(
            bins, y, hps, val_masks, tune.seed,
            n_bins=base.n_bins, cand_ids=idxs, hist_subtract=base.hist_subtract,
        )
        logger.info("cv bucket %s: mean AUC %s", idxs, split_scores[idxs].mean(axis=1))
    del bins
    mean_auc = split_scores.mean(axis=1)
    best_i = int(mean_auc.argmax())
    best_params = dict(candidates[best_i])

    est = GBDTClassifier(base.replace(**best_params), device=dev)
    est.fit(X, y)
    return SearchResult(
        best_params_=best_params,
        best_score_=float(mean_auc[best_i]),
        best_estimator_=est,
        cv_results_={
            "params": candidates,
            "mean_test_score": mean_auc,
            "split_test_scores": split_scores,
            "val_masks": val_np,
        },
    )
