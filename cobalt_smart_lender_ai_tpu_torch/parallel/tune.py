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

A job boosts in chunks of ``chunk_trees`` rounds, carrying its margin
(``fit_binned_resumable(init_margin=, tree_offset=)``, the same bits as one
chunk). On a chunked schedule the search runs the reference's successive
halving (`successive_halving_search`): at each rung of `halving_ladder`
every live candidate is scored on its carried margins and the bottom
``1 - 1/eta`` are pruned, so only the survivors boost to their full
``n_estimators``. A rung advances its jobs in whole chunks: with chunk 26
and a budget of 75 trees the margins it scores hold 78 trees, as the
reference's do. A job's last chunk stops at its ``n_estimators`` (the
reference runs the overflow trees inert).
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
from cobalt_smart_lender_ai_tpu_torch.parallel.budget import resolve_chunk_trees

__all__ = [
    "SearchResult",
    "cross_validate_gbdt",
    "halving_ladder",
    "randomized_search",
    "sample_candidates",
    "search_buckets",
    "stratified_kfold_masks",
    "successive_halving_search",
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


class _Jobs:
    """The (candidate, fold) jobs of one group of candidates, each with its
    carried margin over all rows and the trees it has boosted."""

    def __init__(self, bins, y, hps, cand_ids, val, fm, seed, *, n_bins, hist_subtract):
        self.bins, self.y, self.val, self.fm = bins, y, val, fm
        self.n_bins, self.hist_subtract = n_bins, hist_subtract
        K = val.shape[0]
        self.jobs = [
            {"cand": int(cid), "fold": k, "hp": hp, "seed": fold_in(seed, int(cid) * K + k),
             "margin": torch.zeros(bins.shape[0], dtype=torch.float32, device=bins.device),
             "trees": 0}
            for cid, hp in zip(cand_ids, hps)
            for k in range(K)
        ]

    def boost(self, upto: int) -> None:
        """Boost every job to ``min(upto, its n_estimators)`` trees."""
        for job in self.jobs:
            hp = job["hp"]
            n = min(upto, hp.n_estimators) - job["trees"]
            if n <= 0:
                continue
            _, job["margin"] = fit_binned_resumable(
                self.bins, self.y, 1.0 - self.val[job["fold"]], self.fm, hp, job["seed"],
                n_trees_cap=n, depth_cap=hp.max_depth, n_bins=self.n_bins,
                init_margin=job["margin"], tree_offset=job["trees"],
                hist_subtract=self.hist_subtract,
            )
            job["trees"] += n

    def scores(self) -> dict[int, np.ndarray]:
        """Each candidate's validation AUC per fold, from the carried margins."""
        out: dict[int, list[float]] = {}
        for job in self.jobs:
            auc = roc_auc(self.y, job["margin"], weight=self.val[job["fold"]])
            out.setdefault(job["cand"], []).append(float(auc))
        return {c: np.asarray(v) for c, v in out.items()}

    def keep(self, cands: set[int]) -> None:
        """Drop the jobs (and margins) of every other candidate."""
        self.jobs = [j for j in self.jobs if j["cand"] in cands]


def _row_tensors(bins, y, val_masks, feature_mask):
    dev = bins.device
    y = y.to(device=dev, dtype=torch.float32)
    fm = (
        torch.ones(bins.shape[1], dtype=torch.bool, device=dev)
        if feature_mask is None
        else torch.as_tensor(feature_mask).to(device=dev, dtype=torch.bool)
    )
    return y, val_masks.to(device=dev, dtype=torch.float32), fm


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
    chunk_trees: int | str | None = None,
    feature_mask: torch.Tensor | None = None,
) -> np.ndarray:
    """Validation ROC-AUC of every (candidate, fold) job, shape ``(C, K)``,
    on ``bins``' device.

    Job (c, k) fits ``hps[c]`` on all rows with training weight ``1 -
    val_masks[k]`` over the features of ``feature_mask`` (default all) and
    scores its margin over all rows with weight ``val_masks[k]``.
    ``cand_ids`` are the candidates' global indices (default ``0 ..
    C-1``); job (c, k)'s random stream is ``fold_in(seed, cand_ids[c] * K +
    k)``. ``chunk_trees`` (None, an int or ``"auto"``, resolved against the
    group's shape as the reference does) boosts in chunks, carrying each
    job's margin; the scores are the same bits."""
    K, N = val_masks.shape
    ids = list(range(len(hps))) if cand_ids is None else [int(i) for i in cand_ids]
    y, val, fm = _row_tensors(bins, y, val_masks, feature_mask)
    n_trees = max(hp.n_estimators for hp in hps)
    chunk = resolve_chunk_trees(
        chunk_trees, n_trees=n_trees, n_rows=N, n_feats=bins.shape[1], n_bins=n_bins,
        depth=max(hp.max_depth for hp in hps), n_jobs=len(hps) * K, hist_subtract=hist_subtract,
    )
    jobs = _Jobs(bins, y, hps, ids, val, fm, seed, n_bins=n_bins, hist_subtract=hist_subtract)
    step = chunk or n_trees
    for upto in range(step, n_trees + step, step):
        jobs.boost(upto)
    scores = jobs.scores()
    return np.stack([scores[i] for i in ids]).astype(np.float32)


def _pow2_jobs(n_jobs: int, hp_size: int) -> int:
    """The next power of two at or above ``n_jobs``, floored at (and padded
    to a multiple of) ``hp_size``: the reference's job-axis padding, which
    the halving search's ``"auto"`` chunk is resolved against."""
    p = 1
    while p < max(n_jobs, 1):
        p <<= 1
    p = max(p, hp_size)
    return p + (-p) % hp_size


def _ilog(n: int, eta: int) -> int:
    """floor(log_eta(n)) without float-precision edge cases."""
    r, v = 0, 1
    while v * eta <= n:
        v *= eta
        r += 1
    return r


def halving_ladder(
    n_trees_cap: int, n_candidates: int, *, eta: int, min_rungs: int
) -> list[int] | None:
    """Geometric rung budgets (ascending tree counts, the last ==
    ``n_trees_cap``) of a successive-halving run, or None when it is too
    small to halve: fewer than ``min_rungs`` (at least 2) rungs, bounded
    both by the tree budget and by ``floor(log_eta(n_candidates)) + 1``."""
    eta = max(2, int(eta))
    if n_candidates < 2 or n_trees_cap < 2:
        return None
    n_rungs = min(_ilog(n_candidates, eta) + 1, _ilog(n_trees_cap, eta) + 1)
    if n_rungs < max(2, int(min_rungs)):
        return None
    budgets: list[int] = []
    for j in range(n_rungs):
        b = -(-n_trees_cap // eta ** (n_rungs - 1 - j))
        if not budgets or b > budgets[-1]:
            budgets.append(int(b))
    if len(budgets) < max(2, int(min_rungs)):
        return None
    return budgets


def successive_halving_search(
    bins: torch.Tensor,
    y: torch.Tensor,
    candidates: Sequence[Mapping[str, Any]],
    base: GBDTConfig,
    tune: TuneConfig,
    val_masks: torch.Tensor,
    seed: int,
    *,
    feature_mask: torch.Tensor | None = None,
) -> tuple[np.ndarray, dict[str, Any]] | None:
    """Successive-halving CV over the chunked schedule: the reference's
    ``successive_halving_search``, its jobs run one after another.

    Candidates are grouped by ``(max_depth, n_estimators)``; each depth
    gets one chunk, ``tune.chunk_trees`` resolved against the depth's
    largest group (``_pow2_jobs(len(group) * K, 1)`` jobs) and capped at
    its largest ``n_estimators``. At each rung budget every group boosts
    its live jobs in whole chunks to ``min(budget, group cap)`` trees, and
    every live candidate is scored on its margins; then the top
    ``ceil(n_live / eta)`` by ``(-mean AUC, cand_id)`` live on (all folds
    of a candidate together) and the rest are pruned, their jobs dropped.
    A survivor's final margins, and so its scores, are the exhaustive
    run's bit for bit.

    Returns ``(split_scores (C, K), report)`` (pruned candidates keep the
    scores of their last rung), or None where the reference's does: when
    no depth chunks, or `halving_ladder` gives no ladder. The report has
    the reference's keys (``eta``, ``budgets``, ``rungs``,
    ``pruned_candidates``, ``survivors``, ``scored_at_trees``,
    ``dispatches``: chunk advances of a group) and ``chunk_trees``, the
    chunk of each depth."""
    C = len(candidates)
    cfgs = [base.replace(**dict(c)) for c in candidates]
    eta = max(2, int(tune.halving_eta))
    budgets = halving_ladder(
        max(c.n_estimators for c in cfgs), C, eta=eta, min_rungs=tune.halving_min_rungs
    )
    if budgets is None:
        return None
    K, N = val_masks.shape
    groups = search_buckets(candidates, base)
    by_depth: dict[int, list[list[int]]] = {}
    for idxs in groups:
        by_depth.setdefault(cfgs[idxs[0]].max_depth, []).append(idxs)
    chunk_of: dict[int, int] = {}
    for d, subs in by_depth.items():
        cap_d = max(cfgs[i].n_estimators for idxs in subs for i in idxs)
        jobs_d = max(_pow2_jobs(len(idxs) * K, 1) for idxs in subs)
        ck = resolve_chunk_trees(
            tune.chunk_trees, n_trees=cap_d, n_rows=N, n_feats=bins.shape[1],
            n_bins=base.n_bins, depth=d, n_jobs=jobs_d, hist_subtract=base.hist_subtract,
        )
        chunk_of[d] = cap_d if ck is None else min(int(ck), cap_d)
    if all(chunk_of[d] >= max(cfgs[i].n_estimators for s in subs for i in s)
           for d, subs in by_depth.items()):
        return None

    y, val, fm = _row_tensors(bins, y, val_masks, feature_mask)
    live_groups = [
        {"chunk": chunk_of[d], "done": 0,
         "jobs": _Jobs(bins, y, [GBDTHyperparams.from_config(cfgs[i]) for i in idxs], idxs,
                       val, fm, seed, n_bins=base.n_bins, hist_subtract=base.hist_subtract)}
        for d, subs in sorted(by_depth.items())
        for idxs in subs
    ]
    logger.info("halving search: %d candidates x %d folds, rung budgets %s (eta=%d), chunks %s",
                C, K, budgets, eta, chunk_of)
    split_scores = np.zeros((C, K))
    scored_at = np.zeros(C, dtype=np.int64)
    rungs: list[dict[str, Any]] = []
    pruned_total = dispatches = 0
    for ri, budget in enumerate(budgets):
        cand_mean: dict[int, float] = {}
        for g in live_groups:
            cap = max(j["hp"].n_estimators for j in g["jobs"].jobs)
            target = min(budget, cap)
            steps = max(0, -(-(target - g["done"]) // g["chunk"]))
            g["done"] += steps * g["chunk"]
            dispatches += steps
            g["jobs"].boost(g["done"])
            for cid, sc in g["jobs"].scores().items():
                split_scores[cid] = sc
                scored_at[cid] = min(budget, cfgs[cid].n_estimators)
                cand_mean[cid] = float(sc.mean())
        n_live = len(cand_mean)
        if ri == len(budgets) - 1:
            rungs.append({"rung": ri, "budget_trees": budget, "live": n_live, "pruned": 0})
            break
        n_keep = max(1, -(-n_live // eta))
        keep = set(sorted(cand_mean, key=lambda cid: (-cand_mean[cid], cid))[:n_keep])
        pruned_total += n_live - n_keep
        rungs.append({"rung": ri, "budget_trees": budget, "live": n_live, "pruned": n_live - n_keep})
        logger.info("halving rung %d/%d @ %d trees: %d live -> %d kept",
                    ri + 1, len(budgets), budget, n_live, n_keep)
        for g in live_groups:
            g["jobs"].keep(keep)
        live_groups = [g for g in live_groups if g["jobs"].jobs]

    report = {
        "eta": eta,
        "budgets": budgets,
        "rungs": rungs,
        "pruned_candidates": pruned_total,
        "survivors": sorted(j["cand"] for g in live_groups for j in g["jobs"].jobs if j["fold"] == 0),
        "scored_at_trees": scored_at.tolist(),
        "dispatches": dispatches,
        "chunk_trees": chunk_of,
    }
    return split_scores, report


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
    block. On a chunked schedule with ``tune.halving_enabled`` the
    successive-halving search runs and the winner is the best survivor
    (``cv_results_["halving"]`` holds its report); otherwise every candidate
    runs to its full ``n_estimators`` on every fold."""
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

    halving = None
    if tune.halving_enabled:
        halving = successive_halving_search(bins, y, candidates, base, tune, val_masks, tune.seed)
    if halving is not None:
        split_scores, report = halving
        mean_auc = split_scores.mean(axis=1)
        # The winner is a survivor: pruned candidates' scores are partial.
        best_i = min(report["survivors"], key=lambda i: (-mean_auc[i], i))
    else:
        split_scores = np.zeros((len(candidates), tune.cv_folds))
        for idxs in search_buckets(candidates, base):
            hps = [GBDTHyperparams.from_config(base.replace(**candidates[i])) for i in idxs]
            split_scores[idxs] = cross_validate_gbdt(
                bins, y, hps, val_masks, tune.seed, n_bins=base.n_bins, cand_ids=idxs,
                hist_subtract=base.hist_subtract, chunk_trees=tune.chunk_trees,
            )
            logger.info("cv bucket %s: mean AUC %s", idxs, split_scores[idxs].mean(axis=1))
        mean_auc = split_scores.mean(axis=1)
        best_i = int(mean_auc.argmax())
    del bins
    best_params = dict(candidates[best_i])

    est = GBDTClassifier(base.replace(**best_params), device=dev)
    est.fit(X, y)
    cv_results = {
        "params": candidates,
        "mean_test_score": mean_auc,
        "split_test_scores": split_scores,
        "val_masks": val_np,
    }
    if halving is not None:
        cv_results["halving"] = report
    return SearchResult(
        best_params_=best_params,
        best_score_=float(mean_auc[best_i]),
        best_estimator_=est,
        cv_results_=cv_results,
    )
