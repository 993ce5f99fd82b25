"""Wall seconds of GBDT fits on the card: the user's `GBDTClassifier.fit`
at the committed model's configuration (300 trees of depth 7, 255 bins,
binning included) on 20 features; one RFE selector refit (`fit_binned` at
`RFEConfig`'s 50 trees of depth 6, 64 bins) on 104 features; and one CV
bucket (`cross_validate_gbdt`: 3 candidates of 20 trees of depth 5 that
differ in learning rate, row and column sample, × 3 folds, chunks of 5
trees) on the first 400,000 of the 20-feature rows. The rows are seeded,
with ~10% missing cells in every fifth column.

Each runs ``--reps`` times after one warm-up run that builds the kernel;
each time ends synchronised with the card. Besides the seconds it prints
the histogram launches per run and an md5 of each forest's leaf values and
split features (of the CV scores for the bucket), so two checkouts timed
one after the other can be held to the same bits. It calls only entry
points older than the search's job axis, so one copy of this file times a
checkout from before it too (run it with that checkout's package on the
path).

Usage:
    python -m cobalt_smart_lender_ai_tpu_torch.tools.fit_timing
        [--rows 1840000] [--reps 3] [--out fit_timing.json]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time
from typing import Sequence

import numpy as np

__all__ = ["main"]

#: The committed model's configuration (its artifact header's ``config``).
CLASSIFIER_CONFIG = dict(
    n_estimators=300,
    max_depth=7,
    learning_rate=0.05,
    n_bins=255,
    subsample=0.8,
    colsample_bytree=0.8,
    scale_pos_weight=3.767127752304077,
    seed=42,
)
#: Feature counts: the serving contract's, and the engineered table's that
#: the RFE selector starts from.
CLASSIFIER_FEATURES, RFE_FEATURES = 20, 104


def _rows(n: int, f: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """``n`` seeded rows of ``f`` features, ~10% of cells NaN in every
    fifth column, and a 0/1 label from a logistic function of a few."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f), dtype=np.float32)
    logit = X[:, 0] - 0.8 * X[:, 1] + 0.5 * X[:, 2] * X[:, 3] + 0.4 * X[:, f - 1] - 1.3
    y = (rng.random(n, dtype=np.float32) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    for c in range(0, f, 5):
        X[rng.random(n) < 0.1, c] = np.nan
    return X, y


def _digest(result) -> str:
    """md5 of a forest's leaf values and split features, or of an array."""
    h = hashlib.md5()
    if isinstance(result, np.ndarray):
        h.update(result.tobytes())
    else:
        for t in (result.leaf_value, result.feature):
            h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def main(argv: Sequence[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=1_840_000)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None, help="also write the result as JSON here")
    args = ap.parse_args(argv)

    import torch

    from cobalt_smart_lender_ai_tpu_torch.config import GBDTConfig, RFEConfig
    from cobalt_smart_lender_ai_tpu_torch.models import gbdt
    from cobalt_smart_lender_ai_tpu_torch.ops.binning import compute_bin_edges, transform
    from cobalt_smart_lender_ai_tpu_torch.ops.histogram import gradient_histogram_channels
    from cobalt_smart_lender_ai_tpu_torch.parallel.rfe import SELECTOR_BINS
    from cobalt_smart_lender_ai_tpu_torch.parallel.tune import (
        cross_validate_gbdt,
        stratified_kfold_masks,
    )

    if not torch.cuda.is_available():
        raise RuntimeError("fit_timing times fits on a cuda card; torch.cuda.is_available() is false")
    dev = torch.device("cuda")

    def timed(fit) -> dict:
        fit()  # warm-up: the kernel's build and first launches
        seconds, digests = [], set()
        for _ in range(args.reps):
            torch.cuda.synchronize()
            before = gradient_histogram_channels.launches
            t0 = time.perf_counter()
            result = fit()
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            launches = gradient_histogram_channels.launches - before
            digests.add(_digest(result))
        if len(digests) != 1:
            raise AssertionError(f"{args.reps} runs on the same inputs gave {len(digests)} results")
        return {"seconds": seconds, "launches": launches, "md5": digests.pop()}

    out = {"device": torch.cuda.get_device_name(0), "rows": args.rows, "reps": args.reps}

    X, y = _rows(args.rows, CLASSIFIER_FEATURES, 7)
    Xt, yt = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    cfg = GBDTConfig(**CLASSIFIER_CONFIG)
    out["classifier_fit"] = timed(lambda: gbdt.GBDTClassifier(cfg, device="cuda").fit(Xt, yt).forest)

    n_cv = min(args.rows, 400_000)
    cv_bins = transform(compute_bin_edges(Xt[:n_cv], n_bins=cfg.n_bins), Xt[:n_cv])
    val = torch.from_numpy(stratified_kfold_masks(y[:n_cv], 3, 22)).to(dev)
    hps = [
        gbdt.GBDTHyperparams.from_config(cfg.replace(
            n_estimators=20, max_depth=5, learning_rate=lr, subsample=ss, colsample_bytree=cs))
        for lr, ss, cs in ((0.1, 0.8, 0.8), (0.3, 1.0, 0.6), (0.05, 0.7, 1.0))
    ]
    out["cv_bucket"] = timed(lambda: cross_validate_gbdt(
        cv_bins, yt[:n_cv], hps, val, 22, n_bins=cfg.n_bins, chunk_trees=5))
    del Xt, yt, cv_bins

    X, y = _rows(args.rows, RFE_FEATURES, 8)
    Xt, yt = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    del X
    bins = transform(compute_bin_edges(Xt, n_bins=SELECTOR_BINS), Xt)
    del Xt
    rfe = RFEConfig()
    hp = gbdt.GBDTHyperparams.from_config(GBDTConfig(
        n_estimators=rfe.n_estimators, max_depth=rfe.max_depth, n_bins=SELECTOR_BINS,
        scale_pos_weight=rfe.scale_pos_weight))
    sw = torch.ones(args.rows, dtype=torch.float32, device=dev)
    fm = torch.ones(RFE_FEATURES, dtype=torch.bool, device=dev)
    out["rfe_refit"] = timed(lambda: gbdt.fit_binned(
        bins, yt, sw, fm, hp, gbdt.fold_in(rfe.seed, 0), n_trees_cap=rfe.n_estimators,
        depth_cap=rfe.max_depth, n_bins=SELECTOR_BINS))

    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh)
    return out


if __name__ == "__main__":
    main()
