"""Train the servable model artifact (the port's copy of the reference's
``tools/train_artifact.py``).

The reference ships its trained model in the repo so that
``docker-compose up`` serves at once; this tool makes that model: a
`GBDTArtifact` ``.npz`` and its ``.features.json`` sidecar at the default
serving location (``artifacts/models/gbdt/model_tree``), trained on the 20
serving features with the protocol's tuned hyperparameters (300 trees of
depth 7, learning rate 0.05, row and column samples 0.8, 255 bins, the
labels' ``scale_pos_weight``). On the card the fit runs through the
``gradient_histogram`` kernel, one launch per tree level.

Usage:
    python -m cobalt_smart_lender_ai_tpu_torch.tools.train_artifact \\
        [--rows 130000] [--seed 11] [--out artifacts] \\
        [--key models/gbdt/model_tree] [--device cuda|cpu]

``--device`` defaults to ``cuda`` and fails without a card; ``--device cpu``
runs the plain versions of the kernels. The training frame is the
full-schema synthetic generator, through the host cleaning path
(`clean_raw_frame`, `prepare_cleaned_frame`, `engineer_features` on
``--device``), the leakage drop and the hashed split; the artifact records
its provenance (rows, seed, held-out AUC, wall seconds) in its metrics.
``earliest_cr_line_days`` counts days before the day of the run (a caller of
`train_artifact` may pin it with ``today=``), so that column's bin edges
move with the date of the run.
The default ``--out`` is the committed model: write elsewhere unless the
committed model is what you mean to replace.
"""

from __future__ import annotations

import argparse
import json
import time
from datetime import datetime
from typing import Sequence

__all__ = ["ARTIFACT_CONFIG_KEYS", "main", "parse_args", "prepare_training_rows", "train_artifact"]

#: The fit's config keys the artifact's header records (the reference's).
ARTIFACT_CONFIG_KEYS = (
    "n_estimators", "max_depth", "learning_rate", "subsample",
    "colsample_bytree", "n_bins", "scale_pos_weight", "seed",
)


def prepare_training_rows(rows: int, seed: int, device, today: datetime | None = None) -> tuple:
    """``(X_train, X_test, y_train, y_test)`` on ``device``: the synthetic
    table through the host cleaning path, the leakage drop, the 20 serving
    features and the hashed split."""
    from cobalt_smart_lender_ai_tpu_torch.data import (
        clean_raw_frame,
        engineer_features,
        prepare_cleaned_frame,
        schema,
        synthetic_lendingclub_frame,
        train_test_split_hashed,
    )
    from cobalt_smart_lender_ai_tpu_torch.data.features import drop_training_leakage

    raw = synthetic_lendingclub_frame(n_rows=rows, seed=seed)
    cleaned, _ = clean_raw_frame(raw)
    tree_ff, _, _ = engineer_features(prepare_cleaned_frame(cleaned, today=today), device=device)
    ff = drop_training_leakage(tree_ff).select(schema.SERVING_FEATURES)
    return train_test_split_hashed(ff.X, ff.y)


def train_artifact(
    rows: int = 130_000,
    seed: int = 11,
    *,
    device="cuda",
    today: datetime | None = None,
) -> dict:
    """Prepare, fit and evaluate; returns ``{"artifact", "test_auc",
    "wall_s", "prep_s", "fit_s"}`` (the artifact not yet saved)."""
    from cobalt_smart_lender_ai_tpu_torch.config import GBDTConfig
    from cobalt_smart_lender_ai_tpu_torch.data import schema
    from cobalt_smart_lender_ai_tpu_torch.device import resolve_device
    from cobalt_smart_lender_ai_tpu_torch.io import GBDTArtifact
    from cobalt_smart_lender_ai_tpu_torch.models.gbdt import GBDTClassifier
    from cobalt_smart_lender_ai_tpu_torch.ops.metrics import roc_auc

    dev = resolve_device(device)
    t0 = time.time()
    X_train, X_test, y_train, y_test = prepare_training_rows(rows, seed, dev, today)
    y_np = y_train.cpu().numpy()
    spw = (len(y_np) - y_np.sum()) / max(y_np.sum(), 1.0)
    prep_s = time.time() - t0

    # The protocol's tuned regime: deep-ish trees, low learning rate, the
    # full reference bin budget, class-weighted.
    cfg = GBDTConfig(
        n_estimators=300,
        max_depth=7,
        learning_rate=0.05,
        subsample=0.8,
        colsample_bytree=0.8,
        n_bins=255,
        scale_pos_weight=float(spw),
        chunk_trees="auto",
    )
    t_fit = time.time()
    model = GBDTClassifier(cfg, device=dev).fit(X_train, y_np)
    margin = model.predict_margin(X_test)
    test_auc = float(roc_auc(y_test, margin))
    fit_s = time.time() - t_fit
    wall = time.time() - t0
    artifact = GBDTArtifact(
        forest=model.forest,
        feature_names=tuple(schema.SERVING_FEATURES),
        bin_edges=model.bin_spec.edges.cpu().numpy(),
        config={k: getattr(cfg, k) for k in ARTIFACT_CONFIG_KEYS},
        metrics={
            "test_auc": round(test_auc, 4),
            "train_rows": int(X_train.shape[0]),
            "data": f"synthetic_lendingclub_frame(rows={rows}, seed={seed})",
            "trained_wall_s": round(wall, 1),
        },
    )
    return {"artifact": artifact, "test_auc": test_auc, "wall_s": wall,
            "prep_s": prep_s, "fit_s": fit_s}


def parse_args(argv: Sequence[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=130_000)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--out", default="artifacts")
    ap.add_argument("--key", default="models/gbdt/model_tree")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; the CUDA kernels) or cpu (their plain versions)")
    return ap.parse_args(argv)


def main(argv: Sequence[str] | None = None) -> dict:
    args = parse_args(argv)
    from cobalt_smart_lender_ai_tpu_torch.compilecache import bootstrap_compile_cache
    from cobalt_smart_lender_ai_tpu_torch.io import ObjectStore

    bootstrap_compile_cache()
    run = train_artifact(args.rows, args.seed, device=args.device)
    run["artifact"].save(ObjectStore(args.out), args.key)
    line = {
        "artifact": f"{args.out}/{args.key}",
        "test_auc": round(run["test_auc"], 4),
        "wall_s": round(run["wall_s"], 1),
    }
    print(json.dumps(line))
    run["line"] = line
    return run


if __name__ == "__main__":
    main()
