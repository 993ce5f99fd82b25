"""The training protocol end to end, from raw loans to a published model:
the reference trainer's composition (clean, engineer, split, RFE, search,
fit, persist), as the reference package's device-ingest path runs it.

    raw table -> tokenize (host) -> ingest (device: clean, engineer, bin)
    -> leakage drop -> hashed split (seed 22) -> scale_pos_weight
    -> RFE to 20 features -> randomized search (20 x 3 CV) and refit
    -> held-out eval -> <key>.npz + <key>.features.json + <key>.metrics.json

Every fit runs through the histogram kernel on the card (``device="cpu"``
runs the plain versions). The artifact carries its `FeaturePlan`, so
`ScorerService.predict_raw` scores raw rows with it.

    python -m cobalt_smart_lender_ai_tpu_torch.pipeline --store artifacts \\
        --synthetic-rows 100000 [--seed S] [--quick] [--device cuda|cpu]

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP.md
item): reading the raw table from the store (``raw=None``), checkpoints and
``resume``, the pandas ingest path; the plots and telemetry spans are left
out.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import time
from datetime import datetime
from typing import Any, Sequence

import numpy as np
import torch

from cobalt_smart_lender_ai_tpu_torch.config import PipelineConfig, RFEConfig, TuneConfig
from cobalt_smart_lender_ai_tpu_torch.data.device_pipeline import (
    run_device_ingest,
    tokenize_raw_frame,
)
from cobalt_smart_lender_ai_tpu_torch.data.features import drop_training_leakage
from cobalt_smart_lender_ai_tpu_torch.data.split import train_test_split_hashed
from cobalt_smart_lender_ai_tpu_torch.device import resolve_device
from cobalt_smart_lender_ai_tpu_torch.io import GBDTArtifact, ObjectStore, save_metrics
from cobalt_smart_lender_ai_tpu_torch.ops.histogram import gradient_histogram_channels
from cobalt_smart_lender_ai_tpu_torch.ops.metrics import binary_classification_report, roc_auc
from cobalt_smart_lender_ai_tpu_torch.parallel.rfe import rfe_select
from cobalt_smart_lender_ai_tpu_torch.parallel.tune import SearchResult, randomized_search

__all__ = ["PipelineResult", "main", "quick_config", "run_pipeline"]

logger = logging.getLogger("cobalt_smart_lender_ai_tpu_torch.pipeline")


@dataclasses.dataclass
class PipelineResult:
    """What the reference trainer logs and persists."""

    selected_features: tuple[str, ...]
    best_params: dict[str, Any]
    cv_auc: float
    test_auc: float
    metrics: dict[str, Any]
    artifact: GBDTArtifact
    search: SearchResult
    scale_pos_weight: float
    #: Wall seconds per stage (``host_frontier``, ``device_ingest``, ``rfe``,
    #: ``search``, ``eval``), each ending with the device synchronised.
    timings: dict[str, float]
    #: Histogram kernel launches per stage (none on the CPU, where the plain
    #: version runs).
    hist_launches: dict[str, int]


def quick_config() -> PipelineConfig:
    """The reference CLI's ``--quick`` profile: RFE in steps of 20 with a
    20-tree depth-3 selector, and a 4 x 2 search. Rows and width are not
    cut."""
    return PipelineConfig(
        rfe=RFEConfig(n_select=20, step=20, n_estimators=20, max_depth=3),
        tune=TuneConfig(
            n_iter=4,
            cv_folds=2,
            param_space={
                "n_estimators": (150, 300),
                "max_depth": (3,),
                "learning_rate": (0.05, 0.1),
                "subsample": (0.8,),
            },
        ),
    )


def run_pipeline(
    config: PipelineConfig | None = None,
    raw=None,
    store: ObjectStore | None = None,
    resume: bool | None = None,
    *,
    device: torch.device | str = "cuda",
    today: datetime | None = None,
) -> PipelineResult:
    """Train and publish from the raw table ``raw`` (a `RawFrame`, or any
    frame `tokenize_raw_frame` reads) on ``device`` (``cuda`` unless the
    caller asks for ``cpu``). ``today`` is the snapshot date of the date ->
    age features (default: the day of the run); pinning it makes a retrain
    on the same table reproducible. With a ``store``, the artifact, its
    features and ``metrics.json`` are written under
    ``config.serve.model_key``."""
    cfg = config or PipelineConfig()
    dev = resolve_device(device)
    if raw is None:
        raise NotImplementedError(
            "loading the raw table from the store needs the CSV reader, which "
            "is not ported yet (ROADMAP.md, A3); pass raw="
        )
    if resume:
        raise NotImplementedError(
            "checkpoints and resume are not ported yet (ROADMAP.md, A4)"
        )
    timings: dict[str, float] = {}
    launches: dict[str, int] = {}
    counted = gradient_histogram_channels.launches

    def tick(name: str, t0: float) -> float:
        nonlocal counted
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t = time.perf_counter()
        timings[name] = t - t0
        launches[name] = gradient_histogram_channels.launches - counted
        counted = gradient_histogram_channels.launches
        logger.info("%s done in %.2fs", name, timings[name])
        return t

    t = time.perf_counter()
    tok = tokenize_raw_frame(raw, today=today)
    t = tick("host_frontier", t)
    ingest = run_device_ingest(tok, device=dev)
    del tok
    tree_ff, plan = ingest.tree, ingest.plan
    logger.info(
        "device ingest: %d rows, dropped %d null-heavy cols, %d dupes, %d tree features",
        ingest.report.n_rows_out,
        len(ingest.report.dropped_null_columns),
        ingest.report.n_duplicates_removed,
        tree_ff.n_features,
    )
    del ingest
    t = tick("device_ingest", t)

    ff = drop_training_leakage(tree_ff)
    del tree_ff
    X_train, X_test, y_train, y_test = train_test_split_hashed(
        ff.X, ff.y, test_fraction=cfg.data.test_fraction, seed=cfg.data.split_seed
    )
    n_pos = float(y_train.sum())
    spw = (float(X_train.shape[0]) - n_pos) / max(n_pos, 1.0)
    logger.info(
        "split: %d train / %d test, scale_pos_weight=%.3f",
        X_train.shape[0], X_test.shape[0], spw,
    )

    rfe = rfe_select(
        X_train, y_train, dataclasses.replace(cfg.rfe, scale_pos_weight=spw), device=dev
    )
    selected = tuple(n for n, keep in zip(ff.feature_names, rfe.support_) if keep)
    logger.info("RFE selected %d features: %s", len(selected), selected)
    t = tick("rfe", t)

    # The search and the final model see the selected columns only.
    sel_idx = torch.from_numpy(np.flatnonzero(rfe.support_)).to(dev)
    Xtr_sel = X_train.index_select(1, sel_idx)
    Xte_sel = X_test.index_select(1, sel_idx)
    del X_train, X_test, ff
    search = randomized_search(
        Xtr_sel, y_train, cfg.gbdt.replace(scale_pos_weight=spw), cfg.tune, device=dev
    )
    logger.info("search best CV AUC %.4f with %s", search.best_score_, search.best_params_)
    t = tick("search", t)

    est = search.best_estimator_
    test_auc = float(roc_auc(y_test, est.predict_margin(Xte_sel)))
    metrics = {
        # The reference trainer's metrics.json schema.
        "auc": test_auc,
        "classification_report": binary_classification_report(y_test, est.predict(Xte_sel)),
        "best_params": search.best_params_,
    }
    logger.info("test ROC-AUC %.4f", test_auc)
    t = tick("eval", t)

    artifact = GBDTArtifact(
        forest=est.forest,
        feature_names=selected,
        bin_edges=est.bin_spec.edges.cpu().numpy(),
        plan=plan,
        config={
            "best_params": search.best_params_,
            "scale_pos_weight": spw,
            "split_seed": cfg.data.split_seed,
        },
        metrics=metrics,
    )
    if store is not None:
        key = cfg.serve.model_key
        artifact.save(store, key)
        save_metrics(store, key + ".metrics.json", metrics)
        logger.info("artifact persisted at %s", key)

    return PipelineResult(
        selected_features=selected,
        best_params=search.best_params_,
        cv_auc=float(search.best_score_),
        test_auc=test_auc,
        metrics=metrics,
        artifact=artifact,
        search=search,
        scale_pos_weight=spw,
        timings=timings,
        hist_launches=launches,
    )


def parse_args(argv: Sequence[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--store", default=None, help="object-store root (a local directory)")
    parser.add_argument(
        "--synthetic-rows",
        type=int,
        default=0,
        help="train on a synthetic raw LendingClub table of this many loans",
    )
    parser.add_argument("--seed", type=int, default=0, help="seed of the synthetic table")
    parser.add_argument(
        "--quick",
        action="store_true",
        help="the reference's slim profile: RFE in steps of 20 with a 20-tree "
        "depth-3 selector and a 4 x 2 search; like the full profile it is an "
        "exhaustive search (every candidate to its full n_estimators on every "
        "fold), since successive halving is not ported",
    )
    parser.add_argument(
        "--device",
        default="cuda",
        help="cuda (the default; the CUDA kernels) or cpu (their plain versions)",
    )
    parser.add_argument(
        "--resume", action="store_true", help="not ported yet: raises (ROADMAP.md, A4)"
    )
    parser.add_argument(
        "--pandas-ingest", action="store_true", help="not ported yet: raises (ROADMAP.md, A3)"
    )
    return parser.parse_args(argv)


def main(argv: Sequence[str] | None = None) -> PipelineResult:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s [%(levelname)s] %(message)s")
    dev = resolve_device(args.device)
    if args.pandas_ingest:
        raise NotImplementedError("the pandas ingest path is not ported yet (ROADMAP.md, A3)")
    cfg = quick_config() if args.quick else PipelineConfig()
    raw = None
    if args.synthetic_rows:
        from cobalt_smart_lender_ai_tpu_torch.data.synthetic import synthetic_lendingclub_frame

        raw = synthetic_lendingclub_frame(args.synthetic_rows, seed=args.seed)
    store = ObjectStore(args.store) if args.store else None
    result = run_pipeline(cfg, raw=raw, store=store, resume=args.resume, device=dev)
    print(
        {
            "test_auc": result.test_auc,
            "cv_auc": result.cv_auc,
            "best_params": result.best_params,
            "n_selected": len(result.selected_features),
            "timings": result.timings,
            "hist_launches": result.hist_launches,
        }
    )
    return result


if __name__ == "__main__":
    main()
