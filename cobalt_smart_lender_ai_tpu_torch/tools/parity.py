"""Protocol-scale parity head-to-head: the port's GBDT on the card against a
CPU scikit-learn oracle (the port's copy of the reference's
``tools/parity.py``).

Runs the full reference training protocol on identical data:

    clean -> engineer -> leakage drop -> hashed 80/20 split
    -> RFE to exactly 20 features (step 1)
    -> 20-candidate x 3-fold randomized search
    -> refit best, test ROC-AUC

Side "ours" is the port end to end (`rfe_select` and `randomized_search` on
``--device``: on a card, every histogram through the ``gradient_histogram``
kernel). Side "oracle" is scikit-learn's `HistGradientBoostingClassifier`
driven through the same protocol on the same matrices and the same
stratified fold masks (`stratified_kfold_masks`, seed 22), exactly as the
reference's oracle side. The oracle side needs scikit-learn, which the
card's machine does not have: there ``oracle`` and ``both`` exit non-zero
and say so, and the card's ``ours`` record is merged with the committed
``PARITY_oracle.json`` (130,000 rows, seed 11). An oracle's result is an
AUC, not a time, so it holds on any machine.

Usage:

    python -m cobalt_smart_lender_ai_tpu_torch.tools.parity ours \\
        --rows 130000 --out ours.json [--device cuda|cpu]
    python -m cobalt_smart_lender_ai_tpu_torch.tools.parity merge \\
        ours.json PARITY_oracle.json --out parity.json

``--device`` defaults to ``cuda`` and fails without a card; ``--device cpu``
runs the plain versions of the kernels. The merge gates
``ours.test_auc >= oracle.test_auc - 0.005`` and refuses records whose
``n_rows`` or ``seed`` differ.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Sequence

import numpy as np

__all__ = [
    "HGB_SPACE",
    "PARITY_MARGIN",
    "build_matrices",
    "main",
    "merge",
    "run_head_to_head",
    "run_oracle",
    "run_ours",
]

#: The reference's RandomizedSearchCV space mapped onto
#: HistGradientBoostingClassifier parameters (the reference's own map).
HGB_SPACE = {
    "max_iter": [100, 200, 300],
    "max_depth": [3, 5, 7, 9],
    "learning_rate": [0.01, 0.05, 0.1],
    "max_features": [0.5, 0.8, 1.0],
    "l2_regularization": [0.0, 1.0, 5.0],
}

PARITY_MARGIN = 0.005  # ours must be within this of the oracle (or better)


def build_matrices(n_rows: int, seed: int, device="cuda") -> dict:
    """Shared data side of the protocol: synthetic raw frame -> clean ->
    engineer (on ``device``) -> leakage drop -> hashed split, returned as
    numpy arrays. Deterministic in (n_rows, seed) and the day of the run,
    so two processes reconstruct the same matrices."""
    from cobalt_smart_lender_ai_tpu_torch.data import (
        clean_raw_frame,
        engineer_features,
        prepare_cleaned_frame,
        synthetic_lendingclub_frame,
        train_test_split_hashed,
    )
    from cobalt_smart_lender_ai_tpu_torch.data.features import drop_training_leakage

    raw = synthetic_lendingclub_frame(n_rows=n_rows, seed=seed)
    cleaned, _ = clean_raw_frame(raw)
    tree_ff, _, _ = engineer_features(prepare_cleaned_frame(cleaned), device=device)
    ff = drop_training_leakage(tree_ff)
    X_train, X_test, y_train, y_test = (
        t.cpu().numpy() for t in train_test_split_hashed(ff.X, ff.y)
    )
    n_pos = float(y_train.sum())
    spw = (float(X_train.shape[0]) - n_pos) / max(n_pos, 1.0)
    return {
        "X_train": X_train,
        "X_test": X_test,
        "y_train": y_train,
        "y_test": y_test,
        "feature_names": list(ff.feature_names),
        "spw": spw,
    }


def run_ours(
    mats: dict, chunk_trees: int | str | None = "auto", halving: bool = True, device="cuda"
) -> dict:
    """The port's protocol on the shared matrices, on ``device``: the RFE
    and search block of `pipeline.run_pipeline`, run directly so both sides
    consume the same arrays, each stage in a span (``parity.rfe``,
    ``parity.search``) for ``--trace-out``."""
    import torch

    from cobalt_smart_lender_ai_tpu_torch import config
    from cobalt_smart_lender_ai_tpu_torch.device import mesh_devices, resolve_device
    from cobalt_smart_lender_ai_tpu_torch.ops.metrics import roc_auc
    from cobalt_smart_lender_ai_tpu_torch.parallel.mesh import make_mesh
    from cobalt_smart_lender_ai_tpu_torch.parallel.rfe import rfe_select
    from cobalt_smart_lender_ai_tpu_torch.parallel.tune import randomized_search
    from cobalt_smart_lender_ai_tpu_torch.telemetry import span

    dev = resolve_device(device)
    t0 = time.time()
    mesh = make_mesh(config.MeshConfig(), devices=mesh_devices(dev))
    spw = mats["spw"]
    rfe_cfg = dataclasses.replace(config.RFEConfig(), scale_pos_weight=spw)
    with span("parity.rfe", rows=int(mats["X_train"].shape[0])):
        rfe = rfe_select(mats["X_train"], mats["y_train"], rfe_cfg, device=dev, mesh=mesh)
    t_rfe = time.time() - t0
    selected = [n for n, keep in zip(mats["feature_names"], rfe.support_) if keep]

    sel_idx = np.flatnonzero(rfe.support_)
    Xtr = np.ascontiguousarray(mats["X_train"][:, sel_idx])
    Xte = torch.from_numpy(np.ascontiguousarray(mats["X_test"][:, sel_idx])).to(dev)
    base = config.GBDTConfig().replace(scale_pos_weight=spw)
    tune = dataclasses.replace(config.TuneConfig(), chunk_trees=chunk_trees, halving_enabled=halving)
    t1 = time.time()
    with span("parity.search", rows=int(Xtr.shape[0])):
        search = randomized_search(Xtr, mats["y_train"], base, tune, device=dev, mesh=mesh)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    t_search = time.time() - t1

    margin = search.best_estimator_.predict_margin(Xte)
    y_test = torch.from_numpy(np.asarray(mats["y_test"], dtype=np.float32)).to(dev)
    test_auc = float(roc_auc(y_test, margin))
    halving_report = search.cv_results_.get("halving")
    return {
        "side": "ours",
        "backend": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
        "scheduler": "halving" if halving_report is not None else "exhaustive",
        "halving": None
        if halving_report is None
        else {k: halving_report[k] for k in ("eta", "budgets", "pruned_candidates", "survivors")},
        "selected_features": selected,
        "best_params": search.best_params_,
        "cv_auc": float(search.best_score_),
        "test_auc": test_auc,
        "seconds": {
            "rfe": round(t_rfe, 1),
            "search": round(t_search, 1),
            "total": round(time.time() - t0, 1),
        },
    }


def _require_sklearn() -> None:
    """Exit non-zero, saying why, where scikit-learn is not installed."""
    try:
        import sklearn  # noqa: F401
    except ImportError:
        raise SystemExit(
            "the oracle side needs scikit-learn, which is not installed here; run it on a "
            "machine that has it, or merge the 'ours' record with the committed "
            "PARITY_oracle.json"
        ) from None


def run_oracle(mats: dict, seed: int = 22) -> dict:
    """The CPU oracle: scikit-learn's HistGradientBoostingClassifier through
    the same RFE-20 (step 1) -> 20x3 search -> test eval protocol on the
    same matrices and fold masks."""
    from sklearn.ensemble import HistGradientBoostingClassifier
    from sklearn.inspection import permutation_importance
    from sklearn.metrics import roc_auc_score

    from cobalt_smart_lender_ai_tpu_torch.parallel.tune import (
        sample_candidates,
        stratified_kfold_masks,
    )

    X_train = np.asarray(mats["X_train"], dtype=np.float64)
    X_test = np.asarray(mats["X_test"], dtype=np.float64)
    y_train = np.asarray(mats["y_train"])
    y_test = np.asarray(mats["y_test"])
    spw = mats["spw"]
    sw = np.where(y_train == 1, spw, 1.0)  # scale_pos_weight analog
    F = X_train.shape[1]

    t0 = time.time()
    # RFE to exactly 20, step 1. The selector matches RFEConfig (50 rounds,
    # depth 6, class-weighted); the ranking signal is permutation importance
    # on a 10k training subsample (HGB has no native importances).
    rng = np.random.default_rng(42)
    sub = rng.choice(len(y_train), size=min(10_000, len(y_train)), replace=False)
    mask = np.ones(F, dtype=bool)
    while mask.sum() > 20:
        sel = HistGradientBoostingClassifier(max_iter=50, max_depth=6, random_state=42)
        sel.fit(X_train[:, mask], y_train, sample_weight=sw)
        imp = permutation_importance(
            sel,
            X_train[sub][:, mask],
            y_train[sub],
            scoring="roc_auc",
            n_repeats=1,
            random_state=0,
        ).importances_mean
        drop_local = int(np.argsort(imp, kind="stable")[0])
        mask[np.flatnonzero(mask)[drop_local]] = False
    t_rfe = time.time() - t0
    selected = [n for n, keep in zip(mats["feature_names"], mask) if keep]

    Xtr = X_train[:, mask]
    Xte = X_test[:, mask]

    # The 20-candidate x 3-fold randomized search on the folds ours uses.
    candidates = sample_candidates(HGB_SPACE, 20, seed)
    val_masks = stratified_kfold_masks(y_train, 3, seed)
    t1 = time.time()
    scores = np.zeros((len(candidates), 3))
    for ci, cand in enumerate(candidates):
        for fi in range(3):
            val = val_masks[fi]
            m = HistGradientBoostingClassifier(random_state=78, **cand)
            m.fit(Xtr[~val], y_train[~val], sample_weight=sw[~val])
            p = m.predict_proba(Xtr[val])[:, 1]
            scores[ci, fi] = roc_auc_score(y_train[val], p)
    mean_scores = scores.mean(axis=1)
    best_i = int(mean_scores.argmax())
    best = dict(candidates[best_i])
    t_search = time.time() - t1

    final = HistGradientBoostingClassifier(random_state=78, **best)
    final.fit(Xtr, y_train, sample_weight=sw)
    test_auc = float(roc_auc_score(y_test, final.predict_proba(Xte)[:, 1]))
    return {
        "side": "oracle",
        "backend": "cpu/sklearn-HistGradientBoostingClassifier",
        "selected_features": selected,
        "best_params": best,
        "cv_auc": float(mean_scores[best_i]),
        "test_auc": test_auc,
        "seconds": {
            "rfe": round(t_rfe, 1),
            "search": round(t_search, 1),
            "total": round(time.time() - t0, 1),
        },
    }


def run_head_to_head(
    n_rows: int,
    seed: int = 11,
    chunk_trees: int | str | None = "auto",
    halving: bool = True,
    device="cuda",
) -> dict:
    """Both sides in one process: the matrices on ``device``, ours on
    ``device``, the oracle on the host."""
    mats = build_matrices(n_rows, seed, device)
    ours = run_ours(mats, chunk_trees=chunk_trees, halving=halving, device=device)
    oracle = run_oracle(mats)
    return merge(ours, oracle, n_rows=n_rows, seed=seed)


def merge(ours: dict, oracle: dict, **meta) -> dict:
    gap = ours["test_auc"] - oracle["test_auc"]
    return {
        "protocol": "clean->engineer->RFE-20(step1)->search(20x3)->test eval "
        "(model_tree_train_test.py:111-179)",
        **meta,
        "ours": ours,
        "oracle": oracle,
        "auc_gap_ours_minus_oracle": round(gap, 5),
        "parity_margin": PARITY_MARGIN,
        "parity_ok": bool(gap >= -PARITY_MARGIN),
    }


def _chunk_trees(s: str) -> int | str | None:
    return s if s == "auto" else (None if s == "none" else int(s))


def parse_args(argv: Sequence[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("side", choices=["ours", "oracle", "both", "merge"])
    ap.add_argument("inputs", nargs="*", help="json files for merge")
    ap.add_argument("--rows", type=int, default=130_000)
    ap.add_argument("--seed", type=int, default=11)
    # "auto" derives per-bucket chunks from the workload's shape
    # (parallel/budget.py); an int pins it; "none" fits in one chunk.
    ap.add_argument("--chunk-trees", default="auto", type=_chunk_trees)
    ap.add_argument(
        "--no-halving",
        action="store_true",
        help="exhaustive search scheduler instead of successive halving",
    )
    ap.add_argument("--out", default=None)
    ap.add_argument(
        "--trace-out",
        default=None,
        help="write the run's spans as Perfetto JSON to this path",
    )
    ap.add_argument(
        "--ledger-out",
        default=None,
        help="write a run ledger (env, side timings, program cost table) to this path; "
        "render with tools.obs_report",
    )
    ap.add_argument(
        "--device",
        default="cuda",
        help="cuda (the default; the CUDA kernels) or cpu (their plain versions)",
    )
    return ap.parse_args(argv)


def main(argv: Sequence[str] | None = None) -> dict:
    args = parse_args(argv)
    if args.side in ("oracle", "both"):
        _require_sklearn()

    ledger = None
    if args.ledger_out:
        from cobalt_smart_lender_ai_tpu_torch.telemetry import (
            RunLedger,
            install_device_metrics,
            install_program_metrics,
        )

        install_program_metrics()
        install_device_metrics()
        ledger = RunLedger(
            "parity",
            meta={
                "side": args.side,
                "rows": args.rows,
                "seed": args.seed,
                "halving": not args.no_halving,
                "device": args.device,
            },
        )

    if args.side in ("ours", "both"):
        from cobalt_smart_lender_ai_tpu_torch.compilecache import bootstrap_compile_cache

        bootstrap_compile_cache()
    if args.side == "merge":
        loaded = []
        for path in args.inputs:
            with open(path) as fh:
                loaded.append(json.load(fh))
        by_side = {d.get("side"): d for d in loaded}
        if set(by_side) != {"ours", "oracle"}:
            raise SystemExit(
                f"merge needs one 'ours' and one 'oracle' file, got sides "
                f"{[d.get('side') for d in loaded]}"
            )
        meta = {}
        for k in ("n_rows", "seed"):
            vals = {d.get(k) for d in loaded}
            if len(vals) != 1 or None in vals:
                raise SystemExit(
                    f"sides disagree on {k} ({vals}) — they did not run on "
                    "identical matrices; re-run with matching --rows/--seed"
                )
            meta[k] = vals.pop()
        result = merge(by_side["ours"], by_side["oracle"], **meta)
    elif args.side == "both":
        result = run_head_to_head(
            args.rows, args.seed, args.chunk_trees, halving=not args.no_halving,
            device=args.device,
        )
    else:
        mats = build_matrices(args.rows, args.seed, args.device)
        result = (
            run_ours(mats, chunk_trees=args.chunk_trees, halving=not args.no_halving,
                     device=args.device)
            if args.side == "ours"
            else run_oracle(mats)
        )
        result.update(n_rows=args.rows, seed=args.seed)
    print(json.dumps(result, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    if ledger is not None:
        for side in ("ours", "oracle"):
            block = result.get(side) if args.side in ("both", "merge") else (
                result if result.get("side") == side else None
            )
            if isinstance(block, dict):
                for stage, secs in (block.get("seconds") or {}).items():
                    if stage != "total":
                        ledger.add_stage(f"{side}.{stage}", float(secs))
        ledger.set("parity", result)
        ledger.write(args.ledger_out)
    if args.trace_out:
        from cobalt_smart_lender_ai_tpu_torch.telemetry import default_tracer, render_chrome_trace

        with open(args.trace_out, "w") as f:
            f.write(render_chrome_trace(default_tracer()))
    return result


if __name__ == "__main__":
    main()
