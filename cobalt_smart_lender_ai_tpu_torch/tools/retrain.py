"""Retrain driver: the producing half of the continuous-training loop.

Trains a fresh GBDT champion candidate on a new pull of the training frame
and publishes it through the model registry's ``canary`` channel, never
directly to ``latest``. Promotion into ``latest`` only happens through the
serving side's gate (``POST /admin/promote``, `serve.canary`), after the
candidate has shadow-scored real traffic.

The path is the reference's ``tools/retrain.py``: a synthetic LendingClub
table, the host cleaning path (`clean_raw_frame`, `prepare_cleaned_frame`,
then `engineer_features` on ``device``), the leakage drop, the 20 serving
features and the hashed split, then `GBDTClassifier.fit` on ``device`` (one
``gradient_histogram`` launch per tree level on the card). Every published
version carries the provenance an incident review needs: the dataset
fingerprint (md5 of the exact float32 training matrix and labels), the
config hash (`reliability.checkpoint.config_fingerprint`), the held-out
AUC, and the per-feature training sketch (`telemetry.drift.FeatureSketch`)
that ``GET /drift`` scores live traffic against.

Usage:
    python -m cobalt_smart_lender_ai_tpu_torch.tools.retrain [--store artifacts]
        [--rows 20000] [--seed 17] [--model-name gbdt] [--no-mlp]
        [--bootstrap] [--degrade] [--device cuda|cpu]

``--device`` defaults to ``cuda`` and fails without a card; ``--device cpu``
runs the plain versions of the kernels. ``--bootstrap`` also promotes the
candidate when the registry has no champion yet (first deployment);
``--degrade`` label-shuffles the training set — a deliberately broken
candidate for driving the promotion gate's rejection path, never for
production. As the reference does by default, each generation also trains
the MLP challenger (`models.nn.MLPClassifier`, hidden 32/16, lr 1e-2, on
the GBDT's training matrix and labels, on ``device``) and publishes it as
``<model>_mlp`` to ``canary`` (`io.MLPArtifact`) with the same provenance;
``--no-mlp`` skips it.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time
from typing import Sequence

import numpy as np
import torch

__all__ = ["main", "retrain_candidate"]


def retrain_candidate(
    store,
    *,
    rows: int = 20_000,
    seed: int = 17,
    model_name: str = "gbdt",
    registry_prefix: str = "registry",
    degrade: bool = False,
    bootstrap: bool = False,
    train_mlp: bool = True,
    n_estimators: int = 60,
    max_depth: int = 5,
    mlp_epochs: int = 12,
    drift_bins: int = 10,
    device: torch.device | str = "cuda",
) -> dict:
    """Train and publish one candidate generation; returns the publish
    report. ``device`` is ``cuda`` unless the caller asks for ``cpu``."""
    from cobalt_smart_lender_ai_tpu_torch.config import GBDTConfig, MLPConfig
    from cobalt_smart_lender_ai_tpu_torch.data import (
        clean_raw_frame,
        engineer_features,
        prepare_cleaned_frame,
        schema,
        synthetic_lendingclub_frame,
        train_test_split_hashed,
    )
    from cobalt_smart_lender_ai_tpu_torch.data.features import drop_training_leakage
    from cobalt_smart_lender_ai_tpu_torch.device import resolve_device
    from cobalt_smart_lender_ai_tpu_torch.io import GBDTArtifact, MLPArtifact, ModelRegistry
    from cobalt_smart_lender_ai_tpu_torch.models.gbdt import GBDTClassifier
    from cobalt_smart_lender_ai_tpu_torch.models.nn import MLPClassifier
    from cobalt_smart_lender_ai_tpu_torch.ops.metrics import roc_auc
    from cobalt_smart_lender_ai_tpu_torch.reliability.checkpoint import config_fingerprint
    from cobalt_smart_lender_ai_tpu_torch.telemetry.drift import FeatureSketch

    dev = resolve_device(device)
    t0 = time.time()
    raw = synthetic_lendingclub_frame(n_rows=rows, seed=seed)
    cleaned, _ = clean_raw_frame(raw)
    tree_ff, _, _ = engineer_features(prepare_cleaned_frame(cleaned), device=dev)
    ff = drop_training_leakage(tree_ff).select(schema.SERVING_FEATURES)
    X_train, X_test, y_train, y_test = train_test_split_hashed(ff.X, ff.y)
    X_np = X_train.cpu().numpy()
    y_np = y_train.cpu().numpy()
    if degrade:
        # Sever the feature/label relationship: the candidate trains on
        # shuffled labels, scores near-noise, and must be rejected by the
        # serve-side promotion gate.
        y_np = np.random.default_rng(seed).permutation(y_np)
    spw = (len(y_np) - y_np.sum()) / max(y_np.sum(), 1.0)

    cfg = GBDTConfig(
        n_estimators=n_estimators,
        max_depth=max_depth,
        learning_rate=0.1,
        n_bins=64,
        scale_pos_weight=float(spw),
        seed=seed,
    )
    model = GBDTClassifier(cfg, device=dev).fit(X_train, y_np)
    test_auc = float(roc_auc(y_test, model.predict_margin(X_test)))

    # Provenance: the dataset fingerprint is the md5 of the exact float32
    # training matrix and labels the fit saw, the config hash covers the
    # training regime, and the sketch is the drift baseline.
    data_md5 = hashlib.md5(
        np.ascontiguousarray(X_np, dtype=np.float32).tobytes()
        + np.ascontiguousarray(y_np, dtype=np.float32).tobytes()
    ).hexdigest()
    sketch = FeatureSketch.from_data(X_np, schema.SERVING_FEATURES, bins=drift_bins)
    provenance = {
        "dataset": f"synthetic_lendingclub_frame(rows={rows}, seed={seed})",
        "dataset_md5": data_md5,
        "config_hash": config_fingerprint(cfg, {"rows": rows, "seed": seed}),
        "degraded": bool(degrade),
        "feature_sketch": sketch.to_json(),
    }

    registry = ModelRegistry(store, prefix=registry_prefix)
    champion = GBDTArtifact(
        forest=model.forest,
        feature_names=tuple(schema.SERVING_FEATURES),
        bin_edges=model.bin_spec.edges.cpu().numpy(),
        config={
            k: getattr(cfg, k)
            for k in ("n_estimators", "max_depth", "learning_rate", "n_bins",
                      "scale_pos_weight", "seed")
        },
        metrics={"test_auc": round(test_auc, 4), "train_rows": int(X_np.shape[0])},
    )
    mv = registry.publish(model_name, champion, provenance=provenance, channel="canary")
    report = {
        "model": model_name,
        "version": mv.version,
        "key": mv.key,
        "channel": "canary",
        "test_auc": round(test_auc, 4),
        "parent_version": mv.parent_version,
        "dataset_md5": data_md5,
    }
    if bootstrap and registry.channel(model_name, "latest") is None:
        # First deployment: there is no champion to shadow against, so the
        # registry-level promote seeds `latest` directly. Every later
        # generation goes through the serve-side gate.
        registry.promote(model_name)
        report["channel"] = "latest"
        report["bootstrapped"] = True

    if train_mlp:
        # At the default 1e-3 the few-epoch regime undershoots; 1e-2
        # converges within this budget (the reference's setting).
        mlp_cfg = MLPConfig(hidden_sizes=(32, 16), learning_rate=1e-2, epochs=mlp_epochs, seed=seed)
        mlp = MLPClassifier(mlp_cfg, device=dev).fit(X_train, y_np)
        mlp_auc = float(roc_auc(y_test, mlp.predict_logits(X_test)))
        challenger = MLPArtifact(
            state_dict=mlp.module.state_dict(),
            scaler_low=mlp.scaler.low.cpu().numpy(),
            scaler_range=mlp.scaler.range_.cpu().numpy(),
            feature_names=tuple(schema.SERVING_FEATURES),
            hidden_sizes=tuple(mlp_cfg.hidden_sizes),
            config={"learning_rate": mlp_cfg.learning_rate, "epochs": mlp_cfg.epochs, "seed": seed},
            metrics={"test_auc": round(mlp_auc, 4)},
        )
        mlp_mv = registry.publish(
            f"{model_name}_mlp", challenger, provenance=provenance, channel="canary"
        )
        report["challenger"] = {
            "model": f"{model_name}_mlp",
            "version": mlp_mv.version,
            "key": mlp_mv.key,
            "test_auc": round(mlp_auc, 4),
        }
    report["wall_s"] = round(time.time() - t0, 1)
    return report


def parse_args(argv: Sequence[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--store", default="artifacts")
    ap.add_argument("--rows", type=int, default=20_000)
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--model-name", default="gbdt")
    ap.add_argument("--registry-prefix", default="registry")
    ap.add_argument("--n-estimators", type=int, default=60)
    ap.add_argument("--max-depth", type=int, default=5)
    ap.add_argument("--no-mlp", action="store_true", help="skip the MLP challenger")
    ap.add_argument("--bootstrap", action="store_true",
                    help="promote to 'latest' when no champion exists yet")
    ap.add_argument("--degrade", action="store_true",
                    help="label-shuffle the training set (a gate-rejection "
                    "fixture; never use in production)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; the CUDA kernels) or cpu (their plain versions)")
    ap.add_argument("--trace-out", default=None,
                    help="write the run's spans as Perfetto JSON to this path")
    ap.add_argument("--ledger-out", default=None,
                    help="write a run ledger (env, durations, kernel cost table) to this path")
    return ap.parse_args(argv)


def main(argv: Sequence[str] | None = None) -> dict:
    args = parse_args(argv)
    from cobalt_smart_lender_ai_tpu_torch.compilecache import bootstrap_compile_cache
    from cobalt_smart_lender_ai_tpu_torch.device import resolve_device
    from cobalt_smart_lender_ai_tpu_torch.io import ObjectStore
    from cobalt_smart_lender_ai_tpu_torch.telemetry import (
        RunLedger,
        default_tracer,
        install_device_metrics,
        install_program_metrics,
        render_chrome_trace,
    )

    bootstrap_compile_cache()
    dev = resolve_device(args.device)
    ledger = None
    if args.ledger_out:
        install_program_metrics()
        install_device_metrics()
        ledger = RunLedger(
            "retrain",
            meta={"rows": args.rows, "seed": args.seed, "model_name": args.model_name,
                  "degrade": bool(args.degrade), "device": str(dev)},
        )
    report = retrain_candidate(
        ObjectStore(args.store),
        rows=args.rows,
        seed=args.seed,
        model_name=args.model_name,
        registry_prefix=args.registry_prefix,
        degrade=args.degrade,
        bootstrap=args.bootstrap,
        train_mlp=not args.no_mlp,
        n_estimators=args.n_estimators,
        max_depth=args.max_depth,
        device=dev,
    )
    if ledger is not None:
        ledger.add_stage("retrain", float(report.get("wall_s", 0.0)))
        ledger.set("retrain_report", report)
        ledger.write(args.ledger_out)
    if args.trace_out:
        with open(args.trace_out, "w") as fh:
            fh.write(render_chrome_trace(default_tracer()))
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
