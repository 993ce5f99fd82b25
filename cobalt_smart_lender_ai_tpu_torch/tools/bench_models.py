"""Measured throughput + quality for the neural model families (the port's
copy of the reference's ``tools/bench_models.py``).

One record in the reference's ``MODELS_BENCH.json`` shape: training
throughput and held-out AUC for the MLP, the FT-Transformer and TabNet on
the synthetic LendingClub nn frame (leakage dropped, hashed split, NaN to 0)
on one device. No scoring or histogram kernel runs here: the challengers
are plain PyTorch modules.

Method, the reference's: a cold full-length fit runs first (its wall time,
the libraries' first loads and allocations included, is what a user
experiences), then a short and a long fit run warm, each twice with the
shorter wall kept, and steady-state throughput is ``rows x extra_epochs /
(t_long - t_short)``. Every timed fit ends with the held-out probabilities'
sum copied to the host. A delta under ``NOISE_FLOOR_S`` seconds, equal
epoch counts (early stopping) or a long fit no slower than the short one
reports the whole-fit rate instead, flagged as a lower bound.

    python -m cobalt_smart_lender_ai_tpu_torch.tools.bench_models [--rows 262144] [--out M.json]

``--device`` defaults to ``cuda`` and raises without a card; ``--device
cpu`` runs on the CPU. The AUC is `ops.metrics.roc_auc` (the reference uses
scikit-learn's, which the card's machine lacks; the two agree). The
record's ``backend`` is ``"gpu"`` or ``"cpu"``, ``device`` the device's
name, and it adds a ``card`` block (`tools.bench_common`).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from cobalt_smart_lender_ai_tpu_torch.device import resolve_device
from cobalt_smart_lender_ai_tpu_torch.tools.bench_common import (
    card_block,
    platform_tag,
    summary,
    write_record,
)

__all__ = ["NOISE_FLOOR_S", "bench_family", "main", "parse_args"]

#: Below this many seconds an epoch delta is not a measurement (the
#: reference's floor, kept so the two records mean the same thing).
NOISE_FLOOR_S = 5.0


def _ready(model, Xte_args) -> float:
    """End the timed window: the predictions' sum on the host."""
    p = model.predict_proba(*Xte_args)
    return float(p.sum())


def bench_family(make_model, fit_args, test_args, y_test, short=2, long=12):
    from cobalt_smart_lender_ai_tpu_torch.ops.metrics import roc_auc

    rows = int(np.asarray(fit_args[-1]).shape[0])
    # Cold full fit first: what a user experiences, and the warm-up of the
    # timed fits below.
    t0 = time.time()
    m = make_model(long)
    m.fit(*fit_args)
    _ready(m, test_args)
    t_cold_full = time.time() - t0

    # Each timed fit runs twice and the shorter wall is kept.
    def timed_fit(epochs):
        walls = []
        for _ in range(2):
            t0 = time.time()
            m = make_model(epochs)
            m.fit(*fit_args)
            _ready(m, test_args)
            walls.append(time.time() - t0)
        return min(walls), len(m.history["loss"]), m

    t_short, e_short, _ = timed_fit(short)
    t_long, e_long, m = timed_fit(long)  # early stopping may trim e_long

    measurement = "steady"
    if e_long > e_short and t_long - t_short >= NOISE_FLOOR_S:
        steady = rows * (e_long - e_short) / (t_long - t_short)
    else:
        steady = rows * e_long / max(t_long, 1e-9)
        if e_long <= e_short:
            measurement = "lower_bound_early_stop_clamped"
        elif t_long <= t_short:
            measurement = "lower_bound_timing_noise"
        else:
            measurement = "lower_bound_delta_below_noise_floor"
    p = m.predict_proba(*test_args)[:, 1].contiguous()
    y = torch.as_tensor(np.asarray(y_test), dtype=torch.float32, device=p.device)
    auc = float(roc_auc(y, p))
    return {
        "rows": rows,
        "epochs_run": [e_short, e_long],
        "fit_seconds_incl_compile": round(t_cold_full, 1),
        "fit_seconds_warm": round(t_long, 1),
        "steady_rows_per_sec": round(steady),
        "throughput_measurement": measurement,
        "test_auc": round(auc, 4),
    }


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="bench_models", description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=262_144)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)

    from cobalt_smart_lender_ai_tpu_torch.compilecache import bootstrap_compile_cache

    bootstrap_compile_cache()

    from cobalt_smart_lender_ai_tpu_torch.config import (
        FTTransformerConfig,
        MLPConfig,
    )
    from cobalt_smart_lender_ai_tpu_torch.data import (
        clean_raw_frame,
        engineer_features,
        prepare_cleaned_frame,
        synthetic_lendingclub_frame,
        train_test_split_hashed,
    )
    from cobalt_smart_lender_ai_tpu_torch.data.features import drop_training_leakage
    from cobalt_smart_lender_ai_tpu_torch.models.ft_transformer import (
        FTTransformerClassifier,
    )
    from cobalt_smart_lender_ai_tpu_torch.models.nn import MLPClassifier
    from cobalt_smart_lender_ai_tpu_torch.models.tabnet import (
        TabNetClassifier,
        TabNetConfig,
    )

    # The NN feature frame (numeric + label-encoded categoricals), with the
    # trainer's leakage block dropped as the reference's NN notebook does.
    raw = synthetic_lendingclub_frame(n_rows=args.rows, seed=13)
    cleaned, _ = clean_raw_frame(raw)
    _, nn_ff, plan = engineer_features(prepare_cleaned_frame(cleaned), device=dev)
    nn_ff = drop_training_leakage(nn_ff)
    Xtr, Xte, ytr, yte = (t.cpu().numpy() for t in train_test_split_hashed(nn_ff.X, nn_ff.y))
    # NaNs to 0 after the frames' imputation indicators already encoded them.
    Xtr_n = np.nan_to_num(Xtr, nan=0.0)
    Xte_n = np.nan_to_num(Xte, nan=0.0)

    # Each categorical is a label-code column named after the raw column;
    # code len(vocab) means missing, hence the +1 embedding row.
    names = list(nn_ff.feature_names)
    cat_cols = [i for i, n in enumerate(names) if n in plan.categorical_vocab]
    num_cols = [i for i in range(len(names)) if i not in cat_cols]
    vocab_sizes = tuple(
        len(plan.categorical_vocab[names[i]]) + 1 for i in cat_cols
    )

    results = {
        "backend": platform_tag(dev),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "train_rows": int(Xtr_n.shape[0]),
        "features": len(names),
    }

    results["mlp"] = bench_family(
        lambda e: MLPClassifier(MLPConfig(epochs=e, early_stop_patience=10_000), device=dev),
        (Xtr_n, ytr),
        (Xte_n,),
        yte,
        short=16,
        long=48,
    )
    print("mlp:", json.dumps(results["mlp"]))

    if cat_cols:
        ft_fit = (Xtr_n[:, num_cols], Xtr_n[:, cat_cols].astype(np.int32), ytr)
        ft_test = (Xte_n[:, num_cols], Xte_n[:, cat_cols].astype(np.int32))
        results["ft_transformer"] = bench_family(
            lambda e: FTTransformerClassifier(
                vocab_sizes, FTTransformerConfig(epochs=e), device=dev
            ),
            ft_fit,
            ft_test,
            yte,
            short=4,
            long=10,
        )
        print("ft_transformer:", json.dumps(results["ft_transformer"]))

    results["tabnet"] = bench_family(
        lambda e: TabNetClassifier(TabNetConfig(epochs=e), device=dev),
        (Xtr_n, ytr),
        (Xte_n,),
        yte,
        short=16,
        long=48,
    )
    print("tabnet:", json.dumps(results["tabnet"]))

    results["card"] = card_block(dev)
    write_record(results, args.out, indent=2)
    summary(
        "bench_models",
        "; ".join(
            f"{family} {results[family]['steady_rows_per_sec']} rows/s "
            f"({results[family]['throughput_measurement']}), AUC "
            f"{results[family]['test_auc']}"
            for family in ("mlp", "ft_transformer", "tabnet") if family in results
        ),
        dev,
    )
    return results


if __name__ == "__main__":
    main()
