"""Full-table fit benchmark (the port's copy of the reference's ``bench.py``).

The default run is the reference's single fit, end to end on one device:
2.3M rows x 100 features of a planted logit over 10 features (numpy,
seeded; 2% of the cells missing), quantile binning into 64 bins, 300
boosting rounds of depth 3 at learning rate 0.05 in chunks of 100 on an
80% train split (weights), then the binned margin and the held-out ROC-AUC
(~0.91 at this noise level). On the card the fit runs the
``gradient_histogram`` kernel (``csrc/gradient_histogram.cu``) once per tree
level. One untimed warm-up run builds and loads the libraries; the timed run
ends with the AUC copied to the host.

    python -m cobalt_smart_lender_ai_tpu_torch.tools.bench [--rows 2300000]

``--protocol`` instead times the whole training protocol, `run_pipeline` on
a synthetic raw frame of ``--rows`` loans (clean -> engineer -> RFE-20 at
step 1 -> the 20 x 3 randomized search over the reference's space -> final
fit + eval, the search and fit chunked ``"auto"``), whose eval runs the
``score_forest`` kernel.

The record is the reference's headline, ``{metric, value, unit, ...}``,
without three of its keys: ``vs_baseline`` (a ratio over the reference's
north star of 4,791 rows/s a chip, a TPU v4-8 budget), and ``protocol`` and
``tuned_test_auc`` (copied from the committed ``BENCH_PROTOCOL.json``, a
TPU measurement). No number taken on or for a TPU belongs in a record of
the card; the trend gate's headline reader does not read them. The record
adds ``card`` (`tools.bench_common`) and goes to ``--out`` or stdout.
``--device`` defaults to ``cuda`` and raises without a card; ``--device
cpu`` runs the kernels' plain versions. ``--profile DIR`` traces the timed
run (`debug.profile_trace`); ``--ledger-out`` writes a run ledger;
``--trend-out [PATH]`` appends the headline to a trend file
(``TREND_torch.json`` by default).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from cobalt_smart_lender_ai_tpu_torch.device import resolve_device
from cobalt_smart_lender_ai_tpu_torch.tools.bench_common import (
    DEFAULT_TREND,
    append_trend,
    card_block,
    summary,
    write_record,
)

__all__ = ["main", "parse_args", "planted_logit_rows", "run_protocol", "run_single_fit"]

N_ROWS, N_FEATURES = 2_300_000, 100
N_TREES, MAX_DEPTH, N_BINS = 300, 3, 64
CHUNK_TREES = 100


def planted_logit_rows(n: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(X, y, test)``: the reference's seeded rows (float32, 2% NaN), its
    int32 labels and its boolean 20% held-out mask, bit for bit."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, N_FEATURES)).astype(np.float32)
    logits = X[:, :10] @ rng.normal(size=10) * 0.7
    y = (logits + rng.logistic(size=n) > 0).astype(np.int32)
    X[rng.random(X.shape) < 0.02] = np.nan  # exercise missing-value routing
    test = np.zeros(n, bool)
    test[rng.choice(n, n // 5, replace=False)] = True
    return X, y, test


def run_protocol(n_rows: int, seed: int = 5, *, device="cuda") -> dict:
    """Time the whole `run_pipeline` protocol on a synthetic raw frame, the
    search's and the final fit's chunks derived per workload (``"auto"``,
    `parallel.budget`)."""
    import dataclasses
    import logging

    from cobalt_smart_lender_ai_tpu_torch.config import PipelineConfig
    from cobalt_smart_lender_ai_tpu_torch.data.synthetic import (
        synthetic_lendingclub_frame,
    )
    from cobalt_smart_lender_ai_tpu_torch.pipeline import run_pipeline
    from cobalt_smart_lender_ai_tpu_torch.telemetry import snapshot

    dev = resolve_device(device)
    # Stage-progress lines on stderr.
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s [%(levelname)s] %(message)s"
    )
    cfg = PipelineConfig(save_intermediate=False)
    cfg = dataclasses.replace(
        cfg,
        gbdt=cfg.gbdt.replace(chunk_trees="auto"),
        tune=dataclasses.replace(cfg.tune, chunk_trees="auto"),
    )
    t0 = time.time()
    raw = synthetic_lendingclub_frame(n_rows=n_rows, seed=seed)
    t_gen = time.time() - t0

    t1 = time.time()
    result = run_pipeline(cfg, raw=raw, device=dev)
    total = time.time() - t1  # the test AUC is a host float: the work is done

    return {
        "telemetry": snapshot(span_limit=32),
        "metric": "full_protocol_rows_per_sec_per_chip",
        "produced_by": "tools.bench --protocol (single process)",
        "value": round(n_rows / total, 1),
        "unit": (
            f"rows/s ({n_rows/1e6:.1f}M-row raw frame through the whole "
            f"protocol — clean+engineer+RFE-20(step1)+search(20x3, full "
            f"reference space)+final fit+eval — in {total:.0f}s on one "
            f"device; test AUC {result.test_auc:.4f}, cv AUC "
            f"{result.cv_auc:.4f})"
        ),
        "seconds_total": round(total, 1),
        "seconds_stage": result.timings,
        "seconds_synthetic_datagen_excluded": round(t_gen, 1),
        "test_auc": round(result.test_auc, 4),
        "cv_auc": round(result.cv_auc, 4),
        "best_params": result.best_params,
        "n_rows": n_rows,
        "device": str(dev),
    }


def run_single_fit(n: int, *, device="cuda", profile: str | None = None) -> tuple[dict, float]:
    """The reference's timed single fit; returns the headline and the
    timed run's seconds."""
    from cobalt_smart_lender_ai_tpu_torch.config import GBDTConfig
    from cobalt_smart_lender_ai_tpu_torch.debug import profile_trace
    from cobalt_smart_lender_ai_tpu_torch.models.gbdt import (
        GBDTHyperparams,
        fit_binned_chunked,
        predict_margin,
    )
    from cobalt_smart_lender_ai_tpu_torch.ops.binning import compute_bin_edges, transform
    from cobalt_smart_lender_ai_tpu_torch.ops.metrics import roc_auc
    from cobalt_smart_lender_ai_tpu_torch.telemetry import snapshot, span

    dev = resolve_device(device)
    X, y, test = planted_logit_rows(n)
    hp = GBDTHyperparams.from_config(
        GBDTConfig(
            n_estimators=N_TREES, max_depth=MAX_DEPTH, learning_rate=0.05, n_bins=N_BINS
        )
    )
    Xd = torch.from_numpy(X).to(dev)
    yd = torch.from_numpy(y).to(dev)
    train_w = torch.from_numpy((~test).astype(np.float32)).to(dev)  # 80/20 split via weights
    test_w = torch.from_numpy(test.astype(np.float32)).to(dev)
    fm = torch.ones(N_FEATURES, dtype=torch.bool, device=dev)

    def run(seed: int) -> float:
        spec = compute_bin_edges(Xd, n_bins=N_BINS)
        bins = transform(spec, Xd)
        forest = fit_binned_chunked(
            bins,
            yd.to(torch.float32),
            train_w,
            fm,
            hp,
            seed,
            n_trees_cap=N_TREES,
            depth_cap=MAX_DEPTH,
            n_bins=N_BINS,
            chunk_trees=CHUNK_TREES,
        )
        margin = predict_margin(forest, bins, use_binned=True)
        # The AUC copied to the host ends the window: every launch of the
        # chain has run.
        return float(roc_auc(yd.to(torch.float32), margin, weight=test_w))

    run(0)  # warm-up: builds and loads the libraries
    with profile_trace(profile, device=dev):
        t0 = time.time()
        with span("bench.full_table_fit", rows=n, trees=N_TREES):
            auc = run(1)
        elapsed = time.time() - t0

    rows_per_sec = n / elapsed
    line = {
        "metric": "full_table_e2e_rows_per_sec_per_chip",
        "value": round(rows_per_sec, 1),
        "unit": (
            f"rows/s ({n/1e6:.1f}M rows, bin+{N_TREES}-tree-fit+predict+AUC "
            f"in {elapsed:.1f}s on one device, held-out AUC {auc:.3f})"
        ),
        "telemetry": snapshot(span_limit=16),
    }
    return line, elapsed


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="bench", description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", default=None, help="torch.profiler trace dir")
    parser.add_argument("--rows", type=int, default=N_ROWS)
    parser.add_argument(
        "--protocol",
        action="store_true",
        help="time the full run_pipeline protocol instead of the single fit",
    )
    parser.add_argument(
        "--ledger-out",
        default=None,
        help="write a run ledger (env, stage durations, program cost table) "
        "to this path; render with tools.obs_report",
    )
    parser.add_argument(
        "--trend-out",
        nargs="?",
        const=DEFAULT_TREND,
        default=None,
        help=f"append this run's headline metrics to a trend file (default "
        f"path: {DEFAULT_TREND}; gate with tools.perf_sentinel check)",
    )
    parser.add_argument("--out", default=None, help="write the record here (default: stdout)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    return parser.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)

    from cobalt_smart_lender_ai_tpu_torch.compilecache import bootstrap_compile_cache

    bootstrap_compile_cache()
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
            "bench",
            meta={"rows": args.rows, "protocol": bool(args.protocol)},
        )
    if args.protocol:
        from cobalt_smart_lender_ai_tpu_torch.debug import profile_trace

        with profile_trace(args.profile, device=dev):
            out = run_protocol(args.rows, device=dev)
        if ledger is not None:
            ledger.add_stages(out.get("seconds_stage") or {})
        source = "tools.bench --protocol"
    else:
        out, elapsed = run_single_fit(args.rows, device=dev, profile=args.profile)
        if ledger is not None:
            ledger.add_stage("full_table_fit", elapsed)
        source = "tools.bench"
    out["card"] = card_block(dev)
    if ledger is not None:
        ledger.set("headline", {k: out[k] for k in out if k != "telemetry"})
        ledger.write(args.ledger_out)
    append_trend(args.trend_out, out, source)
    write_record(out, args.out)
    summary("bench", f"{out['metric']} {out['value']}: {out['unit']}", dev)
    return out


if __name__ == "__main__":
    main()
