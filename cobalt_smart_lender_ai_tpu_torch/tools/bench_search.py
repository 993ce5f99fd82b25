"""Search-leg bench (the port's copy of the reference's
``tools/bench_search.py``): successive halving vs exhaustive on the same
grid.

Runs the reference 20x3 randomized-search grid (`TuneConfig.param_space`)
twice on identical data, folds and seed — once with the successive-halving
scheduler, once exhaustive — and reports the
``cobalt_search_dispatch_seconds`` each mode spent on tree work, the winner
each mode picked, and the winner's full-refit test AUC. On the card each
depth bucket's (candidate, fold) jobs share one ``gradient_histogram``
launch per tree level (``csrc/gradient_histogram.cu``); the refit's test
AUC, copied to the host, ends each run.

Single-mode runs (``--mode halving|exhaustive``) write the same record for
one scheduler plus the process's ``cobalt_compile_*`` counters: run one
twice with a shared ``--cache-dir`` (the port's kernel-build cache,
`compilecache`) and the second process builds nothing.

    python -m cobalt_smart_lender_ai_tpu_torch.tools.bench_search --smoke --mode both
    python -m cobalt_smart_lender_ai_tpu_torch.tools.bench_search --smoke --mode halving --cache-dir /tmp/cc

The data is `tools.parity.build_matrices` (the protocol's matrices from the
synthetic raw frame). ``--device`` defaults to ``cuda`` and raises without
a card; ``--device cpu`` runs the plain histogram. ``--force-devices n``
names the one device ``n`` times as the search's mesh (no scaling is
measured: every shard shares the one card). The record adds a ``card``
block (`tools.bench_common`) and goes to ``--out`` or stdout.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from cobalt_smart_lender_ai_tpu_torch.device import resolve_device
from cobalt_smart_lender_ai_tpu_torch.tools.bench_common import (
    DEFAULT_TREND,
    append_trend,
    card_block,
    device_count,
    force_devices,
    platform_tag,
    summary,
    write_record,
)

__all__ = ["main", "parse_args", "run_search"]


def run_search(mats, tune_cfg, *, base, mesh, device="cuda"):
    """One randomized_search over the shared matrices; returns the result
    plus the dispatch-seconds delta attributed to this run's scheduler."""
    from cobalt_smart_lender_ai_tpu_torch.ops.metrics import roc_auc
    from cobalt_smart_lender_ai_tpu_torch.parallel.tune import randomized_search
    from cobalt_smart_lender_ai_tpu_torch.telemetry import default_registry

    dev = resolve_device(device)
    counter = default_registry().counter(
        "cobalt_search_dispatch_seconds", "", ("mode",)
    )
    before = {
        m: counter.labels(mode=m).value for m in ("halving", "exhaustive")
    }
    t0 = time.time()
    res = randomized_search(
        mats["X_train"], mats["y_train"], base, tune_cfg, device=dev, mesh=mesh
    )
    wall = time.time() - t0
    deltas = {
        m: round(counter.labels(mode=m).value - before[m], 3)
        for m in ("halving", "exhaustive")
    }
    margin = res.best_estimator_.predict_margin(mats["X_test"])
    test_auc = float(
        roc_auc(torch.as_tensor(mats["y_test"], dtype=torch.float32, device=dev), margin)
    )
    report = res.cv_results_.get("halving")
    mode = "halving" if report is not None else "exhaustive"
    out = {
        "mode": mode,
        "wall_seconds": round(wall, 1),
        "dispatch_seconds": deltas[mode],
        "dispatch_seconds_by_mode": deltas,
        "best_params": res.best_params_,
        "cv_auc": round(float(res.best_score_), 6),
        "test_auc": round(test_auc, 6),
        "mean_test_score": np.round(
            np.asarray(res.cv_results_["mean_test_score"]), 6
        ).tolist(),
    }
    if report is not None:
        out["halving"] = {
            k: report[k]
            for k in ("eta", "budgets", "rungs", "pruned_candidates",
                      "survivors", "dispatches")
        }
    return out


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="bench_search", description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=40_000)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument(
        "--mode", choices=("both", "halving", "exhaustive"), default="both"
    )
    ap.add_argument(
        "--smoke",
        action="store_true",
        help="short profile: small rows/bins, fixed small chunk so the "
        "schedule rungs even at toy scale",
    )
    ap.add_argument(
        "--mini-grid",
        action="store_true",
        help="miniature 6x2 search grid (48-tree cap) instead of the 20x3 "
        "reference grid — the schedule still rungs and prunes",
    )
    ap.add_argument(
        "--chunk-trees",
        default="auto",
        type=lambda s: s if s == "auto" else (None if s == "none" else int(s)),
    )
    ap.add_argument("--eta", type=int, default=2)
    ap.add_argument("--n-bins", type=int, default=None)
    ap.add_argument(
        "--cache-dir",
        default=None,
        help="kernel-build cache dir (default: the package's _build/)",
    )
    ap.add_argument(
        "--force-devices", type=int, default=0,
        help="name the one device this many times as the search's mesh",
    )
    ap.add_argument("--out", default=None)
    ap.add_argument(
        "--trend-out",
        nargs="?",
        const=DEFAULT_TREND,
        default=None,
        help="append this run's warm-dispatch/cache-miss metrics to a trend "
        f"file (default path: {DEFAULT_TREND}; gate with "
        "tools.perf_sentinel check)",
    )
    ap.add_argument(
        "--check",
        action="store_true",
        help="with --mode both: exit nonzero unless halving pruned "
        "candidates, spent fewer dispatch seconds than exhaustive, and "
        "the refit AUC is within the parity margin",
    )
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)

    from cobalt_smart_lender_ai_tpu_torch.compilecache import (
        bootstrap_compile_cache,
        compile_stats,
    )
    from cobalt_smart_lender_ai_tpu_torch.config import (
        CompileCacheConfig,
        GBDTConfig,
        MeshConfig,
        TuneConfig,
    )
    from cobalt_smart_lender_ai_tpu_torch.device import mesh_devices
    from cobalt_smart_lender_ai_tpu_torch.parallel.mesh import make_mesh
    from cobalt_smart_lender_ai_tpu_torch.tools.parity import build_matrices

    cache_dir = bootstrap_compile_cache(CompileCacheConfig(cache_dir=args.cache_dir))

    if args.smoke:
        rows = min(args.rows, 6000)
        n_bins = args.n_bins or 32
        default_chunk = 12 if args.mini_grid else 25
        chunk = args.chunk_trees if args.chunk_trees != "auto" else default_chunk
    else:
        rows = args.rows
        n_bins = args.n_bins or GBDTConfig.n_bins
        chunk = args.chunk_trees

    mats = build_matrices(rows, args.seed, dev)
    base = GBDTConfig().replace(n_bins=n_bins, scale_pos_weight=mats["spw"])

    grid_overrides = {}
    grid_name = "TuneConfig.param_space 20x3 reference grid"
    if args.mini_grid:
        grid_overrides = dict(
            n_iter=6,
            cv_folds=2,
            param_space={
                "n_estimators": (24, 48),
                "max_depth": (2, 3),
                "learning_rate": (0.1, 0.3),
            },
        )
        grid_name = "mini 6x2 grid (48-tree cap)"

    def tune_for(halving: bool) -> TuneConfig:
        return dataclasses.replace(
            TuneConfig(),
            chunk_trees=chunk,
            halving_enabled=halving,
            halving_eta=args.eta,
            **grid_overrides,
        )

    runs = {}
    modes = (
        ("halving", "exhaustive") if args.mode == "both" else (args.mode,)
    )
    with force_devices(args.force_devices, dev) as forced:
        mesh = make_mesh(MeshConfig(), devices=mesh_devices(dev))
        n_devices = device_count(dev)
        for mode in modes:
            print(f"[bench_search] running {mode} search on {rows} rows ...")
            result = run_search(
                mats, tune_for(mode == "halving"), base=base, mesh=mesh, device=dev
            )
            if args.smoke:
                # At smoke scale the first pass's library loads and the
                # allocator's first requests dwarf the tree work the
                # scheduler saves, so the gated comparison is the warm run;
                # the first pass stays in the record as cold_*.
                cold = result
                result = run_search(
                    mats, tune_for(mode == "halving"), base=base, mesh=mesh, device=dev
                )
                result["cold_dispatch_seconds"] = cold["dispatch_seconds"]
                result["cold_wall_seconds"] = cold["wall_seconds"]
            runs[mode] = result
            print(
                f"[bench_search] {mode}: dispatch "
                f"{runs[mode]['dispatch_seconds']}s, wall "
                f"{runs[mode]['wall_seconds']}s, test_auc "
                f"{runs[mode]['test_auc']}"
            )

    out = {
        "bench": "search_halving_vs_exhaustive",
        "rows": rows,
        "seed": args.seed,
        "n_bins": n_bins,
        "chunk_trees": chunk,
        "eta": args.eta,
        "grid": grid_name,
        "backend": platform_tag(dev),
        "n_devices": n_devices,
        "host_cpu_cores": os.cpu_count(),
        "measurement": (
            "warm (second in-process pass per mode; cold_* fields are the "
            "first pass that loaded the libraries)"
            if args.smoke
            else "single cold pass per mode"
        ),
        "compile_cache_dir": cache_dir,
        "compile": compile_stats(),
        "runs": runs,
        "card": card_block(dev),
    }
    if forced is not None:
        out["force_devices"] = forced

    failures = []
    if args.mode == "both":
        h, e = runs["halving"], runs["exhaustive"]
        out["dispatch_seconds_saved"] = round(
            e["dispatch_seconds"] - h["dispatch_seconds"], 3
        )
        out["refit_auc_gap"] = round(h["test_auc"] - e["test_auc"], 6)
        if args.check:
            if "halving" not in h:
                failures.append("halving scheduler did not engage")
            elif h["halving"]["pruned_candidates"] <= 0:
                failures.append("halving pruned no candidates")
            if h["dispatch_seconds"] >= e["dispatch_seconds"]:
                failures.append(
                    "halving dispatch seconds not below exhaustive "
                    f"({h['dispatch_seconds']} vs {e['dispatch_seconds']})"
                )
            if abs(out["refit_auc_gap"]) > 0.005:
                failures.append(
                    f"refit AUC gap {out['refit_auc_gap']} exceeds 0.005"
                )
    out["check_failures"] = failures

    append_trend(args.trend_out, out, "tools.bench_search")
    write_record(out, args.out, indent=2, sort_keys=True)
    if args.out:
        print(f"[bench_search] wrote {args.out}")
    summary(
        "bench_search",
        "search_halving_vs_exhaustive: " + "; ".join(
            f"{m} dispatch {r['dispatch_seconds']} s, test AUC {r['test_auc']}"
            for m, r in runs.items()
        ),
        dev,
    )
    if failures:
        print("[bench_search] CHECK FAILED: " + "; ".join(failures))
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
