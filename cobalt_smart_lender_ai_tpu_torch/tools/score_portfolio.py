"""Portfolio & stress-scenario driver: the offline batch workload.

Streams a portfolio CSV from the object store through the fused scoring
kernel (one margin+SHAP launch per chunk) in checkpointed chunks, sweeps a
counterfactual `ScenarioGrid`, and lands scores, per-scenario deltas and a
JSON scenario report back in the store under ``scenario_runs/<run-id>/``.
A killed run (preemption, OOM, or the deterministic
``--fail-after-chunks`` test hook) resumes with ``--resume`` and produces
scores bit-identical to an uninterrupted run.

Usage:
    python -m cobalt_smart_lender_ai_tpu_torch.tools.score_portfolio \\
        --store artifacts --portfolio portfolios/book.csv \\
        --scenarios scenarios.json --run-id 2026q3-stress [--resume] \\
        [--ledger-out ledger.json] [--trace-out trace.json] [--device cuda|cpu]

The model comes from the registry (``--model-name``/``--channel``, default
the ``latest`` champion) so the report carries version provenance and the
training feature sketch for PSI OOD flagging; ``--model-key`` bypasses the
registry for ad-hoc artifacts. ``--scenarios`` is a JSON file of grid axes::

    {"axes": [{"feature": "installment", "op": "add", "values": [25, 50]},
              {"feature": "annual_inc", "op": "mul", "values": [0.9, 1.0]}]}

``--synthetic-portfolio N`` writes a portfolio of N synthetic loans (after
cleaning, fewer rows) at ``--portfolio`` when the key is absent (CI / demo
bootstrap). ``--device`` defaults to ``cuda`` and fails without a card;
``--device cpu`` scores with the kernel's plain version. ``--shards``
splits each chunk's rows over a dp mesh: 0/1 one device, -1 every visible
device, N an N-way mesh clamped to the visible devices; it is not part of
the resume fingerprint, so a run killed on one mesh resumes on another.
Exit codes: 0 success, 3 interrupted-but-resumable (the
``--fail-after-chunks`` path).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time
from datetime import datetime
from typing import Sequence


def build_synthetic_portfolio(
    store,
    key: str,
    rows: int,
    seed: int,
    device="cuda",
    today: datetime | None = None,
) -> int:
    """A serving-feature portfolio CSV of ``rows`` synthetic loans through
    the host cleaning path (`clean_raw_frame`, `prepare_cleaned_frame`,
    `engineer_features` on ``device``, the 20 serving features), written
    with `ObjectStore.save_frame`. Returns the rows that survived cleaning."""
    import numpy as np

    from cobalt_smart_lender_ai_tpu_torch.data import schema
    from cobalt_smart_lender_ai_tpu_torch.data.clean import clean_raw_frame
    from cobalt_smart_lender_ai_tpu_torch.data.features import (
        engineer_features,
        prepare_cleaned_frame,
    )
    from cobalt_smart_lender_ai_tpu_torch.data.frame import RawFrame
    from cobalt_smart_lender_ai_tpu_torch.data.synthetic import synthetic_lendingclub_frame

    raw = synthetic_lendingclub_frame(n_rows=rows, seed=seed)
    cleaned, _ = clean_raw_frame(raw)
    del raw
    tree_ff, _, _ = engineer_features(prepare_cleaned_frame(cleaned, today=today), device=device)
    ff = tree_ff.select(schema.SERVING_FEATURES)
    X = np.ascontiguousarray(ff.X.cpu().numpy(), dtype=np.float32)
    store.save_frame(key, RawFrame({n: X[:, j] for j, n in enumerate(ff.feature_names)}))
    return int(X.shape[0])


def parse_args(argv: Sequence[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--store", default="artifacts")
    ap.add_argument("--portfolio", default="portfolios/portfolio.csv",
                    help="store key of the portfolio CSV to score")
    ap.add_argument("--scenarios", default=None,
                    help="path to a ScenarioGrid JSON file (omit for a "
                    "baseline-only run)")
    ap.add_argument("--run-id", default=None,
                    help="run-versioned output namespace (default: "
                    "portfolio-<unixtime>)")
    ap.add_argument("--resume", action="store_true",
                    help="continue a killed run with the same --run-id")
    ap.add_argument("--shards", type=int, default=1,
                    help="row shards per chunk: 0/1 one device, -1 all visible "
                    "devices, N an N-way dp mesh (clamped to the host)")
    ap.add_argument("--chunk-rows", type=int, default=2048)
    ap.add_argument("--no-shap", action="store_true",
                    help="skip SHAP attribution (margin-only sweep)")
    ap.add_argument("--model-name", default="gbdt")
    ap.add_argument("--channel", default="latest")
    ap.add_argument("--registry-prefix", default="registry")
    ap.add_argument("--model-key", default=None,
                    help="bypass the registry: load this artifact key "
                    "directly (no provenance / PSI baseline)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="optional wall-clock budget; default None = batch "
                    "runs never abort themselves")
    ap.add_argument("--synthetic-portfolio", type=int, default=None,
                    metavar="ROWS",
                    help="generate a synthetic portfolio of ROWS loans at "
                    "--portfolio when the key does not exist")
    ap.add_argument("--seed", type=int, default=29)
    ap.add_argument("--fail-after-chunks", type=int, default=None,
                    help="deterministic kill hook: raise after K freshly "
                    "scored chunks (exit 3, checkpoint resumable), for "
                    "CI and tests")
    ap.add_argument("--ledger-out", default=None,
                    help="write a run ledger here; render with "
                    "python -m cobalt_smart_lender_ai_tpu_torch.tools.obs_report")
    ap.add_argument("--trace-out", default=None,
                    help="write the run's spans as Perfetto JSON here")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (the default; the CUDA kernel) or cpu (its plain version)")
    return ap.parse_args(argv)


def main(argv: Sequence[str] | None = None) -> int:
    args = parse_args(argv)

    from cobalt_smart_lender_ai_tpu_torch.compilecache import bootstrap_compile_cache
    from cobalt_smart_lender_ai_tpu_torch.device import resolve_device
    from cobalt_smart_lender_ai_tpu_torch.io import GBDTArtifact, ObjectStore
    from cobalt_smart_lender_ai_tpu_torch.reliability.deadline import start_deadline
    from cobalt_smart_lender_ai_tpu_torch.scenario import (
        PortfolioInterrupted,
        PortfolioScorer,
        ScenarioGrid,
        load_portfolio,
    )

    bootstrap_compile_cache()
    dev = resolve_device(args.device)
    store = ObjectStore(args.store)
    run_id = args.run_id or f"portfolio-{int(time.time())}"

    if args.synthetic_portfolio and not store.exists(args.portfolio):
        build_synthetic_portfolio(
            store, args.portfolio, args.synthetic_portfolio, args.seed, dev
        )

    grid = None
    if args.scenarios:
        with open(args.scenarios) as fh:
            grid = ScenarioGrid.from_json(json.load(fh))

    common = dict(
        shards=args.shards,
        chunk_rows=args.chunk_rows,
        compute_shap=not args.no_shap,
        device=dev,
    )
    if args.model_key:
        blob = store.get_bytes(args.model_key + ".npz")
        scorer = PortfolioScorer(
            GBDTArtifact.from_bytes(blob, dev),
            store,
            # The stored bytes' md5 pins the model in the resume fingerprint.
            model_info={"key": args.model_key, "channel": "direct",
                        "md5": hashlib.md5(blob).hexdigest()},
            **common,
        )
    else:
        scorer = PortfolioScorer.from_registry(
            store,
            model_name=args.model_name,
            channel=args.channel,
            registry_prefix=args.registry_prefix,
            **common,
        )

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
            "portfolio",
            meta={
                "run_id": run_id,
                "portfolio": args.portfolio,
                "shards": args.shards,
                "chunk_rows": args.chunk_rows,
                "resume": bool(args.resume),
                "device": str(dev),
            },
        )

    X, portfolio_meta = load_portfolio(
        store, args.portfolio, scorer.artifact.feature_names
    )

    def _finish_artifacts():
        if ledger is not None:
            ledger.write(args.ledger_out)
        if args.trace_out:
            from cobalt_smart_lender_ai_tpu_torch.telemetry import (
                default_tracer,
                render_chrome_trace,
            )

            with open(args.trace_out, "w") as fh:
                fh.write(render_chrome_trace(default_tracer()))

    try:
        report = scorer.run(
            X,
            grid,
            run_id=run_id,
            resume=args.resume,
            deadline=start_deadline(args.deadline_s),
            fail_after_chunks=args.fail_after_chunks,
            ledger=ledger,
            portfolio_meta=portfolio_meta,
        )
    except PortfolioInterrupted as exc:
        if ledger is not None:
            ledger.set(
                "scenario_report",
                {"run_id": run_id, "interrupted": True,
                 "items_done": exc.items_done,
                 "items_total": exc.items_total},
            )
        _finish_artifacts()
        print(json.dumps({
            "run_id": run_id,
            "interrupted": True,
            "items_done": exc.items_done,
            "items_total": exc.items_total,
            "resume_with": "--resume",
        }))
        return 3

    if ledger is not None:
        ledger.fingerprint = report["fingerprint"]
    _finish_artifacts()
    print(json.dumps({
        "run_id": run_id,
        "report_key": report["keys"]["report"],
        "rows": report["portfolio"]["rows"],
        "scenarios": len(report["scenarios"]),
        "chunks_resumed": report["resume"]["chunks_resumed"],
        "chunks_scored": report["resume"]["chunks_scored"],
        "rows_per_second": report["telemetry"]["rows_per_second"],
        "shards": report["partitioner"]["shards"],
        "ood_scenarios": [
            b["id"] for b in report["scenarios"]
            if (b.get("drift") or {}).get("ood")
        ],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
