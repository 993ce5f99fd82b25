"""Perf sentinel: ingest benchmark artifacts into a trend file and gate
regressions against the rolling baseline (the port's copy of the
reference's ``tools/perf_sentinel.py``).

    # append artifacts (BENCH_*.json, run ledgers, bench harness records)
    python -m cobalt_smart_lender_ai_tpu_torch.tools.perf_sentinel ingest run.json

    # gate the newest row: exit 0 pass, 1 regression, 3 no baseline
    python -m cobalt_smart_lender_ai_tpu_torch.tools.perf_sentinel check

    # render the sparkline trend page
    python -m cobalt_smart_lender_ai_tpu_torch.tools.perf_sentinel render --out trend.html

All math lives in `cobalt_smart_lender_ai_tpu_torch.telemetry.trend`; this
is argv plumbing plus exit codes. `check` prints its report as JSON so CI
logs carry the numbers, not just the verdict. Note argparse itself exits
2 on bad usage, which stays distinct from the gate codes.

The one difference from the reference's CLI is the default of
``--trend``: ``TREND_torch.json``, not the committed ``TREND.json``. That
file's rows are a TPU's and a CPU's numbers, so a row of the card's gated
against their baseline would say nothing about a regression of the port.
It imports no torch, so each call starts in a fraction of a second.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from cobalt_smart_lender_ai_tpu_torch.telemetry import trend as trendlib

EXIT_PASS = 0
EXIT_REGRESSION = 1
EXIT_MISSING_BASELINE = 3

#: The port's trend file (the reference's is the committed ``TREND.json``).
DEFAULT_TREND = "TREND_torch.json"


def _cmd_ingest(args: argparse.Namespace) -> int:
    doc = trendlib.load_trend(args.trend)
    for path in args.files:
        with open(path) as fh:
            text = fh.read()
        # bench.py emits one record per line; tolerate multi-line files too.
        records = []
        try:
            records.append(json.loads(text))
        except json.JSONDecodeError:
            for line in text.splitlines():
                line = line.strip()
                if line.startswith("{"):
                    records.append(json.loads(line))
        for record in records:
            row = trendlib.append_row(
                doc,
                source=os.path.basename(path),
                metrics=trendlib.extract_metrics(record),
                stamp=None if args.no_stamp else time.time(),
            )
            print(f"ingested {path}: {len(row['metrics'])} metrics", file=sys.stderr)
    trendlib.save_trend(doc, args.trend)
    return EXIT_PASS


def _cmd_check(args: argparse.Namespace) -> int:
    doc = trendlib.load_trend(args.trend)
    report = trendlib.check(doc)
    print(json.dumps(report, indent=1, sort_keys=True))
    if report["status"] == "regression":
        return EXIT_REGRESSION
    if report["status"] in ("missing_baseline", "empty"):
        return EXIT_MISSING_BASELINE
    if report["missing"] and args.strict_missing:
        return EXIT_MISSING_BASELINE
    return EXIT_PASS


def _cmd_render(args: argparse.Namespace) -> int:
    doc = trendlib.load_trend(args.trend)
    html = trendlib.render_trend_html(doc)
    with open(args.out, "w") as fh:
        fh.write(html)
    print(f"wrote {args.out}", file=sys.stderr)
    return EXIT_PASS


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="perf_sentinel", description=__doc__.splitlines()[0])
    parser.add_argument(
        "--trend",
        default=DEFAULT_TREND,
        help=f"trend ledger path (default: {DEFAULT_TREND})",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_ingest = sub.add_parser("ingest", help="append benchmark artifacts as trend rows")
    p_ingest.add_argument("files", nargs="+")
    p_ingest.add_argument(
        "--no-stamp",
        action="store_true",
        help="omit stamp_unix (deterministic seeding of committed history)",
    )
    p_ingest.set_defaults(fn=_cmd_ingest)

    p_check = sub.add_parser("check", help="gate the newest row vs the rolling baseline")
    p_check.add_argument(
        "--strict-missing",
        action="store_true",
        help="exit 3 when any gated metric lacks a baseline "
        "(default: warn only if at least one metric was checked)",
    )
    p_check.set_defaults(fn=_cmd_check)

    p_render = sub.add_parser("render", help="write the trend HTML page")
    p_render.add_argument("--out", default="trend.html")
    p_render.set_defaults(fn=_cmd_render)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
