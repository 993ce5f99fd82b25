"""Performance trend ledger: BENCH records + run ledgers -> a trend file
(the port's copy of the reference's ``telemetry/trend.py``, with the same
schema, window, policies, sniffers, verdicts and page).

The committed BENCH_*.json records and the per-run ledgers each answer
"how fast was THIS run"; nothing answered "is this run slower than the
last five". This module gives that question a file: ``TREND.json`` is an
append-only list of rows, one per ingested benchmark artifact, each row
carrying a flat ``{metric_name: value}`` map extracted from whatever
shape the artifact has (the `ingest` sniffers below understand every
committed BENCH shape, the bench harnesses' records, and
`telemetry.runledger` ledgers).

`check` gates the newest row against a rolling baseline — the median of
up to the last `BASELINE_WINDOW` prior rows that carry the same metric —
with per-metric-kind tolerances:

- throughput (``qps`` / ``rows_per_s*``): must stay >= 0.7x baseline;
- tail latency (``p99.9``/``p999``): must stay <= 1.5x baseline;
- warm dispatch wall (``*dispatch_seconds``): must stay <= 1.25x;
- compile-cache misses: at most baseline + 2 (a new bucket shape is one
  miss; a cache regression is dozens).

Metrics matching no policy are tracked (they render on the trend page
and feed future baselines) but never gate. A gated metric with no prior
rows is reported as ``missing`` — CI warns instead of failing, so the
first run after adding a metric doesn't break the build.

`tools.perf_sentinel` is the CLI over this module; a harness appends its
fresh record through `append_record`. The port's trend file is not the
reference's committed ``TREND.json``, whose rows are TPU and CPU numbers
(`tools.perf_sentinel` says why).
"""

from __future__ import annotations

import json
import math
import os
import statistics
from typing import Any

__all__ = [
    "BASELINE_WINDOW",
    "TREND_SCHEMA",
    "append_record",
    "append_row",
    "check",
    "extract_metrics",
    "load_trend",
    "new_trend",
    "policy_for",
    "render_trend_html",
    "save_trend",
]

TREND_SCHEMA = 1

#: Rolling-baseline depth: the median of up to this many prior rows.
BASELINE_WINDOW = 5


# --- gate policies ------------------------------------------------------------


def policy_for(name: str) -> dict | None:
    """Gate policy for a metric name, or None for tracked-only metrics.

    Matching is by name shape so every ingester stays honest: any metric
    it emits with a throughput/tail/dispatch/cache-miss name is gated
    automatically, with no second registry to keep in sync.
    """
    leaf = name.rsplit(".", 1)[-1]
    if "cache_misses" in leaf:
        return {"kind": "slack_max", "slack": 2.0, "direction": "lower"}
    if "p999" in leaf or "p99.9" in leaf:
        return {"kind": "ratio_max", "limit": 1.5, "direction": "lower"}
    if leaf.endswith("dispatch_seconds"):
        return {"kind": "ratio_max", "limit": 1.25, "direction": "lower"}
    if leaf == "qps" or leaf.startswith("rows_per_s") or (
        "rows_per_sec" in leaf
    ):
        return {"kind": "ratio_min", "limit": 0.7, "direction": "higher"}
    return None


# --- artifact sniffers --------------------------------------------------------


def _finite(value: Any) -> float | None:
    try:
        v = float(value)
    except (TypeError, ValueError):
        return None
    return v if math.isfinite(v) else None


def _put(metrics: dict, name: str, value: Any) -> None:
    v = _finite(value)
    if v is not None:
        metrics[name] = v


def _from_headline(record: dict, metrics: dict) -> None:
    """bench.py's one-line record / BENCH_PROTOCOL: {metric, value, ...}."""
    name = record.get("metric")
    if isinstance(name, str) and name:
        _put(metrics, name, record.get("value"))


def _from_serve_throughput(record: dict, metrics: dict) -> None:
    """BENCH_SERVE_r01/r02 + bench_serve's default record. The client
    count joins the series name: a 4-client CI smoke and a 32-client
    bench measure different workloads and must never share a baseline."""
    clients = record.get("clients")
    prefix = f"serve.c{int(clients)}" if clients else "serve"
    for mode, row in (record.get("results") or {}).items():
        if not isinstance(row, dict):
            continue
        _put(metrics, f"{prefix}.{mode}.qps", row.get("qps"))
        _put(metrics, f"{prefix}.{mode}.p99_ms", row.get("p99_ms"))
        _put(metrics, f"{prefix}.{mode}.p999_ms", row.get("p99.9_ms"))


def _from_serve_async(record: dict, metrics: dict) -> None:
    """BENCH_SERVE_r03 / bench_serve --async-clients: impl x client grid."""
    for impl, cells in (record.get("results") or {}).items():
        if not isinstance(cells, dict):
            continue
        for cell, row in cells.items():
            if not isinstance(row, dict):
                continue
            base = f"serve_async.{impl}.{cell}"
            _put(metrics, f"{base}.qps", row.get("qps"))
            _put(metrics, f"{base}.p999_ms", row.get("p99.9_ms"))


def _from_serve_chaos(record: dict, metrics: dict) -> None:
    """BENCH_CHAOS / bench_serve --chaos: the self-healing fleet under
    injected replica kills and hangs. ``qps`` and ``p999`` auto-gate by
    name shape against their own chaos baseline; errors / untyped / heal
    seconds ride along tracked-only (the hard ``== 0`` and ``< 30s`` gates
    live in the chaos-fleet CI job, which reads the record directly)."""
    load = record.get("load") or {}
    _put(metrics, "serve.chaos.qps", load.get("qps"))
    _put(metrics, "serve.chaos.p999_ms", load.get("p99.9_ms"))
    _put(metrics, "serve.chaos.errors", load.get("errors"))
    _put(metrics, "serve.chaos.untyped", load.get("untyped_errors"))
    sup = record.get("supervisor") or {}
    _put(metrics, "serve.chaos.heal_s", sup.get("heal_s"))


def _from_serve_traffic(record: dict, metrics: dict) -> None:
    """BENCH_TRAFFIC / bench_serve --traffic: the load-adaptive fleet under
    an open-loop arrival shape. The shape joins the series name — a
    flash-crowd run and a diurnal run measure different workloads. ``qps``
    and ``p999`` auto-gate by name shape; errors / untyped ride along
    tracked-only (the hard ``== 0`` gates live in the autoscale-smoke CI
    job, which reads the record directly)."""
    shape = (record.get("traffic") or {}).get("shape") or "unknown"
    load = record.get("load") or {}
    base = f"serve.traffic.{shape}"
    _put(metrics, f"{base}.qps", load.get("qps"))
    _put(metrics, f"{base}.p999_ms", load.get("p99.9_ms"))
    _put(metrics, f"{base}.errors", load.get("errors"))
    _put(metrics, f"{base}.untyped", load.get("untyped_errors"))


def _from_bulk(record: dict, metrics: dict) -> None:
    """BENCH_BULK_r01 / bench_serve --bulk: best shard plan throughput."""
    best = None
    for row in (record.get("results") or {}).values():
        v = _finite(row.get("rows_per_s")) if isinstance(row, dict) else None
        if v is not None and (best is None or v > best):
            best = v
    if best is not None:
        metrics["bulk.best.rows_per_s"] = best


def _from_pipeline_ingest(record: dict, metrics: dict) -> None:
    """BENCH_PIPE / tools/bench_pipeline.py: host-vs-device ingest rows/s
    per size. The row count joins the series name so each size gates
    against its own baseline (`rows_per_s` leaves auto-gate at 0.7x)."""
    for size, row in (record.get("results") or {}).items():
        if not isinstance(row, dict):
            continue
        for path in ("host", "device"):
            cell = row.get(path)
            if isinstance(cell, dict):
                _put(
                    metrics,
                    f"pipe.{size}.{path}.rows_per_s",
                    cell.get("rows_per_s"),
                )


def _from_bench_kernel(record: dict, metrics: dict) -> None:
    """BENCH_KERNEL / tools/bench_kernels.py: fused vs reference scoring
    dispatch wall at serving bucket sizes, per forest precision. Bucket and
    precision join the series name so every (impl, precision, bucket) cell
    gates against its own baseline — the ``dispatch_seconds`` leaf
    auto-gates at 1.25x lower-is-better by name shape."""
    for prec, buckets in (record.get("results") or {}).items():
        if not isinstance(buckets, dict):
            continue
        for bucket, row in buckets.items():
            if not isinstance(row, dict):
                continue
            for impl in ("fused", "reference"):
                cell = row.get(impl)
                if isinstance(cell, dict):
                    _put(
                        metrics,
                        f"kernel.{impl}.{prec}.b{bucket}.dispatch_seconds",
                        cell.get("dispatch_seconds"),
                    )


def _from_search(record: dict, metrics: dict) -> None:
    """BENCH_SEARCH / BENCH_SEARCH_WARM / tools/bench_search.py output."""
    compile_block = record.get("compile") or {}
    _put(
        metrics,
        "search.compile.cache_misses",
        compile_block.get("cache_misses"),
    )
    for mode, run in (record.get("runs") or {}).items():
        if isinstance(run, dict):
            _put(
                metrics,
                f"search.{mode}.warm_dispatch_seconds",
                run.get("dispatch_seconds"),
            )


def _from_ledger(record: dict, metrics: dict) -> None:
    """telemetry.runledger documents (schema >= 1)."""
    kind = record.get("kind") or "run"
    attribution = record.get("dispatch_attribution") or {}
    measured = _finite(attribution.get("measured_seconds"))
    if measured is not None and measured > 0:
        metrics[f"ledger.{kind}.warm_dispatch_seconds"] = measured
    compile_block = record.get("compile") or {}
    _put(
        metrics,
        f"ledger.{kind}.compile_cache_misses",
        compile_block.get("cache_misses"),
    )
    _put(metrics, f"ledger.{kind}.wall_seconds", record.get("wall_seconds"))


def extract_metrics(record: dict) -> dict[str, float]:
    """Flat gateable metrics from any known benchmark-artifact shape.

    Unknown shapes return {} (the row is still appended, as provenance);
    a BENCH_rNN wrapper whose run failed (``rc != 0`` / ``parsed: null``)
    also yields {} rather than raising — seeded history must tolerate
    the committed failure record.
    """
    metrics: dict[str, float] = {}
    if not isinstance(record, dict):
        return metrics
    if "cmd" in record and "parsed" in record:  # BENCH_rNN driver wrapper
        parsed = record.get("parsed")
        if isinstance(parsed, dict) and record.get("rc", 0) == 0:
            _from_headline(parsed, metrics)
            extra = parsed.get("protocol")
            if isinstance(extra, dict):
                _put(
                    metrics,
                    "full_protocol_rows_per_sec_per_chip",
                    extra.get("rows_per_sec_per_chip"),
                )
        return metrics
    bench = record.get("bench")
    if bench == "serve_throughput":
        _from_serve_throughput(record, metrics)
    elif bench == "serve_async_http":
        _from_serve_async(record, metrics)
    elif bench == "serve_chaos":
        _from_serve_chaos(record, metrics)
    elif bench == "serve_traffic":
        _from_serve_traffic(record, metrics)
    elif bench == "bulk_scoring":
        _from_bulk(record, metrics)
    elif bench == "search_halving_vs_exhaustive":
        _from_search(record, metrics)
    elif bench == "pipeline_ingest":
        _from_pipeline_ingest(record, metrics)
    elif bench == "score_kernels":
        _from_bench_kernel(record, metrics)
    elif "schema" in record and "kind" in record:
        _from_ledger(record, metrics)
    elif "metric" in record and "value" in record:
        _from_headline(record, metrics)
    return metrics


# --- the trend document -------------------------------------------------------


def new_trend() -> dict:
    return {"schema": TREND_SCHEMA, "rows": []}


def load_trend(path: str) -> dict:
    """Load TREND.json; a missing file is an empty trend (first ingest
    creates it)."""
    if not os.path.exists(path):
        return new_trend()
    with open(path) as fh:
        doc = json.load(fh)
    if not isinstance(doc, dict) or not isinstance(doc.get("rows"), list):
        raise ValueError(f"{path} is not a trend document")
    return doc


def save_trend(trend: dict, path: str) -> None:
    with open(path, "w") as fh:
        json.dump(trend, fh, indent=1, sort_keys=True)
        fh.write("\n")


def append_row(
    trend: dict,
    *,
    source: str,
    metrics: dict[str, float],
    meta: dict | None = None,
    stamp: float | None = None,
) -> dict:
    """Append one row; returns it. Rows are ordered, never rewritten —
    the rolling baseline depends on append-only history."""
    row: dict[str, Any] = {
        "source": source,
        "metrics": {k: metrics[k] for k in sorted(metrics)},
    }
    if meta:
        row["meta"] = meta
    if stamp is not None:
        row["stamp_unix"] = round(float(stamp), 3)
    trend["rows"].append(row)
    return row


def append_record(
    trend_path: str,
    record: dict,
    *,
    source: str,
    meta: dict | None = None,
    stamp: float | None = None,
) -> dict:
    """One-call ingest for the bench harnesses' ``--trend-out`` flag:
    load (or create) TREND.json, extract, append, save."""
    trend = load_trend(trend_path)
    row = append_row(
        trend,
        source=source,
        metrics=extract_metrics(record),
        meta=meta,
        stamp=stamp,
    )
    save_trend(trend, trend_path)
    return row


# --- the gate -----------------------------------------------------------------


def _baseline(rows: list[dict], name: str) -> tuple[float | None, int]:
    """Median of up to BASELINE_WINDOW most-recent prior values of
    ``name`` (rows newest-last; the last row is the candidate, callers
    pass rows[:-1])."""
    values: list[float] = []
    for row in reversed(rows):
        v = _finite((row.get("metrics") or {}).get(name))
        if v is not None:
            values.append(v)
            if len(values) >= BASELINE_WINDOW:
                break
    if not values:
        return None, 0
    return float(statistics.median(values)), len(values)


def check(trend: dict) -> dict:
    """Gate the newest row against the rolling baseline.

    Returns ``{status, checked, regressions, missing}`` where status is
    ``pass`` / ``regression`` / ``missing_baseline`` / ``empty``. Only
    the newest row is judged — committed history is settled.
    """
    rows = trend.get("rows") or []
    if not rows:
        return {
            "status": "empty",
            "checked": [],
            "regressions": [],
            "missing": [],
        }
    head, prior = rows[-1], rows[:-1]
    checked: list[dict] = []
    regressions: list[dict] = []
    missing: list[dict] = []
    for name, value in sorted((head.get("metrics") or {}).items()):
        policy = policy_for(name)
        if policy is None:
            continue
        baseline, n = _baseline(prior, name)
        entry = {
            "metric": name,
            "value": value,
            "baseline": baseline,
            "baseline_n": n,
            "policy": policy,
        }
        if baseline is None:
            missing.append(entry)
            continue
        if policy["kind"] == "ratio_max":
            entry["limit"] = round(baseline * policy["limit"], 6)
            ok = value <= entry["limit"]
        elif policy["kind"] == "ratio_min":
            entry["limit"] = round(baseline * policy["limit"], 6)
            ok = value >= entry["limit"]
        else:  # slack_max
            entry["limit"] = baseline + policy["slack"]
            ok = value <= entry["limit"]
        entry["ok"] = ok
        checked.append(entry)
        if not ok:
            regressions.append(entry)
    status = "pass"
    if regressions:
        status = "regression"
    elif missing and not checked:
        status = "missing_baseline"
    return {
        "status": status,
        "source": head.get("source"),
        "checked": checked,
        "regressions": regressions,
        "missing": missing,
    }


# --- rendering ----------------------------------------------------------------


def render_trend_html(trend: dict, *, title: str = "cobalt perf trend") -> str:
    """Stdlib-HTML trend page: one sparkline per metric over the row
    history plus the latest gate verdict — the CI artifact next to the
    serving /dashboard."""
    import html as _html

    from cobalt_smart_lender_ai_tpu_torch.telemetry.timeseries import sparkline_svg

    rows = trend.get("rows") or []
    by_metric: dict[str, list[tuple[float, float]]] = {}
    for i, row in enumerate(rows):
        for name, value in (row.get("metrics") or {}).items():
            v = _finite(value)
            if v is not None:
                by_metric.setdefault(name, []).append((float(i), v))
    report = check(trend)
    verdict = {e["metric"]: e for e in report["checked"]}
    parts = [
        "<!DOCTYPE html><html><head><meta charset='utf-8'>",
        f"<title>{_html.escape(title)}</title>",
        "<style>body{font-family:system-ui,sans-serif;margin:1.5rem;"
        "background:#fafafa}table{border-collapse:collapse}"
        "td,th{padding:.3rem .7rem;border-bottom:1px solid #ddd;"
        "text-align:left;font-size:.85rem}.bad{color:#b00020;"
        "font-weight:600}.ok{color:#1b5e20}</style></head><body>",
        f"<h1>{_html.escape(title)}</h1>",
        f"<p>{len(rows)} rows; latest source: "
        f"<code>{_html.escape(str(report.get('source')))}</code>; "
        f"gate: <strong class="
        f"{'bad' if report['status'] == 'regression' else 'ok'}>"
        f"{_html.escape(report['status'])}</strong></p>",
        "<table><tr><th>metric</th><th>trend</th><th>latest</th>"
        "<th>baseline</th><th>gate</th></tr>",
    ]
    for name in sorted(by_metric):
        points = by_metric[name]
        latest = points[-1][1]
        entry = verdict.get(name)
        if entry is None:
            gate = "tracked"
            cls = ""
        elif entry["ok"]:
            gate = f"ok (limit {entry['limit']:g})"
            cls = " class=ok"
        else:
            gate = f"REGRESSION (limit {entry['limit']:g})"
            cls = " class=bad"
        baseline = "" if entry is None else f"{entry['baseline']:g}"
        parts.append(
            f"<tr><td><code>{_html.escape(name)}</code></td>"
            f"<td>{sparkline_svg(points)}</td>"
            f"<td>{latest:g}</td><td>{baseline}</td>"
            f"<td{cls}>{_html.escape(gate)}</td></tr>"
        )
    parts.append("</table></body></html>")
    return "".join(parts)
