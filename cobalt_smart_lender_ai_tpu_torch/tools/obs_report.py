"""Render a run ledger as a markdown cost-attribution report, or diff two
(the port's copy of the reference's ``tools/obs_report.py``, whose markdown
it matches byte for byte; it imports nothing of JAX, so it runs on the
card's machine).

The ledger (`telemetry.runledger`, written by the training CLI's and
``tools.retrain``'s and ``tools.score_portfolio``'s ``--ledger-out``)
carries a run's config fingerprint, environment, stage durations, search
rung history, and the kernel cost table from `telemetry.programs`. This
tool turns one ledger into a report of which program the seconds went to,
and two ledgers into an A/B comparison.

Usage:
    python -m cobalt_smart_lender_ai_tpu_torch.tools.obs_report run.json          # render one
    python -m cobalt_smart_lender_ai_tpu_torch.tools.obs_report a.json b.json     # diff two
    python -m cobalt_smart_lender_ai_tpu_torch.tools.obs_report run.json --out REPORT.md
    python -m cobalt_smart_lender_ai_tpu_torch.tools.obs_report run.json --min-attribution 0.8

``--min-attribution R`` exits nonzero when the ledger's measured dispatch
seconds exist but less than fraction R of them is attributed to named
programs: the observatory's coverage gate.
"""

from __future__ import annotations

import argparse
import sys
from typing import Any


def _fmt_s(v: Any) -> str:
    try:
        return f"{float(v):.3f}"
    except (TypeError, ValueError):
        return "-"


def _fmt_rate(v: Any) -> str:
    """Human FLOP/s: 650 -> '650', 2.1e9 -> '2.10 G'."""
    try:
        v = float(v)
    except (TypeError, ValueError):
        return "-"
    for scale, suffix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k")):
        if abs(v) >= scale:
            return f"{v / scale:.2f} {suffix}"
    return f"{v:.0f}"


def _table(headers: list[str], rows: list[list[str]]) -> list[str]:
    out = ["| " + " | ".join(headers) + " |",
           "|" + "|".join("---" for _ in headers) + "|"]
    out += ["| " + " | ".join(r) + " |" for r in rows]
    return out


def render_report(doc: dict) -> str:
    """One ledger -> markdown cost-attribution report."""
    lines: list[str] = []
    lines.append(f"# Run report: {doc.get('kind', '?')}")
    lines.append("")
    fp = doc.get("fingerprint")
    if fp:
        lines.append(f"- config fingerprint: `{fp}`")
    meta = doc.get("meta") or {}
    if meta:
        lines.append(
            "- meta: "
            + ", ".join(f"{k}={v}" for k, v in sorted(meta.items()))
        )
    lines.append(f"- wall: {_fmt_s(doc.get('wall_seconds'))} s")
    env = doc.get("env") or {}
    lines.append(
        "- env: python {py}, jax {jx}, backend {be} x{n}".format(
            py=env.get("python", "?"),
            jx=env.get("jax", "?"),
            be=env.get("backend", "?"),
            n=env.get("device_count", "?"),
        )
    )
    devices = env.get("devices") or []
    if devices:
        kinds: dict[str, int] = {}
        for d in devices:
            kinds[d.get("kind", "?")] = kinds.get(d.get("kind", "?"), 0) + 1
        lines.append(
            "- devices: "
            + ", ".join(f"{n}x {k}" for k, n in sorted(kinds.items()))
        )
    lines.append("")

    stages = doc.get("stages") or {}
    if stages:
        lines.append("## Stages")
        lines.append("")
        total = sum(stages.values())
        lines += _table(
            ["stage", "seconds", "% of stages"],
            [
                [name, _fmt_s(sec),
                 f"{100.0 * sec / total:.1f}%" if total > 0 else "-"]
                for name, sec in sorted(
                    stages.items(), key=lambda kv: -kv[1]
                )
            ],
        )
        # Device-resident ingest splits L1/L2 wall into a host tokenize pass
        # and the device ingest.* programs; quote the host share directly so
        # a trend re-anchor can cite it without re-deriving from the table.
        host_s = stages.get("host_frontier")
        dev_s = stages.get("device_ingest")
        if host_s is not None and dev_s is not None and (host_s + dev_s) > 0:
            lines.append("")
            lines.append(
                f"Ingest host residual: {100.0 * host_s / (host_s + dev_s):.1f}% "
                f"of ingest wall ({_fmt_s(host_s)} stringy-frontier tokenize "
                f"vs {_fmt_s(dev_s)} device programs)."
            )
        lines.append("")

    programs = doc.get("programs") or []
    totals = doc.get("program_totals") or {}
    lines.append("## Program cost table")
    lines.append("")
    if programs:
        attr_total = float(totals.get("dispatch_seconds") or 0.0)
        rows = []
        for p in programs:
            disp_s = float(p.get("dispatch_seconds") or 0.0)
            rows.append([
                f"`{p.get('name', '?')}`",
                str(p.get("dispatches", 0)),
                _fmt_s(disp_s),
                f"{100.0 * disp_s / attr_total:.1f}%"
                if attr_total > 0 else "-",
                str(p.get("compiles", 0)),
                _fmt_s(p.get("compile_seconds")),
                _fmt_rate(p.get("flops")),
                _fmt_rate(p.get("achieved_flops_per_second")),
                "-" if p.get("roofline_utilization") is None
                else f"{100.0 * p['roofline_utilization']:.1f}%",
            ])
        lines += _table(
            ["program", "disp", "disp s", "% attr", "compiles",
             "compile s", "flops/disp", "achieved FLOP/s", "roofline"],
            rows,
        )
    else:
        lines.append("(no programs recorded)")
    lines.append("")

    attr = doc.get("dispatch_attribution") or {}
    measured = attr.get("measured_seconds")
    ratio = attr.get("ratio")
    lines.append("## Dispatch attribution")
    lines.append("")
    lines.append(f"- measured dispatch seconds: {_fmt_s(measured)}")
    lines.append(
        f"- attributed to named programs: {_fmt_s(attr.get('attributed_seconds'))}"
    )
    if ratio is None:
        lines.append("- ratio: n/a (no measured dispatch families this run)")
    else:
        lines.append(f"- ratio: {float(ratio):.3f}")
    lines.append("")

    comp = doc.get("compile") or {}
    if comp:
        lines.append("## Compile cache")
        lines.append("")
        for k in sorted(comp):
            lines.append(f"- {k}: {comp[k]}")
        lines.append("")

    halving = doc.get("search_halving")
    if isinstance(halving, dict) and halving.get("rungs"):
        lines.append("## Search rungs (successive halving)")
        lines.append("")
        lines += _table(
            ["rung", "budget trees", "live", "pruned"],
            [
                [str(i), str(r.get("budget", r.get("budget_trees", "?"))),
                 str(r.get("live", "?")), str(r.get("pruned", "?"))]
                for i, r in enumerate(halving["rungs"])
            ],
        )
        lines.append(
            f"\n- pruned candidates total: "
            f"{halving.get('pruned_candidates', '?')}"
        )
        lines.append("")

    final = doc.get("final_metrics")
    if isinstance(final, dict):
        lines.append("## Final metrics")
        lines.append("")
        for k, v in sorted(final.items()):
            lines.append(f"- {k}: {v}")
        lines.append("")
    return "\n".join(lines).rstrip() + "\n"


def _program_seconds(doc: dict) -> dict[str, float]:
    return {
        p.get("name", "?"): float(p.get("dispatch_seconds") or 0.0)
        for p in (doc.get("programs") or [])
    }


def render_diff(a: dict, b: dict) -> str:
    """Two ledgers -> markdown A/B comparison (B relative to A)."""
    lines: list[str] = []
    lines.append(
        f"# Run diff: {a.get('kind', '?')} (A) vs {b.get('kind', '?')} (B)"
    )
    lines.append("")
    for label, doc in (("A", a), ("B", b)):
        env = doc.get("env") or {}
        lines.append(
            f"- {label}: backend {env.get('backend', '?')} "
            f"x{env.get('device_count', '?')}, "
            f"wall {_fmt_s(doc.get('wall_seconds'))} s, "
            f"fingerprint `{doc.get('fingerprint') or '-'}`"
        )
    if a.get("fingerprint") != b.get("fingerprint"):
        lines.append(
            "- **fingerprints differ** — the sides ran different configs"
        )
    lines.append("")

    sa, sb = a.get("stages") or {}, b.get("stages") or {}
    names = sorted(set(sa) | set(sb), key=lambda n: -(sa.get(n, 0.0)))
    if names:
        lines.append("## Stage deltas (B - A)")
        lines.append("")
        rows = []
        for n in names:
            va, vb = sa.get(n), sb.get(n)
            delta = None if va is None or vb is None else vb - va
            speed = (
                f"{va / vb:.2f}x"
                if va and vb and vb > 0 else "-"
            )
            rows.append([
                n, _fmt_s(va), _fmt_s(vb),
                "-" if delta is None else f"{delta:+.3f}", speed,
            ])
        lines += _table(["stage", "A s", "B s", "delta s", "A/B"], rows)
        lines.append("")

    pa, pb = _program_seconds(a), _program_seconds(b)
    names = sorted(
        set(pa) | set(pb),
        key=lambda n: -max(pa.get(n, 0.0), pb.get(n, 0.0)),
    )
    if names:
        lines.append("## Program dispatch-seconds deltas (B - A)")
        lines.append("")
        rows = []
        for n in names:
            va, vb = pa.get(n), pb.get(n)
            delta = None if va is None or vb is None else vb - va
            rows.append([
                f"`{n}`",
                "-" if va is None else _fmt_s(va),
                "-" if vb is None else _fmt_s(vb),
                "-" if delta is None else f"{delta:+.3f}",
            ])
        lines += _table(["program", "A s", "B s", "delta s"], rows)
        lines.append("")

    fa, fb = a.get("final_metrics") or {}, b.get("final_metrics") or {}
    keys = sorted(
        k for k in set(fa) | set(fb)
        if isinstance(fa.get(k, fb.get(k)), (int, float))
    )
    if keys:
        lines.append("## Final metric deltas (B - A)")
        lines.append("")
        rows = []
        for k in keys:
            va, vb = fa.get(k), fb.get(k)
            delta = (
                None
                if not isinstance(va, (int, float))
                or not isinstance(vb, (int, float))
                else vb - va
            )
            rows.append([
                k, str(va if va is not None else "-"),
                str(vb if vb is not None else "-"),
                "-" if delta is None else f"{delta:+.5f}",
            ])
        lines += _table(["metric", "A", "B", "delta"], rows)
        lines.append("")
    return "\n".join(lines).rstrip() + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("ledger", help="run-ledger JSON path")
    ap.add_argument("ledger_b", nargs="?", default=None,
                    help="second ledger: render an A/B diff instead")
    ap.add_argument("--out", default=None,
                    help="write the markdown here (default: stdout)")
    ap.add_argument("--min-attribution", type=float, default=None,
                    help="exit 1 unless attributed/measured dispatch "
                    "seconds >= this fraction (skipped when the run "
                    "measured no dispatch seconds)")
    args = ap.parse_args(argv)

    from cobalt_smart_lender_ai_tpu_torch.telemetry.runledger import load_ledger

    doc = load_ledger(args.ledger)
    if args.ledger_b:
        text = render_diff(doc, load_ledger(args.ledger_b))
    else:
        text = render_report(doc)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)
    else:
        print(text)

    if args.min_attribution is not None:
        attr = doc.get("dispatch_attribution") or {}
        ratio = attr.get("ratio")
        if ratio is not None and float(ratio) < args.min_attribution:
            print(
                f"attribution ratio {float(ratio):.3f} below the "
                f"--min-attribution {args.min_attribution} gate",
                file=sys.stderr,
            )
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
