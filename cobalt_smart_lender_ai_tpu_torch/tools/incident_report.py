"""Causal incident forensics over the fleet event journal (the port's copy
of the reference's ``tools/incident_report.py``, whose markdown it matches
byte for byte on the same events; it imports nothing of JAX, so it runs on
the card's machine).

The control plane journals every decision it makes — supervisor
transitions, autoscaler resizes, brownout rungs, canary verdicts, reload
publishes, breaker flips, chaos injections — as typed events whose
``cause_id`` links chain each consequence back to its trigger
(`telemetry.events`). This tool turns that journal into the markdown
postmortem an operator would otherwise reconstruct by hand from four
dashboards: what fired, what caused it, what the data plane saw while it
happened, and how long until the fleet was healthy again.

Sources (either or both):
    --bench RECORD.json     a bench record with the embedded
                            ``events.journal`` snapshot
                            (``{"events": {"journal": [...]}}``)
    --store PATH [--prefix] durable md5-pinned segments shipped by the
                            journal (`telemetry.events.load_events`)

Usage:
    python -m cobalt_smart_lender_ai_tpu_torch.tools.incident_report --bench RECORD.json
    python -m cobalt_smart_lender_ai_tpu_torch.tools.incident_report --store artifacts --out incident.md
    python -m cobalt_smart_lender_ai_tpu_torch.tools.incident_report --bench b.json --window 10:40
    python -m cobalt_smart_lender_ai_tpu_torch.tools.incident_report --bench b.json --require-cause

``--window A:B`` keeps events whose timestamp falls in [A, B]; values
under 1e6 are offsets in seconds from the first event, larger values are
absolute wall timestamps. Either side may be empty (``:30``, ``10:``).

``--require-cause`` is the CI gate: every quarantine transition, resize
and brownout step must carry a cause (trigger snapshot) or a ``cause_id``
link — an orphan means an emit site lost its causal thread. Exit 4 lists
the orphans; exit 2 means the input could not be read.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any

__all__ = [
    "apply_window",
    "build_chains",
    "find_orphans",
    "heal_seconds",
    "load_bench",
    "load_store",
    "main",
    "render_report",
    "suspected_trigger",
]

#: (component, kind) pairs that make a causal tree worth a postmortem
#: section. Routine control-plane churn (retunes, publishes, breaker
#: close) still shows in the totals and event log, just not as an
#: incident of its own.
_INCIDENT_SEVERITY: dict[tuple[str, str], int] = {
    ("supervisor", "probe_failure"): 1,
    ("supervisor", "rebuild"): 2,
    ("supervisor", "swap"): 2,
    ("supervisor", "transition"): 2,
    ("autoscaler", "resize"): 1,
    ("autoscaler", "brownout"): 1,
    ("canary", "reject"): 2,
    ("canary", "rollback"): 2,
    ("reload", "rollback"): 2,
    ("breaker", "open"): 2,
    ("chaos", "inject"): 1,
}

#: Kinds the --require-cause gate audits: the three decisions an operator
#: always asks "why" about. Each must carry a cause snapshot or chain to
#: the event that triggered it.
_GATED = ("supervisor.transition:quarantined", "autoscaler.resize",
          "autoscaler.brownout")


def _gated(event: dict) -> str | None:
    """The gate label this event falls under, or None if ungated."""
    component, kind = event.get("component"), event.get("kind")
    if component == "supervisor" and kind == "transition":
        payload = event.get("payload") or {}
        if payload.get("to") == "quarantined":
            return _GATED[0]
        return None
    if component == "autoscaler" and kind in ("resize", "brownout"):
        return f"{component}.{kind}"
    return None


# -- loading -------------------------------------------------------------------

def load_bench(path: str) -> tuple[list[dict], dict]:
    """Events embedded in a bench record, plus the record itself (its
    load/supervisor/autoscaler blocks become the report's data-plane
    context)."""
    with open(path) as fh:
        doc = json.load(fh)
    block = doc.get("events") or {}
    journal = block.get("journal")
    if not isinstance(journal, list):
        raise ValueError(
            f"{path} has no events.journal block — re-run the bench with "
            "a journal-aware harness"
        )
    return [e for e in journal if isinstance(e, dict)], doc


def load_store(path: str, prefix: str) -> list[dict]:
    from cobalt_smart_lender_ai_tpu_torch.io.store import ObjectStore
    from cobalt_smart_lender_ai_tpu_torch.telemetry.events import load_events

    return load_events(ObjectStore(path), prefix)


def apply_window(events: list[dict], window: str | None) -> list[dict]:
    if not window:
        return events
    lo_s, _, hi_s = window.partition(":")
    t0 = min((float(e.get("t", 0.0)) for e in events), default=0.0)

    def _bound(raw: str) -> float | None:
        if not raw:
            return None
        v = float(raw)
        return t0 + v if abs(v) < 1e6 else v

    lo, hi = _bound(lo_s), _bound(hi_s)
    return [
        e
        for e in events
        if (lo is None or float(e.get("t", 0.0)) >= lo)
        and (hi is None or float(e.get("t", 0.0)) <= hi)
    ]


# -- causal reconstruction -----------------------------------------------------

def build_chains(events: list[dict]) -> list[list[dict]]:
    """Group events into causal trees by walking ``cause_id`` links.

    A root is an event whose cause_id is absent *or* points outside the
    window (its trigger was evicted or filtered — the chain is still
    worth reading from where it starts). Each tree is flattened
    depth-first in event-id order, so a chain reads top-to-bottom as
    trigger -> consequence."""
    by_id = {int(e["event_id"]): e for e in events if "event_id" in e}
    children: dict[int, list[int]] = {}
    roots: list[int] = []
    for eid in sorted(by_id):
        cause = by_id[eid].get("cause_id")
        if cause is not None and int(cause) in by_id:
            children.setdefault(int(cause), []).append(eid)
        else:
            roots.append(eid)

    def _flatten(eid: int, out: list[dict]) -> None:
        out.append(by_id[eid])
        for child in children.get(eid, ()):
            _flatten(child, out)

    trees: list[list[dict]] = []
    for root in roots:
        tree: list[dict] = []
        _flatten(root, tree)
        trees.append(tree)
    return trees


def _severity(tree: list[dict]) -> int:
    return max(
        (
            _INCIDENT_SEVERITY.get((e.get("component"), e.get("kind")), 0)
            for e in tree
        ),
        default=0,
    )


def suspected_trigger(
    tree: list[dict], events: list[dict]
) -> dict | None:
    """The most recent same-replica ``chaos.inject`` preceding the chain's
    root. Chaos faults surface to the supervisor only as probe failures,
    so the causal link is circumstantial by design — the report names the
    suspect rather than silently claiming certainty."""
    root = tree[0]
    if (root.get("component"), root.get("kind")) == ("chaos", "inject"):
        return None
    replicas = {e.get("replica") for e in tree if e.get("replica") is not None}
    if not replicas:
        return None
    best = None
    for e in events:
        if (e.get("component"), e.get("kind")) != ("chaos", "inject"):
            continue
        if e.get("replica") not in replicas:
            continue
        if float(e.get("t", 0.0)) > float(root.get("t", 0.0)):
            continue
        if best is None or float(e["t"]) > float(best["t"]):
            best = e
    return best


def heal_seconds(tree: list[dict]) -> float | None:
    """Quarantine -> healthy wall time within one chain, if both ends are
    present."""
    t_q = t_h = None
    for e in tree:
        if (e.get("component"), e.get("kind")) != ("supervisor", "transition"):
            continue
        to = (e.get("payload") or {}).get("to")
        if to == "quarantined" and t_q is None:
            t_q = float(e.get("t", 0.0))
        if to == "healthy" and t_q is not None:
            t_h = float(e.get("t", 0.0))
    if t_q is None or t_h is None:
        return None
    return round(t_h - t_q, 3)


def find_orphans(events: list[dict]) -> list[dict]:
    """Gated events carrying neither a cause snapshot nor a cause link."""
    return [
        e
        for e in events
        if _gated(e) is not None
        and not e.get("cause")
        and e.get("cause_id") is None
    ]


# -- rendering -----------------------------------------------------------------

def _payload_brief(event: dict, limit: int = 4) -> str:
    payload = event.get("payload") or {}
    parts = [
        f"{k}={payload[k]}"
        for k in list(payload)[:limit]
        if not isinstance(payload[k], (dict, list))
    ]
    return ", ".join(parts) if parts else "-"


def _chain_table(tree: list[dict], t0: float) -> list[str]:
    rows = []
    for e in tree:
        rows.append(
            "| {eid} | +{dt:.2f}s | {ck} | {rep} | {cause} | {detail} |".format(
                eid=e.get("event_id", "?"),
                dt=float(e.get("t", t0)) - t0,
                ck=f"{e.get('component')}.{e.get('kind')}",
                rep="-" if e.get("replica") is None else e["replica"],
                cause="-" if e.get("cause_id") is None else e["cause_id"],
                detail=_payload_brief(e),
            )
        )
    return [
        "| event | t | what | replica | cause | detail |",
        "|---|---|---|---|---|---|",
        *rows,
    ]


def render_report(
    events: list[dict],
    *,
    source: str,
    bench: dict | None = None,
    window: str | None = None,
) -> str:
    lines: list[str] = ["# Fleet incident report", ""]
    lines.append(f"- source: {source}")
    if window:
        lines.append(f"- window: `{window}`")
    lines.append(f"- events: {len(events)}")
    if not events:
        lines.append("")
        lines.append("No control-plane events in the window — nothing fired.")
        return "\n".join(lines) + "\n"
    t0 = min(float(e.get("t", 0.0)) for e in events)
    span = max(float(e.get("t", 0.0)) for e in events) - t0
    lines.append(f"- span: {span:.2f}s")
    lines.append("")

    counts: dict[str, int] = {}
    for e in events:
        key = f"{e.get('component')}.{e.get('kind')}"
        counts[key] = counts.get(key, 0) + 1
    lines.append("## What fired")
    lines.append("")
    lines.append("| event kind | count |")
    lines.append("|---|---|")
    for key in sorted(counts):
        lines.append(f"| {key} | {counts[key]} |")
    lines.append("")

    if bench is not None:
        lines += _bench_context(bench)

    trees = build_chains(events)
    incidents = [t for t in trees if _severity(t) >= 2]
    minor = [t for t in trees if _severity(t) == 1 and len(t) > 1]
    lines.append("## Incidents")
    lines.append("")
    if not incidents and not minor:
        lines.append("No incident-grade causal chains — routine churn only.")
        lines.append("")
    for n, tree in enumerate(incidents + minor, start=1):
        root = tree[0]
        title = f"{root.get('component')}.{root.get('kind')}"
        if root.get("replica") is not None:
            title += f" (replica {root['replica']})"
        lines.append(f"### Incident {n}: {title}")
        lines.append("")
        trigger = suspected_trigger(tree, events)
        if trigger is not None:
            lines.append(
                "- suspected trigger: `chaos.inject` "
                f"fault={((trigger.get('payload') or {}).get('fault'))!r} on "
                f"replica {trigger.get('replica')} at "
                f"+{float(trigger.get('t', t0)) - t0:.2f}s "
                f"(event {trigger.get('event_id')})"
            )
        heal = heal_seconds(tree)
        if heal is not None:
            lines.append(f"- time to healthy: **{heal:.3f}s**")
        cause = root.get("cause")
        if cause:
            brief = ", ".join(
                f"{k}={v}"
                for k, v in list(cause.items())[:4]
                if not isinstance(v, (dict, list))
            )
            if brief:
                lines.append(f"- root cause snapshot: {brief}")
        lines.append("")
        lines += _chain_table(tree, t0)
        lines.append("")

    orphans = find_orphans(events)
    lines.append("## Causal coverage")
    lines.append("")
    gated = [e for e in events if _gated(e) is not None]
    lines.append(
        f"- gated events (quarantine/resize/brownout): {len(gated)}, "
        f"orphans (no cause, no cause_id): {len(orphans)}"
    )
    for e in orphans:
        lines.append(
            f"  - ORPHAN event {e.get('event_id')}: "
            f"{e.get('component')}.{e.get('kind')} at "
            f"+{float(e.get('t', t0)) - t0:.2f}s"
        )
    lines.append("")
    return "\n".join(lines) + "\n"


def _bench_context(bench: dict) -> list[str]:
    """What the data plane saw while the control plane acted."""
    lines = ["## Data plane during the run", ""]
    load = bench.get("load") or {}
    if load:
        lines.append(
            "- load: {req} requests, {err} errors ({unt} untyped), "
            "p99 {p99} ms".format(
                req=load.get("requests", "?"),
                err=load.get("errors", "?"),
                unt=load.get("untyped_errors", "?"),
                p99=load.get("p99_ms", "?"),
            )
        )
    sup = bench.get("supervisor") or {}
    if sup:
        lines.append(
            "- supervisor: {q} quarantines, {r} rebuilds ok, heal "
            "{h}s, all healthy at end: {a}".format(
                q=sup.get("quarantines", "?"),
                r=sup.get("rebuilds_ok", "?"),
                h=sup.get("heal_s", "?"),
                a=sup.get("all_healthy", "?"),
            )
        )
    scaler = bench.get("autoscaler") or {}
    if scaler:
        lines.append(
            "- autoscaler: {u} up / {d} down, brownout engaged {e} / "
            "released {rel}, max level {m}".format(
                u=scaler.get("resizes_up", "?"),
                d=scaler.get("resizes_down", "?"),
                e=scaler.get("brownout_engaged", "?"),
                rel=scaler.get("brownout_released", "?"),
                m=scaler.get("max_level_seen", "?"),
            )
        )
    stats = (bench.get("events") or {}).get("stats") or {}
    if stats:
        lines.append(
            "- journal: {n} emitted, {drop} dropped, ring depth "
            "{depth}/{cap}".format(
                n=stats.get("emitted", "?"),
                drop=stats.get("dropped", "?"),
                depth=stats.get("depth", "?"),
                cap=stats.get("capacity", "?"),
            )
        )
    lines.append("")
    return lines


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bench", default=None,
                    help="bench record JSON with an events.journal block")
    ap.add_argument("--store", default=None,
                    help="object store path holding shipped journal segments")
    ap.add_argument("--prefix", default="telemetry/events",
                    help="segment key prefix under --store")
    ap.add_argument("--window", default=None, metavar="A:B",
                    help="keep events in [A, B] (relative seconds when "
                         "< 1e6, else absolute wall timestamps)")
    ap.add_argument("--require-cause", action="store_true",
                    help="exit 4 if any quarantine/resize/brownout event "
                         "carries neither a cause nor a cause_id link")
    ap.add_argument("--out", default=None,
                    help="write the markdown report here (default stdout)")
    args = ap.parse_args(argv)

    if args.bench is None and args.store is None:
        ap.error("need --bench and/or --store")

    events: list[dict] = []
    bench_doc: dict | None = None
    sources: list[str] = []
    try:
        if args.bench is not None:
            bench_events, bench_doc = load_bench(args.bench)
            events += bench_events
            sources.append(f"bench `{args.bench}`")
        if args.store is not None:
            events += load_store(args.store, args.prefix)
            sources.append(f"store `{args.store}` prefix `{args.prefix}`")
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    # merge + dedup by event_id (bench snapshot and shipped segments overlap)
    merged = {int(e["event_id"]): e for e in events if "event_id" in e}
    events = [merged[eid] for eid in sorted(merged)]
    events = apply_window(events, args.window)

    report = render_report(
        events,
        source=" + ".join(sources),
        bench=bench_doc,
        window=args.window,
    )
    if args.out:
        Path(args.out).write_text(report)
        print(f"wrote {args.out}", file=sys.stderr)
    else:
        print(report)

    if args.require_cause:
        orphans = find_orphans(events)
        if orphans:
            print(
                f"require-cause: {len(orphans)} orphan event(s) — a "
                "quarantine/resize/brownout lost its causal link:",
                file=sys.stderr,
            )
            for e in orphans:
                print(
                    f"  event {e.get('event_id')} "
                    f"{e.get('component')}.{e.get('kind')} "
                    f"payload={e.get('payload')}",
                    file=sys.stderr,
                )
            return 4
        gated = [e for e in events if _gated(e) is not None]
        print(
            f"require-cause: OK ({len(gated)} gated events, 0 orphans)",
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
