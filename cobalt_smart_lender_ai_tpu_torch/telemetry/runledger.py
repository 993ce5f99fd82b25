"""Run ledgers: one JSON artifact per run, carrying everything a cost
investigation needs to NOT re-run the workload.

The training CLI's ``--ledger-out`` writes one per run — config
fingerprint, device/environment identity (torch, CUDA, each card's name),
stage durations, search rung/prune history, the final metrics snapshot,
and the kernel cost table from `telemetry.programs` — in the reference's
schema, so the reference's ``tools/obs_report.py`` renders one ledger as a
markdown cost-attribution report or diffs two.

A ledger is a plain dict once finalized; `load_ledger` round-trips the
file. Schema changes bump ``schema`` so old ledgers stay diffable.
"""

from __future__ import annotations

import json
import os
import platform
import sys
import time
from typing import Any, Callable, Mapping

__all__ = ["RunLedger", "load_ledger"]

SCHEMA_VERSION = 1

#: Metric families whose values ARE measured dispatch wall — the
#: denominator of the attribution ratio obs_report gates on (the
#: reference's list; the port publishes the bulk and ingest families).
#: Counters are summed across label sets; histograms contribute their _sum.
_DISPATCH_SECONDS_FAMILIES: tuple[str, ...] = (
    "cobalt_search_dispatch_seconds",
    "cobalt_bulk_dispatch_seconds",
    "cobalt_portfolio_dispatch_seconds",
    "cobalt_ingest_dispatch_seconds",
)


def _env_block() -> dict[str, Any]:
    import torch

    from cobalt_smart_lender_ai_tpu_torch.telemetry.devices import (
        device_info,
        host_rss_bytes,
    )

    cuda = torch.cuda.is_available()
    env: dict[str, Any] = {
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "hostname": platform.node(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 0,
    }
    env["devices"] = device_info()
    rss = host_rss_bytes()
    if rss is not None:
        env["host_rss_bytes"] = rss
    return env


def _measured_dispatch_seconds(metrics_snapshot: Mapping[str, Any]) -> float:
    total = 0.0
    for fam in _DISPATCH_SECONDS_FAMILIES:
        block = metrics_snapshot.get(fam)
        if not isinstance(block, Mapping):
            continue
        for sample in block.get("samples", ()):
            if "value" in sample:
                total += float(sample["value"])
            elif "sum" in sample:
                total += float(sample["sum"])
    return total


class RunLedger:
    """Accumulates a run's facts, then `finalize`/`write` snapshots the
    process-wide program table, compile stats, and metrics alongside them.

    Usage::

        ledger = RunLedger("pipeline", fingerprint=fp)
        ledger.add_stage("search", 12.3)
        ledger.set("search", halving_report)
        ledger.set("final_metrics", {"test_auc": 0.79})
        ledger.write("ledger.json")
    """

    def __init__(
        self,
        kind: str,
        *,
        fingerprint: str | None = None,
        meta: Mapping[str, Any] | None = None,
        clock: Callable[[], float] = time.time,
    ) -> None:
        self.kind = kind
        self.fingerprint = fingerprint
        self.meta = dict(meta or {})
        self._clock = clock
        self.created_unix = clock()
        self.stages: dict[str, float] = {}
        self.extras: dict[str, Any] = {}

    def add_stage(self, name: str, seconds: float) -> None:
        self.stages[name] = self.stages.get(name, 0.0) + max(
            0.0, float(seconds)
        )

    def add_stages(self, timings: Mapping[str, float]) -> None:
        for name, seconds in timings.items():
            self.add_stage(name, seconds)

    def set(self, key: str, value: Any) -> None:
        """Attach an arbitrary JSON-able block (search report, final
        metrics, bench headline, ...)."""
        self.extras[key] = value

    def finalize(self, *, registry: Any | None = None) -> dict[str, Any]:
        """Snapshot everything into one JSON-able dict. ``registry``
        defaults to the process-wide metrics registry (resolved now, so a
        test-swapped registry is honored)."""
        from cobalt_smart_lender_ai_tpu_torch.compilecache import compile_stats
        from cobalt_smart_lender_ai_tpu_torch.ops._build import build_stats
        from cobalt_smart_lender_ai_tpu_torch.telemetry.metrics import (
            default_registry,
        )
        from cobalt_smart_lender_ai_tpu_torch.telemetry.programs import (
            default_program_registry,
        )

        reg = registry if registry is not None else default_registry()
        try:
            metrics = reg.snapshot()
        except Exception:  # a broken collect callback must not lose the run
            metrics = {}
        progs = default_program_registry()
        programs = progs.table()
        totals = progs.totals()
        measured = _measured_dispatch_seconds(metrics)
        attributed = float(totals["dispatch_seconds"])
        doc: dict[str, Any] = {
            "schema": SCHEMA_VERSION,
            "kind": self.kind,
            "created_unix": round(self.created_unix, 3),
            "wall_seconds": round(self._clock() - self.created_unix, 6),
            "fingerprint": self.fingerprint,
            "meta": self.meta,
            "env": _env_block(),
            "stages": {k: round(v, 6) for k, v in self.stages.items()},
            "programs": programs,
            "program_totals": totals,
            "dispatch_attribution": {
                "measured_seconds": round(measured, 6),
                "attributed_seconds": round(attributed, 6),
                # ratio > 1 is possible (serving programs measured directly
                # are not part of the measured families); obs_report clamps
                # for display but gates on the raw value.
                "ratio": None
                if measured <= 0
                else round(attributed / measured, 4),
            },
            "compile": {**build_stats(), **compile_stats()},
            "metrics": metrics,
        }
        doc.update(self.extras)
        return doc

    def write(
        self, path: str, *, registry: Any | None = None
    ) -> dict[str, Any]:
        """Finalize and write the ledger; returns the finalized dict."""
        doc = self.finalize(registry=registry)
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        with open(path, "w") as fh:
            json.dump(doc, fh, indent=2, sort_keys=False, default=str)
            fh.write("\n")
        return doc


def load_ledger(path: str) -> dict[str, Any]:
    """Round-trip a written ledger (obs_report's input)."""
    with open(path) as fh:
        doc = json.load(fh)
    if not isinstance(doc, dict) or "schema" not in doc:
        raise ValueError(f"{path} is not a run ledger (no schema field)")
    return doc
