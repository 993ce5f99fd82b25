"""Declarative SLOs evaluated as multi-window burn rates over the registry.

"The Tail at Scale" (Dean & Barroso, 2013) argues tail percentiles must be
first-class engineering targets; the Google SRE workbook operationalizes
that with error-budget *burn rates*: if an objective allows a bad-request
budget of ``1 - target``, the burn rate over a window is

    burn = bad_fraction_in_window / (1 - target)

Burn 1.0 spends the budget exactly at the allowed pace; a *fast burn*
(canonically >= 14.4 on a short window — the rate that spends 2%% of a
30-day budget in one hour) is the page-someone signal. Evaluating the same
objective over several windows (default 1 min and 1 h) keeps the signal
both recent and sustained.

Everything is computed from the histogram families the service already
populates — no second bookkeeping on the request path:

- **latency** objectives count an observation "good" when it lands at or
  under the largest bucket bound <= the threshold (the *effective*
  threshold, reported per objective: bucket bounds are the measurement
  resolution, as in any Prometheus burn-rate rule);
- **availability** objectives count status >= 500 as "bad" — shed 429s and
  client 4xxs are policy working as intended, not unavailability.

Windowed deltas come from a timestamped ring of cumulative-count
snapshots taken at evaluation time (the clock is injectable, so tests
drive windows deterministically). Results are served at ``GET /slo`` and
mirrored as ``cobalt_slo_*`` gauges on the same registry, so the burn rate
itself is scrapeable/alertable.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Any, Callable, Mapping, Sequence

from cobalt_smart_lender_ai_tpu_torch.telemetry.metrics import (
    Histogram,
    HistogramChild,
    MetricsRegistry,
)

__all__ = ["Objective", "SLOEngine", "default_objectives"]

#: Canonical fast-burn threshold (SRE workbook: 2% of a 30-day budget in
#: one hour). An objective whose burn exceeds this on EVERY window at once
#: is flagged ``fast_burn`` — the page condition.
FAST_BURN_THRESHOLD = 14.4


@dataclasses.dataclass(frozen=True)
class Objective:
    """One declarative objective over a histogram family.

    ``labels`` filters the family's children: a plain string value must
    match exactly; a tuple/list/set value means "any of these". The
    ``status`` label never needs declaring for availability — the kind
    implies it."""

    name: str
    kind: str  # "latency" | "availability"
    target: float  # e.g. 0.99 => 99% of requests good
    family: str = "cobalt_request_latency_seconds"
    labels: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    threshold_s: float | None = None  # latency objectives only
    description: str = ""

    def __post_init__(self) -> None:
        if self.kind not in ("latency", "availability"):
            raise ValueError(f"unknown objective kind {self.kind!r}")
        if not (0.0 < self.target < 1.0):
            raise ValueError(f"target must be in (0, 1), got {self.target}")
        if self.kind == "latency" and not self.threshold_s:
            raise ValueError(f"latency objective {self.name!r} needs threshold_s")


def default_objectives(cfg: Any) -> tuple[Objective, ...]:
    """The serving defaults, parameterized by `ServeConfig` knobs: p99 and
    p99.9 single-row latency plus scoring-route availability."""
    scoring_routes = (
        "/predict", "/predict_bulk_csv", "/feature_importance_bulk",
    )
    return (
        Objective(
            name="predict_latency_p99",
            kind="latency",
            target=0.99,
            labels={"route": "/predict"},
            threshold_s=cfg.slo_p99_ms / 1000.0,
            description=(
                f"99% of /predict requests under {cfg.slo_p99_ms} ms"
            ),
        ),
        Objective(
            name="predict_latency_p999",
            kind="latency",
            target=0.999,
            labels={"route": "/predict"},
            threshold_s=cfg.slo_p999_ms / 1000.0,
            description=(
                f"99.9% of /predict requests under {cfg.slo_p999_ms} ms"
            ),
        ),
        Objective(
            name="availability",
            kind="availability",
            target=cfg.slo_availability_target,
            labels={"route": scoring_routes},
            description=(
                "scoring routes answer below HTTP 500 "
                f"{cfg.slo_availability_target:.3%} of the time"
            ),
        ),
    )


class SLOEngine:
    """Evaluate objectives against a registry with windowed burn rates.

    The engine never touches the request path: each `evaluate()` reads the
    histogram families' cumulative counts (cheap — a handful of children),
    appends a timestamped snapshot to a bounded ring, and differences the
    ring against each window. Evaluations are memoized for ``cache_s`` so
    the ``cobalt_slo_*`` collect-time gauge callbacks (one per objective x
    window) don't recount per gauge on a single scrape."""

    def __init__(
        self,
        registry: MetricsRegistry,
        objectives: Sequence[Objective],
        *,
        clock: Callable[[], float] = time.monotonic,
        windows_s: Sequence[float] = (60.0, 3600.0),
        fast_burn_threshold: float = FAST_BURN_THRESHOLD,
        cache_s: float = 0.25,
    ) -> None:
        if not objectives:
            raise ValueError("SLOEngine needs at least one objective")
        names = [o.name for o in objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names in {names}")
        self.objectives = tuple(objectives)
        self.windows_s = tuple(sorted(float(w) for w in windows_s))
        if not self.windows_s or self.windows_s[0] <= 0:
            raise ValueError(f"windows must be positive, got {windows_s}")
        self.fast_burn_threshold = float(fast_burn_threshold)
        self._registry = registry
        self._clock = clock
        self._cache_s = float(cache_s)
        self._lock = threading.Lock()
        # ring of (t, {objective: (good, total)}) cumulative snapshots,
        # pruned past the largest window (plus one entry of slack so a
        # window-spanning delta always has a baseline). Seeded with a
        # zero-counts snapshot at engine birth so traffic arriving before
        # the first evaluation still has a baseline to difference against.
        self._snapshots: list[tuple[float, dict[str, tuple[int, int]]]] = [
            (self._clock(), {o.name: (0, 0) for o in self.objectives})
        ]
        self._cache: tuple[float, dict] | None = None

    # -- counting ---------------------------------------------------------

    def _family(self, name: str) -> Histogram | None:
        for fam in self._registry.families():
            if fam.name == name and isinstance(fam, Histogram):
                return fam
        return None

    @staticmethod
    def _matches(obj: Objective, labels: Mapping[str, str]) -> bool:
        for key, want in obj.labels.items():
            have = labels.get(key)
            if isinstance(want, (tuple, list, set, frozenset)):
                if have not in want:
                    return False
            elif have != str(want):
                return False
        return True

    def effective_threshold_s(self, obj: Objective) -> float | None:
        """Largest bucket bound <= the declared threshold — the resolution
        the histogram can actually answer at (reported per objective so an
        operator sees what is being measured)."""
        if obj.threshold_s is None:
            return None
        fam = self._family(obj.family)
        if fam is None:
            return None
        fit = [b for b in fam.buckets if b <= obj.threshold_s + 1e-12]
        return fit[-1] if fit else None

    def _counts(self, obj: Objective) -> tuple[int, int]:
        """(good, total) cumulative for one objective, right now."""
        fam = self._family(obj.family)
        if fam is None:
            return (0, 0)
        eff = self.effective_threshold_s(obj)
        good = total = 0
        for labelvalues, child in fam._items():
            if not isinstance(child, HistogramChild):
                continue
            labels = dict(zip(fam.labelnames, labelvalues))
            if not self._matches(obj, labels):
                continue
            count = child.count
            total += count
            if obj.kind == "availability":
                status = labels.get("status", "")
                is_bad = status.isdigit() and int(status) >= 500
                if not is_bad:
                    good += count
            else:  # latency
                if eff is None:
                    continue  # no bucket can answer: everything counts bad
                good += next(
                    (c for le, c in child.cumulative() if le == eff), 0
                )
        return (good, total)

    # -- evaluation -------------------------------------------------------

    def evaluate(self, *, force: bool = False) -> dict:
        """Snapshot the registry and report every objective's burn rate per
        window. JSON-able; served verbatim at ``GET /slo``."""
        now = self._clock()
        with self._lock:
            if (
                not force
                and self._cache is not None
                and 0.0 <= now - self._cache[0] < self._cache_s
            ):
                return self._cache[1]
            counts = {o.name: self._counts(o) for o in self.objectives}
            if not self._snapshots or now > self._snapshots[-1][0]:
                self._snapshots.append((now, counts))
            else:
                # same (fake-clock) instant: replace, never double-record
                self._snapshots[-1] = (now, counts)
            horizon = now - self.windows_s[-1]
            while len(self._snapshots) > 1 and self._snapshots[1][0] <= horizon:
                self._snapshots.pop(0)
            result = self._evaluate_locked(now, counts)
            self._cache = (now, result)
            return result

    def _evaluate_locked(
        self, now: float, counts: dict[str, tuple[int, int]]
    ) -> dict:
        objectives_out = []
        any_fast_burn = False
        for obj in self.objectives:
            good_now, total_now = counts[obj.name]
            budget = 1.0 - obj.target
            windows_out = []
            burns: list[float] = []
            for w in self.windows_s:
                base_t, base = self._baseline(now - w)
                base_good, base_total = base.get(obj.name, (0, 0))
                d_total = max(0, total_now - base_total)
                d_bad = max(0, (total_now - good_now) - (base_total - base_good))
                bad_ratio = (d_bad / d_total) if d_total else 0.0
                burn = bad_ratio / budget if budget > 0 else math.inf
                burns.append(burn if d_total else 0.0)
                windows_out.append(
                    {
                        "window_s": w,
                        "covered_s": round(min(w, max(0.0, now - base_t)), 3),
                        "total": d_total,
                        "bad": d_bad,
                        "bad_ratio": round(bad_ratio, 6),
                        "burn_rate": round(burn, 3),
                    }
                )
            fast_burn = bool(burns) and all(
                b >= self.fast_burn_threshold for b in burns
            )
            any_fast_burn = any_fast_burn or fast_burn
            out: dict[str, Any] = {
                "name": obj.name,
                "kind": obj.kind,
                "target": obj.target,
                "description": obj.description,
                "total": total_now,
                "bad": total_now - good_now,
                "windows": windows_out,
                "fast_burn": fast_burn,
                "fast_burn_threshold": self.fast_burn_threshold,
            }
            if obj.threshold_s is not None:
                out["threshold_ms"] = round(obj.threshold_s * 1000.0, 3)
                eff = self.effective_threshold_s(obj)
                out["effective_threshold_ms"] = (
                    None if eff is None else round(eff * 1000.0, 3)
                )
            objectives_out.append(out)
        return {
            "now": round(now, 3),
            "windows_s": list(self.windows_s),
            "fast_burn": any_fast_burn,
            "objectives": objectives_out,
        }

    def _baseline(
        self, cutoff: float
    ) -> tuple[float, dict[str, tuple[int, int]]]:
        """Newest snapshot at or before ``cutoff`` (the window's baseline),
        else the oldest we have — a window larger than the engine's history
        degrades to since-start, reported via ``covered_s``."""
        chosen = self._snapshots[0]
        for snap in self._snapshots:
            if snap[0] <= cutoff:
                chosen = snap
            else:
                break
        return chosen

    # -- gauge mirror -----------------------------------------------------

    def register_gauges(self) -> None:
        """Expose every objective's burn state as ``cobalt_slo_*`` gauges on
        the engine's registry (collect-time callbacks through the cached
        `evaluate`, so one scrape costs one evaluation)."""
        reg = self._registry
        g_target = reg.gauge(
            "cobalt_slo_target",
            "declared SLO target (fraction of requests that must be good)",
            ("objective",),
        )
        g_burn = reg.gauge(
            "cobalt_slo_burn_rate",
            "error-budget burn rate per objective and window "
            "(1.0 = spending exactly the allowed budget)",
            ("objective", "window"),
        )
        g_bad = reg.gauge(
            "cobalt_slo_bad_ratio",
            "fraction of requests violating the objective per window",
            ("objective", "window"),
        )
        g_fast = reg.gauge(
            "cobalt_slo_fast_burn",
            "1 when the objective burns over the fast-burn threshold on "
            "every window at once (the page condition)",
            ("objective",),
        )
        for obj in self.objectives:
            g_target.labels(objective=obj.name).set(obj.target)
            g_fast.labels(objective=obj.name).set_function(
                lambda n=obj.name: float(self._lookup(n, None, "fast_burn"))
            )
            for w in self.windows_s:
                wl = f"{int(w)}s"
                g_burn.labels(objective=obj.name, window=wl).set_function(
                    lambda n=obj.name, w=w: self._lookup(n, w, "burn_rate")
                )
                g_bad.labels(objective=obj.name, window=wl).set_function(
                    lambda n=obj.name, w=w: self._lookup(n, w, "bad_ratio")
                )

    def _lookup(self, name: str, window_s: float | None, field: str) -> float:
        report = self.evaluate()
        for obj in report["objectives"]:
            if obj["name"] != name:
                continue
            if window_s is None:
                return float(obj[field])
            for win in obj["windows"]:
                if win["window_s"] == window_s:
                    return float(win[field])
        return float("nan")
