"""Canary shadow-scoring, the promotion gate, automatic rollback, and drift
detection — the serve side of the continuous-training loop, the
reference's ``serve/canary.py``.

One `CanaryController` hangs off the serving facade (a `ScorerService`;
the reference also fronts a fleet of replicas with one) and owns four
jobs:

1. **Shadow tap.** A configurable slice of validated single-row requests is
   re-scored through the registry's ``canary`` model on a background worker
   (bounded queue, drop-on-overflow): on the card each shadow row is one
   margin-only ``score_forest`` launch at bucket 1, and its probability is
   the reference's host sigmoid of that margin — the canary's answer is
   NEVER returned to the caller, only folded into the comparison window
   and the ``cobalt_canary_*`` metric families.
2. **Promotion gate.** ``promote()`` compares the window: rank correlation
   of canary vs champion scores (the AUC proxy — champion ranking as
   pseudo-labels), mean absolute score delta, shadow vs champion dispatch
   latency ratio, and canary error rate. Pass → atomic reload through the
   owner's ``reload_from_store`` (score cache invalidated) followed by the
   registry's pointer flip. Fail → typed `PromotionRejected` (HTTP 409)
   carrying the structured report.
3. **Guard window / automatic rollback.** For ``promotion_guard_window_s``
   after a promotion, every finished request (and every readiness probe)
   checks the SLO engine; fast burn inside the window demotes ``latest``
   back to ``previous`` — no operator in the loop.
4. **Drift.** The same tap folds live rows into a `FeatureSketch` aligned
   with the training snapshot shipped in the champion's provenance record;
   per-feature PSI is served at ``GET /drift`` and as ``cobalt_drift_*``
   gauges, and crossing ``drift_psi_alert`` fires the ``on_drift`` hook
   (which retrain automation, `tools.retrain`, can point at itself).

Everything store-shaped goes through a `ResilientStore`-wrapped handle, so
channel-pointer reads/writes retry transient faults and verify content pins;
every failure surfaced to an adapter is a typed `RequestError`.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Mapping

import numpy as np
import torch

from cobalt_smart_lender_ai_tpu_torch.config import ServeConfig
from cobalt_smart_lender_ai_tpu_torch.io.artifacts import GBDTArtifact
from cobalt_smart_lender_ai_tpu_torch.io.model_registry import ModelRegistry
from cobalt_smart_lender_ai_tpu_torch.io.store import ObjectStore
from cobalt_smart_lender_ai_tpu_torch.reliability.errors import (
    PromotionRejected,
    ReloadFailed,
    RequestError,
    RollbackFailed,
)
from cobalt_smart_lender_ai_tpu_torch.telemetry import event_context, get_logger
from cobalt_smart_lender_ai_tpu_torch.telemetry.drift import FeatureSketch

_LOG = get_logger("cobalt.serve.canary")

_QUEUE_CAP = 512  # shadow requests buffered before drop-on-overflow


def _rank(values: np.ndarray) -> np.ndarray:
    order = np.argsort(values, kind="stable")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(values.size, dtype=np.float64)
    return ranks


def rank_correlation(a: np.ndarray, b: np.ndarray) -> float:
    """Spearman rank correlation, NaN-safe: a degenerate (constant) score
    vector — the signature of a label-shuffled candidate — scores 0.0, not
    NaN, so the gate reads it as "no agreement" rather than erroring."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.size < 2 or np.ptp(a) == 0.0 or np.ptp(b) == 0.0:
        return 0.0
    c = np.corrcoef(_rank(a), _rank(b))[0, 1]
    return 0.0 if not np.isfinite(c) else float(c)


class CanaryController:
    """Shadow-scoring + promotion/rollback orchestration for one serving
    facade. ``service`` is duck-typed: anything with ``reload_from_store``,
    ``set_model_info``, ``registry`` (metrics), ``device``, and optionally
    ``slo`` and ``journal`` — `ScorerService` qualifies."""

    def __init__(
        self,
        service: Any,
        store: ObjectStore,
        *,
        config: ServeConfig | None = None,
        clock: Callable[[], float] = time.monotonic,
        compile_fn: Callable[[GBDTArtifact], Any] | None = None,
        on_drift: Callable[[dict], None] | None = None,
    ):
        self._service = service
        self._store = store
        self.config = config or getattr(service, "config", None) or ServeConfig()
        self._clock = clock
        self._on_drift = on_drift
        self.registry = ModelRegistry(store, prefix=self.config.registry_prefix)
        self.name = self.config.model_name
        if compile_fn is None:
            # Default: a full _CompiledModel on the facade's device — shadow
            # launches then run the kernel the candidate would serve with,
            # and a CUDA service never scores its canary on the plain
            # version. Imported lazily (service.py imports us).
            from cobalt_smart_lender_ai_tpu_torch.serve.service import _CompiledModel

            compile_fn = lambda art: _CompiledModel(  # noqa: E731
                art, self.config, service.device
            )
        self._compile_fn = compile_fn

        self._canary_model: Any | None = None
        self._canary_info: dict | None = None
        self._window: collections.deque = collections.deque(
            maxlen=max(8, self.config.canary_window)
        )
        # Per-candidate tallies (the cobalt_canary_* counters are lifetime-
        # cumulative; the gate must judge only the canary under evaluation).
        self._win_shadowed = 0
        self._win_errors = 0
        self._baseline: FeatureSketch | None = None
        self._live: FeatureSketch | None = None
        self._drift_cache: tuple[int, dict] | None = None
        self._drift_alarmed = False

        self._sample_acc = 0.0
        self._guard: dict | None = None
        self.last_promotion: dict | None = None
        self._admin_lock = threading.Lock()

        self._queue: collections.deque = collections.deque()
        self._cond = threading.Condition()
        self._inflight = 0
        self._closed = False
        self._init_metrics()
        self._worker = threading.Thread(
            target=self._run, name="canary-shadow", daemon=True
        )
        self._worker.start()

    def _journal_emit(self, kind: str, **kw) -> int | None:
        """Journal a canary action on the owning service/fleet's journal.
        Returns the event id, or None when the owner has no journal (bare
        test doubles)."""
        journal = getattr(self._service, "journal", None)
        if journal is None:
            return None
        return journal.emit("canary", kind, **kw)

    # -- metrics --------------------------------------------------------------

    def _init_metrics(self) -> None:
        reg = self._service.registry
        self._m_shadow = reg.counter(
            "cobalt_canary_shadow_total",
            "single-row requests shadow-scored through the canary model",
        )
        self._m_dropped = reg.counter(
            "cobalt_canary_shadow_dropped_total",
            "sampled requests dropped because the shadow queue was full",
        )
        self._m_errors = reg.counter(
            "cobalt_canary_errors_total",
            "canary shadow-scoring failures (never surfaced to the caller)",
        )
        self._m_delta = reg.histogram(
            "cobalt_canary_score_delta",
            "absolute canary-vs-champion probability delta per shadowed row",
            buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0),
        )
        self._m_latency = reg.histogram(
            "cobalt_canary_latency_seconds",
            "wall time of one canary shadow dispatch",
        )
        self._m_promotions = reg.counter(
            "cobalt_canary_promotions_total",
            "promotion gate decisions by outcome (promoted / rejected)",
            ("outcome",),
        )
        self._m_rollbacks = reg.counter(
            "cobalt_canary_rollbacks_total",
            "latest->previous demotions by trigger (manual / slo_fast_burn)",
            ("trigger",),
        )
        reg.gauge(
            "cobalt_canary_loaded",
            "1 when a canary model is loaded for shadow scoring",
        ).set_function(lambda: 0.0 if self._canary_model is None else 1.0)
        reg.gauge(
            "cobalt_canary_window_size",
            "shadow comparisons currently in the promotion-gate window",
        ).set_function(lambda: float(len(self._window)))
        reg.gauge(
            "cobalt_drift_max_psi",
            "largest per-feature PSI of live traffic vs the training snapshot",
        ).set_function(lambda: self._drift_summary()[0])
        reg.gauge(
            "cobalt_drift_alarm",
            "1 while any feature's PSI exceeds drift_psi_alert",
        ).set_function(lambda: 1.0 if self._drift_summary()[1] else 0.0)
        self._m_psi = reg.gauge(
            "cobalt_drift_psi",
            "population stability index of live traffic vs the training "
            "snapshot, per feature",
            ("feature",),
        )

    # -- registry sync --------------------------------------------------------

    def sync_identity(self) -> None:
        """Stamp the facade's model identity from the registry's ``latest``
        pointer (when the served key matches it) and load the training
        snapshot sketch from that version's provenance."""
        latest = self.registry.channel(self.name, "latest")
        if latest is None:
            return
        served_key = getattr(self._service, "_model_key", None)
        if served_key is not None and served_key != latest["key"]:
            return
        self._service.set_model_info(
            version=f"v{latest['version']}",
            channel="latest",
            provenance_md5=latest["md5"],
        )
        self._load_baseline(int(latest["version"]))

    def _load_baseline(self, version: int) -> None:
        try:
            record = self.registry.record(self.name, version)
        except Exception:
            return
        sketch = record.provenance.get("feature_sketch")
        if not sketch:
            return
        self._baseline = FeatureSketch.from_json(sketch)
        self._live = self._baseline.empty_like()
        self._drift_cache = None
        for f in self._baseline.feature_names:
            self._m_psi.labels(feature=f).set_function(
                lambda f=f: self._drift_values().get(f, float("nan"))
            )

    def refresh(self) -> dict | None:
        """(Re)load whatever the ``canary`` channel points at. Loading is
        best-effort — a broken canary must never take the champion down —
        but the outcome is observable via ``status()``."""
        ptr = self.registry.channel(self.name, "canary")
        if ptr is None:
            self._canary_model = None
            self._canary_info = None
            self.reset_window()
            return None
        if self._canary_info and self._canary_info["version"] == ptr["version"]:
            return self._canary_info
        try:
            artifact = GBDTArtifact.load(self._store, ptr["key"], self._service.device)
            model = self._compile_fn(artifact)
        except Exception as exc:
            self._canary_model = None
            self._canary_info = {
                "version": ptr["version"],
                "key": ptr["key"],
                "error": f"{type(exc).__name__}: {exc}",
            }
            _LOG.warning("canary_load_failed", **self._canary_info)
            return self._canary_info
        self.reset_window()
        self._canary_model = model
        self._canary_info = {
            "version": ptr["version"],
            "key": ptr["key"],
            "md5": ptr.get("md5"),
        }
        _LOG.info("canary_loaded", **self._canary_info)
        return self._canary_info

    def reset_window(self) -> None:
        self._window.clear()
        self._win_shadowed = 0
        self._win_errors = 0

    # -- shadow tap -----------------------------------------------------------

    def tap(
        self,
        row: Mapping[str, float],
        champion_prob: float,
        champion_latency_s: float | None = None,
    ) -> None:
        """Request-path hook: deterministic stride sampling, O(1), never
        raises. The actual canary dispatch happens on the worker thread so
        the caller's latency is untouched. Event-loop safe: the only lock
        held is a plain mutex around a bounded in-memory append (no I/O,
        no waits), so request coroutines on the asyncio frontend call this
        directly without stalling the loop."""
        if self._closed:
            return
        if self._canary_model is None and self._live is None:
            return  # nothing to score against, nothing to sketch
        self._sample_acc += min(1.0, max(0.0, self.config.canary_sample_rate))
        if self._sample_acc < 1.0:
            return
        self._sample_acc -= 1.0
        with self._cond:
            if len(self._queue) >= _QUEUE_CAP:
                self._m_dropped.inc()
                return
            self._queue.append((dict(row), champion_prob, champion_latency_s))
            self._cond.notify()

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait(timeout=0.5)
                if self._closed and not self._queue:
                    return
                item = self._queue.popleft()
                self._inflight += 1
            try:
                self._shadow_one(*item)
            except Exception as exc:  # shadow path NEVER propagates
                self._m_errors.inc()
                if self._canary_model is not None:
                    self._win_errors += 1
                _LOG.warning("canary_shadow_error", error=str(exc))
            finally:
                with self._cond:
                    self._inflight -= 1
                    self._cond.notify_all()

    def _shadow_one(
        self,
        row: dict,
        champion_prob: float,
        champion_latency_s: float | None,
    ) -> None:
        live = self._live
        if live is not None:
            live.observe_row(row)
            self._maybe_drift_alarm()
        model = self._canary_model
        if model is None:
            return
        t0 = time.perf_counter()
        x = torch.from_numpy(model.rows_array([row])).to(model.device)
        margin = float(model.margin_fn(x)[0][0])
        # The reference's host sigmoid, not the kernel's f32 one: the gate's
        # deltas are then the JAX package's for the same margins.
        prob = float(1.0 / (1.0 + np.exp(-margin)))
        lat = time.perf_counter() - t0
        self._m_shadow.inc()
        self._win_shadowed += 1
        self._m_latency.observe(lat)
        self._m_delta.observe(abs(prob - champion_prob))
        self._window.append((champion_prob, prob, champion_latency_s, lat))

    def flush(self, timeout_s: float = 10.0) -> bool:
        """Drain the shadow queue (tests / the gate before evaluating)."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while self._queue or self._inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(timeout=remaining)
        return True

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._worker.join(timeout=5.0)

    # -- promotion gate -------------------------------------------------------

    def evaluate_gate(self) -> dict:
        """Compare the shadow window; structured verdict either way."""
        cfg = self.config
        window = list(self._window)
        n = len(window)
        reasons: list[str] = []
        checks: dict[str, Any] = {"samples": n}
        if self._canary_model is None:
            reasons.append("no_canary_loaded")
        if n < cfg.canary_min_samples:
            reasons.append(
                f"insufficient_samples:{n}<{cfg.canary_min_samples}"
            )
        shadowed = float(self._win_shadowed)
        errors = float(self._win_errors)
        err_ratio = errors / max(1.0, shadowed + errors)
        checks["error_ratio"] = round(err_ratio, 6)
        if err_ratio > cfg.canary_max_error_ratio:
            reasons.append(
                f"error_ratio:{err_ratio:.4f}>{cfg.canary_max_error_ratio}"
            )
        if n:
            champ = np.asarray([w[0] for w in window])
            canary = np.asarray([w[1] for w in window])
            delta = float(np.mean(np.abs(canary - champ)))
            corr = rank_correlation(champ, canary)
            checks["mean_abs_score_delta"] = round(delta, 6)
            checks["score_rank_correlation"] = round(corr, 6)
            if delta > cfg.canary_max_score_delta:
                reasons.append(
                    f"score_delta:{delta:.4f}>{cfg.canary_max_score_delta}"
                )
            if corr < cfg.canary_min_score_corr:
                reasons.append(
                    f"score_correlation:{corr:.4f}<{cfg.canary_min_score_corr}"
                )
            champ_lat = [w[2] for w in window if w[2] is not None]
            can_lat = [w[3] for w in window if w[3] is not None]
            if champ_lat and can_lat:
                ratio = float(np.mean(can_lat) / max(np.mean(champ_lat), 1e-9))
                checks["latency_ratio"] = round(ratio, 3)
                if ratio > cfg.canary_max_latency_ratio:
                    reasons.append(
                        f"latency_ratio:{ratio:.2f}>"
                        f"{cfg.canary_max_latency_ratio}"
                    )
        report = {
            "eligible": not reasons,
            "reasons": reasons,
            "checks": checks,
            "canary": self._canary_info,
        }
        return report

    def promote(self, *, force: bool = False) -> dict:
        """Gate -> atomic fleet reload -> registry pointer flip -> guard
        window. Raises typed errors only: `PromotionRejected` (409) when the
        gate says no or there is no canary, `ReloadFailed` (500) when the
        store/registry breaks mid-flight."""
        with self._admin_lock:
            try:
                ptr = self.registry.channel(self.name, "canary")
            except RequestError:
                raise
            except Exception as exc:
                raise ReloadFailed(f"registry unavailable: {exc}")
            if ptr is None:
                raise PromotionRejected(
                    "no canary channel published",
                    report={"eligible": False, "reasons": ["no_canary"]},
                )
            try:
                self.refresh()
            except Exception:
                pass  # judged below: an unloaded canary fails the gate
            self.flush(timeout_s=5.0)
            report = self.evaluate_gate()
            if not report["eligible"] and not force:
                self._m_promotions.labels(outcome="rejected").inc()
                self.last_promotion = {
                    "action": "rejected",
                    "version": ptr["version"],
                    "gate": report,
                }
                eid = self._journal_emit(
                    "reject",
                    model=f"v{ptr['version']}",
                    payload={"reasons": report["reasons"]},
                    cause={"gate": report},
                )
                with event_context(eid):
                    _LOG.warning(
                        "canary_promotion_rejected",
                        version=ptr["version"],
                        reasons=report["reasons"],
                    )
                raise PromotionRejected(
                    "promotion gate rejected canary "
                    f"v{ptr['version']}: {', '.join(report['reasons'])}",
                    report=report,
                )
            # Fleet first, pointers second: a failed reload leaves the
            # registry untouched; a crash between reload and flip leaves a
            # stale-but-consistent pointer an idempotent re-promote fixes.
            result = self._reload_fleet(ptr["key"])
            try:
                flip = self.registry.promote(self.name)
            except Exception as exc:
                raise ReloadFailed(
                    f"fleet reloaded to {ptr['key']} but the channel flip "
                    f"failed: {exc}"
                )
            self._service.set_model_info(
                version=f"v{flip['promoted_version']}",
                channel="latest",
                provenance_md5=ptr.get("md5"),
            )
            self._load_baseline(int(flip["promoted_version"]))
            self._canary_model = None
            self._canary_info = None
            self.reset_window()
            guard_s = self.config.promotion_guard_window_s
            if guard_s > 0 and getattr(self._service, "slo", None) is not None:
                self._guard = {
                    "until": self._clock() + guard_s,
                    "promoted_version": flip["promoted_version"],
                    "window_s": guard_s,
                }
            self._m_promotions.labels(outcome="promoted").inc()
            self.last_promotion = {
                "action": "promoted",
                **flip,
                "gate": report,
                "guard": self._guard,
            }
            eid = self._journal_emit(
                "promote",
                model=f"v{flip['promoted_version']}",
                payload=dict(flip),
                cause={"gate": report, "forced": force},
            )
            with event_context(eid):
                _LOG.info(
                    "canary_promoted", **{k: v for k, v in flip.items()}
                )
            return {"status": "promoted", **flip, "gate": report,
                    "reload": result}

    def rollback(
        self, *, reason: str = "manual", trigger: str = "manual"
    ) -> dict:
        """Demote ``latest`` back to ``previous`` fleet-wide — the manual
        ``POST /admin/rollback`` path and the guard window's automatic one."""
        with self._admin_lock:
            return self._rollback_locked(reason=reason, trigger=trigger)

    def _rollback_locked(self, *, reason: str, trigger: str) -> dict:
        try:
            prev = self.registry.channel(self.name, "previous")
        except RequestError:
            raise
        except Exception as exc:
            raise ReloadFailed(f"registry unavailable: {exc}")
        if prev is None:
            raise RollbackFailed("no previous version to roll back to")
        result = self._reload_fleet(prev["key"])
        try:
            flip = self.registry.rollback(self.name, reason=reason)
        except Exception as exc:
            raise ReloadFailed(
                f"fleet reloaded to {prev['key']} but the channel flip "
                f"failed: {exc}"
            )
        self._service.set_model_info(
            version=f"v{flip['restored_version']}",
            channel="latest",
            provenance_md5=prev.get("md5"),
        )
        self._load_baseline(int(flip["restored_version"]))
        self._guard = None
        self.reset_window()
        self._m_rollbacks.labels(trigger=trigger).inc()
        self.last_promotion = {"action": "rolled_back", **flip,
                               "trigger": trigger}
        eid = self._journal_emit(
            "rollback",
            model=f"v{flip['restored_version']}",
            payload=dict(flip),
            cause={"trigger": trigger, "reason": reason},
        )
        with event_context(eid):
            _LOG.warning("model_rollback", trigger=trigger, **flip)
        return {"status": "rolled_back", "trigger": trigger, **flip,
                "reload": result}

    def _reload_fleet(self, key: str) -> dict:
        """All-or-nothing reload through the owning facade; store faults
        surface as typed `ReloadFailed`, never a raw ConnectionError."""
        try:
            result = self._service.reload_from_store(
                store=self._store, model_key=key
            )
        except RequestError:
            raise
        except Exception as exc:
            raise ReloadFailed(f"reload to {key} failed: {exc}")
        if result.get("status") != "ok":
            raise ReloadFailed(
                f"reload to {key} rolled back: {result.get('error')}"
            )
        return result

    # -- guard window / automatic rollback ------------------------------------

    def maybe_auto_rollback(self) -> dict | None:
        """Called from the facade's request/readiness paths. O(1) when no
        guard window is open; inside one, a fast-burning SLO triggers the
        demotion. Never raises — a failed auto-rollback is logged and
        retried on the next request."""
        guard = self._guard
        if guard is None:
            return None
        now = self._clock()
        if now > guard["until"]:
            self._guard = None
            return None
        slo = getattr(self._service, "slo", None)
        if slo is None:
            return None
        try:
            if not slo.evaluate().get("fast_burn"):
                return None
            with self._admin_lock:
                # Two callers (the HTTP server's post-response hook and a
                # request) can both see the burn; only the one holding the
                # guard it read acts, or the second would flip ``latest``
                # back to the demoted version.
                if self._guard is not guard:
                    return None
                return self._rollback_locked(
                    reason=(
                        f"slo fast burn within {guard['window_s']:g}s guard "
                        f"window after promoting v{guard['promoted_version']}"
                    ),
                    trigger="slo_fast_burn",
                )
        except Exception as exc:
            _LOG.warning("auto_rollback_failed", error=str(exc))
            return None

    # -- drift ----------------------------------------------------------------

    def _drift_values(self) -> dict[str, float]:
        baseline, live = self._baseline, self._live
        if baseline is None or live is None:
            return {}
        cached = self._drift_cache
        n = live.n
        if cached is not None and cached[0] == n:
            return cached[1]
        values = baseline.psi_vs(live)
        self._drift_cache = (n, values)
        return values

    def _drift_summary(self) -> tuple[float, bool]:
        values = self._drift_values()
        live_n = 0 if self._live is None else self._live.n
        if not values or live_n < self.config.drift_min_samples:
            return (float("nan"), False)
        worst = max(values.values())
        return (worst, worst > self.config.drift_psi_alert)

    def _maybe_drift_alarm(self) -> None:
        _, alarmed = self._drift_summary()
        if alarmed and not self._drift_alarmed:
            self._drift_alarmed = True
            report = self.drift_report()
            _LOG.warning(
                "drift_alarm",
                max_psi=report.get("max_psi"),
                threshold=self.config.drift_psi_alert,
            )
            if self._on_drift is not None:
                try:
                    self._on_drift(report)
                except Exception as exc:
                    _LOG.warning("on_drift_hook_failed", error=str(exc))
        elif not alarmed:
            self._drift_alarmed = False

    def drift_report(self) -> dict:
        """``GET /drift`` payload."""
        baseline, live = self._baseline, self._live
        if baseline is None or live is None:
            return {
                "status": "no_baseline",
                "detail": "serving model has no training snapshot in its "
                          "registry provenance (publish via tools.retrain)",
            }
        values = self._drift_values()
        worst, alarmed = self._drift_summary()
        return {
            "status": "ok",
            "n_live": live.n,
            "n_baseline": baseline.n,
            "min_samples": self.config.drift_min_samples,
            "threshold": self.config.drift_psi_alert,
            "max_psi": None if not np.isfinite(worst) else round(worst, 6),
            "alarm": alarmed,
            "features": {k: round(v, 6) for k, v in sorted(values.items())},
        }

    # -- observability --------------------------------------------------------

    def status(self) -> dict:
        """The ``canary`` block of ``/readyz``."""
        out: dict[str, Any] = {
            "enabled": True,
            "model_name": self.name,
            "loaded": self._canary_model is not None,
            "canary": self._canary_info,
            "window": len(self._window),
            "sample_rate": self.config.canary_sample_rate,
            "shadowed": int(self._m_shadow.value),
            "errors": int(self._m_errors.value),
            "guard": self._guard,
        }
        if self.last_promotion is not None:
            out["last_promotion"] = self.last_promotion
        return out


__all__ = ["CanaryController", "rank_correlation"]
