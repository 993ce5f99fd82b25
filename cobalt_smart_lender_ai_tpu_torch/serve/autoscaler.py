"""The fleet's load control: `FleetAutoscaler` and the brownout ladder.

The reference's ``serve/autoscaler.py``, module for module.

`FleetAutoscaler` is a control loop off the request path (one daemon
thread, started with the HTTP server; `tick` runs one evaluation, so tests
and ``chip_smoke.py`` drive it by hand on a held clock). Each tick reads
the signals the telemetry already measures — SLO fast burn
(`telemetry.slo`), each replica's micro-batch queue-wait p95 from the
fleet history (`telemetry.timeseries`), admission utilization, live queue
depths — and acts through the fleet's own machinery, one action per tick:

- **scale up**: a fresh `ScorerService` from the served artifact on the
  fleet's device (its pack, its warm-up launches of the scoring kernel,
  the reload candidate's smoke check), published by
  `ReplicaSet.add_replica`;
- **brown out**: when capacity cannot come (the ceiling, or the scale-up
  cooldown) and the SLO burns, one rung down the ladder;
- **recover**: once the burn clears, one rung back up per tick, before any
  capacity is retired;
- **scale down**: after ``autoscaler_stable_ticks`` idle ticks and both
  cooldowns, `ReplicaSet.remove_replica` drains and retires the tail (its
  pack is freed when its reaper thread has closed it);
- **retune**: busy (or brownout rung 3) publishes wide coalescing
  (``autoscaler_busy_wait_ms``, ``autoscaler_busy_max_rows``) to every live
  micro-batcher under its pause gate; idle restores the configured window.

The ladder's rungs, each including the ones before it:

1. drop the canary's shadow taps (invisible to clients;
   `ScorerService._canary_tap`);
2. serve ``degraded: true`` without SHAP: the micro-batcher and the direct
   path launch the margin-only program (with ``ReliabilityConfig.degrade_shap``);
3. widen micro-batch coalescing: the autoscaler's retune to the busy
   profile (5 ms, 256 rows by default), so bursts coalesce into 128- and
   256-row launches of the scoring kernel;
4. shed bulk requests 429 (`brownout_gate`), single rows still serve;
5. shed everything 429.

`ReplicaSet` shares one ladder with every replica and journals each step
on the fleet's `EventJournal`; the autoscaler journals its resizes and
retunes there too (``autoscaler.resize`` / ``retune`` / ``brownout``, each
with the signals that caused it), counts them in
``cobalt_autoscaler_{resizes,retunes,brownouts,ticks}_total`` and answers
``POST /admin/autoscaler`` and the ``/readyz`` ``autoscaler`` block.
"""

from __future__ import annotations

import threading
import time
from typing import TYPE_CHECKING, Callable

from cobalt_smart_lender_ai_tpu_torch.reliability.errors import RequestShed, ValidationError
from cobalt_smart_lender_ai_tpu_torch.telemetry import default_tracer, event_context, get_logger

if TYPE_CHECKING:  # replicas imports this module
    from cobalt_smart_lender_ai_tpu_torch.serve.replicas import ReplicaSet

__all__ = [
    "BROWNOUT_RUNGS",
    "LEVEL_HEALTHY",
    "LEVEL_NO_CANARY",
    "LEVEL_NO_SHAP",
    "LEVEL_WIDE_BATCH",
    "LEVEL_SHED_BULK",
    "LEVEL_SHED_ALL",
    "BrownoutLadder",
    "FleetAutoscaler",
    "brownout_gate",
]

_LOG = get_logger("serve.autoscaler")

LEVEL_HEALTHY = 0  # full service
LEVEL_NO_CANARY = 1  # drop canary shadow taps
LEVEL_NO_SHAP = 2  # serve ``degraded: true`` without SHAP
LEVEL_WIDE_BATCH = 3  # widen micro-batch coalescing
LEVEL_SHED_BULK = 4  # 429 bulk requests; single rows still serve
LEVEL_SHED_ALL = 5  # 429 everything

BROWNOUT_RUNGS = (
    "healthy",
    "no_canary",
    "no_shap",
    "wide_batch",
    "shed_bulk",
    "shed_all",
)


class BrownoutLadder:
    """Thread-safe brownout state: a level in ``[0, max_level]`` walked one
    rung at a time. The serving paths only read `level`."""

    def __init__(self, *, max_level: int = LEVEL_SHED_ALL):
        self.max_level = max(0, min(int(max_level), LEVEL_SHED_ALL))
        self.level = 0
        self.engaged_total = 0
        self.released_total = 0
        self._lock = threading.Lock()
        #: The fleet's `EventJournal` (`ReplicaSet` assigns it): every step
        #: is an ``autoscaler.brownout`` event, whoever drove it.
        self.journal = None

    def _journal_step(self, direction: str, reason: str, cause) -> int | None:
        if self.journal is None:
            return None
        return self.journal.emit(
            "autoscaler",
            "brownout",
            payload={
                "direction": direction,
                "level": self.level,
                "rung": BROWNOUT_RUNGS[self.level],
            },
            cause=cause if cause is not None else {"reason": reason},
        )

    def engage(self, reason: str = "", *, cause=None) -> tuple[int, int] | None:
        """One rung down; ``(old, new)``, or None at ``max_level``."""
        with self._lock:
            if self.level >= self.max_level:
                return None
            old, self.level = self.level, self.level + 1
            self.engaged_total += 1
        with event_context(self._journal_step("engage", reason, cause)):
            _LOG.warning("brownout_engage", level=self.level, rung=BROWNOUT_RUNGS[self.level],
                         reason=reason)
        return old, self.level

    def release(self, reason: str = "", *, cause=None) -> tuple[int, int] | None:
        """One rung back up; ``(old, new)``, or None at 0."""
        with self._lock:
            if self.level <= 0:
                return None
            old, self.level = self.level, self.level - 1
            self.released_total += 1
        with event_context(self._journal_step("release", reason, cause)):
            _LOG.info("brownout_release", level=self.level, rung=BROWNOUT_RUNGS[self.level],
                      reason=reason)
        return old, self.level

    @property
    def rung(self) -> str:
        return BROWNOUT_RUNGS[self.level]

    def snapshot(self) -> dict:
        return {
            "level": self.level,
            "rung": self.rung,
            "max_level": self.max_level,
            "engaged_total": self.engaged_total,
            "released_total": self.released_total,
        }


def brownout_gate(ladder: BrownoutLadder | None, kind: str, *, retry_after_s: float = 1.0) -> None:
    """The shed rungs at the scoring entry points: the typed `RequestShed`
    admission raises (429 + ``Retry-After``). ``kind`` is ``bulk`` or
    ``single``; bulk sheds first."""
    if ladder is None:
        return
    level = ladder.level
    if level >= LEVEL_SHED_ALL or (level >= LEVEL_SHED_BULK and kind == "bulk"):
        raise RequestShed(
            f"brownout level {level} ({BROWNOUT_RUNGS[level]}): shedding {kind} requests",
            retry_after_s=retry_after_s,
        )


class FleetAutoscaler:
    """The resize, retune and brownout policy loop over a `ReplicaSet`.

    Construction registers the ``cobalt_autoscaler_*`` families on the fleet
    registry and starts nothing: the thread starts with `start` (the HTTP
    server calls `ReplicaSet.start_autoscaler`), and `tick` runs one
    evaluation synchronously. Its state holds numbers only — no replica,
    tensor or callable — so a retired replica's pack is freed."""

    def __init__(self, fleet: "ReplicaSet", *, clock: Callable[[], float] = time.monotonic):
        self.fleet = fleet
        self.config = fleet.config
        self.brownout = fleet.brownout
        self._clock = clock
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None
        self._tick_lock = threading.Lock()  # tick() and the admin force serialize
        self.paused = False
        self._last_scale_up_at: float | None = None
        self._last_scale_down_at: float | None = None
        self._idle_ticks = 0
        self._retuned_busy = False
        self._last_signals: dict = {}
        reg = fleet.registry
        self._m_resizes = reg.counter(
            "cobalt_autoscaler_resizes_total",
            "fleet resizes the autoscaler performed, by direction",
            ("direction",),
        )
        self._m_retunes = reg.counter(
            "cobalt_autoscaler_retunes_total",
            "micro-batch knob retunes published under the pause gate, by "
            "profile (busy: wide coalescing; idle: configured defaults)",
            ("profile",),
        )
        self._m_brownouts = reg.counter(
            "cobalt_autoscaler_brownouts_total",
            "brownout ladder steps, by direction (engage: one rung further "
            "degraded; release: one rung recovered)",
            ("direction",),
        )
        self._m_ticks = reg.counter(
            "cobalt_autoscaler_ticks_total",
            "autoscaler control-loop evaluations",
        )

    # -- lifecycle -------------------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> None:
        """Start the control loop (idempotent)."""
        if self.running:
            return
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True, name="fleet-autoscaler")
        self._thread.start()

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _loop(self) -> None:
        interval = max(0.05, float(self.config.autoscaler_interval_s))
        while not self._stop_evt.wait(interval):
            try:
                self.tick()
            except Exception as exc:  # the loop outlives its own bugs
                _LOG.error("autoscaler_tick_failed", error=f"{type(exc).__name__}: {exc}")

    # -- signals ---------------------------------------------------------------------

    def _queue_wait_p95_ms(self) -> float | None:
        """The worst replica's latest queue-wait p95 (ms) from the fleet
        history's ``cobalt_microbatch_coalesce_wait_seconds:p95|replica=i``
        series, over the last four sampling intervals of the history's
        clock. None until the sampler has points: unknown is not busy."""
        history = self.fleet.history
        if history is None:
            return None
        worst: float | None = None
        prefix = "cobalt_microbatch_coalesce_wait_seconds:p95"
        try:
            names = [n for n in history.series_names() if n.startswith(prefix)]
            for name in names:
                res = history.query(name, window_s=4.0 * max(1.0, self.config.history_interval_s))
                points = res.get("points") or []
                if not points:
                    continue
                v = float(points[-1][1]) * 1000.0
                if worst is None or v > worst:
                    worst = v
        except Exception:
            return worst
        return worst

    def _signals(self) -> dict:
        fleet = self.fleet
        fast_burn = False
        if fleet.slo is not None:
            try:
                fast_burn = bool(fleet.slo.evaluate(force=True).get("fast_burn"))
            except Exception:
                fast_burn = False
        adm = fleet.admission
        util = 0.0
        if adm.max_in_flight:
            util = adm.in_flight / float(adm.max_in_flight)
        with fleet._route_lock:
            queue_depth = sum(0 if rep.batcher is None else rep.batcher.queue_depth() for rep in fleet.replicas)
            in_flight = sum(fleet._inflight)
            n = len(fleet.replicas)
        return {
            "fast_burn": fast_burn,
            "queue_wait_p95_ms": self._queue_wait_p95_ms(),
            "util": round(util, 4),
            "queue_depth": queue_depth,
            "in_flight": in_flight,
            "replicas": n,
        }

    # -- one control pass ------------------------------------------------------------

    def tick(self) -> dict:
        """One evaluation: classify the load, then, in priority order, scale
        up, brown out, recover, retire — one resize or one ladder step per
        tick, the property the cooldowns build on — and retune."""
        with self._tick_lock:
            return self._tick_locked()

    def _tick_locked(self) -> dict:
        self._m_ticks.inc()
        cfg = self.config
        if self.paused:
            return {"status": "paused"}
        sig = self._signals()
        self._last_signals = sig
        qw = sig["queue_wait_p95_ms"]
        busy = (
            sig["fast_burn"]
            or (qw is not None and qw >= cfg.autoscaler_queue_wait_high_ms)
            or sig["util"] >= cfg.autoscaler_util_high
        )
        idle = (
            not sig["fast_burn"]
            and (qw is None or qw <= cfg.autoscaler_queue_wait_low_ms)
            and sig["util"] <= cfg.autoscaler_util_low
            and sig["queue_depth"] == 0
        )
        summary = {"signals": sig, "actions": []}
        n = sig["replicas"]

        if busy:
            self._idle_ticks = 0
            up_ok = n < cfg.autoscaler_max_replicas and self._cooled(
                self._last_scale_up_at, cfg.autoscaler_scale_up_cooldown_s
            )
            if up_ok and self._scale_up():
                summary["actions"].append("scale_up")
            elif sig["fast_burn"] and cfg.brownout_enabled:
                # Capacity cannot come (ceiling or cooldown) and the SLO
                # burns: degrade one rung instead of collapsing.
                step = self.brownout.engage(
                    f"fast_burn at {n} replicas (max {cfg.autoscaler_max_replicas})", cause=sig
                )
                if step is not None:
                    self._m_brownouts.labels(direction="engage").inc()
                    summary["actions"].append(f"brownout:{BROWNOUT_RUNGS[step[1]]}")
        else:
            # The burn cleared: one rung back up per tick, symmetric with
            # engagement, before any capacity is retired.
            if self.brownout.level > 0:
                step = self.brownout.release("load cleared", cause=sig)
                if step is not None:
                    self._m_brownouts.labels(direction="release").inc()
                    summary["actions"].append(f"brownout_release:{BROWNOUT_RUNGS[step[1]]}")
            elif idle:
                self._idle_ticks += 1
                down_ok = (
                    n > max(1, cfg.autoscaler_min_replicas)
                    and self._idle_ticks >= cfg.autoscaler_stable_ticks
                    and self._cooled(self._last_scale_down_at, cfg.autoscaler_scale_down_cooldown_s)
                    and self._cooled(self._last_scale_up_at, cfg.autoscaler_scale_down_cooldown_s)
                )
                if down_ok and self._scale_down():
                    summary["actions"].append("scale_down")
            else:
                self._idle_ticks = 0

        # Rung 3 is this retune: wide coalescing while the ladder is there.
        self._retune(busy=busy or self.brownout.level >= LEVEL_WIDE_BATCH, summary=summary)
        return summary

    def _cooled(self, stamp: float | None, cooldown_s: float) -> bool:
        return stamp is None or (self._clock() - stamp) >= cooldown_s

    # -- actuation -------------------------------------------------------------------

    def _scale_up(self) -> bool:
        """Admit one replica: the supervisor's rebuild recipe — a fresh
        `ScorerService` from the served artifact, packed and warmed on the
        fleet's device (its replicas' device; with several cards and
        ``replica_devices``, the next slot's card), smoke-checked — then
        `ReplicaSet.add_replica` routes to it and rescales admission. A
        failed build is logged and retried next tick."""
        from cobalt_smart_lender_ai_tpu_torch.serve.replicas import resolve_replica_devices
        from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService

        fleet = self.fleet
        n = len(fleet.replicas)
        try:
            with default_tracer().span("autoscaler.scale_up", replicas=n + 1):
                device = resolve_replica_devices(n + 1, self.config.replica_devices, fleet.device)[n]
                replica = ScorerService(
                    fleet.artifact, self.config, store=fleet._store, clock=fleet._clock, device=device
                )
                replica._model_key = fleet._model_key
                replica._smoke_check(replica._model)
        except Exception as exc:
            _LOG.error("autoscaler_scale_up_failed", error=f"{type(exc).__name__}: {exc}")
            return False
        eid = fleet.journal.emit(
            "autoscaler",
            "resize",
            payload={"direction": "up", "from": n, "to": n + 1},
            cause=self._last_signals or {"trigger": "forced"},
        )
        with event_context(eid):
            # add_replica's admission.rescale event chains to this resize
            i = fleet.add_replica(replica)
            self._last_scale_up_at = self._clock()
            self._m_resizes.labels(direction="up").inc()
            _LOG.info("autoscaler_scale_up", replica=i, replicas=len(fleet.replicas))
        return True

    def _scale_down(self) -> bool:
        """Retire the tail replica through `ReplicaSet.remove_replica`. A
        refusal (the tail is being healed, or it is the last routable
        replica) is not an error: the loop tries again later."""
        fleet = self.fleet
        try:
            with default_tracer().span("autoscaler.scale_down", replicas=len(fleet.replicas) - 1):
                result = fleet.remove_replica()
        except ValidationError as exc:
            _LOG.info("autoscaler_scale_down_refused", reason=str(exc))
            return False
        self._last_scale_down_at = self._clock()
        self._idle_ticks = 0
        self._m_resizes.labels(direction="down").inc()
        eid = fleet.journal.emit(
            "autoscaler",
            "resize",
            replica=result["replica"],
            payload={
                "direction": "down",
                "from": result["replicas"] + 1,
                "to": result["replicas"],
                "drained": result["drained"],
            },
            cause=self._last_signals or {"trigger": "forced"},
        )
        with event_context(eid):
            _LOG.info("autoscaler_scale_down", replica=result["replica"], replicas=result["replicas"])
        return True

    def _retune(self, *, busy: bool, summary: dict) -> None:
        """Publish the load's coalescing knobs to every live micro-batcher
        under its pause gate. Busy: ``autoscaler_busy_wait_ms`` and
        ``autoscaler_busy_max_rows``; idle: the configured window. Only a
        change of profile publishes (and counts)."""
        cfg = self.config
        if not cfg.autoscaler_retune_enabled or busy == self._retuned_busy:
            return
        if busy:
            wait_s = cfg.autoscaler_busy_wait_ms / 1000.0
            rows = min(cfg.autoscaler_busy_max_rows, cfg.max_batch_rows)
            profile = "busy"
        else:
            wait_s = cfg.microbatch_max_wait_ms / 1000.0
            rows = min(cfg.microbatch_max_rows, cfg.max_batch_rows)
            profile = "idle"
        retuned = 0
        with self.fleet._route_lock:
            replicas = list(self.fleet.replicas)
        for rep in replicas:
            batcher = rep.batcher
            if batcher is None or batcher.closed:
                continue
            with batcher.pause():
                batcher._max_wait_s = wait_s
                batcher._max_rows = rows
            retuned += 1
        self._retuned_busy = busy
        if retuned:
            self._m_retunes.labels(profile=profile).inc()
            summary["actions"].append(f"retune:{profile}")
            eid = self.fleet.journal.emit(
                "autoscaler",
                "retune",
                payload={
                    "profile": profile,
                    "max_wait_ms": wait_s * 1000.0,
                    "max_rows": rows,
                    "replicas": retuned,
                },
                cause=summary.get("signals"),
            )
            with event_context(eid):
                _LOG.info("autoscaler_retune", profile=profile, max_wait_ms=wait_s * 1000.0,
                          max_rows=rows, replicas=retuned)

    # -- admin and observability -----------------------------------------------------

    def pause(self) -> dict:
        self.paused = True
        return {"status": "paused"}

    def resume(self) -> dict:
        self.paused = False
        return {"status": "resumed"}

    def force(self, replicas: int) -> dict:
        """Operator-forced fleet size: walk to ``replicas`` one step at a
        time through the same add and retire paths (the bounds and the
        one-routable floor still hold), past the cooldowns and signals."""
        try:
            target = int(replicas)
        except (TypeError, ValueError):
            raise ValidationError(f"replicas must be an integer, got {replicas!r}") from None
        cfg = self.config
        lo = max(1, cfg.autoscaler_min_replicas)
        hi = max(lo, cfg.autoscaler_max_replicas)
        if not lo <= target <= hi:
            raise ValidationError(f"replicas must be in [{lo}, {hi}], got {target}")
        with self._tick_lock:
            steps = []
            guard = 0
            while len(self.fleet.replicas) != target and guard < 32:
                guard += 1
                if len(self.fleet.replicas) < target:
                    if not self._scale_up():
                        break
                    steps.append("up")
                else:
                    if not self._scale_down():
                        break
                    steps.append("down")
            return {
                "status": "ok",
                "replicas": len(self.fleet.replicas),
                "target": target,
                "steps": steps,
            }

    def status(self) -> dict:
        """The ``/readyz`` ``autoscaler`` block."""
        return {
            "enabled": True,
            "running": self.running,
            "paused": self.paused,
            "replicas": len(self.fleet.replicas),
            "min_replicas": max(1, self.config.autoscaler_min_replicas),
            "max_replicas": self.config.autoscaler_max_replicas,
            "idle_ticks": self._idle_ticks,
            "brownout": self.brownout.snapshot(),
            "last_signals": self._last_signals,
        }
