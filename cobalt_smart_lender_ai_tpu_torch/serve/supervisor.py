"""Fleet supervision: a health state machine per replica and a healing loop.

The reference's ``serve/supervisor.py``:

- `ReplicaHealth`, one per replica, the pure state machine::

      healthy -> degraded -> quarantined -> restarting -> healthy

  driven by an error-rate EWMA over routed outcomes. Only replica-internal
  failures count (`replica_internal`): a 422, 429 or 504 is request
  policy. The router reads ``routable`` and ``error_ewma`` on every pick,
  so a quarantined replica gets no traffic and a failing one less.

- `FleetSupervisor`, the healing loop (one daemon thread per fleet, started
  with the HTTP server; `tick` runs one pass for tests on a manual clock).
  Each tick, per replica: revive a dead micro-batch worker, quarantine on a
  stalled queue head (the queue-age watchdog) or on consecutive failed
  deadline-bounded probes, and heal a quarantined replica: drain (bounded),
  rebuild a fresh `ScorerService` from the served artifact on the old
  replica's device (packed, warmed and smoke-checked as a reload candidate
  is), swap it into its routing slot, readmit. Manual quarantines
  (``POST /admin/quarantine``) wait for the operator.

Every transition is journaled, logged, traced and counted
(``cobalt_supervisor_*``) and shown per replica in ``/readyz``.
"""

from __future__ import annotations

import math
import threading
import time
from concurrent.futures import TimeoutError as FutureTimeout
from typing import TYPE_CHECKING, Callable

import numpy as np
import torch

from cobalt_smart_lender_ai_tpu_torch.reliability.deadline import Deadline
from cobalt_smart_lender_ai_tpu_torch.reliability.errors import RequestError, WorkerDead
from cobalt_smart_lender_ai_tpu_torch.telemetry import default_tracer, event_context, get_logger

if TYPE_CHECKING:  # pragma: no cover - replicas imports this module
    from cobalt_smart_lender_ai_tpu_torch.serve.replicas import ReplicaSet
    from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService

__all__ = [
    "DEGRADED",
    "HEALTHY",
    "QUARANTINED",
    "RESTARTING",
    "STATE_CODES",
    "FleetSupervisor",
    "ReplicaHealth",
    "replica_internal",
]

_LOG = get_logger("serve.supervisor")

HEALTHY = "healthy"
DEGRADED = "degraded"
QUARANTINED = "quarantined"
RESTARTING = "restarting"

#: The `cobalt_supervisor_state` gauge's encoding.
STATE_CODES = {HEALTHY: 0, DEGRADED: 1, QUARANTINED: 2, RESTARTING: 3}


def replica_internal(exc: BaseException) -> bool:
    """True when a failure indicts the replica, not the request. Typed
    request errors fail alike on any replica and never count; `WorkerDead`
    (that replica's worker died) does, as does any untyped `Exception`. A
    `BaseException` that is not an `Exception` is the caller's."""
    if isinstance(exc, WorkerDead):
        return True
    return isinstance(exc, Exception) and not isinstance(exc, RequestError)


class ReplicaHealth:
    """One replica's state machine: bookkeeping only, no threads or I/O.
    The router and the supervisor are its only writers."""

    __slots__ = (
        "index",
        "state",
        "error_ewma",
        "outcomes",
        "probe_failures",
        "quarantines",
        "reason",
        "manual",
        "last_transition_at",
        "quarantined_at",
        "_alpha",
        "_degraded",
        "_quarantine",
        "_recover",
        "_clock",
    )

    def __init__(
        self,
        index: int,
        *,
        alpha: float = 0.2,
        degraded_ewma: float = 0.3,
        quarantine_ewma: float = 0.6,
        recover_ewma: float = 0.1,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.index = index
        self.state = HEALTHY
        self.error_ewma = 0.0
        self.outcomes = 0
        self.probe_failures = 0  # consecutive
        self.quarantines = 0
        self.reason: str | None = None
        self.manual = False
        self._alpha = float(alpha)
        self._degraded = float(degraded_ewma)
        self._quarantine = float(quarantine_ewma)
        self._recover = float(recover_ewma)
        self._clock = clock
        self.last_transition_at = clock()
        self.quarantined_at: float | None = None

    @property
    def routable(self) -> bool:
        """Degraded replicas stay in rotation (penalized); quarantined and
        restarting ones get no traffic."""
        return self.state in (HEALTHY, DEGRADED)

    def to(self, state: str, reason: str, *, manual: bool = False) -> tuple[str, str]:
        """Transition unconditionally; ``(old, new)`` for the caller to
        journal and count."""
        old, self.state = self.state, state
        self.reason = reason
        self.last_transition_at = self._clock()
        if state == QUARANTINED:
            self.quarantines += 1
            self.manual = manual
            self.quarantined_at = self.last_transition_at
        elif state == HEALTHY:
            self.error_ewma = 0.0
            self.probe_failures = 0
            self.manual = False
            self.quarantined_at = None
        return old, state

    def record_outcome(self, ok: bool, *, allow_quarantine: bool) -> tuple[str, str] | None:
        """Fold one routed outcome into the EWMA and step the machine.
        Without a supervisor to heal (``allow_quarantine`` False) it tops
        out at degraded and the router's penalty shields the fleet."""
        self.outcomes += 1
        self.error_ewma = self._alpha * (0.0 if ok else 1.0) + (1.0 - self._alpha) * self.error_ewma
        if self.state == HEALTHY and self.error_ewma >= self._degraded:
            return self.to(DEGRADED, f"error EWMA {self.error_ewma:.2f} over threshold")
        if self.state == DEGRADED:
            if allow_quarantine and self.error_ewma >= self._quarantine:
                return self.to(
                    QUARANTINED, f"error EWMA {self.error_ewma:.2f} over quarantine threshold"
                )
            if self.error_ewma <= self._recover:
                return self.to(HEALTHY, "error EWMA recovered")
        return None

    def snapshot(self) -> dict:
        """The ``/readyz`` per-replica block."""
        return {
            "state": self.state,
            "error_ewma": round(self.error_ewma, 4),
            "outcomes": self.outcomes,
            "probe_failures": self.probe_failures,
            "quarantines": self.quarantines,
            "reason": self.reason,
            "manual": self.manual,
            "since_transition_s": round(max(0.0, self._clock() - self.last_transition_at), 3),
        }


class FleetSupervisor:
    """The healing loop over a `ReplicaSet`. Construction registers the
    probe, rebuild and heal families on the fleet's registry; the thread
    starts with `start` (the HTTP server calls `ReplicaSet.start_supervisor`
    when its socket opens), and `tick` runs one pass."""

    def __init__(
        self,
        fleet: "ReplicaSet",
        *,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.fleet = fleet
        self.config = fleet.config
        self._clock = clock
        self._sleep = sleep
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None
        self._heal_lock = threading.Lock()  # one heal at a time
        reg = fleet.registry
        self._m_ticks = reg.counter(
            "cobalt_supervisor_ticks_total", "supervision passes run over the fleet"
        )
        self._m_probes = reg.counter(
            "cobalt_supervisor_probes_total",
            "deadline-bounded smoke probes by replica and outcome",
            ("replica", "outcome"),
        )
        self._m_rebuilds = reg.counter(
            "cobalt_supervisor_rebuilds_total",
            "quarantined-replica rebuilds by replica and outcome",
            ("replica", "outcome"),
        )
        self._m_heal_s = reg.gauge(
            "cobalt_supervisor_heal_seconds",
            "duration of each replica's last quarantine -> healthy cycle",
            ("replica",),
        )

    # -- lifecycle ----------------------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> None:
        """Start the probe loop (idempotent)."""
        if self.running:
            return
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True, name="fleet-supervisor")
        self._thread.start()

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _loop(self) -> None:
        interval = max(0.05, float(self.config.supervisor_probe_interval_s))
        while not self._stop_evt.wait(interval):
            try:
                self.tick()
            except Exception as exc:  # the loop outlives its fleet's bugs
                _LOG.error("supervisor_tick_failed", error=f"{type(exc).__name__}: {exc}")

    # -- one pass -------------------------------------------------------------------

    def tick(self) -> dict:
        """One pass over every replica: revive dead workers, watch the queue
        head's age, probe, quarantine, heal. Returns the pass's counts."""
        self._m_ticks.inc()
        fleet = self.fleet
        cfg = self.config
        summary = {"probed": 0, "quarantined": 0, "healed": 0, "revived": 0}
        for i in range(len(fleet.replicas)):
            if i >= len(fleet.replicas):
                break  # the tail was retired mid-tick
            h = fleet.replica_health[i]
            if h.state == RESTARTING:
                continue
            if h.state == QUARANTINED:
                # Manual quarantines are the operator's; automatic ones heal.
                if not h.manual and self.heal(i).get("status") == "healed":
                    summary["healed"] += 1
                continue
            rep = fleet.replicas[i]
            batcher = rep.batcher
            if batcher is not None and not batcher.closed:
                # A dead worker is revived here even with no traffic.
                if batcher.ensure_worker():
                    summary["revived"] += 1
                age = batcher.oldest_queued_age()
                if age > cfg.supervisor_queue_age_limit_s:
                    self.quarantine(i, f"queue head stalled for {age:.1f}s (wedged worker)")
                    summary["quarantined"] += 1
                    continue
            summary["probed"] += 1
            if self._probe(i, rep):
                h.probe_failures = 0
                self._m_probes.labels(replica=str(i), outcome="ok").inc()
            else:
                h.probe_failures += 1
                self._m_probes.labels(replica=str(i), outcome="failed").inc()
                pf_eid = fleet.journal.emit(
                    "supervisor",
                    "probe_failure",
                    replica=i,
                    payload={
                        "consecutive": h.probe_failures,
                        "threshold": cfg.supervisor_probe_failures,
                    },
                )
                if h.probe_failures >= cfg.supervisor_probe_failures:
                    self.quarantine(
                        i, f"{h.probe_failures} consecutive smoke probes failed", cause_id=pf_eid
                    )
                    summary["quarantined"] += 1
        return summary

    def _probe(self, i: int, rep: "ScorerService") -> bool:
        """Deadline-bounded smoke probe: the zeros row through the replica's
        own batcher, so a wedged worker fails it. Without a batcher, one
        margin-only launch at bucket 1 through the replica's model, the
        probability the host's sigmoid of the margin."""
        budget = max(0.05, float(self.config.supervisor_probe_deadline_s))
        dl = Deadline(budget, self._clock)
        try:
            batcher = rep.batcher
            with default_tracer().span("supervisor.probe", replica=i):
                if batcher is not None and not batcher.closed:
                    row = {name: 0.0 for name in rep.feature_names}
                    prob = batcher.submit(row, dl).result(timeout=budget)[0]
                else:
                    model = rep._model
                    with model.on_stream():
                        x = torch.zeros((1, model.n_features), dtype=torch.float32,
                                        device=model.device)
                        margin = float(model.margin_fn(x)[0][0])
                    prob = float(1.0 / (1.0 + np.exp(-margin)))
            if not (math.isfinite(prob) and 0.0 <= prob <= 1.0):
                raise RuntimeError(f"probe scored non-probability {prob!r}")
            return True
        except (Exception, FutureTimeout) as exc:
            _LOG.warning("supervisor_probe_failed", replica=i, error=f"{type(exc).__name__}: {exc}")
            return False

    # -- quarantine and heal ----------------------------------------------------------

    def quarantine(
        self, i: int, reason: str, *, manual: bool = False, cause_id: int | None = None
    ) -> dict:
        """Take replica ``i`` out of routing (idempotent). ``cause_id`` chains
        the journal's transition to its trigger (a probe-failure event)."""
        h = self.fleet.replica_health[i]
        if h.state in (QUARANTINED, RESTARTING):
            return {"status": h.state, "replica": i, "reason": h.reason}
        self.fleet._note_transition(i, *h.to(QUARANTINED, reason, manual=manual), cause_id=cause_id)
        return {"status": QUARANTINED, "replica": i, "reason": reason}

    def heal(self, i: int) -> dict:
        """Drain -> rebuild -> smoke-check -> swap -> readmit replica ``i``.
        The old replica closes on a reaper thread (a wedged worker's join
        never stalls the heal); a failed rebuild leaves it quarantined for
        the next tick."""
        fleet = self.fleet
        h = fleet.replica_health[i]
        with self._heal_lock:
            if h.state != QUARANTINED:
                return {"status": h.state, "replica": i}
            started = h.quarantined_at or self._clock()
            # Every event of the heal chains back to the quarantine.
            quarantine_eid = fleet._last_transition_event.get(i)
            fleet._note_transition(
                i, *h.to(RESTARTING, "rebuilding replacement"), cause_id=quarantine_eid
            )
            old = fleet.replicas[i]
            drained = self._drain(i)
            try:
                with default_tracer().span("supervisor.rebuild", replica=i):
                    replacement = self._rebuild(old)
            except Exception as exc:
                self._m_rebuilds.labels(replica=str(i), outcome="failed").inc()
                fleet.journal.emit(
                    "supervisor",
                    "rebuild",
                    replica=i,
                    payload={"outcome": "failed", "error": f"{type(exc).__name__}: {exc}"},
                    cause_id=quarantine_eid,
                )
                fleet._note_transition(
                    i,
                    *h.to(QUARANTINED, f"rebuild failed: {type(exc).__name__}: {exc}"),
                    cause_id=quarantine_eid,
                )
                return {"status": "rebuild_failed", "replica": i}
            rebuild_eid = fleet.journal.emit(
                "supervisor",
                "rebuild",
                replica=i,
                payload={"outcome": "ok", "drained": drained},
                cause_id=quarantine_eid,
            )
            fleet._swap_replica(i, replacement)
            swap_eid = fleet.journal.emit(
                "supervisor", "swap", replica=i, model=fleet._model_key, cause_id=rebuild_eid
            )
            threading.Thread(target=old.close, daemon=True, name=f"replica-reaper-{i}").start()
            del old
            self._m_rebuilds.labels(replica=str(i), outcome="ok").inc()
            heal_s = max(0.0, self._clock() - started)
            self._m_heal_s.labels(replica=str(i)).set(heal_s)
            eid = fleet._note_transition(
                i, *h.to(HEALTHY, f"rebuilt and readmitted in {heal_s:.2f}s"), cause_id=swap_eid
            )
            with event_context(eid):
                _LOG.info("replica_healed", replica=i, heal_s=round(heal_s, 3), drained=drained)
            return {"status": "healed", "replica": i, "heal_s": heal_s}

    def _drain(self, i: int) -> bool:
        """Bounded wait for replica ``i``'s routed in-flight count to reach
        zero; False on timeout (stragglers finish on the old replica, alive
        until its reaper closes it)."""
        fleet = self.fleet
        give_up = self._clock() + max(0.0, float(self.config.supervisor_drain_timeout_s))
        while True:
            with fleet._route_lock:
                if fleet._inflight[i] == 0:
                    return True
            if self._clock() >= give_up:
                return False
            self._sleep(0.05)

    def _rebuild(self, old: "ScorerService") -> "ScorerService":
        """A fresh replica from the served artifact on ``old``'s device: the
        pack, its warm-up launches, then the reload candidate's smoke check."""
        from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService

        fleet = self.fleet
        replacement = ScorerService(
            fleet.artifact, fleet.config, store=old._store, clock=fleet._clock, device=old.device
        )
        replacement._model_key = fleet._model_key
        replacement._smoke_check(replacement._model)
        return replacement

    def status(self) -> dict:
        """The ``/readyz`` ``supervisor`` block."""
        return {
            "enabled": True,
            "running": self.running,
            "probe_interval_s": self.config.supervisor_probe_interval_s,
            "states": [h.state for h in self.fleet.replica_health],
        }
