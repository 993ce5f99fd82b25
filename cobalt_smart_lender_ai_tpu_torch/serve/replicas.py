"""The serving fleet: N shared-nothing `ScorerService` replicas behind one
service-shaped facade.

The reference's ``serve/replicas.py``. `ReplicaSet` holds
``ServeConfig.replicas`` full services, each with its own pack, scratch,
micro-batcher and metrics registry. On one card every replica sits on it
and launches the scoring kernel from its own worker thread onto the card's
default stream; with several cards and ``replica_devices``, replica i goes
to ``cuda:(i % cards)``. Nothing crosses a replica boundary but the
artifact the replicas packed from, so one stalled replica never convoys the
others.

Routing is least-loaded: each request picks the routable replica with the
least ``in_flight + queue depth + 16 x error EWMA``, round-robin among ties,
so an idle fleet rotates and a fast-failing replica (which reports no load)
does not take the fleet's traffic. Quarantined replicas (`serve.supervisor`)
are skipped. A single row that fails replica-internally is hedged: retried
once on another replica inside the caller's deadline; typed request errors
never hedge.

The facade answers the surface the HTTP server binds to: the scoring
routes route (the brownout ladder's shed rungs gate them first);
`reload_from_store` builds and smoke-checks every replica's candidate
before any publishes, so a bad artifact rolls back everywhere; `/readyz`
is ready when every routable replica is; `/metrics` serves the facade's
registry with the ``cobalt_replica_*``, ``cobalt_supervisor_*`` and
``cobalt_brownout_level`` families; `/events` merges the facade's journal
with the replicas'. One canary controller shadow-scores for the fleet and
promotes through the fleet's all-or-nothing reload.

The fleet's history (``/history``, ``/dashboard``) is one sampler over the
facade's registry and every replica's, merged (`telemetry.aggregate`):
fleet sums beside per-replica series under a ``replica`` label. With
``ServeConfig.autoscaler_enabled`` a `serve.autoscaler.FleetAutoscaler`
reads it and resizes the fleet at runtime (`add_replica`,
`remove_replica`), retunes its coalescing and walks the brownout ladder;
``POST /admin/autoscaler`` steers it. Both threads start with the HTTP
server.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Mapping

import numpy as np
import torch

from cobalt_smart_lender_ai_tpu_torch.config import ServeConfig
from cobalt_smart_lender_ai_tpu_torch.device import resolve_device
from cobalt_smart_lender_ai_tpu_torch.io import GBDTArtifact, ObjectStore
from cobalt_smart_lender_ai_tpu_torch.reliability.admission import admission_from_config
from cobalt_smart_lender_ai_tpu_torch.reliability.errors import (
    CircuitOpenError,
    PromotionRejected,
    RollbackFailed,
    ValidationError,
)
from cobalt_smart_lender_ai_tpu_torch.serve.autoscaler import (
    LEVEL_NO_CANARY,
    BrownoutLadder,
    FleetAutoscaler,
    brownout_gate,
)
from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService, _registry_store
from cobalt_smart_lender_ai_tpu_torch.serve.supervisor import (
    HEALTHY,
    QUARANTINED,
    RESTARTING,
    STATE_CODES,
    FleetSupervisor,
    ReplicaHealth,
    replica_internal,
)
from cobalt_smart_lender_ai_tpu_torch.telemetry import (
    EventJournal,
    FlightRecorder,
    MetricsRegistry,
    SLOEngine,
    TimeSeriesStore,
    add_phase,
    default_objectives,
    default_program_registry,
    default_tracer,
    event_context,
    get_logger,
    install_device_metrics,
    install_program_metrics,
    merge_events,
    merge_expositions,
    parse_exposition,
)

__all__ = ["ReplicaSet", "resolve_replica_devices"]

_LOG = get_logger("serve.replicas")


def resolve_replica_devices(
    n_replicas: int, pin_devices: bool, device: torch.device | str = "cuda"
) -> list[torch.device]:
    """Each replica's device. ``cpu``: every replica on the CPU. ``cuda``:
    on a host with several cards and ``pin_devices``, replica i on
    ``cuda:(i % cards)`` (8 replicas on 4 cards double up); otherwise every
    replica on the one card. ``cuda`` without a card raises."""
    dev = resolve_device(device)
    if dev.type != "cuda" or not pin_devices:
        return [dev] * n_replicas
    n_cards = torch.cuda.device_count()
    if n_cards <= 1:
        return [dev] * n_replicas
    return [torch.device("cuda", i % n_cards) for i in range(n_replicas)]


class ReplicaSet:
    """N shared-nothing `ScorerService` replicas and a least-loaded router,
    presenting the single service's surface to the HTTP server."""

    #: Load units one full point of error EWMA costs a replica in the pick:
    #: a replica failing every request weighs as 16 queued requests, so a
    #: busy healthy replica beats an idle failing one.
    _ERROR_PENALTY = 16.0

    def __init__(
        self,
        replicas: list[ScorerService],
        config: ServeConfig,
        *,
        clock: Callable[[], float] = time.monotonic,
    ):
        if not replicas:
            raise ValueError("ReplicaSet needs at least one replica")
        self.replicas = replicas
        self.config = config
        self._clock = clock
        # Per-replica in-flight counts, owned here: the facade brackets every
        # routed call, so the load signal exists without a batcher too.
        self._route_lock = threading.Lock()
        self._inflight = [0] * len(replicas)
        self._rr = 0  # round-robin cursor among ties
        # Runtime resizes serialize here, so two removals never drain the
        # same tail slot.
        self._resize_lock = threading.Lock()
        # One ladder for the fleet, shared by every replica.
        self.brownout = BrownoutLadder(
            max_level=config.brownout_max_level if config.brownout_enabled else 0
        )
        for rep in replicas:
            rep.brownout = self.brownout
        self.replica_health = [self._new_health(i) for i in range(len(replicas))]
        self.supervisor: FleetSupervisor | None = None
        # One admission controller at the fleet's door (the server admits
        # once per request), its limits one replica's times the fleet size.
        self.admission = admission_from_config(config.reliability, clock=clock)
        self.admission.rescale(len(replicas))
        self.registry = MetricsRegistry()
        self.flight = FlightRecorder(
            capacity=config.flight_capacity,
            slow_threshold_s=config.flight_slow_threshold_ms / 1000.0,
            top_k=config.flight_top_k,
        )
        # The fleet's control-plane journal: supervisor transitions, brownout
        # rungs, chaos injections, fleet reloads. Event ids are process-wide,
        # so GET /events merges it with the replicas' by a sort.
        self.journal = EventJournal(
            capacity=config.events_capacity,
            ship_interval_s=config.events_ship_interval_s,
            registry=self.registry,
        )
        self.brownout.journal = self.journal
        # Each slot's latest transition event: a heal chains its rebuild,
        # swap and readmit back to the quarantine.
        self._last_transition_event: dict[int, int] = {}
        self.slo: SLOEngine | None = None
        self._swap_lock = threading.Lock()
        self._last_reload: dict | None = None
        # One canary controller for the fleet (`enable_canary`), promoting
        # through the all-or-nothing `reload_from_store`.
        self.canary = None
        self._model_identity: dict | None = None
        self._init_metrics()
        # Constructed here so the state machine may auto-quarantine (there is
        # something to heal it); its thread starts with the HTTP server.
        if config.supervisor_enabled:
            self.supervisor = FleetSupervisor(self, clock=clock)
        if config.slo_enabled:
            self.slo = SLOEngine(
                self.registry,
                default_objectives(config),
                clock=clock,
                windows_s=config.slo_windows_s,
                fast_burn_threshold=config.slo_fast_burn_threshold,
            )
            self.slo.register_gauges()
        # The fleet's history: one sampler over the facade's registry and
        # every replica's, merged — fleet sums beside per-replica series. The
        # replicas' own history stores stay unstarted behind the facade.
        self.history: TimeSeriesStore | None = None
        if config.history_enabled:
            self.history = TimeSeriesStore(
                scrape=self._fleet_scrape,
                interval_s=config.history_interval_s,
                tiers=config.history_tiers,
            )
        # Built last, as it reads the SLO engine, the history and admission;
        # its thread starts with the HTTP server (`start_autoscaler`).
        self.autoscaler: FleetAutoscaler | None = None
        if config.autoscaler_enabled:
            self.autoscaler = FleetAutoscaler(self, clock=clock)

    def _fleet_scrape(self) -> dict:
        """The history's scrape: the facade's registry first with no join
        labels (its request families are already fleet-level), then each
        replica's under ``replica=i``, kept beside the sums."""
        regs = [self.registry] + [r.registry for r in self.replicas]
        extra = [{}] + [{"replica": str(i)} for i in range(len(regs) - 1)]
        return merge_expositions(
            [parse_exposition(r.render()) for r in regs], extra_labels=extra, keep_sources=True
        )

    def _new_health(self, i: int) -> ReplicaHealth:
        cfg = self.config
        return ReplicaHealth(
            i,
            alpha=cfg.supervisor_ewma_alpha,
            degraded_ewma=cfg.supervisor_degraded_ewma,
            quarantine_ewma=cfg.supervisor_quarantine_ewma,
            recover_ewma=cfg.supervisor_recover_ewma,
            clock=self._clock,
        )

    @classmethod
    def from_store(
        cls,
        store: ObjectStore,
        config: ServeConfig | None = None,
        *,
        device: torch.device | str = "cuda",
        clock: Callable[[], float] = time.monotonic,
    ) -> "ScorerService | ReplicaSet":
        """The fleet from one restore: the store is read once and every
        replica packs the same artifact. ``replicas <= 1`` is the plain
        `ScorerService`: there is nothing to route between."""
        cfg = config or ServeConfig()
        n = max(1, int(cfg.replicas))
        if n == 1:
            return ScorerService.from_store(store, cfg, device=device, clock=clock)
        devices = resolve_replica_devices(n, cfg.replica_devices, device)
        # The replicas resolve the registry's ``latest`` channel but attach
        # no canary: the fleet's controller goes on the facade below.
        first = ScorerService.from_store(
            store, cfg, device=devices[0], clock=clock, enable_canary=False
        )
        replicas = [first]
        for dev in devices[1:]:
            rep = ScorerService(first.artifact, cfg, device=dev, store=store, clock=clock)
            rep._model_key = first._model_key
            replicas.append(rep)
        fleet = cls(replicas, cfg, clock=clock)
        if cfg.canary_enabled:
            fleet.enable_canary()
        return fleet

    # -- lifecycle hooks the HTTP server calls ---------------------------------------

    def start_history(self) -> None:
        """Start the fleet's history sampler and the journal's shipping to
        the bound store (idempotent; the HTTP server calls it when its
        socket opens)."""
        if self.history is not None:
            self.history.start()
        if self._store is not None:
            if self.journal._store is None:
                self.journal.attach_store(self._store)
            self.journal.start()

    def start_supervisor(self) -> None:
        """Start the supervision loop (idempotent; the HTTP server calls it
        when its socket opens). In-process fleets keep the state machine and
        the router's penalty; tests drive `FleetSupervisor.tick`."""
        if self.supervisor is not None:
            self.supervisor.start()

    def start_autoscaler(self) -> None:
        """Start the autoscaler's loop (idempotent; the HTTP server calls it
        when its socket opens). Held-clock callers drive
        `FleetAutoscaler.tick` instead."""
        if self.autoscaler is not None:
            self.autoscaler.start()

    def events(
        self,
        *,
        component: str | None = None,
        kind: str | None = None,
        since: float | None = None,
        limit: int | None = None,
    ) -> list[dict]:
        """The ``GET /events`` body: the fleet's journal and every replica's,
        one list in event-id order."""
        journals = [self.journal] + [rep.journal for rep in self.replicas]
        return merge_events(journals, component=component, kind=kind, since=since, limit=limit)

    # -- metrics ----------------------------------------------------------------------

    def _init_metrics(self) -> None:
        reg = self.registry
        # The request families the single service has, so the SLO engine
        # and dashboards read a fleet unchanged.
        self._m_latency = reg.histogram(
            "cobalt_request_latency_seconds",
            "request wall time by route and final HTTP status",
            ("route", "status"),
        )
        self._m_phase = reg.histogram(
            "cobalt_request_phase_seconds",
            "request wall time attributed to each serving phase",
            ("phase",),
        )
        self._m_errors = reg.counter(
            "cobalt_request_errors_total",
            "non-2xx responses by route and typed error code",
            ("route", "code"),
        )
        adm = self.admission
        reg.gauge(
            "cobalt_admission_in_flight",
            "scoring requests currently holding an admission slot",
        ).set_function(lambda: adm.in_flight)
        reg.counter(
            "cobalt_admission_admitted_total",
            "scoring requests admitted past both admission gates",
        ).set_function(lambda: adm.admitted)
        shed = reg.counter(
            "cobalt_admission_shed_total",
            "requests shed 429 at the door, by which gate refused them",
            ("gate",),
        )
        shed.labels(gate="rate").set_function(lambda: adm.shed_rate)
        shed.labels(gate="capacity").set_function(lambda: adm.shed_capacity)
        reg.gauge("cobalt_replica_count", "serving replicas behind the router").set_function(
            lambda: len(self.replicas)
        )
        reg.gauge(
            "cobalt_brownout_level",
            "current brownout ladder rung (0 healthy .. 5 shed-everything; "
            "see serve.autoscaler.BROWNOUT_RUNGS)",
        ).set_function(lambda: float(self.brownout.level))
        self._g_inflight = reg.gauge(
            "cobalt_replica_in_flight",
            "requests currently routed to (and not yet returned by) each replica",
            ("replica",),
        )
        self._g_queue = reg.gauge(
            "cobalt_replica_queue_depth",
            "each replica's micro-batch queue depth (0 when coalescing is off)",
            ("replica",),
        )
        self._m_routed = reg.counter(
            "cobalt_replica_routed_total",
            "requests the least-loaded router sent to each replica",
            ("replica",),
        )
        self._g_state = reg.gauge(
            "cobalt_supervisor_state",
            "replica health state (0 healthy, 1 degraded, 2 quarantined, "
            "3 restarting; a retired slot reports 3)",
            ("replica",),
        )
        self._g_ewma = reg.gauge(
            "cobalt_supervisor_error_ewma",
            "per-replica error-rate EWMA over routed outcomes "
            "(replica-internal failures only)",
            ("replica",),
        )
        self._m_transitions = reg.counter(
            "cobalt_supervisor_transitions_total",
            "replica health-state transitions by replica and target state",
            ("replica", "to"),
        )
        self._m_quarantines = reg.counter(
            "cobalt_supervisor_quarantines_total",
            "replica quarantines by trigger (auto: supervisor; manual: "
            "POST /admin/quarantine)",
            ("replica", "trigger"),
        )
        self._m_hedges = reg.counter(
            "cobalt_replica_hedges_total",
            "hedged single-row failovers by outcome (rescued: the retry "
            "answered; failed: the retry also errored)",
            ("outcome",),
        )
        self._m_reloads = reg.counter(
            "cobalt_model_reloads_total",
            "fleet-wide hot swap attempts by outcome (ok / rolled_back)",
            ("status",),
        )
        self._m_model_info = reg.gauge(
            "cobalt_model_info",
            "identity of the serving model (value is always 1; the labels "
            "carry the information)",
            ("version", "channel", "provenance_md5"),
        )
        self._model_info_labels = ("unversioned", "direct", "none")
        self._m_model_info.labels(*self._model_info_labels).set(1.0)
        self._c_bulk_rows = reg.counter(
            "cobalt_bulk_rows_total",
            "rows scored through each replica's bulk (sharded) path",
            ("replica",),
        )
        self._c_bulk_disp = reg.counter(
            "cobalt_bulk_dispatches_total",
            "device dispatches issued by each replica's bulk path",
            ("replica",),
        )
        # With a replica per card each replica publishes its own program rows
        # under a ``replica`` label; replicas sharing one device share one
        # process-wide program table, published once.
        self._pinned_publish = len({str(rep.device) for rep in self.replicas}) > 1
        self._slots_registered = 0
        for i in range(len(self.replicas)):
            self._register_replica_metrics(i)
        if not self._pinned_publish:
            install_program_metrics(reg)
        install_device_metrics(reg)

    def _register_replica_metrics(self, i: int) -> None:
        """Slot ``i``'s collect functions (once per slot). They capture the
        slot index, not the replica: a healed replica is swapped into its
        slot and the reads follow."""
        if i < self._slots_registered:
            return
        self._slots_registered = i + 1

        def _rep(i: int) -> ScorerService | None:
            return self.replicas[i] if i < len(self.replicas) else None

        self._g_state.labels(replica=str(i)).set_function(
            lambda i=i: float(
                STATE_CODES[self.replica_health[i].state]
                if i < len(self.replica_health)
                else STATE_CODES[RESTARTING]
            )
        )
        self._g_ewma.labels(replica=str(i)).set_function(
            lambda i=i: self.replica_health[i].error_ewma if i < len(self.replica_health) else 0.0
        )
        self._g_inflight.labels(replica=str(i)).set_function(
            lambda i=i: self._inflight[i] if i < len(self._inflight) else 0
        )
        self._g_queue.labels(replica=str(i)).set_function(
            lambda i=i: 0 if _rep(i) is None or _rep(i).batcher is None else _rep(i).batcher.queue_depth()
        )
        self._c_bulk_rows.labels(replica=str(i)).set_function(
            lambda i=i: 0 if _rep(i) is None else _rep(i)._m_bulk_rows.value
        )
        self._c_bulk_disp.labels(replica=str(i)).set_function(
            lambda i=i: 0 if _rep(i) is None else _rep(i)._m_bulk_dispatches.value
        )
        if self._pinned_publish:
            default_program_registry().publish(
                self.registry, replica=str(i), device=str(self.replicas[i].device)
            )

    # -- routing ----------------------------------------------------------------------

    def _load_of(self, i: int) -> float:
        rep = self.replicas[i]
        queued = 0 if rep.batcher is None else rep.batcher.queue_depth()
        return self._inflight[i] + queued + self._ERROR_PENALTY * self.replica_health[i].error_ewma

    def _pick(self, exclude: tuple[int, ...] = ()) -> int:
        """The least-loaded routable replica, round-robin among ties. With
        every replica out of routing it fails open to the least loaded of
        all (a degraded answer beats none). ``exclude`` is the hedge's
        "not the replica that just failed"."""
        with self._route_lock:
            n = len(self.replicas)
            best, best_load = None, None
            for routable_only in (True, False):
                for off in range(n):
                    i = (self._rr + off) % n
                    if i in exclude:
                        continue
                    if routable_only and not self.replica_health[i].routable:
                        continue
                    load = self._load_of(i)
                    if best_load is None or load < best_load:
                        best, best_load = i, load
                if best is not None:
                    break
            if best is None:
                raise RuntimeError(
                    f"no replica available to route to (fleet of {n}, excluded {sorted(exclude)})"
                )
            self._rr = (best + 1) % n
            self._inflight[best] += 1
        self._m_routed.labels(replica=str(best)).inc()
        return best

    @contextlib.contextmanager
    def _routed(self, exclude: tuple[int, ...] = ()):
        """Route one call: yields ``(index, replica)``, brackets the
        in-flight count and folds the outcome into the replica's EWMA (only
        replica-internal failures count against it)."""
        i = self._pick(exclude)
        ok = True
        try:
            with default_tracer().span("serve.route", replica=i):
                yield i, self.replicas[i]
        except BaseException as exc:
            ok = not replica_internal(exc)
            raise
        finally:
            with self._route_lock:
                if i < len(self._inflight):
                    self._inflight[i] -= 1
            self._record_outcome(i, ok)

    def _record_outcome(self, i: int, ok: bool) -> None:
        if i >= len(self.replica_health):
            return
        h = self.replica_health[i]
        # Auto-quarantine only with a supervisor to heal it.
        transition = h.record_outcome(ok, allow_quarantine=self.supervisor is not None)
        if transition is not None:
            self._note_transition(i, *transition)
            if transition[1] == QUARANTINED:
                self._m_quarantines.labels(replica=str(i), trigger="auto").inc()

    def _note_transition(
        self,
        i: int,
        old: str,
        new: str,
        *,
        cause: Mapping[str, Any] | None = None,
        cause_id: int | None = None,
    ) -> int:
        """Journal, log, trace and count one health transition; returns the
        event id (a heal chains its later events to it). ``cause`` defaults
        to the reason and the error EWMA at the transition."""
        h = self.replica_health[i]
        self._m_transitions.labels(replica=str(i), to=new).inc()
        with default_tracer().span("supervisor.transition", replica=i, frm=old, to=new):
            pass
        eid = self.journal.emit(
            "supervisor",
            "transition",
            replica=i,
            payload={"from": old, "to": new, "reason": h.reason},
            cause=dict(cause)
            if cause is not None
            else {"reason": h.reason, "error_ewma": round(h.error_ewma, 4)},
            cause_id=cause_id,
        )
        self._last_transition_event[i] = eid
        log = _LOG.warning if new in (QUARANTINED, RESTARTING) else _LOG.info
        with event_context(eid):
            log(
                "replica_health_transition",
                replica=i,
                frm=old,
                to=new,
                reason=h.reason,
                error_ewma=round(h.error_ewma, 4),
            )
        return eid

    def _swap_replica(self, i: int, replacement: ScorerService) -> ScorerService:
        """Put a rebuilt replica into slot ``i`` under the route lock, so no
        pick sees a half-swapped slot."""
        replacement.brownout = self.brownout
        with self._route_lock:
            old, self.replicas[i] = self.replicas[i], replacement
        return old

    def add_replica(self, replica: ScorerService) -> int:
        """Publish a new replica into routing at runtime (callers build and
        smoke-check it first). Appended, so every existing index, label and
        health record stays put under traffic; the admission limits are
        rescaled to the new fleet size."""
        replica.brownout = self.brownout
        with self._route_lock:
            i = len(self.replicas)
            self.replicas.append(replica)
            self._inflight.append(0)
            self.replica_health.append(self._new_health(i))
        self._register_replica_metrics(i)
        admission = self.admission.rescale(len(self.replicas))
        eid = self.journal.emit(
            "admission",
            "rescale",
            replica=i,
            payload=dict(admission),
            cause={"trigger": "replica_added", "replicas": i + 1},
        )
        with event_context(eid):
            _LOG.info("replica_added", replica=i, admission=admission)
        return i

    def remove_replica(self, *, drain_timeout_s: float | None = None) -> dict:
        """Drain and retire the tail replica at runtime. Only the tail goes
        (popping a middle slot would renumber the others under traffic),
        never the last routable replica nor one being healed. It is marked
        restarting (no new picks), its in-flight requests get a bounded
        drain, then it is popped and closed on a reaper thread."""
        with self._resize_lock:
            with self._route_lock:
                n = len(self.replicas)
                i = n - 1
                routable = sum(h.routable for h in self.replica_health)
            if n <= 1 or (self.replica_health[i].routable and routable <= 1):
                raise ValidationError(
                    "refusing to retire below one routable replica (the fleet would go dark)"
                )
            h = self.replica_health[i]
            if not h.routable:
                raise ValidationError(
                    f"tail replica {i} is {h.state} (being healed); retry the retire once it settles"
                )
            self._note_transition(i, *h.to(RESTARTING, "retiring (scale-down)"))
            timeout = (
                float(drain_timeout_s)
                if drain_timeout_s is not None
                else float(self.config.supervisor_drain_timeout_s)
            )
            give_up = self._clock() + timeout
            drained, spins = False, 0
            while spins < 10_000:
                spins += 1
                with self._route_lock:
                    if self._inflight[i] == 0:
                        drained = True
                        break
                if self._clock() >= give_up:
                    break
                time.sleep(0.02)
            with self._route_lock:
                old = self.replicas.pop()
                self._inflight.pop()
                self.replica_health.pop()
                self._rr %= max(1, len(self.replicas))
            threading.Thread(target=old.close, daemon=True, name=f"replica-retire-{i}").start()
            del old
            admission = self.admission.rescale(len(self.replicas))
            eid = self.journal.emit(
                "admission",
                "rescale",
                replica=i,
                payload=dict(admission),
                cause={"trigger": "replica_retired", "replicas": len(self.replicas)},
            )
            with event_context(eid):
                _LOG.info("replica_retired", replica=i, replicas=len(self.replicas),
                          drained=drained, admission=admission)
            return {"status": "retired", "replica": i, "replicas": len(self.replicas),
                    "drained": drained}

    # -- the scoring surface ---------------------------------------------------------

    def _hedge_target(self, exc: BaseException, deadline, failed: int | None):
        """The exclusion tuple for a hedged retry, or None: hedging on,
        another replica to try, a replica-internal failure (a typed error
        fails alike anywhere) and deadline budget left."""
        if (
            not self.config.hedge_enabled
            or failed is None
            or len(self.replicas) < 2
            or not replica_internal(exc)
        ):
            return None
        if deadline is not None and deadline.remaining() <= 0.0:
            return None
        return (failed,)

    def _shed_hint_s(self) -> float:
        return float(self.config.reliability.shed_retry_after_s)

    def _fleet_response(self, resp: dict) -> dict:
        """The fleet's identity and its canary tap (skipped at brownout
        rung 1) on a routed single-row response."""
        if self._model_identity is not None:
            resp["model_version"] = self._model_identity["version"]
        can = self.canary
        if can is not None and self.brownout.level < LEVEL_NO_CANARY:
            can.tap(resp["input_row"], resp["prob_default"], None)
        return resp

    def _log_hedge(self, failed: int | None, exc: BaseException) -> None:
        _LOG.warning("hedged_failover", failed_replica=failed, error=f"{type(exc).__name__}: {exc}")

    def predict_single(self, payload: Mapping[str, Any], *, deadline=None) -> dict:
        brownout_gate(self.brownout, "single", retry_after_s=self._shed_hint_s())
        first: int | None = None
        try:
            with self._routed() as (i, rep):
                first = i
                resp = rep.predict_single(payload, deadline=deadline)
        except BaseException as exc:
            exclude = self._hedge_target(exc, deadline, first)
            if exclude is None:
                raise
            self._log_hedge(first, exc)
            try:
                with self._routed(exclude) as (_i, rep):
                    resp = rep.predict_single(payload, deadline=deadline)
            except BaseException:
                self._m_hedges.labels(outcome="failed").inc()
                raise
            self._m_hedges.labels(outcome="rescued").inc()
        return self._fleet_response(resp)

    async def predict_single_async(self, payload: Mapping[str, Any], *, deadline=None) -> dict:
        """`predict_single` on the event loop: the router takes plain locks
        only, and the in-flight count brackets the whole await."""
        brownout_gate(self.brownout, "single", retry_after_s=self._shed_hint_s())
        first: int | None = None
        try:
            with self._routed() as (i, rep):
                first = i
                resp = await rep.predict_single_async(payload, deadline=deadline)
        except BaseException as exc:
            exclude = self._hedge_target(exc, deadline, first)
            if exclude is None:
                raise
            self._log_hedge(first, exc)
            try:
                with self._routed(exclude) as (_i, rep):
                    resp = await rep.predict_single_async(payload, deadline=deadline)
            except BaseException:
                self._m_hedges.labels(outcome="failed").inc()
                raise
            self._m_hedges.labels(outcome="rescued").inc()
        return self._fleet_response(resp)

    def predict_bulk_csv(self, csv_bytes: bytes, *, deadline=None) -> dict:
        brownout_gate(self.brownout, "bulk", retry_after_s=self._shed_hint_s())
        with self._routed() as (_i, rep):
            return rep.predict_bulk_csv(csv_bytes, deadline=deadline)

    async def predict_bulk_csv_async(self, csv_bytes: bytes, *, deadline=None) -> dict:
        brownout_gate(self.brownout, "bulk", retry_after_s=self._shed_hint_s())
        with self._routed() as (_i, rep):
            return await rep.predict_bulk_csv_async(csv_bytes, deadline=deadline)

    def feature_importance_bulk(self, payload: Mapping[str, Any], *, deadline=None) -> dict:
        brownout_gate(self.brownout, "bulk", retry_after_s=self._shed_hint_s())
        with self._routed() as (_i, rep):
            return rep.feature_importance_bulk(payload, deadline=deadline)

    async def feature_importance_bulk_async(self, payload: Mapping[str, Any], *, deadline=None) -> dict:
        brownout_gate(self.brownout, "bulk", retry_after_s=self._shed_hint_s())
        with self._routed() as (_i, rep):
            return await rep.feature_importance_bulk_async(payload, deadline=deadline)

    def predict_proba(self, X: np.ndarray, deadline=None) -> np.ndarray:
        with self._routed() as (_i, rep):
            return rep.predict_proba(X, deadline=deadline)

    # -- observability hooks the HTTP server calls ------------------------------------

    def observe_request(
        self,
        route: str,
        status: int,
        duration_s: float,
        code: str | None = None,
        trace_id: int | str | None = None,
    ) -> None:
        self._m_latency.labels(route=route, status=str(status)).observe(
            max(0.0, duration_s), exemplar=None if trace_id is None else str(trace_id)
        )
        if status >= 400:
            self._m_errors.labels(route=route, code=code or "error").inc()
        if self.canary is not None:
            self.canary.maybe_auto_rollback()

    @contextlib.contextmanager
    def phase(self, name: str):
        try:
            with default_tracer().span(f"serve.{name}") as sp:
                yield sp
        finally:
            duration_s = max(0.0, sp.duration_s or 0.0)
            self._m_phase.labels(phase=name).observe(duration_s)
            add_phase(name, duration_s)

    # -- the fleet --------------------------------------------------------------------

    @property
    def artifact(self) -> GBDTArtifact:
        return self.replicas[0].artifact

    @property
    def feature_names(self) -> list[str]:
        return self.replicas[0].feature_names

    @property
    def device(self) -> torch.device:
        """The first replica's device (the canary's models pack there)."""
        return self.replicas[0].device

    def health(self) -> dict:
        return {"status": "ok"}

    def ready(self) -> tuple[bool, dict]:
        """Ready when some replica is routable and every routable replica is
        ready (a fleet healing one replica still serves), with the fleet's
        shape on top and each replica's payload, its health block added."""
        per = [rep.ready() for rep in self.replicas]
        routable = [h.routable for h in self.replica_health]
        all_ready = any(routable) and all(ok for (ok, _), r in zip(per, routable) if r)
        for (_, p), h in zip(per, self.replica_health):
            p["supervisor"] = h.snapshot()
        payload = {
            "status": "ok" if all_ready else "unavailable",
            "replicas": len(self.replicas),
            "replica_devices": [str(rep.device) for rep in self.replicas],
            "router": {
                "policy": "least_loaded",
                "in_flight": list(self._inflight),
                "routable": routable,
            },
            "supervisor": (
                self.supervisor.status()
                if self.supervisor is not None
                else {"enabled": False, "states": [h.state for h in self.replica_health]}
            ),
            "admission": self.admission.stats(),
            "brownout": self.brownout.snapshot(),
            "autoscaler": (
                self.autoscaler.status() if self.autoscaler is not None else {"enabled": False}
            ),
            "per_replica": [p for _, p in per],
            "events": self.journal.stats(),
        }
        if self._last_reload is not None:
            payload["last_reload"] = self._last_reload
        payload["model"] = self.model_info
        if self.canary is not None:
            self.canary.maybe_auto_rollback()
            payload["canary"] = self.canary.status()
        return all_ready, payload

    def reload_from_store(self, store: ObjectStore | None = None, model_key: str | None = None) -> dict:
        """All-or-nothing fleet swap: every replica restores, packs, warms
        and smoke-checks its candidate first; only when all are good does
        any publish. A failure anywhere rolls back everywhere."""
        with self._swap_lock:
            key = model_key or self.replicas[0]._model_key
            candidates = []
            try:
                for rep in self.replicas:
                    s = store if store is not None else rep._store
                    if s is None:
                        raise RuntimeError(
                            "no store bound: construct the fleet with from_store() or "
                            "pass store= explicitly"
                        )
                    candidates.append(rep._build_candidate(s, key))
            except CircuitOpenError:
                raise
            except Exception as exc:
                del candidates
                self._last_reload = {
                    "status": "rolled_back",
                    "model_key": key,
                    "replicas": len(self.replicas),
                    "error": f"{type(exc).__name__}: {exc}",
                }
                self._m_reloads.labels(status="rolled_back").inc()
                eid = self.journal.emit(
                    "reload",
                    "rollback",
                    model=key,
                    payload=dict(self._last_reload),
                    cause={"error": self._last_reload["error"]},
                )
                with event_context(eid):
                    _LOG.warning("fleet_reload", **self._last_reload)
                return self._last_reload
            eid = self.journal.emit(
                "reload", "publish", model=key, payload={"replicas": len(self.replicas), "model_key": key}
            )
            with event_context(eid):  # the replicas' publish events chain to it
                for rep, cand in zip(self.replicas, candidates):
                    rep._publish_candidate(cand, key)
            self._last_reload = {
                "status": "ok",
                "model_key": key,
                "replicas": len(self.replicas),
                "n_features": candidates[0].n_features,
            }
            self._m_reloads.labels(status="ok").inc()
            with event_context(eid):
                _LOG.info("fleet_reload", **self._last_reload)
            return self._last_reload

    # -- the continuous-training loop (serve.canary) -----------------------------------

    @property
    def _model_key(self) -> str | None:
        """The key every replica serves (fleet swaps are all-or-nothing)."""
        return self.replicas[0]._model_key

    @property
    def _store(self):
        return self.replicas[0]._store

    @property
    def model_info(self) -> dict:
        """The fleet model's identity: `/readyz`'s ``model`` block and the
        ``model_version`` of responses."""
        if self._model_identity is not None:
            return self._model_identity
        return {"version": "unversioned", "channel": "direct", "provenance_md5": None}

    def set_model_info(self, *, version: str, channel: str, provenance_md5: str | None) -> None:
        """Move ``cobalt_model_info`` to a new identity (the old labels drop
        to 0)."""
        self._model_identity = {
            "version": version,
            "channel": channel,
            "provenance_md5": provenance_md5,
        }
        new_labels = (version, channel, provenance_md5 or "none")
        self._m_model_info.labels(*self._model_info_labels).set(0.0)
        self._m_model_info.labels(*new_labels).set(1.0)
        self._model_info_labels = new_labels

    def enable_canary(self, on_drift=None) -> "ReplicaSet":
        """Attach one fleet-level canary controller (idempotent): it shadows
        the facade's responses and swaps through `reload_from_store`, so a
        promotion lands on every replica or on none."""
        if self.canary is not None:
            return self
        store = self._store
        if store is None:
            raise RuntimeError(
                "no store bound: construct the fleet with from_store() or bind a store on the replicas"
            )
        from cobalt_smart_lender_ai_tpu_torch.serve.canary import CanaryController

        self.canary = CanaryController(
            self,
            _registry_store(store, self.config),
            config=self.config,
            clock=self._clock,
            on_drift=on_drift,
        )
        try:
            self.canary.sync_identity()
            self.canary.refresh()
        except Exception as exc:
            _LOG.warning("canary_enable_degraded", error=str(exc))
        return self

    def promote_canary(self, *, force: bool = False) -> dict:
        """``POST /admin/promote``: gate, fleet swap, channel flip."""
        if self.canary is None:
            raise PromotionRejected(
                "canary evaluation is not enabled on this fleet",
                report={"eligible": False, "reasons": ["canary_not_enabled"]},
            )
        return self.canary.promote(force=force)

    def rollback_model(self, *, reason: str = "manual") -> dict:
        """``POST /admin/rollback``: demote ``latest`` back to ``previous``."""
        if self.canary is None:
            raise RollbackFailed("canary evaluation is not enabled on this fleet")
        return self.canary.rollback(reason=reason, trigger="manual")

    def drift_report(self) -> dict:
        """``GET /drift``."""
        if self.canary is None:
            return {"status": "disabled"}
        return self.canary.drift_report()

    # -- manual supervision (POST /admin/quarantine, /admin/readmit) ------------------

    def _check_replica_index(self, index) -> int:
        try:
            i = int(index)
        except (TypeError, ValueError):
            raise ValidationError(f"replica must be an integer, got {index!r}") from None
        if not 0 <= i < len(self.replicas):
            raise ValidationError(f"replica {i} out of range for a fleet of {len(self.replicas)}")
        return i

    def quarantine_replica(self, index, *, reason: str = "manual quarantine") -> dict:
        """Operator eviction until ``POST /admin/readmit`` (the supervisor
        leaves manual quarantines alone). The last routable replica is never
        evicted."""
        i = self._check_replica_index(index)
        h = self.replica_health[i]
        if h.state in (QUARANTINED, RESTARTING):
            return {"status": h.state, "replica": i, "supervisor": h.snapshot()}
        if sum(x.routable for x in self.replica_health) <= 1:
            raise ValidationError(
                "refusing to quarantine the last routable replica (the fleet would go dark)"
            )
        self._note_transition(i, *h.to(QUARANTINED, reason, manual=True))
        self._m_quarantines.labels(replica=str(i), trigger="manual").inc()
        return {"status": "quarantined", "replica": i, "reason": reason, "supervisor": h.snapshot()}

    def readmit_replica(self, index) -> dict:
        """Operator readmission: state and EWMA reset, traffic at once, no
        rebuild (the supervisor's heal rebuilds)."""
        i = self._check_replica_index(index)
        h = self.replica_health[i]
        if h.state not in (QUARANTINED, RESTARTING):
            raise ValidationError(f"replica {i} is {h.state}, not quarantined — nothing to readmit")
        self._note_transition(i, *h.to(HEALTHY, "manual readmit"))
        return {"status": "readmitted", "replica": i, "supervisor": h.snapshot()}

    def autoscaler_admin(self, payload: Mapping[str, Any] | None) -> dict:
        """``POST /admin/autoscaler``: ``{"action": "pause" | "resume" |
        "status"}``, or ``{"action": "force", "replicas": n}`` (walks the
        fleet to ``n`` through the same add and retire paths, past the
        cooldowns). Typed 422 without an autoscaler or on a bad action."""
        if self.autoscaler is None:
            raise ValidationError(
                "autoscaler is not enabled on this fleet (ServeConfig.autoscaler_enabled)"
            )
        action = (payload or {}).get("action", "status")
        if action == "pause":
            return self.autoscaler.pause()
        if action == "resume":
            return self.autoscaler.resume()
        if action == "status":
            return self.autoscaler.status()
        if action == "force":
            return self.autoscaler.force((payload or {}).get("replicas"))
        raise ValidationError(
            f"unknown autoscaler action {action!r}; expected pause, resume, status, or force"
        )

    def close(self) -> None:
        """Shut the fleet down, the replicas closing together under
        ``replica_close_timeout_s``: one wedged replica cannot hold the
        others' shutdown. Stragglers are left to their daemon threads."""
        if self.autoscaler is not None:
            self.autoscaler.stop()
        if self.supervisor is not None:
            self.supervisor.stop()
        if self.canary is not None:
            self.canary.close()
        if self.history is not None:
            self.history.stop()
        self.journal.stop()
        timeout = max(0.1, float(self.config.replica_close_timeout_s))
        closers = [
            threading.Thread(target=rep.close, daemon=True, name=f"replica-close-{i}")
            for i, rep in enumerate(self.replicas)
        ]
        for t in closers:
            t.start()
        give_up = time.monotonic() + timeout
        for t in closers:
            t.join(timeout=max(0.0, give_up - time.monotonic()))
        stragglers = [t.name for t in closers if t.is_alive()]
        if stragglers:
            _LOG.warning("replica_close_timeout", timeout_s=timeout, stragglers=stragglers)
