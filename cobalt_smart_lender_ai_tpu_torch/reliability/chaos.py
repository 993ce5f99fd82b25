"""`ChaosPlan`: scriptable replica faults for the serving fleet.

The reference's ``reliability/chaos.py``. A plan arms faults per replica
index and injects them at each replica micro-batcher's chaos checkpoint,
which the worker reads once per loop iteration, before the batch's launch:

- ``kill_worker``   the worker raises `WorkerKilled` and dies with its batch
                    in hand (the watchdog fails it typed and restarts it);
- ``hang_dispatch`` the worker sleeps ``hang_s`` on the host before the
                    launch (`ChaosPlan.release` wakes it early), so the
                    queue head ages and deadline-bounded probes time out;
- ``error_storm``   the dispatch raises `ChaosError`, a replica-internal
                    failure: the batch's futures fail with it, the worker
                    lives, the error EWMA and hedged failover see it;
- ``add_latency``   the dispatch sleeps ``delay_s`` plus a seeded jitter.

A hang or a delay is a host sleep before the launch, never inside a CUDA
call. Determinism as `FaultInjectingStore`'s: one ``random.Random(seed)``
drawn in call order, an injectable ``sleep`` and ``clock``, and per-kind
counters mirrored into ``cobalt_chaos_events_total`` behind a weakref.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
import weakref
from collections import Counter
from typing import Callable

from cobalt_smart_lender_ai_tpu_torch.telemetry import (
    MetricsRegistry,
    default_registry,
    get_logger,
)

_LOG = get_logger("reliability.chaos")

KINDS = ("kill", "hang", "error", "delay")


class ChaosError(RuntimeError):
    """An injected replica-internal dispatch failure. Not a `RequestError`:
    it stands for a bug inside one replica, which hedged failover retries
    elsewhere."""


class WorkerKilled(BaseException):
    """Raised at the worker's chaos checkpoint. A `BaseException`, so it
    escapes the worker's per-batch containment and kills the thread with
    its queue intact: what the watchdog exists to survive."""


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    """One armed fault profile for one replica.

    - ``kill_worker``: raise `WorkerKilled` through the worker loop.
    - ``hang_s``: wedge the worker this long before the launch.
    - ``error_rate``: probability that a dispatch raises `ChaosError`.
    - ``error_after``: the first N dispatches are clean, later ones raise.
    - ``delay_s`` / ``delay_jitter_s``: added latency, the jitter a seeded
      uniform draw in ``[0, delay_jitter_s)``.
    - ``max_events``: the fault budget (None: unbounded); a bounded budget
      lets the fleet heal.
    """

    kill_worker: bool = False
    hang_s: float = 0.0
    error_rate: float = 0.0
    error_after: int | None = None
    delay_s: float = 0.0
    delay_jitter_s: float = 0.0
    max_events: int | None = None


@dataclasses.dataclass
class _Armed:
    """A `ChaosSpec` and what it has spent."""

    replica: int
    spec: ChaosSpec
    spent: int = 0
    dispatches: int = 0

    def budget_left(self) -> bool:
        return self.spec.max_events is None or self.spent < self.spec.max_events


class ChaosPlan:
    """Arms faults per replica index and injects them into a fleet::

        plan = ChaosPlan(seed=7)
        plan.kill_worker(replica=1)
        plan.error_storm(replica=1, rate=1.0, max_events=20)
        plan.inject(fleet)          # or one ScorerService (replica 0)
        ...
        plan.release()              # wake hangs, detach every hook

    The hooks read the armed list on every dispatch, so arming after
    `inject` takes effect at once. A replica the supervisor rebuilds gets a
    fresh batcher without a hook: healing clears chaos, as a process
    restart would."""

    def __init__(
        self,
        *,
        seed: int = 0,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
        registry: MetricsRegistry | None = None,
    ):
        self._rng = random.Random(seed)
        self._sleep = sleep
        self._clock = clock
        self._lock = threading.Lock()
        self._armed: list[_Armed] = []
        self._hooked: list = []  # weakrefs to the batchers hooked, for release()
        self._released = threading.Event()
        self.events: Counter[str] = Counter()
        self.last_event_at: dict[str, float] = {}
        # The injected fleet's journal (a weakref: chaos never keeps a fleet
        # alive); every fault is a ``chaos.inject`` event there.
        self._journal_ref: Callable[[], object | None] = lambda: None
        self._register_metrics(registry if registry is not None else default_registry())

    # -- arming -----------------------------------------------------------------

    def arm(self, replica: int, spec: ChaosSpec) -> "ChaosPlan":
        with self._lock:
            self._armed.append(_Armed(replica=int(replica), spec=spec))
        return self

    def kill_worker(self, replica: int = 0, *, max_events: int = 1) -> "ChaosPlan":
        return self.arm(replica, ChaosSpec(kill_worker=True, max_events=max_events))

    def hang_dispatch(
        self, replica: int = 0, hang_s: float = 1.0, *, max_events: int = 1
    ) -> "ChaosPlan":
        return self.arm(replica, ChaosSpec(hang_s=hang_s, max_events=max_events))

    def error_storm(
        self,
        replica: int = 0,
        rate: float = 1.0,
        *,
        error_after: int | None = None,
        max_events: int | None = None,
    ) -> "ChaosPlan":
        return self.arm(
            replica, ChaosSpec(error_rate=rate, error_after=error_after, max_events=max_events)
        )

    def add_latency(
        self,
        replica: int = 0,
        delay_s: float = 0.01,
        *,
        jitter_s: float = 0.0,
        max_events: int | None = None,
    ) -> "ChaosPlan":
        return self.arm(
            replica, ChaosSpec(delay_s=delay_s, delay_jitter_s=jitter_s, max_events=max_events)
        )

    # -- injection --------------------------------------------------------------

    def inject(self, target) -> "ChaosPlan":
        """Hook every replica batcher of ``target`` (a `ReplicaSet`, or one
        `ScorerService` as replica 0)."""
        replicas = getattr(target, "replicas", None) or [target]
        journal = getattr(target, "journal", None)
        if journal is not None:
            self._journal_ref = weakref.ref(journal)
        for i, rep in enumerate(replicas):
            batcher = getattr(rep, "batcher", None)
            if batcher is None:
                continue
            batcher._chaos = _ReplicaChaos(self, i)
            self._hooked.append(weakref.ref(batcher))
        return self

    def release(self) -> None:
        """Wake any hanging worker and detach every hook; the plan injects
        nothing more, even through a stale hook."""
        self._released.set()
        with self._lock:
            self._armed.clear()
        for ref in self._hooked:
            batcher = ref()
            if batcher is not None:
                batcher._chaos = None
        self._hooked.clear()

    # -- the checkpoint (worker threads) ----------------------------------------

    def _record(self, kind: str, replica: int | None = None) -> None:
        self.events[kind] += 1
        self.last_event_at[kind] = self._clock()
        journal = self._journal_ref()
        if journal is not None:
            try:
                journal.emit(
                    "chaos",
                    "inject",
                    replica=replica,
                    payload={"fault": kind},
                    cause={"plan": "chaos", "fault": kind},
                )
            except Exception:
                pass  # the fault is injected even if journaling fails

    def _hang(self, duration: float) -> None:
        # On the real sleep, wait on the release event so `release()` wakes
        # the worker early; an injected sleep is called as it is.
        if self._sleep is time.sleep:
            self._released.wait(timeout=duration)
        else:
            self._sleep(duration)

    def _on_dispatch(self, replica: int) -> None:
        """Runs in the worker loop before each batch's launch. `WorkerKilled`
        kills the thread; `ChaosError` fails the batch; the other kinds
        sleep on the host."""
        if self._released.is_set():
            return
        with self._lock:
            armed = [a for a in self._armed if a.replica == replica]
            for a in armed:
                a.dispatches += 1
        for a in armed:
            spec = a.spec
            if not a.budget_left():
                continue
            if spec.delay_s or spec.delay_jitter_s:
                delay = spec.delay_s + spec.delay_jitter_s * self._rng.random()
                a.spent += 1
                self._record("delay", replica)
                self._sleep(delay)
            if spec.hang_s and a.budget_left():
                a.spent += 1
                self._record("hang", replica)
                _LOG.warning("chaos_hang", replica=replica, hang_s=spec.hang_s)
                self._hang(spec.hang_s)
            if spec.kill_worker and a.budget_left():
                a.spent += 1
                self._record("kill", replica)
                _LOG.warning("chaos_kill_worker", replica=replica)
                raise WorkerKilled(f"chaos killed replica {replica} worker")
            storm = spec.error_rate and (spec.error_after is None or a.dispatches > spec.error_after)
            if storm and a.budget_left() and self._rng.random() < spec.error_rate:
                a.spent += 1
                self._record("error", replica)
                raise ChaosError(
                    f"chaos error storm on replica {replica} (dispatch {a.dispatches})"
                )

    # -- metrics ----------------------------------------------------------------

    def _register_metrics(self, reg: MetricsRegistry) -> None:
        """Per-kind counts read at scrape time behind a weakref: a collected
        plan reads as absent instead of failing the scrape."""
        self_ref = weakref.ref(self)

        def _sample(kind: str) -> Callable[[], float]:
            def read() -> float:
                plan = self_ref()
                if plan is None:
                    raise LookupError("chaos plan was garbage-collected")
                return float(plan.events.get(kind, 0))

            return read

        fam = reg.counter(
            "cobalt_chaos_events_total",
            "chaos faults injected into replica workers",
            ("kind",),
        )
        for kind in KINDS:
            fam.labels(kind=kind).set_function(_sample(kind))


class _ReplicaChaos:
    """The per-batcher hook binding a plan to one replica index. The plan
    sits behind a weakref, so a dropped plan stops injecting."""

    __slots__ = ("_plan", "replica")

    def __init__(self, plan: ChaosPlan, replica: int):
        self._plan = weakref.ref(plan)
        self.replica = replica

    def on_dispatch(self) -> None:
        plan = self._plan()
        if plan is not None:
            plan._on_dispatch(self.replica)
