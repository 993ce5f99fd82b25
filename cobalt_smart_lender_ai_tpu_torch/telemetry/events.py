"""Fleet event journal: typed, causally-linked control-plane events.

The reference's ``telemetry/events.py``, module for module. The data plane
explains itself through flight phases and Dapper-style traces; this module
is the control plane's counterpart. Every fleet *action* — a supervisor
quarantine, an autoscaler resize, a brownout rung change, a canary flip, a
hot reload, a breaker trip, a chaos injection — is recorded as one typed
event in a bounded, thread-safe ring (`EventJournal`), with three causal
hooks:

- ``cause``: the structured trigger snapshot (the error-EWMA that tripped
  a quarantine, the SLO fast-burn signals that forced a resize);
- ``cause_id``: the ``event_id`` of the upstream event, so a heal chain
  (quarantine -> rebuild -> swap -> readmit) is walkable without log
  archaeology. When an emit happens inside :func:`event_context` the link
  is stamped automatically;
- the active trace/request ids when one exists, joining the journal to
  flight records and spans.

``event_id`` is minted from one process-wide monotonic sequence, so ids
from the fleet journal and per-replica journals merge into a single total
order by simple sort. Journals optionally ship md5-pinned JSON segments
through ``io/store.py``, so the record of what the fleet did survives the
fleet.

The port emits the reload, breaker and canary events today; the taxonomy
keeps the reference's other components (supervisor, autoscaler,
admission, chaos), so a journal shipped by either package reads in both.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from contextvars import ContextVar
from typing import Any, Callable, Iterable, Mapping

__all__ = [
    "EVENT_KINDS",
    "EventJournal",
    "current_event_id",
    "event_context",
    "load_events",
    "merge_events",
]

# Canonical component -> kinds taxonomy. Emit sites use these literal
# names; the ``/events`` validators 422 anything outside this table.
EVENT_KINDS: dict[str, tuple[str, ...]] = {
    "supervisor": ("transition", "probe_failure", "rebuild", "swap"),
    "autoscaler": ("resize", "retune", "brownout"),
    "canary": ("promote", "reject", "rollback"),
    "reload": ("publish", "rollback"),
    "breaker": ("open", "half_open", "close"),
    "admission": ("rescale",),
    "chaos": ("inject",),
}

# One process-wide sequence: ids stay unique and totally ordered across
# every journal in the process, so a fleet merge is a sort, not a vector
# clock.
_SEQ_LOCK = threading.Lock()
_NEXT_EVENT_ID = 1


def _mint_event_id() -> int:
    global _NEXT_EVENT_ID
    with _SEQ_LOCK:
        eid = _NEXT_EVENT_ID
        _NEXT_EVENT_ID += 1
    return eid


# The "current event" join key, mirroring request_context/span contextvars:
# emits inside the context chain to it by default, and StructuredLogger
# stamps it onto log lines so logs/flight/traces/journal share one key.
_EVENT_ID: ContextVar[int | None] = ContextVar("cobalt_event_id", default=None)


def current_event_id() -> int | None:
    """The event id of the enclosing :func:`event_context`, if any."""
    return _EVENT_ID.get()


@contextlib.contextmanager
def event_context(event_id: int | None):
    """Make ``event_id`` the ambient causal parent: journal emits inside
    the block default their ``cause_id`` to it, and structured log lines
    carry it as ``event_id``."""
    token = _EVENT_ID.set(event_id)
    try:
        yield event_id
    finally:
        _EVENT_ID.reset(token)


class EventJournal:
    """Bounded, thread-safe ring of control-plane events.

    Same discipline as FlightRecorder: ``deque(maxlen=)``
    ring, injectable clock, an explicit drop counter when the ring wraps,
    and optional durable shipping of md5-pinned segments. ``emit`` is the
    single write path and is safe from any thread (supervisor loop,
    autoscaler loop, batcher workers, breaker under its own lock — the
    journal only ever takes its own lock and calls nothing back).
    """

    def __init__(
        self,
        *,
        capacity: int = 512,
        clock: Callable[[], float] = time.time,
        mono: Callable[[], float] = time.monotonic,
        registry: Any | None = None,
        store: Any | None = None,
        store_prefix: str = "telemetry/events",
        ship_interval_s: float = 30.0,
        retain_segments: int = 48,
    ) -> None:
        if capacity < 1:
            raise ValueError("EventJournal capacity must be >= 1")
        self.capacity = int(capacity)
        self._clock = clock
        self._mono = mono
        self._ring: deque[dict[str, Any]] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.emitted = 0
        self.dropped = 0
        self._last_event_id = 0

        # durable shipping
        self._store = store
        self.store_prefix = store_prefix.rstrip("/")
        self.ship_interval_s = float(ship_interval_s)
        self.retain_segments = int(retain_segments)
        self._seq = 0
        self._shipped_until = 0  # event_id high-water mark
        self._last_ship_t: float | None = None
        self.ship_failures = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

        self._m_events = None
        self._m_dropped = None
        if registry is not None:
            self._m_events = registry.counter(
                "cobalt_events_total",
                "Control-plane events journaled, by component and kind.",
                ("component", "kind"),
            )
            self._m_dropped = registry.counter(
                "cobalt_events_dropped_total",
                "Journal events evicted by ring wrap before shipping.",
            )
            import weakref

            ref = weakref.ref(self)
            registry.gauge(
                "cobalt_events_ring_depth",
                "Events currently held in the journal ring.",
            ).set_function(
                lambda: float(len(ref()._ring)) if ref() is not None else 0.0
            )

    # -- write path --------------------------------------------------------

    def emit(
        self,
        component: str,
        kind: str,
        *,
        replica: int | str | None = None,
        model: str | None = None,
        payload: Mapping[str, Any] | None = None,
        cause: Mapping[str, Any] | str | None = None,
        cause_id: int | None = None,
    ) -> int:
        """Append one typed event; returns its process-unique ``event_id``.

        Unknown component/kind pairs are a programming error and raise —
        the taxonomy in ``EVENT_KINDS`` is the contract the forensics
        tooling parses. ``cause_id`` defaults to the ambient
        :func:`event_context` id, so call sites that actuate inside a
        context chain for free.
        """
        kinds = EVENT_KINDS.get(component)
        if kinds is None or kind not in kinds:
            raise ValueError(f"unknown event type {component}.{kind}")
        if cause_id is None:
            cause_id = _EVENT_ID.get()
        trace_id = span_id = request_id = None
        try:  # late imports: telemetry.logging imports us for the join key
            from cobalt_smart_lender_ai_tpu_torch.telemetry.logging import (
                current_request_id,
            )
            from cobalt_smart_lender_ai_tpu_torch.telemetry.tracing import (
                current_trace_ids,
            )

            request_id = current_request_id()
            ids = current_trace_ids()
            if ids is not None:
                trace_id, span_id = ids
        except Exception:
            pass
        eid = _mint_event_id()
        event = {
            "event_id": eid,
            "t": self._clock(),
            "t_mono": self._mono(),
            "component": component,
            "kind": kind,
            "replica": replica,
            "model": model,
            "payload": dict(payload) if payload else {},
            "cause": (
                dict(cause) if isinstance(cause, Mapping) else cause
            ),
            "cause_id": cause_id,
            "trace_id": trace_id,
            "request_id": request_id,
        }
        with self._lock:
            if len(self._ring) == self.capacity:
                victim = self._ring[0]
                if victim["event_id"] > self._shipped_until:
                    self.dropped += 1
                    if self._m_dropped is not None:
                        self._m_dropped.inc()
            self._ring.append(event)
            self.emitted += 1
            self._last_event_id = eid
        if self._m_events is not None:
            self._m_events.labels(component=component, kind=kind).inc()
        self._maybe_ship(event["t"])
        return eid

    # -- read path ---------------------------------------------------------

    def events(
        self,
        *,
        component: str | None = None,
        kind: str | None = None,
        since: float | None = None,
        since_id: int | None = None,
        limit: int | None = None,
    ) -> list[dict[str, Any]]:
        """Filtered snapshot, oldest first. ``since`` filters on wall
        time ``t`` (exclusive of older), ``since_id`` on ``event_id``;
        ``limit`` keeps the most recent N after filtering."""
        with self._lock:
            out = [dict(e) for e in self._ring]
        if component is not None:
            out = [e for e in out if e["component"] == component]
        if kind is not None:
            out = [e for e in out if e["kind"] == kind]
        if since is not None:
            out = [e for e in out if e["t"] >= since]
        if since_id is not None:
            out = [e for e in out if e["event_id"] > since_id]
        if limit is not None and limit >= 0:
            out = out[-limit:]
        return out

    def chain(self, event_id: int) -> list[dict[str, Any]]:
        """Walk ``cause_id`` links from ``event_id`` back to its root.
        Returns root-first; empty if the id is not in the ring."""
        with self._lock:
            by_id = {e["event_id"]: dict(e) for e in self._ring}
        out: list[dict[str, Any]] = []
        seen: set[int] = set()
        cur = by_id.get(event_id)
        while cur is not None and cur["event_id"] not in seen:
            seen.add(cur["event_id"])
            out.append(cur)
            cid = cur.get("cause_id")
            cur = by_id.get(cid) if cid is not None else None
        out.reverse()
        return out

    def stats(self) -> dict[str, Any]:
        """Journal health for ``/readyz`` and the metrics block."""
        with self._lock:
            depth = len(self._ring)
            return {
                "depth": depth,
                "capacity": self.capacity,
                "emitted": self.emitted,
                "dropped": self.dropped,
                "last_event_id": self._last_event_id,
                "shipping": {
                    "enabled": self._store is not None,
                    "segments": self._seq,
                    "shipped_until_id": self._shipped_until,
                    "ship_failures": self.ship_failures,
                    "last_ship_t": self._last_ship_t,
                },
            }

    # -- durable segments --------------------------------------------------

    def attach_store(
        self, store: Any, prefix: str | None = None
    ) -> "EventJournal":
        """Late-bind a durable store (the serving path constructs the
        journal before it knows whether an object store is in play — the
        HTTP server attaches and `start`s shipping, bare in-process
        services never write a byte)."""
        self._store = store
        if prefix is not None:
            self.store_prefix = prefix.rstrip("/")
        return self

    def _maybe_ship(self, t: float) -> None:
        if self._store is None or self.ship_interval_s <= 0:
            return
        if (
            self._last_ship_t is not None
            and t - self._last_ship_t < self.ship_interval_s
        ):
            return
        self._last_ship_t = t
        try:
            self.ship()
        except Exception:
            self.ship_failures += 1

    def ship(self) -> str | None:
        """Write one append-only segment (events since the previous ship)
        as md5-pinned JSON, then GC old segments. Returns the segment
        key, or None when nothing new accumulated."""
        if self._store is None:
            raise ValueError("EventJournal has no durable store")
        with self._lock:
            since = self._shipped_until
            events = [dict(e) for e in self._ring if e["event_id"] > since]
            if not events:
                return None
            hi = events[-1]["event_id"]
            self._seq += 1
            seq = self._seq
            doc = {
                "schema": 1,
                "seq": seq,
                "from_id": since,
                "to_id": hi,
                "events": events,
            }
        key = f"{self.store_prefix}/segment-{seq:08d}.json"
        self._store.put_json(key, doc)
        self._store.write_pointer(key)
        with self._lock:
            # only advance the high-water mark once the write held: a
            # failed ship re-ships the same events next time
            self._shipped_until = max(self._shipped_until, hi)
        self._gc_segments()
        return key

    def _gc_segments(self) -> None:
        from cobalt_smart_lender_ai_tpu_torch.io.store import PTR_SUFFIX

        segs = sorted(
            k
            for k in self._store.list(self.store_prefix + "/")
            if not k.endswith(PTR_SUFFIX)
        )
        for stale in segs[: -self.retain_segments]:
            for victim in (stale, stale + PTR_SUFFIX):
                try:
                    self._store.delete(victim)
                except Exception:
                    pass  # GC is advisory; the next ship retries

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "EventJournal":
        if self._store is None or self.ship_interval_s <= 0:
            return self
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def _run() -> None:
            while not self._stop.wait(self.ship_interval_s):
                try:
                    self.ship()
                except Exception:
                    self.ship_failures += 1

        self._thread = threading.Thread(
            target=_run, name="cobalt-event-shipper", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None
        if self._store is not None:
            try:  # final flush so the tail of the run survives
                self.ship()
            except Exception:
                self.ship_failures += 1

    def __enter__(self) -> "EventJournal":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def merge_events(
    journals: Iterable["EventJournal"],
    *,
    component: str | None = None,
    kind: str | None = None,
    since: float | None = None,
    since_id: int | None = None,
    limit: int | None = None,
) -> list[dict[str, Any]]:
    """Fleet merge: concatenate journal snapshots into one list ordered by
    the process-wide ``event_id`` (which IS the total emit order)."""
    out: list[dict[str, Any]] = []
    seen: set[int] = set()
    for j in journals:
        for e in j.events(
            component=component, kind=kind, since=since, since_id=since_id
        ):
            if e["event_id"] not in seen:
                seen.add(e["event_id"])
                out.append(e)
    out.sort(key=lambda e: e["event_id"])
    if limit is not None and limit >= 0:
        out = out[-limit:]
    return out


def load_events(
    store: Any, prefix: str = "telemetry/events"
) -> list[dict[str, Any]]:
    """Round-trip shipped segments back into one event list (sorted,
    de-duplicated by ``event_id`` — a re-shipped overlap after a failed
    write collapses cleanly). Segments whose md5 pointer fails
    `verify_pointer` are skipped: a torn write is a gap, not a crash."""
    from cobalt_smart_lender_ai_tpu_torch.io.store import PTR_SUFFIX

    prefix = prefix.rstrip("/")
    merged: dict[int, dict[str, Any]] = {}
    for key in sorted(store.list(prefix + "/")):
        if key.endswith(PTR_SUFFIX):
            continue
        if not store.verify_pointer(key):
            continue
        try:
            doc = store.get_json(key)
        except Exception:
            continue
        if not isinstance(doc, dict) or doc.get("schema") != 1:
            continue
        for event in doc.get("events") or ():
            if isinstance(event, dict) and "event_id" in event:
                merged[int(event["event_id"])] = event
    return [merged[eid] for eid in sorted(merged)]
