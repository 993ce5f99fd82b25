"""Per-request flight recorder — the tail-latency forensics surface.

A p99 far below the max says some requests were slow, and nothing in the
metrics/log/span legs could answer *which request* was slow and *where its
time went*: histograms aggregate, the span ring is global and unindexed,
and logs only narrate non-2xx. The flight recorder closes that gap the way
an aircraft FDR does — a bounded, always-on ring of the most recent
per-request records, plus two always-capture rules so the interesting
requests survive the ring even under load:

- **slow**: any request whose wall time exceeds a configurable threshold
  (``ServeConfig.flight_slow_threshold_ms``) is additionally kept in a
  top-K-by-latency board (`slowest()`, served at ``GET /debug/slowest``) —
  the board keeps the K slowest requests *ever seen*, not just the ring's
  window, fed by a bounded min-heap.
- **error**: any non-2xx is additionally kept in its own bounded ring
  (`errors()`), so a burst of traffic cannot evict the one 500 an operator
  is hunting.

Each record carries the request id, the trace id (the root span's id —
resolvable in ``GET /debug/trace`` and stamped on log lines), route,
method, status, typed error code, wall time, and a **phase breakdown**:
validate / queue_wait / dispatch / shap / serialize durations accumulated
by `ScorerService` as the request executes. Phases are pushed into the
record via a contextvar accumulator (`collect_phases`) opened by the HTTP
middleware — an O(1) append per phase, never a scan of the span ring on
the request path (at ~6600 req/s a per-request ring scan would be the new
tail). The batcher's worker thread measures queue_wait/dispatch/shap per
batch and hands them back through each request's future, so attribution
survives the thread hop.

Everything is stdlib-only and thread-safe; the recorder is owned by the
`ScorerService` next to its metrics registry, so two services in one
process never mix records.
"""

from __future__ import annotations

import contextlib
import contextvars
import heapq
import itertools
import threading
import time
from collections import deque
from typing import Any, Callable, Iterator, Mapping

__all__ = [
    "FlightRecorder",
    "META_ROUTES",
    "PHASES",
    "add_phase",
    "collect_phases",
]

#: Canonical phase names, in request order. ``queue_wait`` only appears on
#: the micro-batched path; ``serialize`` covers response encoding in the
#: adapter. Unattributed remainder (framework overhead, header parsing) is
#: reported per record as ``other_ms``.
PHASES: tuple[str, ...] = (
    "validate", "queue_wait", "dispatch", "shap", "serialize",
)

#: Observability-plane routes the middleware does NOT flight-record: a
#: scraper polling /metrics every few seconds would evict the data-plane
#: records the ring exists for.
META_ROUTES: frozenset[str] = frozenset(
    {
        "/healthz",
        "/readyz",
        "/metrics",
        "/slo",
        "/drift",
        "/debug/requests",
        "/debug/slowest",
        "/debug/trace",
        "/debug/programs",
        "/history",
        "/events",
        "/dashboard",
    }
)


def _phase_filter(recs: list[dict], phase: str | None) -> list[dict]:
    """Keep only records that spent time in ``phase`` (a key of their
    ``phases_ms`` breakdown) — the ``?phase=`` query of the debug routes,
    so a queue-wait hunt doesn't page through validate-only requests."""
    if phase is None:
        return recs
    return [r for r in recs if phase in r.get("phases_ms", {})]


class PhaseAccumulator:
    """Per-request phase durations, filled in as the request executes."""

    __slots__ = ("phases",)

    def __init__(self) -> None:
        self.phases: dict[str, float] = {}

    def add(self, name: str, seconds: float) -> None:
        self.phases[name] = self.phases.get(name, 0.0) + max(0.0, seconds)


_current_acc: contextvars.ContextVar[PhaseAccumulator | None] = (
    contextvars.ContextVar("cobalt_flight_phases", default=None)
)


@contextlib.contextmanager
def collect_phases() -> Iterator[PhaseAccumulator]:
    """Open a phase accumulator for the current request (the HTTP
    middleware wraps the handler in this); `add_phase` calls anywhere down
    the stack land in it via the contextvar."""
    acc = PhaseAccumulator()
    token = _current_acc.set(acc)
    try:
        yield acc
    finally:
        _current_acc.reset(token)


def add_phase(name: str, seconds: float) -> None:
    """Attribute ``seconds`` to phase ``name`` of the request in scope —
    a no-op outside a `collect_phases` block (direct service calls, the
    bench's closed loop), so instrumented code never has to care."""
    acc = _current_acc.get()
    if acc is not None:
        acc.add(name, seconds)


class FlightRecorder:
    """Bounded, thread-safe store of finished-request records.

    Three views, all O(capacity)-bounded:

    - ``records(n)``   — the most recent ``n`` requests (newest first)
    - ``errors(n)``    — the most recent ``n`` non-2xx requests
    - ``slowest(k)``   — the top-``k`` requests by wall time ever recorded
      (a min-heap of size ``top_k``: each record costs O(log k), fast
      requests fall out immediately)
    """

    def __init__(
        self,
        *,
        capacity: int = 256,
        slow_threshold_s: float = 0.1,
        top_k: int = 32,
        clock: Callable[[], float] = time.time,
    ) -> None:
        self.capacity = max(1, int(capacity))
        self.slow_threshold_s = float(slow_threshold_s)
        self.top_k = max(1, int(top_k))
        self._clock = clock
        self._lock = threading.Lock()
        self._recent: deque[dict] = deque(maxlen=self.capacity)
        self._errors: deque[dict] = deque(maxlen=self.capacity)
        # min-heap of (duration_s, seq, record); seq breaks duration ties so
        # records (dicts) are never compared
        self._slow_heap: list[tuple[float, int, dict]] = []
        self._seq = itertools.count()
        self._recorded = 0
        self._slow = 0
        self._error_count = 0

    def record(
        self,
        *,
        request_id: str | None,
        trace_id: int | None,
        route: str,
        method: str,
        status: int,
        duration_s: float,
        code: str | None = None,
        phases: Mapping[str, float] | None = None,
    ) -> dict:
        """Store one finished request; returns the JSON-able record."""
        duration_s = max(0.0, float(duration_s))
        phases_ms = {
            name: round(sec * 1000.0, 3)
            for name, sec in (phases or {}).items()
            if sec > 0.0
        }
        attributed_s = sum((phases or {}).values())
        rec: dict[str, Any] = {
            "request_id": request_id,
            "trace_id": trace_id,
            "route": route,
            "method": method,
            "status": int(status),
            "code": code,
            "ts": round(self._clock(), 6),
            "duration_ms": round(duration_s * 1000.0, 3),
            "phases_ms": phases_ms,
            "other_ms": round(max(0.0, duration_s - attributed_s) * 1000.0, 3),
            "slow": duration_s >= self.slow_threshold_s,
            "error": status >= 400,
        }
        with self._lock:
            self._recorded += 1
            self._recent.append(rec)
            if rec["error"]:
                self._error_count += 1
                self._errors.append(rec)
            if rec["slow"]:
                self._slow += 1
            entry = (duration_s, next(self._seq), rec)
            if len(self._slow_heap) < self.top_k:
                heapq.heappush(self._slow_heap, entry)
            elif duration_s > self._slow_heap[0][0]:
                heapq.heapreplace(self._slow_heap, entry)
        return rec

    def records(self, limit: int = 50, phase: str | None = None) -> list[dict]:
        """Most recent records, newest first; ``phase`` keeps only records
        that spent time in that phase."""
        with self._lock:
            recs = list(self._recent)
        return _phase_filter(recs[::-1], phase)[: max(0, int(limit))]

    def errors(self, limit: int = 50, phase: str | None = None) -> list[dict]:
        """Most recent non-2xx records, newest first."""
        with self._lock:
            recs = list(self._errors)
        return _phase_filter(recs[::-1], phase)[: max(0, int(limit))]

    def slowest(
        self, k: int | None = None, phase: str | None = None
    ) -> list[dict]:
        """Top-``k`` records by wall time ever recorded, slowest first."""
        with self._lock:
            board = sorted(self._slow_heap, reverse=True)
        k = self.top_k if k is None else max(0, int(k))
        return _phase_filter([rec for _, _, rec in board], phase)[:k]

    def stats(self) -> dict:
        with self._lock:
            return {
                "recorded": self._recorded,
                "slow": self._slow,
                "errors": self._error_count,
                "capacity": self.capacity,
                "slow_threshold_ms": round(self.slow_threshold_s * 1000.0, 3),
                "top_k": self.top_k,
            }
