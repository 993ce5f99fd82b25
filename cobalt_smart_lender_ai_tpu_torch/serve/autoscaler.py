"""The brownout ladder: the declared, ordered degradation between "healthy"
and "shed".

The reference's ``serve/autoscaler.py:80-197``. Its `FleetAutoscaler` (the
control loop that resizes the fleet, retunes coalescing and walks this
ladder from SLO burn) is not ported yet; until then an operator or a test
drives the ladder. The rungs, each including the ones before it:

1. drop the canary's shadow taps (invisible to clients;
   `ScorerService._canary_tap`);
2. serve ``degraded: true`` without SHAP: the micro-batcher and the direct
   path launch the margin-only program (with ``ServeConfig.degrade_shap``);
3. widen micro-batch coalescing: applied by the autoscaler's retune, so a
   no-op here until it is ported;
4. shed bulk requests 429 (`brownout_gate`), single rows still serve;
5. shed everything 429.

`ReplicaSet` shares one ladder with every replica and journals each step
on the fleet's `EventJournal`.
"""

from __future__ import annotations

import threading

from cobalt_smart_lender_ai_tpu_torch.reliability.errors import RequestShed
from cobalt_smart_lender_ai_tpu_torch.telemetry import event_context, get_logger

__all__ = [
    "BROWNOUT_RUNGS",
    "LEVEL_HEALTHY",
    "LEVEL_NO_CANARY",
    "LEVEL_NO_SHAP",
    "LEVEL_WIDE_BATCH",
    "LEVEL_SHED_BULK",
    "LEVEL_SHED_ALL",
    "BrownoutLadder",
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
