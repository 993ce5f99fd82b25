"""Circuit breaker (closed -> open -> half-open) for store-backed operations
(the port's copy of the reference's ``reliability/breaker.py``).

`reliability.retry` protects a single call against a transient blip. A
flapping or down store is a different failure: every caller pays the full
retry schedule, and the store is hammered when it is least able to answer.
The breaker remembers across calls:

- **closed**: calls pass through; ``failure_threshold`` *consecutive*
  failures trip it open (any success resets the streak).
- **open**: calls fail at once with `errors.CircuitOpenError` (HTTP 503 +
  ``Retry-After``) for ``reset_timeout_s``; no load reaches the store.
- **half-open**: after the timeout, up to ``half_open_max_calls`` probes
  pass; one success closes the circuit, one failure re-opens it and
  restarts the timer. Excess calls during probing fail fast.

The clock is injectable, transitions are recorded in ``transitions``, and
one lock guards every mutation, so request threads can share a breaker.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

from cobalt_smart_lender_ai_tpu_torch.reliability.errors import CircuitOpenError

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Wrap store-backed calls: ``breaker.call(lambda: artifact_load(...))``.

    Every exception from the wrapped call counts as a failure — a store that
    keeps raising *anything* (transient or not) is a store to back off from;
    the caller still sees the original exception, so deterministic errors
    keep their type.
    """

    def __init__(
        self,
        *,
        failure_threshold: int = 5,
        reset_timeout_s: float = 30.0,
        half_open_max_calls: int = 1,
        clock: Callable[[], float] = time.monotonic,
        name: str = "store",
    ):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if half_open_max_calls < 1:
            raise ValueError("half_open_max_calls must be >= 1")
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.half_open_max_calls = half_open_max_calls
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at: float | None = None
        self._probes_in_flight = 0
        #: Transition history ("open"/"half_open"/"closed" in order) —
        #: observable so tests assert the *path* taken, not just the end state.
        self.transitions: list[str] = []
        self.opened_count = 0
        self.fast_failures = 0  # calls rejected without touching the store
        #: Optional observer ``(old_state, new_state) -> None`` invoked on
        #: every transition. Runs under the breaker lock, so it must not
        #: call back into the breaker; any exception it raises is swallowed:
        #: observation never breaks the state machine.
        self.on_transition: Callable[[str, str], None] | None = None

    # -- state machine (lock held for every mutation) --------------------------

    def _transition_locked(self, to: str) -> None:
        old = self._state
        self._state = to
        self.transitions.append(to)
        if to == OPEN:
            self._opened_at = self._clock()
            self.opened_count += 1
        elif to == CLOSED:
            self._consecutive_failures = 0
        elif to == HALF_OPEN:
            self._probes_in_flight = 0
        if self.on_transition is not None:
            try:
                self.on_transition(old, to)
            except Exception:
                pass

    def _poll_locked(self) -> str:
        """Advance open → half-open once the reset timeout has elapsed."""
        if (
            self._state == OPEN
            and self._clock() - self._opened_at >= self.reset_timeout_s
        ):
            self._transition_locked(HALF_OPEN)
        return self._state

    @property
    def state(self) -> str:
        with self._lock:
            return self._poll_locked()

    @property
    def consecutive_failures(self) -> int:
        return self._consecutive_failures

    def _reject_locked(self) -> None:
        self.fast_failures += 1
        if self._state == OPEN:
            remaining = self.reset_timeout_s - (self._clock() - self._opened_at)
            detail = f"{self.name} circuit open"
        else:  # half-open with all probe slots taken
            remaining = self.reset_timeout_s
            detail = f"{self.name} circuit half-open, probe in flight"
        raise CircuitOpenError(
            detail, retry_after_s=max(remaining, 1e-3)
        )

    def call(self, fn: Callable[[], Any]) -> Any:
        """Run ``fn`` under the breaker; raise `CircuitOpenError` without
        calling it when the circuit is open (or probing at capacity)."""
        with self._lock:
            state = self._poll_locked()
            if state == OPEN:
                self._reject_locked()
            if state == HALF_OPEN:
                if self._probes_in_flight >= self.half_open_max_calls:
                    self._reject_locked()
                self._probes_in_flight += 1
        try:
            result = fn()
        except BaseException:
            self._record_failure()
            raise
        self._record_success()
        return result

    def _record_success(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                self._transition_locked(CLOSED)
            self._consecutive_failures = 0

    def _record_failure(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                # The probe failed: the dependency is still down; re-open and
                # restart the timer.
                self._transition_locked(OPEN)
            elif self._state == CLOSED:
                self._consecutive_failures += 1
                if self._consecutive_failures >= self.failure_threshold:
                    self._transition_locked(OPEN)


def breaker_from_config(
    rel, clock: Callable[[], float] = time.monotonic, name: str = "store"
) -> CircuitBreaker:
    """Build from a `config.ReliabilityConfig`."""
    return CircuitBreaker(
        failure_threshold=rel.breaker_failure_threshold,
        reset_timeout_s=rel.breaker_reset_s,
        half_open_max_calls=rel.breaker_half_open_max,
        clock=clock,
        name=name,
    )
