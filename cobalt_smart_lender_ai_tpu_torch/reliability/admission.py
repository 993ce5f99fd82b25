"""Admission control: token-bucket rate limiting + a bounded in-flight cap
(the port's copy of the reference's ``reliability/admission.py``).

Without admission control, overload becomes an unbounded queue of tasks all
waiting on the same card: latency grows without bound and every client
times out. Excess load is *shed* at the door as `errors.RequestShed` (HTTP
429 with ``Retry-After``): the admitted requests finish fast, and the others
get an immediate answer with the server's own estimate of when to come back.

Two independent gates, both optional:

- **Token bucket**: sustained rate capped at ``rate_rps`` with bursts up to
  ``burst``; refill is computed from the injectable clock, so behaviour is
  exact under fake clocks (no background refill thread).
- **In-flight cap**: at most ``max_in_flight`` requests executing at once;
  one slow launch holds its slot for its whole duration.

The counters (`admitted`, `shed_rate`, `shed_capacity`, `in_flight`) are
what ``/readyz`` and the ``cobalt_admission_*`` families report.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Iterator

from cobalt_smart_lender_ai_tpu_torch.reliability.errors import RequestShed


class TokenBucket:
    """Classic token bucket over an injectable monotonic clock."""

    def __init__(
        self,
        rate_rps: float,
        burst: float,
        clock: Callable[[], float] = time.monotonic,
    ):
        if rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
        if burst < 1:
            raise ValueError(f"burst must be >= 1, got {burst}")
        self.rate_rps = float(rate_rps)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._stamp = clock()
        self._lock = threading.Lock()

    def _refill_locked(self) -> None:
        now = self._clock()
        self._tokens = min(
            self.burst, self._tokens + (now - self._stamp) * self.rate_rps
        )
        self._stamp = now

    def try_acquire(self, n: float = 1.0) -> bool:
        with self._lock:
            self._refill_locked()
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def retry_after_s(self, n: float = 1.0) -> float:
        """Time until ``n`` tokens will have accumulated — the honest
        ``Retry-After`` for a shed request."""
        with self._lock:
            self._refill_locked()
            deficit = n - self._tokens
            return max(0.0, deficit / self.rate_rps)

    def resize(self, rate_rps: float, burst: float) -> None:
        """Swap the bucket's rate/burst in place (fleet resize). Accrued
        tokens are refilled at the OLD rate first, then clamped to the new
        burst — a shrink can't leave a stale oversized balance."""
        if rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
        if burst < 1:
            raise ValueError(f"burst must be >= 1, got {burst}")
        with self._lock:
            self._refill_locked()
            self.rate_rps = float(rate_rps)
            self.burst = float(burst)
            self._tokens = min(self._tokens, self.burst)


class AdmissionController:
    """Gate every scoring request through ``with admission.admit():``.

    Raises `RequestShed` (HTTP 429 + ``Retry-After``) instead of queueing.
    Health, readiness and admin routes are not gated: an overloaded
    instance must still be observable and operable.
    """

    def __init__(
        self,
        *,
        rate_rps: float | None = None,
        burst: float = 16,
        max_in_flight: int | None = None,
        shed_retry_after_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.bucket = (
            None if rate_rps is None else TokenBucket(rate_rps, burst, clock)
        )
        self.max_in_flight = max_in_flight
        self.shed_retry_after_s = shed_retry_after_s
        # Per-unit base values for `rescale`: the configured limits describe
        # what ONE replica can absorb; a fleet multiplies them by its size.
        self._base_rate_rps = rate_rps
        self._base_burst = burst
        self._base_max_in_flight = max_in_flight
        self.scale_units = 1
        self._lock = threading.Lock()
        self.in_flight = 0
        self.admitted = 0
        self.shed_rate = 0
        self.shed_capacity = 0

    def rescale(self, units: int) -> dict:
        """Recompute capacity for ``units`` serving replicas: shedding
        thresholds must track actual capacity, or a scale-up keeps shedding
        at the old single-replica limits (and a scale-down queues load the
        shrunken fleet can no longer absorb)."""
        units = max(1, int(units))
        self.scale_units = units
        if self._base_max_in_flight is not None:
            self.max_in_flight = self._base_max_in_flight * units
        if self.bucket is not None and self._base_rate_rps is not None:
            self.bucket.resize(
                self._base_rate_rps * units, max(1, self._base_burst * units)
            )
        return {
            "units": units,
            "max_in_flight": self.max_in_flight,
            "rate_rps": None if self.bucket is None else self.bucket.rate_rps,
        }

    @contextlib.contextmanager
    def admit(self) -> Iterator[None]:
        if self.bucket is not None and not self.bucket.try_acquire():
            with self._lock:
                self.shed_rate += 1
            raise RequestShed(
                "request rate limit exceeded",
                # At least a millisecond: a drained bucket's deficit can
                # round to 0 between the failed acquire and this estimate.
                retry_after_s=max(self.bucket.retry_after_s(), 1e-3),
            )
        with self._lock:
            if (
                self.max_in_flight is not None
                and self.in_flight >= self.max_in_flight
            ):
                self.shed_capacity += 1
                raise RequestShed(
                    f"server at capacity ({self.max_in_flight} requests in "
                    "flight)",
                    retry_after_s=self.shed_retry_after_s,
                )
            self.in_flight += 1
            self.admitted += 1
        try:
            yield
        finally:
            with self._lock:
                self.in_flight -= 1

    def stats(self) -> dict:
        with self._lock:
            return {
                "in_flight": self.in_flight,
                "admitted": self.admitted,
                "shed_rate": self.shed_rate,
                "shed_capacity": self.shed_capacity,
                "max_in_flight": self.max_in_flight,
                "scale_units": self.scale_units,
            }


def admission_from_config(
    rel, clock: Callable[[], float] = time.monotonic
) -> AdmissionController:
    """Build from a `config.ReliabilityConfig`."""
    return AdmissionController(
        rate_rps=rel.rate_limit_rps,
        burst=rel.rate_limit_burst,
        max_in_flight=rel.max_in_flight,
        shed_retry_after_s=rel.shed_retry_after_s,
        clock=clock,
    )
