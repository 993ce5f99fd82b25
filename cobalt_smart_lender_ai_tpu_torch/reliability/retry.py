"""Bounded retry with exponential backoff for store I/O: the port's copy of
the reference's ``reliability/retry.py``.

Design constraints, in order:

- **Deterministic under test.** `call_with_retry` takes ``sleep``,
  ``monotonic`` and ``rng`` so the backoff schedule is asserted against a
  fake clock — tier-1 never sleeps for real.
- **Never retries a deterministic failure.** The default predicate treats
  connection/timeout-shaped errors (and injected/corruption faults) as
  transient; `FileNotFoundError`, `StoreKeyError`, validation errors and
  everything else deterministic re-raises on the first attempt.
- **Bounded twice.** `max_attempts` caps the count; `deadline_s` caps wall
  time — whichever is hit first ends the loop with the last real exception
  (no wrapper exception to unwrap at call sites).
"""

from __future__ import annotations

import dataclasses
import logging
import random
import time
from typing import Any, Callable

logger = logging.getLogger(__name__)


def is_transient_store_error(exc: BaseException) -> bool:
    """Default retryable predicate for store I/O.

    Transient: dropped connections, timeouts, interrupted syscalls, injected
    faults (`InjectedFault` subclasses ConnectionError) and detected
    corruption (`CorruptObjectError` — a re-read can return clean bytes).
    Deterministic (never retried): missing objects, escaping keys, type and
    validation errors.
    """
    from cobalt_smart_lender_ai_tpu_torch.reliability.stores import CorruptObjectError

    if isinstance(exc, CorruptObjectError):
        return True
    if isinstance(
        exc, (FileNotFoundError, IsADirectoryError, NotADirectoryError, PermissionError)
    ):
        return False
    return isinstance(exc, (ConnectionError, TimeoutError, InterruptedError, OSError))


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded attempts + exponential backoff + jitter + deadline.

    Delay before retry ``i`` (0-based) is
    ``min(base_delay_s * multiplier**i, max_delay_s)`` scaled by a uniform
    factor in ``[1 - jitter, 1 + jitter]``.
    """

    max_attempts: int = 4
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.1
    deadline_s: float | None = None
    retryable: Callable[[BaseException], bool] = is_transient_store_error

    def delay(self, failure_index: int, rng: random.Random) -> float:
        raw = min(
            self.base_delay_s * self.multiplier**failure_index, self.max_delay_s
        )
        if self.jitter:
            raw *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(raw, 0.0)


def policy_from_config(rel) -> RetryPolicy:
    """Build a `RetryPolicy` from a `config.ReliabilityConfig` (kept here so
    config.py stays dependency-free)."""
    return RetryPolicy(
        max_attempts=rel.max_attempts,
        base_delay_s=rel.base_delay_s,
        max_delay_s=rel.max_delay_s,
        multiplier=rel.backoff_multiplier,
        jitter=rel.jitter,
        deadline_s=rel.deadline_s,
    )


def call_with_retry(
    fn: Callable[[], Any],
    policy: RetryPolicy | None = None,
    *,
    sleep: Callable[[float], None] = time.sleep,
    monotonic: Callable[[], float] = time.monotonic,
    rng: random.Random | None = None,
    on_retry: Callable[[int, BaseException], None] | None = None,
) -> Any:
    """Run ``fn()`` under ``policy``; re-raise the last exception when the
    attempt or deadline budget is exhausted or the failure is not retryable.

    ``on_retry(failure_index, exc)`` fires before each backoff sleep —
    callers use it for retry counters and logging.
    """
    policy = policy or RetryPolicy()
    rng = rng or random.Random()
    start = monotonic()
    for attempt in range(max(policy.max_attempts, 1)):
        try:
            return fn()
        except BaseException as exc:
            last_attempt = attempt >= policy.max_attempts - 1
            if last_attempt or not policy.retryable(exc):
                raise
            delay = policy.delay(attempt, rng)
            if (
                policy.deadline_s is not None
                and monotonic() - start + delay > policy.deadline_s
            ):
                raise
            if on_retry is not None:
                on_retry(attempt, exc)
            logger.debug(
                "transient failure (attempt %d/%d), retrying in %.3fs: %s",
                attempt + 1,
                policy.max_attempts,
                delay,
                exc,
            )
            sleep(delay)
    raise AssertionError("unreachable")  # pragma: no cover
