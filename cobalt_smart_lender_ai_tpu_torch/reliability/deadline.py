"""Per-request deadlines with cooperative cancellation checkpoints.

A kernel launch cannot be interrupted, so cancellation is cooperative: the
service calls `Deadline.check` where abandoning the request is cheap (after
validation, between bulk chunks). The clock is injectable so tests assert
deadline behaviour without sleeping.
"""

from __future__ import annotations

import asyncio
import time
from typing import Awaitable, Callable, TypeVar

from cobalt_smart_lender_ai_tpu_torch.reliability.errors import DeadlineExceeded

_T = TypeVar("_T")


class Deadline:
    """An absolute expiry point on an injectable monotonic clock."""

    __slots__ = ("budget_s", "_expires_at", "_clock")

    def __init__(
        self, budget_s: float, clock: Callable[[], float] = time.monotonic
    ):
        if budget_s < 0:
            raise ValueError(f"deadline budget must be >= 0, got {budget_s}")
        self.budget_s = float(budget_s)
        self._clock = clock
        self._expires_at = clock() + float(budget_s)

    def remaining(self) -> float:
        """Seconds left; negative once expired."""
        return self._expires_at - self._clock()

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def exceeded(self, checkpoint: str = "request") -> DeadlineExceeded:
        """Build (without raising) the error this deadline raises at
        ``checkpoint`` — the micro-batcher resolves queued futures with it."""
        return DeadlineExceeded(
            f"deadline of {self.budget_s:g}s exceeded at {checkpoint!r} "
            f"({-self.remaining():.3f}s over budget)"
        )

    def check(self, checkpoint: str = "request") -> None:
        """Raise `DeadlineExceeded` if the budget is spent."""
        if self.remaining() <= 0.0:
            raise self.exceeded(checkpoint)


async def await_under_deadline(
    awaitable: Awaitable[_T],
    deadline: Deadline | None,
    checkpoint: str = "request",
) -> _T:
    """Await ``awaitable`` under a loop-scheduled timeout. On timeout the
    awaitable is abandoned (shielded, not cancelled): the micro-batch worker
    still owns the underlying future and resolves it later."""
    if deadline is None:
        return await awaitable
    fut = asyncio.ensure_future(awaitable)
    try:
        return await asyncio.wait_for(
            asyncio.shield(fut), timeout=max(0.0, deadline.remaining())
        )
    except (asyncio.TimeoutError, TimeoutError):
        raise deadline.exceeded(checkpoint) from None


def start_deadline(
    budget_s: float | None, clock: Callable[[], float] = time.monotonic
) -> Deadline | None:
    """Begin a request deadline; a ``None`` budget means no deadline."""
    return None if budget_s is None else Deadline(budget_s, clock)
