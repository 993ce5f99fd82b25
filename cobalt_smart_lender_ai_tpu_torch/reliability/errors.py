"""Typed request errors: each carries its HTTP status and a stable ``code``.

==== ====================== ==================================================
422  ``invalid_input``      request failed the serving schema
413  ``payload_too_large``  bulk CSV over ``max_bulk_rows``/``max_bulk_bytes``
429  ``shed``               admission control refused (rate / in-flight cap);
                            always carries ``Retry-After``
503  ``circuit_open``       a store-backed dependency is failing fast;
                            carries ``Retry-After`` (time until half-open)
504  ``deadline_exceeded``  cooperative cancellation hit the request deadline
500  ``reload_failed``      hot model swap failed and was rolled back
500  ``worker_dead``        the micro-batch worker thread died with requests
                            queued; they are failed typed, never left hanging
409  ``promotion_rejected`` the canary promotion gate said no (or there is no
                            canary); the body carries the gate's ``report``
409  ``rollback_failed``    no ``previous`` version to roll back to
==== ====================== ==================================================
"""

from __future__ import annotations

import math


class RequestError(Exception):
    """Base of the serving taxonomy: HTTP ``status`` + stable ``code``.

    ``retry_after_s`` (when set) becomes a ``Retry-After`` header, so clients
    pace their retries off the server's own estimate."""

    status: int = 500
    code: str = "internal"

    def __init__(self, detail: str = "", *, retry_after_s: float | None = None):
        super().__init__(detail)
        self.detail = detail or self.code
        self.retry_after_s = retry_after_s

    def body(self) -> dict:
        """JSON body: FastAPI's ``detail`` convention + the typed ``code``."""
        return {"detail": self.detail, "error": self.code}

    def headers(self) -> dict[str, str]:
        if self.retry_after_s is None:
            return {}
        # Whole seconds, at least 1: "Retry-After: 0" invites a busy retry loop.
        return {"Retry-After": str(max(1, math.ceil(self.retry_after_s)))}


class ValidationError(RequestError, ValueError):
    """Input failed the serving schema — HTTP 422."""

    status = 422
    code = "invalid_input"


class PayloadTooLarge(RequestError, ValueError):
    """Bulk request over the configured size bounds — HTTP 413, raised before
    the CSV is parsed or scored."""

    status = 413
    code = "payload_too_large"


class RequestShed(RequestError):
    """Admission control refused the request (token bucket empty or in-flight
    cap reached) — HTTP 429 with ``Retry-After``."""

    status = 429
    code = "shed"


class CircuitOpenError(RequestError):
    """A store-backed dependency's circuit breaker is open: fail fast (HTTP
    503 + ``Retry-After``) instead of tying up a worker in doomed retries."""

    status = 503
    code = "circuit_open"


class DeadlineExceeded(RequestError):
    """The request's wall-clock budget expired at a cooperative checkpoint —
    HTTP 504."""

    status = 504
    code = "deadline_exceeded"


class ReloadFailed(RequestError):
    """Hot model swap failed validation and was rolled back; the previous
    model keeps serving — typed HTTP 500."""

    status = 500
    code = "reload_failed"


class WorkerDead(RequestError):
    """The micro-batch worker thread exited while requests were queued: the
    watchdog resolves every orphaned future with this typed 500 and restarts
    the worker."""

    status = 500
    code = "worker_dead"


class PromotionRejected(RequestError):
    """The canary promotion gate said no (or there is no canary to promote)
    — HTTP 409. Carries the gate's structured ``report`` (sample counts,
    per-check verdicts, machine-readable reasons) in the body."""

    status = 409
    code = "promotion_rejected"

    def __init__(self, detail: str = "", *, report: dict | None = None):
        super().__init__(detail)
        self.report = report or {}

    def body(self) -> dict:
        return {**super().body(), "report": self.report}


class RollbackFailed(RequestError):
    """A rollback was asked for but there is no ``previous`` channel to
    restore (or the canary loop is not enabled) — HTTP 409: the serving
    model is untouched and still healthy."""

    status = 409
    code = "rollback_failed"


def error_response(exc: RequestError) -> tuple[int, dict, dict[str, str]]:
    """The adapter-side mapping: (HTTP status, JSON body, headers)."""
    return exc.status, exc.body(), exc.headers()
