"""Typed request errors: each carries its HTTP status and a stable ``code``.

==== ====================== ==================================================
422  ``invalid_input``      request failed the serving schema
413  ``payload_too_large``  bulk CSV over ``max_bulk_rows``/``max_bulk_bytes``
504  ``deadline_exceeded``  cooperative cancellation hit the request deadline
==== ====================== ==================================================
"""

from __future__ import annotations


class RequestError(Exception):
    """Base of the serving taxonomy: HTTP ``status`` + stable ``code``."""

    status: int = 500
    code: str = "internal"

    def __init__(self, detail: str = ""):
        super().__init__(detail)
        self.detail = detail or self.code

    def body(self) -> dict:
        """JSON body: FastAPI's ``detail`` convention + the typed ``code``."""
        return {"detail": self.detail, "error": self.code}


class ValidationError(RequestError, ValueError):
    """Input failed the serving schema — HTTP 422."""

    status = 422
    code = "invalid_input"


class PayloadTooLarge(RequestError, ValueError):
    """Bulk request over the configured size bounds — HTTP 413, raised before
    the CSV is parsed or scored."""

    status = 413
    code = "payload_too_large"


class DeadlineExceeded(RequestError):
    """The request's wall-clock budget expired at a cooperative checkpoint —
    HTTP 504."""

    status = 504
    code = "deadline_exceeded"


def error_response(exc: RequestError) -> tuple[int, dict]:
    """The adapter-side mapping: (HTTP status, JSON body)."""
    return exc.status, exc.body()
