"""Request-path error taxonomy and deadlines."""

from cobalt_smart_lender_ai_tpu_torch.reliability.deadline import (
    Deadline,
    await_under_deadline,
    start_deadline,
)
from cobalt_smart_lender_ai_tpu_torch.reliability.errors import (
    DeadlineExceeded,
    PayloadTooLarge,
    RequestError,
    ValidationError,
    error_response,
)

__all__ = [
    "Deadline",
    "DeadlineExceeded",
    "PayloadTooLarge",
    "RequestError",
    "ValidationError",
    "await_under_deadline",
    "error_response",
    "start_deadline",
]
