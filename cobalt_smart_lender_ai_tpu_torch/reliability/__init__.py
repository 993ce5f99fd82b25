"""Request-path error taxonomy and deadlines; the store's retries and the
pipeline's stage checkpoints."""

from cobalt_smart_lender_ai_tpu_torch.reliability.checkpoint import (
    MANIFEST_FORMAT,
    PipelineCheckpoint,
    config_fingerprint,
)
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
from cobalt_smart_lender_ai_tpu_torch.reliability.retry import (
    RetryPolicy,
    call_with_retry,
    is_transient_store_error,
    policy_from_config,
)
from cobalt_smart_lender_ai_tpu_torch.reliability.stores import CorruptObjectError, ResilientStore

__all__ = [
    "MANIFEST_FORMAT",
    "CorruptObjectError",
    "Deadline",
    "DeadlineExceeded",
    "PayloadTooLarge",
    "PipelineCheckpoint",
    "RequestError",
    "ResilientStore",
    "RetryPolicy",
    "ValidationError",
    "await_under_deadline",
    "call_with_retry",
    "config_fingerprint",
    "error_response",
    "is_transient_store_error",
    "policy_from_config",
    "start_deadline",
]
