"""Request-path error taxonomy, deadlines, admission control and the store's
circuit breaker; the store's retries, fault injection, the fleet's chaos
harness, the synthetic open-loop traffic generator and the pipeline's stage
checkpoints."""

from cobalt_smart_lender_ai_tpu_torch.reliability.admission import (
    AdmissionController,
    TokenBucket,
    admission_from_config,
)
from cobalt_smart_lender_ai_tpu_torch.reliability.breaker import (
    CircuitBreaker,
    breaker_from_config,
)
from cobalt_smart_lender_ai_tpu_torch.reliability.chaos import (
    ChaosError,
    ChaosPlan,
    ChaosSpec,
    WorkerKilled,
)
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
    CircuitOpenError,
    DeadlineExceeded,
    PayloadTooLarge,
    PromotionRejected,
    ReloadFailed,
    RequestError,
    RequestShed,
    RollbackFailed,
    ValidationError,
    WorkerDead,
    error_response,
)
from cobalt_smart_lender_ai_tpu_torch.reliability.faults import (
    FaultInjectingStore,
    FaultSpec,
    InjectedFault,
)
from cobalt_smart_lender_ai_tpu_torch.reliability.retry import (
    RetryPolicy,
    call_with_retry,
    is_transient_store_error,
    policy_from_config,
)
from cobalt_smart_lender_ai_tpu_torch.reliability.stores import CorruptObjectError, ResilientStore
from cobalt_smart_lender_ai_tpu_torch.reliability.traffic import (
    TenantPopulation,
    TrafficGenerator,
    TrafficShape,
    shape_by_name,
)

__all__ = [
    "MANIFEST_FORMAT",
    "AdmissionController",
    "ChaosError",
    "ChaosPlan",
    "ChaosSpec",
    "CircuitBreaker",
    "CircuitOpenError",
    "CorruptObjectError",
    "Deadline",
    "DeadlineExceeded",
    "FaultInjectingStore",
    "FaultSpec",
    "InjectedFault",
    "PayloadTooLarge",
    "PipelineCheckpoint",
    "PromotionRejected",
    "ReloadFailed",
    "RequestError",
    "RequestShed",
    "ResilientStore",
    "RetryPolicy",
    "RollbackFailed",
    "TenantPopulation",
    "TokenBucket",
    "TrafficGenerator",
    "TrafficShape",
    "ValidationError",
    "WorkerDead",
    "WorkerKilled",
    "admission_from_config",
    "await_under_deadline",
    "breaker_from_config",
    "call_with_retry",
    "config_fingerprint",
    "error_response",
    "is_transient_store_error",
    "policy_from_config",
    "shape_by_name",
    "start_deadline",
]
