"""Object store and model artifacts."""

from cobalt_smart_lender_ai_tpu_torch.io.artifacts import (
    GBDTArtifact,
    plan_from_json,
    plan_to_json,
    save_metrics,
)
from cobalt_smart_lender_ai_tpu_torch.io.store import PTR_SUFFIX, ObjectStore, StoreKeyError

__all__ = [
    "GBDTArtifact",
    "ObjectStore",
    "PTR_SUFFIX",
    "StoreKeyError",
    "plan_from_json",
    "plan_to_json",
    "save_metrics",
]
