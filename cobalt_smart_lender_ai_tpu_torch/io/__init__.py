"""Object store and model artifacts."""

from cobalt_smart_lender_ai_tpu_torch.io.artifacts import (
    GBDTArtifact,
    plan_from_json,
    plan_to_json,
    save_metrics,
)
from cobalt_smart_lender_ai_tpu_torch.io.store import ObjectStore, StoreKeyError

__all__ = [
    "GBDTArtifact",
    "ObjectStore",
    "StoreKeyError",
    "plan_from_json",
    "plan_to_json",
    "save_metrics",
]
