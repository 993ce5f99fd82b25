"""Object store, dataset and model registries, and model artifacts."""

from cobalt_smart_lender_ai_tpu_torch.io.artifacts import (
    GBDTArtifact,
    MLPArtifact,
    plan_from_json,
    load_metrics,
    plan_to_json,
    save_metrics,
)
from cobalt_smart_lender_ai_tpu_torch.io.model_registry import (
    CHANNELS,
    ModelRegistry,
    ModelVersion,
)
from cobalt_smart_lender_ai_tpu_torch.io.registry import (
    REFERENCE_RAW_PINS,
    DatasetPin,
    DatasetRegistry,
)
from cobalt_smart_lender_ai_tpu_torch.io.store import PTR_SUFFIX, ObjectStore, StoreKeyError

__all__ = [
    "CHANNELS",
    "REFERENCE_RAW_PINS",
    "DatasetPin",
    "DatasetRegistry",
    "GBDTArtifact",
    "MLPArtifact",
    "ModelRegistry",
    "ModelVersion",
    "ObjectStore",
    "PTR_SUFFIX",
    "StoreKeyError",
    "load_metrics",
    "plan_from_json",
    "plan_to_json",
    "save_metrics",
]
