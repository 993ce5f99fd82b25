"""Object store and model artifacts."""

from cobalt_smart_lender_ai_tpu_torch.io.artifacts import GBDTArtifact
from cobalt_smart_lender_ai_tpu_torch.io.store import ObjectStore, StoreKeyError

__all__ = ["GBDTArtifact", "ObjectStore", "StoreKeyError"]
