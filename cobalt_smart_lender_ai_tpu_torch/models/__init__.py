"""Model families. Only the GBDT scorer is ported so far."""

from cobalt_smart_lender_ai_tpu_torch.models.gbdt import (
    Forest,
    gain_importances,
    predict_margin,
)

__all__ = ["Forest", "gain_importances", "predict_margin"]
