"""Model explanations: path-dependent TreeSHAP."""

from cobalt_smart_lender_ai_tpu_torch.explain.treeshap import shap_values

__all__ = ["shap_values"]
