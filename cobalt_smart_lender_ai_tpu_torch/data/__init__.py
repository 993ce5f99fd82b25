"""Serving-schema constants (the port keeps its own copy)."""

from cobalt_smart_lender_ai_tpu_torch.data import schema

__all__ = ["schema"]
