"""The data layer: schema constants, the pandas-free raw table, the
synthetic generator, the host tokenizer and the device ingest, the split."""

from cobalt_smart_lender_ai_tpu_torch.data import schema

__all__ = ["schema"]
