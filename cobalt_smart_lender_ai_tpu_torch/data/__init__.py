"""The data layer: schema constants, the pandas-free raw table, the
synthetic generator, the host cleaning path (clean, prepare, engineer) and
the device ingest, the split."""

from cobalt_smart_lender_ai_tpu_torch.data import schema
from cobalt_smart_lender_ai_tpu_torch.data.clean import clean_raw_frame
from cobalt_smart_lender_ai_tpu_torch.data.features import (
    FeatureFrame,
    engineer_features,
    prepare_cleaned_frame,
)
from cobalt_smart_lender_ai_tpu_torch.data.split import train_test_split_hashed
from cobalt_smart_lender_ai_tpu_torch.data.synthetic import synthetic_lendingclub_frame

__all__ = [
    "FeatureFrame",
    "clean_raw_frame",
    "engineer_features",
    "prepare_cleaned_frame",
    "schema",
    "synthetic_lendingclub_frame",
    "train_test_split_hashed",
]
