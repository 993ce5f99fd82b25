"""Model families: the histogram GBDT, logistic regression, the MLP
challenger, FT-Transformer and TabNet."""

from cobalt_smart_lender_ai_tpu_torch.models.ft_transformer import (
    FTTransformer,
    FTTransformerClassifier,
)
from cobalt_smart_lender_ai_tpu_torch.models.gbdt import (
    Forest,
    GBDTClassifier,
    GBDTHyperparams,
    attach_float_thresholds,
    fit_binned,
    gain_importances,
    predict_margin,
)
from cobalt_smart_lender_ai_tpu_torch.models.linear import LogisticRegression
from cobalt_smart_lender_ai_tpu_torch.models.nn import MLP, MLPClassifier
from cobalt_smart_lender_ai_tpu_torch.models.tabnet import TabNet, TabNetClassifier, TabNetConfig

__all__ = [
    "MLP",
    "MLPClassifier",
    "TabNet",
    "TabNetClassifier",
    "TabNetConfig",
    "FTTransformer",
    "FTTransformerClassifier",
    "Forest",
    "GBDTClassifier",
    "GBDTHyperparams",
    "attach_float_thresholds",
    "fit_binned",
    "gain_importances",
    "predict_margin",
    "LogisticRegression",
]
