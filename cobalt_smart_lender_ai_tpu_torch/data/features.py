"""Feature frames, the replay plan, and the engineering transforms as plain
torch functions: the port's copy of the pieces of the reference's
``data/features.py`` that the device ingest and raw-row serving run.

Two outputs, as in the reference: the tree frame (log1p on the skewed
columns, one-hot categoricals with the first category dropped, NaN kept for
the NaN-aware GBDT) and the nn frame (median impute, ``<col>_NA``
indicators, ``no_income``/``dti_NA`` flags and integer category codes).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch

from cobalt_smart_lender_ai_tpu_torch.data import schema

__all__ = [
    "FeatureFrame",
    "FeaturePlan",
    "drop_training_leakage",
    "impute_with_indicators",
    "log1p_masked",
    "one_hot_codes",
]


@dataclasses.dataclass(frozen=True)
class FeatureFrame:
    """A named feature matrix on its device."""

    feature_names: tuple[str, ...]
    X: torch.Tensor  # (N, F) float32
    y: torch.Tensor | None = None  # (N,) float32 labels

    @property
    def n_rows(self) -> int:
        return int(self.X.shape[0])

    @property
    def n_features(self) -> int:
        return int(self.X.shape[1])

    def select(self, names: Sequence[str]) -> "FeatureFrame":
        idx = torch.tensor([self.feature_names.index(n) for n in names], device=self.X.device)
        return FeatureFrame(tuple(names), self.X[:, idx], self.y)

    def drop(self, names: Sequence[str]) -> "FeatureFrame":
        keep = [n for n in self.feature_names if n not in set(names)]
        return self.select(keep)


@dataclasses.dataclass(frozen=True)
class FeaturePlan:
    """Everything needed to replay the engineering on new raw rows: the
    categorical vocabularies (one-hot order follows ``categorical_vocab``'s
    order), the label-encode vocabularies, the imputation medians and the
    snapshot date of the date -> age features. Saved with model artifacts."""

    numeric_names: tuple[str, ...]
    categorical_vocab: Mapping[str, tuple[str, ...]]
    label_vocab: Mapping[str, tuple[str, ...]]
    medians: Mapping[str, float]
    log_cols: tuple[str, ...]
    tree_feature_names: tuple[str, ...]
    nn_feature_names: tuple[str, ...]
    #: ISO date the ingest snapshot used for date -> age features; raw-row
    #: serving pins its "today" to it.
    asof: str | None = None


def log1p_masked(X: torch.Tensor, col_mask: torch.Tensor) -> torch.Tensor:
    """log1p on the masked columns where the value is present and positive.

    Each log1p is taken in float64 and rounded once to float32, which is
    the correctly rounded value but for a few cells in a billion. So the
    result of a cell does not depend on which code path of the device's
    elementwise loop (vectorised body or scalar tail) reached it: a raw row
    scored alone gets the bits of the same row in a batch. It stays within
    a few ulps of the reference's float32 ``log1p``."""
    out = X.clone()
    for j in torch.nonzero(col_mask.cpu()).flatten().tolist():
        col = X[:, j]
        apply = (col > 0) & ~torch.isnan(col)
        out[:, j] = torch.where(apply, torch.log1p(col.double()).to(X.dtype), col)
    return out


def one_hot_codes(codes: torch.Tensor, n_classes: int) -> torch.Tensor:
    """(N,) integer codes -> (N, n_classes - 1) float32 one-hot, class 0
    dropped (get_dummies drop_first); code -1 (missing or unseen) is an
    all-zero row."""
    classes = torch.arange(1, n_classes, device=codes.device)
    return (codes.long()[:, None] == classes[None, :]).to(torch.float32)


def impute_with_indicators(
    X: torch.Tensor, medians: torch.Tensor, need: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Median-fill NaNs; return the filled matrix and the per-column NaN
    indicators of the columns flagged in ``need`` (zero elsewhere)."""
    isnan = torch.isnan(X)
    filled = torch.where(isnan, medians[None, :], X)
    indicators = torch.where(need[None, :], isnan.to(torch.float32), 0.0)
    return filled, indicators


def drop_training_leakage(ff: FeatureFrame) -> FeatureFrame:
    """Remove the trainer's leakage columns."""
    return ff.drop([c for c in schema.TRAIN_LEAKAGE_COLS if c in ff.feature_names])
