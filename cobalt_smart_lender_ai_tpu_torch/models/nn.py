"""The MLP challenger: the reference's ``models/nn.py``, the counterpart of
the Keras Sequential 128/32/16/1 network of
`notebooks/04_model_training.ipynb` cell 39 (AdamW, exponential decay, L2,
early stopping), with a class-weighted loss in place of SMOTE and min-max
scaling in front of the network.

Layers start as the reference's flax layers do: dense weights LeCun-normal
(a normal truncated at two standard deviations, scaled to variance
``1 / fan_in``), biases zero, drawn from a `torch.Generator` seeded with the
config's seed on the CPU, so a seed gives the same initial weights on the
card and on the CPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from cobalt_smart_lender_ai_tpu_torch.config import MLPConfig
from cobalt_smart_lender_ai_tpu_torch.data.split import train_test_split_hashed
from cobalt_smart_lender_ai_tpu_torch.device import resolve_device
from cobalt_smart_lender_ai_tpu_torch.models.train_loop import TrainSettings, fit_binary

__all__ = ["MLP", "MLPClassifier", "MinMaxStats", "dense", "lecun_normal_", "seeded_generator"]

#: Standard deviation of a standard normal truncated to (-2, 2).
_TRUNC_STD = 0.87962566103423978


def seeded_generator(seed: int) -> torch.Generator:
    """A CPU generator for initial weights: the same draws on any device."""
    gen = torch.Generator()
    gen.manual_seed(int(seed))
    return gen


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal``: truncated at +-2 std, variance ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def dense(in_features: int, out_features: int, generator: torch.Generator) -> nn.Linear:
    """An `nn.Linear` initialised as flax's ``nn.Dense``."""
    layer = torch.nn.utils.skip_init(nn.Linear, in_features, out_features)
    lecun_normal_(layer.weight, in_features, generator)
    with torch.no_grad():
        layer.bias.zero_()
    return layer


class MLP(nn.Module):
    """relu MLP emitting logits; hidden sizes default (128, 32, 16).
    ``layers[i]`` is the reference's ``Dense_i``, the last one the output."""

    def __init__(
        self,
        n_features: int,
        hidden: Sequence[int] = (128, 32, 16),
        *,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        gen = generator if generator is not None else seeded_generator(0)
        widths = [n_features, *hidden, 1]
        self.layers = nn.ModuleList(dense(a, b, gen) for a, b in zip(widths[:-1], widths[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)[..., 0]


@dataclasses.dataclass(frozen=True)
class MinMaxStats:
    """Min-max scaling (the reference scales with sklearn's MinMaxScaler in
    `04_model_training.ipynb` cell 32); NaN scales to 0, the column minimum,
    and scaled values clip to [-1, 2]."""

    low: torch.Tensor  # (F,)
    range_: torch.Tensor  # (F,)

    @staticmethod
    def fit(X: torch.Tensor) -> "MinMaxStats":
        nan = torch.isnan(X)
        inf = torch.tensor(float("inf"), dtype=X.dtype, device=X.device)
        low = torch.where(nan, inf, X).amin(dim=0)
        high = torch.where(nan, -inf, X).amax(dim=0)
        empty = nan.all(dim=0)  # an all-NaN column: low 0, high 1
        low = torch.where(empty, 0.0, low)
        high = torch.where(empty, 1.0, high)
        return MinMaxStats(low=low, range_=torch.clamp_min(high - low, 1e-12))

    def __call__(self, X: torch.Tensor) -> torch.Tensor:
        Xs = (X - self.low[None, :]) / self.range_[None, :]
        return torch.clip(torch.where(torch.isnan(Xs), 0.0, Xs), -1.0, 2.0)


class MLPClassifier:
    """Keras-``fit``-shaped facade: scaling, class weighting, early stopping
    on validation ROC-AUC, on ``device`` (``cuda`` unless the caller asks
    for ``cpu``)."""

    def __init__(self, config: MLPConfig | None = None, *, device: torch.device | str = "cuda"):
        self.config = config or MLPConfig()
        self.device = resolve_device(device)
        self.module: MLP | None = None
        self.scaler: MinMaxStats | None = None
        self.history: dict | None = None

    def _tensor(self, X) -> torch.Tensor:
        return torch.as_tensor(X, dtype=torch.float32).to(self.device)

    def fit(self, X, y, X_val=None, y_val=None) -> "MLPClassifier":
        cfg = self.config
        X, y = self._tensor(X), self._tensor(y)
        if X_val is None:
            # the hashed 10% holdout for the early-stop monitor
            X, X_val, y, y_val = train_test_split_hashed(X, y, test_fraction=0.1, seed=cfg.seed)
        else:
            X_val, y_val = self._tensor(X_val), self._tensor(y_val)
        self.scaler = MinMaxStats.fit(X)
        Xs, Xvs = self.scaler(X), self.scaler(X_val)

        pos_weight = cfg.positive_class_weight
        if pos_weight is None:  # balanced, like scale_pos_weight
            n_pos = float(y.sum())
            pos_weight = (float(y.shape[0]) - n_pos) / max(n_pos, 1.0)

        self.module = MLP(
            int(Xs.shape[1]), tuple(cfg.hidden_sizes), generator=seeded_generator(cfg.seed)
        ).to(self.device)
        settings = TrainSettings(
            batch_size=cfg.batch_size,
            epochs=cfg.epochs,
            learning_rate=cfg.learning_rate,
            lr_decay_rate=cfg.lr_decay_rate,
            lr_decay_steps=cfg.lr_decay_steps,
            weight_decay=cfg.weight_decay,
            l2=cfg.l2,
            pos_weight=pos_weight,
            early_stop_patience=cfg.early_stop_patience,
            epochs_per_dispatch=cfg.epochs_per_dispatch,
            seed=cfg.seed,
        )
        self.history = fit_binary(self.module, Xs, y, settings, X_val=Xvs, y_val=y_val)
        return self

    def predict_logits(self, X) -> torch.Tensor:
        if self.module is None or self.scaler is None:
            raise RuntimeError("fit first")
        with torch.no_grad():
            return self.module(self.scaler(self._tensor(X)))

    def predict_proba(self, X) -> torch.Tensor:
        p1 = torch.sigmoid(self.predict_logits(X))
        return torch.stack([1.0 - p1, p1], dim=1)

    def predict(self, X, threshold: float = 0.5) -> np.ndarray:
        return (self.predict_proba(X)[:, 1] >= threshold).cpu().numpy().astype(np.int32)
