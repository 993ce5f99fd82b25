"""TabNet, the second modern-tabular challenger: the reference's
``models/tabnet.py`` in PyTorch.

TabNet (Arik & Pfister, 2019) runs ``n_steps`` decision steps. Each picks a
sparse feature mask with an attentive transformer (sparsemax of a learned
score times a prior that decays the features already used), transforms the
masked features through GLU blocks, and adds a ReLU'd slice to the running
decision. The masks summed over the training rows are the model's own
feature importances.

As in the reference: `sparsemax` is sort, cumulative sum and threshold;
batch norm is replaced by a fixed `StandardStats` standardisation, so
training and scoring see one function; the shared feature transformer is
one module called at every step (one set of weights); the sparsity
regulariser (the masks' mean entropy, weight ``lambda_sparse``) rides the
train loop's ``(logits, aux)`` return.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
from torch import nn

from cobalt_smart_lender_ai_tpu_torch.device import resolve_device
from cobalt_smart_lender_ai_tpu_torch.models.ft_transformer import StandardStats
from cobalt_smart_lender_ai_tpu_torch.models.nn import dense, seeded_generator
from cobalt_smart_lender_ai_tpu_torch.models.train_loop import TrainSettings, fit_binary
from cobalt_smart_lender_ai_tpu_torch.ops.metrics import roc_auc

__all__ = [
    "FeatureTransformer",
    "GLUBlock",
    "TabNet",
    "TabNetClassifier",
    "TabNetConfig",
    "sparsemax",
]


def sparsemax(z: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Euclidean projection of ``z`` onto the probability simplex along
    ``dim``: sparse "probabilities", exact zeros for low scores.

    Sorted descending, z_(1) >= z_(2) ...; k* = max{k : 1 + k z_(k) >
    cumsum_k}; tau = (cumsum_{k*} - 1) / k*; out = max(z - tau, 0).
    """
    z = z.movedim(dim, -1)
    z_sorted = torch.sort(z, dim=-1, descending=True).values
    k = torch.arange(1, z.shape[-1] + 1, dtype=z.dtype, device=z.device)
    cum = torch.cumsum(z_sorted, dim=-1)
    support = 1.0 + k * z_sorted > cum  # a True prefix
    k_star = support.sum(dim=-1, keepdim=True)
    tau = (torch.gather(cum, -1, k_star - 1) - 1.0) / k_star.to(z.dtype)
    return torch.clamp_min(z - tau, 0.0).movedim(-1, dim)


class GLUBlock(nn.Module):
    """Dense, then a gated linear unit: the feature transformer's cell."""

    def __init__(self, in_features: int, width: int, generator: torch.Generator):
        super().__init__()
        self.dense = dense(in_features, 2 * width, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.dense(x).chunk(2, dim=-1)
        return a * torch.sigmoid(b)


class FeatureTransformer(nn.Module):
    """Two GLU blocks with sqrt(0.5)-scaled residuals (the paper's §3.2)."""

    def __init__(self, in_features: int, width: int, generator: torch.Generator):
        super().__init__()
        self.glu = nn.ModuleList([GLUBlock(in_features, width, generator),
                                  GLUBlock(width, width, generator)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.glu[0](x)
        return (h + self.glu[1](h)) * math.sqrt(0.5)


class TabNet(nn.Module):
    """``n_steps`` of (attentive mask -> feature transform -> decision
    slice). Returns ``(logit, entropy, agg_mask)``: the (B,) logit, the (B,)
    mask entropy per row averaged over the steps (the sparsity regulariser,
    per row so the train loop weights padding out; the caller scales it by
    ``lambda_sparse``) and the (B, F) aggregate mask."""

    def __init__(
        self,
        n_features: int,
        n_steps: int = 4,
        width: int = 32,  # n_d = n_a
        gamma: float = 1.5,  # prior relaxation: 1.0 uses each feature once
        *,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        gen = generator if generator is not None else seeded_generator(0)
        self.n_features = n_features
        self.n_steps = n_steps
        self.width = width
        self.gamma = gamma
        self.shared_ft = FeatureTransformer(n_features, 2 * width, gen)
        self.attn = nn.ModuleList(dense(width, n_features, gen) for _ in range(n_steps))
        self.step_ft = nn.ModuleList(
            FeatureTransformer(2 * width, 2 * width, gen) for _ in range(n_steps)
        )
        self.head = dense(width, 1, gen)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        B, F = x.shape[0], self.n_features
        w = self.width
        prior = x.new_ones((B, F))
        decision = x.new_zeros((B, w))
        agg_mask = x.new_zeros((B, F))
        entropy = x.new_zeros((B,))
        a = self.shared_ft(x)[:, w:]  # step 0 attends over the whole row
        for step in range(self.n_steps):
            mask = sparsemax(self.attn[step](a) * prior)
            entropy = entropy + torch.sum(-mask * torch.log(mask + 1e-10), dim=-1)
            prior = prior * (self.gamma - mask)
            agg_mask = agg_mask + mask
            h = self.step_ft[step](self.shared_ft(mask * x))
            d, a = h[:, :w], h[:, w:]
            decision = decision + torch.relu(d)
        return self.head(decision)[:, 0], entropy / self.n_steps, agg_mask


@dataclasses.dataclass(frozen=True)
class TabNetConfig:
    n_steps: int = 4
    width: int = 32
    gamma: float = 1.5
    lambda_sparse: float = 1e-3
    learning_rate: float = 2e-2
    batch_size: int = 4096
    epochs: int = 30
    #: Epochs between two host reads of the loss history (the results are
    #: the same for any value).
    epochs_per_dispatch: int = 8
    seed: int = 0


class TabNetClassifier:
    """sklearn-shaped facade on ``device`` (``cuda`` unless the caller asks
    for ``cpu``): standardise -> TabNet -> sigmoid, trained with the shared
    loop. `feature_importances_` sums the aggregate masks over the training
    rows (the paper's global importance)."""

    def __init__(self, config: TabNetConfig | None = None, *, device: torch.device | str = "cuda"):
        self.config = config or TabNetConfig()
        self.device = resolve_device(device)
        self.module: TabNet | None = None
        self.scaler: StandardStats | None = None
        self.history: dict | None = None
        self._train_mask_sum: np.ndarray | None = None

    def _tensor(self, X) -> torch.Tensor:
        return torch.as_tensor(X, dtype=torch.float32).to(self.device)

    def fit(self, X, y, X_val=None, y_val=None) -> "TabNetClassifier":
        cfg = self.config
        if (X_val is None) != (y_val is None):
            raise ValueError("provide both X_val and y_val, or neither")
        X, y = self._tensor(X), self._tensor(y)
        self.scaler = StandardStats.fit(X)
        Xs = self.scaler(X)
        self.module = TabNet(
            int(X.shape[1]), cfg.n_steps, cfg.width, cfg.gamma, generator=seeded_generator(cfg.seed)
        ).to(self.device)
        module, lam = self.module, cfg.lambda_sparse

        def apply_fn(xb, generator):
            logit, entropy, _ = module(xb)
            return logit, lam * entropy

        settings = TrainSettings(
            batch_size=cfg.batch_size,
            epochs=cfg.epochs,
            learning_rate=cfg.learning_rate,
            epochs_per_dispatch=cfg.epochs_per_dispatch,
            seed=cfg.seed,
        )
        val_kw: dict[str, Any] = {}
        if X_val is not None:
            val_kw = {"X_val": self.scaler(self._tensor(X_val)), "y_val": self._tensor(y_val)}
        self.history = fit_binary(module, Xs, y, settings, apply_fn=apply_fn, **val_kw)
        # Global importances from the aggregate masks over a strided sample
        # of the training rows (spread over the whole table, so a sorted
        # frame does not bias them; at most ~64k rows).
        stride = max(1, len(Xs) // 65536)
        with torch.no_grad():
            _, _, agg = module(Xs[::stride])
        self._train_mask_sum = agg.sum(dim=0).cpu().numpy()
        return self

    def predict_logits(self, X) -> torch.Tensor:
        if self.module is None or self.scaler is None:
            raise RuntimeError("fit first")
        with torch.no_grad():
            return self.module(self.scaler(self._tensor(X)))[0]

    def predict_proba(self, X) -> torch.Tensor:
        p1 = torch.sigmoid(self.predict_logits(X))
        return torch.stack([1.0 - p1, p1], dim=1)

    def predict(self, X, threshold: float = 0.5) -> np.ndarray:
        return (torch.sigmoid(self.predict_logits(X)) >= threshold).cpu().numpy().astype(np.int32)

    def score_auc(self, X, y) -> float:
        return float(roc_auc(self._tensor(y), self.predict_logits(X)))

    @property
    def feature_importances_(self) -> np.ndarray:
        if self._train_mask_sum is None:
            raise RuntimeError("fit first")
        s = self._train_mask_sum.sum()
        return self._train_mask_sum / s if s > 0 else self._train_mask_sum
