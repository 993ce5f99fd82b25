"""Logistic regression: the reference's ``models/linear.py`` (its
BASELINE configs[0]) in PyTorch on ``device``.

A fixed number of Newton-Raphson steps with ridge ``l2`` on the
coefficients (not the intercept). NaNs are mean-imputed, then each column
is standardised (population standard deviation, at least 1e-8). The
Hessian is positive definite, so each step solves it by Cholesky
(`torch.linalg.cholesky`, `torch.cholesky_solve`). Class imbalance is a
``pos_weight`` on the positive rows, with the semantics of XGBoost's
``scale_pos_weight``.
"""

from __future__ import annotations

import dataclasses

import torch

from cobalt_smart_lender_ai_tpu_torch.device import resolve_device

__all__ = ["LogisticRegression", "LogisticRegressionParams"]


@dataclasses.dataclass(frozen=True)
class LogisticRegressionParams:
    coef: torch.Tensor  # (F,)
    intercept: torch.Tensor  # ()
    mean: torch.Tensor  # (F,) standardisation mean
    scale: torch.Tensor  # (F,) standardisation scale

    def state_dict(self) -> dict[str, torch.Tensor]:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}


def _fit(
    X: torch.Tensor,
    y: torch.Tensor,
    sample_weight: torch.Tensor,
    l2: float,
    pos_weight: float,
    n_iter: int,
) -> LogisticRegressionParams:
    mean = torch.nanmean(X, dim=0)
    Xf = torch.where(torch.isnan(X), mean[None, :], X)
    scale = torch.clamp_min(Xf.std(dim=0, correction=0), 1e-8)
    Xs = (Xf - mean[None, :]) / scale[None, :]
    n, f = Xs.shape
    Xb = torch.cat([Xs, torch.ones((n, 1), dtype=Xs.dtype, device=Xs.device)], dim=1)
    w_row = sample_weight * torch.where(y > 0.5, pos_weight, 1.0)
    reg = l2 * torch.cat([torch.ones(f, device=Xs.device), torch.zeros(1, device=Xs.device)])
    ridge = torch.diag(reg + 1e-8)
    beta = torch.zeros(f + 1, dtype=Xs.dtype, device=Xs.device)
    for _ in range(n_iter):
        p = torch.sigmoid(Xb @ beta)
        g = Xb.T @ (w_row * (p - y)) + reg * beta
        s = w_row * torch.clamp_min(p * (1.0 - p), 1e-6)
        H = (Xb * s[:, None]).T @ Xb + ridge
        beta = beta - torch.cholesky_solve(g[:, None], torch.linalg.cholesky(H))[:, 0]
    return LogisticRegressionParams(beta[:f], beta[f], mean, scale)


class LogisticRegression:
    """sklearn-shaped facade on ``device`` (``cuda`` unless the caller asks
    for ``cpu``)."""

    def __init__(
        self,
        l2: float = 1.0,
        pos_weight: float = 1.0,
        n_iter: int = 25,
        *,
        device: torch.device | str = "cuda",
    ):
        self.l2 = l2
        self.pos_weight = pos_weight
        self.n_iter = n_iter
        self.device = resolve_device(device)
        self.params: LogisticRegressionParams | None = None

    def _tensor(self, X) -> torch.Tensor:
        return torch.as_tensor(X, dtype=torch.float32).to(self.device)

    def fit(self, X, y, sample_weight=None) -> "LogisticRegression":
        X, y = self._tensor(X), self._tensor(y)
        sw = torch.ones_like(y) if sample_weight is None else self._tensor(sample_weight)
        self.params = _fit(X, y, sw, float(self.l2), float(self.pos_weight), int(self.n_iter))
        return self

    def decision_function(self, X) -> torch.Tensor:
        """(N,) logits: sklearn's ``decision_function``."""
        if self.params is None:
            raise RuntimeError("fit first")
        p = self.params
        X = self._tensor(X)
        Xf = torch.where(torch.isnan(X), p.mean[None, :], X)
        return ((Xf - p.mean[None, :]) / p.scale[None, :]) @ p.coef + p.intercept

    def predict_proba(self, X) -> torch.Tensor:
        """(N, 2) class probabilities, as the other model facades give them."""
        p1 = torch.sigmoid(self.decision_function(X))
        return torch.stack([1.0 - p1, p1], dim=1)

    def predict(self, X, threshold: float = 0.5) -> torch.Tensor:
        return (self.predict_proba(X)[:, 1] >= threshold).to(torch.int32)
