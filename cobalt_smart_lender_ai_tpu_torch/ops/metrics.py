"""Classification metrics as plain PyTorch on the scores' device."""

from __future__ import annotations

import torch

__all__ = ["roc_auc"]


def roc_auc(
    y_true: torch.Tensor, scores: torch.Tensor, weight: torch.Tensor | None = None
) -> torch.Tensor:
    """Area under the ROC curve via the rank statistic, with exact tie
    handling (a tied positive-negative pair counts one half), matching
    ``sklearn.metrics.roc_auc_score`` and the reference's ``roc_auc``.
    O(N log N): one sort and one cumulative sum, in float32."""
    y = y_true.to(torch.float32)
    s = scores.to(torch.float32)
    w = torch.ones_like(y) if weight is None else weight.to(torch.float32)
    order = torch.argsort(s, stable=True)
    ss = s[order]
    cum_neg = torch.cumsum((w * (1.0 - y))[order], dim=0)
    left = torch.searchsorted(ss, s, right=False)
    right = torch.searchsorted(ss, s, right=True)
    zero = torch.zeros((), dtype=torch.float32, device=s.device)
    neg_below = torch.where(left > 0, cum_neg[torch.clamp(left - 1, min=0)], zero)
    neg_at = torch.where(right > 0, cum_neg[torch.clamp(right - 1, min=0)], zero) - neg_below
    wp = w * y
    total_neg = cum_neg[-1]
    pairs_won = torch.sum(wp * (neg_below + 0.5 * neg_at))
    return pairs_won / torch.clamp(wp.sum() * total_neg, min=1e-30)
