"""Classification metrics as plain PyTorch on the scores' device."""

from __future__ import annotations

import torch

__all__ = [
    "binary_classification_report",
    "confusion_matrix",
    "precision_recall_f1",
    "roc_auc",
]


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


def _weights(y: torch.Tensor, weight: torch.Tensor | None) -> torch.Tensor:
    return torch.ones_like(y, dtype=torch.float32) if weight is None else weight.to(torch.float32)


def confusion_matrix(
    y_true: torch.Tensor,
    y_pred: torch.Tensor,
    n_classes: int = 2,
    weight: torch.Tensor | None = None,
) -> torch.Tensor:
    """(n_classes, n_classes) float32 matrix, rows = actual, cols =
    predicted: one float32 one-hot product, as the reference computes it."""
    w = _weights(y_true.to(torch.float32), weight)
    oh_true = torch.nn.functional.one_hot(y_true.long(), n_classes).to(torch.float32)
    oh_pred = torch.nn.functional.one_hot(y_pred.long(), n_classes).to(torch.float32)
    return (oh_true * w[:, None]).T @ oh_pred


def precision_recall_f1(
    cm: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-class (precision, recall, f1, support) from a confusion matrix."""
    tp = torch.diagonal(cm)
    support = cm.sum(dim=1)
    pred_count = cm.sum(dim=0)
    precision = tp / torch.clamp(pred_count, min=1e-30)
    recall = tp / torch.clamp(support, min=1e-30)
    f1 = 2 * precision * recall / torch.clamp(precision + recall, min=1e-30)
    return precision, recall, f1, support


def binary_classification_report(
    y_true: torch.Tensor, y_pred: torch.Tensor, weight: torch.Tensor | None = None
) -> dict:
    """The dict of sklearn's ``classification_report(output_dict=True)``,
    with the key names the reference persists into ``metrics.json``."""
    cm = confusion_matrix(y_true, y_pred, 2, weight)
    precision, recall, f1, support = precision_recall_f1(cm)
    accuracy = torch.diagonal(cm).sum() / torch.clamp(cm.sum(), min=1e-30)

    def _cls(i: int) -> dict:
        return {
            "precision": float(precision[i]),
            "recall": float(recall[i]),
            "f1-score": float(f1[i]),
            "support": float(support[i]),
        }

    def wavg(v: torch.Tensor) -> float:
        return float(torch.sum(v * support) / torch.clamp(torch.sum(support), min=1e-30))

    return {
        "0": _cls(0),
        "1": _cls(1),
        "accuracy": float(accuracy),
        "macro avg": {
            "precision": float(precision.mean()),
            "recall": float(recall.mean()),
            "f1-score": float(f1.mean()),
            "support": float(support.sum()),
        },
        "weighted avg": {
            "precision": wavg(precision),
            "recall": wavg(recall),
            "f1-score": wavg(f1),
            "support": float(support.sum()),
        },
    }
