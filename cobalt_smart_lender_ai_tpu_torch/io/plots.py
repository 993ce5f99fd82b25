"""Evaluation plot artifacts — the PNG outputs the reference's trainer
uploads alongside metrics.json (`model_tree_train_test.py:184-210`, via
`save_plot_to_s3` :64-71): a confusion-matrix heatmap and a top-20
feature-importance bar chart. The port's copy of the reference package's
``io/plots.py``, drawing the same figures.

Rendering happens on host with matplotlib (imported lazily so the compute
path never pays for it) and returns raw PNG bytes for
`ObjectStore.put_bytes` — the same bytes-to-object contract the reference
uses (`plt.savefig(buf)` then S3 PutObject). Figures are built with the
object-oriented `Figure` + Agg canvas API, never pyplot, so rendering has
zero global state: the caller's interactive backend (e.g. a notebook's
inline backend) is untouched.
"""

from __future__ import annotations

import io as _io
from typing import Sequence

import numpy as np


def _new_fig(figsize):
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    fig = Figure(figsize=figsize)
    FigureCanvasAgg(fig)  # attaches itself as fig.canvas
    return fig


def _fig_to_png(fig) -> bytes:
    buf = _io.BytesIO()
    fig.savefig(buf, format="png", dpi=100, bbox_inches="tight")
    return buf.getvalue()


def render_confusion_matrix(
    cm: np.ndarray,
    class_names: Sequence[str] = ("No Default", "Default"),
    title: str = "Confusion Matrix",
) -> bytes:
    """Annotated heatmap of a (C, C) confusion matrix (rows = actual,
    cols = predicted) — the `sns.heatmap(annot=True, fmt='d')` plot of
    `model_tree_train_test.py:184-192`, rendered with plain matplotlib."""
    cm = np.asarray(cm, dtype=np.float64)
    fig = _new_fig((5, 4))
    ax = fig.add_subplot()
    im = ax.imshow(cm, cmap="Blues")
    fig.colorbar(im, ax=ax)
    thresh = cm.max() / 2.0 if cm.size else 0.0
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            ax.text(
                j,
                i,
                f"{int(round(cm[i, j])):d}",
                ha="center",
                va="center",
                color="white" if cm[i, j] > thresh else "black",
            )
    ax.set_xticks(range(len(class_names)), class_names)
    ax.set_yticks(range(len(class_names)), class_names)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("Actual")
    ax.set_title(title)
    return _fig_to_png(fig)


def render_feature_importance(
    names: Sequence[str],
    scores: Sequence[float],
    top_n: int = 20,
    title: str = "Feature Importance (gain)",
) -> bytes:
    """Horizontal bar chart of the top-``top_n`` features by score, largest
    on top — the booster-gain importance plot of
    `model_tree_train_test.py:197-210`."""
    scores = np.asarray(scores, dtype=np.float64)
    order = np.argsort(scores)[::-1][:top_n]
    top_names = [str(names[i]) for i in order][::-1]  # largest drawn last = top
    top_scores = scores[order][::-1]
    fig = _new_fig((7, max(3, 0.3 * len(top_names) + 1)))
    ax = fig.add_subplot()
    ax.barh(range(len(top_names)), top_scores, color="#2b6cb0")
    ax.set_yticks(range(len(top_names)), top_names, fontsize=8)
    ax.set_xlabel("total gain")
    ax.set_title(title)
    return _fig_to_png(fig)


__all__ = ["render_confusion_matrix", "render_feature_importance"]
