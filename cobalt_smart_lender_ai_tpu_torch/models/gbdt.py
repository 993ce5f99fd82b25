"""The tensorized gradient-boosted forest and its plain scoring functions.

A `Forest` holds ``T`` complete trees of depth ``d``: internal nodes are
heap-indexed ``0 .. 2^d - 2`` and the ``2^d`` leaves are stored separately
(heap slots ``2^d - 1 ..``). Training is not ported yet; forests arrive from
artifacts written by the reference package (`convert.forest_from_numpy`).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Forest:
    """Tensorized forest. ``cover`` is the training-row count reaching each
    heap slot (internal nodes, then leaves) — TreeSHAP's path weights."""

    feature: torch.Tensor  # (T, I) int32
    thr_float: torch.Tensor  # (T, I) float32; trivial splits are +inf
    missing_left: torch.Tensor  # (T, I) bool
    gain: torch.Tensor  # (T, I) float32; 0 for trivial (non-)splits
    cover: torch.Tensor  # (T, I + L) float32
    leaf_value: torch.Tensor  # (T, L) float32, already scaled by learning rate
    depth: int

    @property
    def n_trees(self) -> int:
        return self.feature.shape[0]

    @property
    def device(self) -> torch.device:
        return self.feature.device

    def to(self, device: torch.device | str) -> "Forest":
        return dataclasses.replace(
            self,
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
                if f.name != "depth"
            },
        )


def landed_leaves(
    feature: torch.Tensor,
    thr: torch.Tensor,
    missing_left: torch.Tensor,
    depth: int,
    X: torch.Tensor,
) -> torch.Tensor:
    """(N, T) index of the leaf each row lands in, per tree: ``depth`` levels
    of ``x <= thr`` (NaN follows the learned missing direction)."""
    N, T = X.shape[0], feature.shape[0]
    trees = torch.arange(T, device=X.device)
    feat = feature.long()
    node = torch.zeros((N, T), dtype=torch.long, device=X.device)
    for _ in range(depth):
        x = torch.gather(X, 1, feat[trees, node])
        go_left = torch.where(
            torch.isnan(x), missing_left[trees, node], x <= thr[trees, node]
        )
        node = 2 * node + 2 - go_left.long()
    return node - (2**depth - 1)


def sum_trees_in_order(values: torch.Tensor) -> torch.Tensor:
    """Sum (N, T) per-tree values over trees one f32 add at a time, tree 0
    first, starting at 0.0 — the reference's ``lax.scan`` order, so margins
    agree bit for bit."""
    margin = torch.zeros(values.shape[0], dtype=torch.float32, device=values.device)
    for t in range(values.shape[1]):
        margin = margin + values[:, t]
    return margin


def predict_margin(forest: Forest, X: torch.Tensor) -> torch.Tensor:
    """Sum-of-trees margin (log-odds) of raw float rows ``X`` (N, F)."""
    leaves = landed_leaves(
        forest.feature, forest.thr_float, forest.missing_left, forest.depth, X
    )
    trees = torch.arange(forest.n_trees, device=X.device)
    return sum_trees_in_order(forest.leaf_value[trees, leaves])


def gain_importances(
    forest: Forest, n_features: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(total_gain, n_splits) per feature over the real splits — backs the
    booster "gain" scores that ``/feature_importance_bulk`` serves."""
    real = forest.gain > 0.0
    idx = forest.feature.reshape(-1).long()
    zeros = torch.zeros(n_features, dtype=torch.float32, device=forest.device)
    total_gain = zeros.index_add(
        0, idx, torch.where(real, forest.gain, 0.0).reshape(-1)
    )
    n_splits = zeros.index_add(0, idx, real.reshape(-1).float())
    return total_gain, n_splits
