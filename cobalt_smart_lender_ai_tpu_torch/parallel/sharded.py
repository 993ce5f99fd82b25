"""Row-sharded (data-parallel) GBDT training and prediction over a mesh's
dp axis: the port's copy of the reference's ``parallel/sharded.py``.

Each dp shard holds a contiguous block of the rows (`parallel.mesh.row_bounds`:
uneven by at most one row, so nothing is padded) and builds the histograms
of its rows; each level's histograms are reduced exactly across the shards
(`ops.histogram.gradient_histogram_sharded`, int64 fixed point under one
scale the shards agree on, with the unpadded row count), and every shard
then takes the same split decisions. On the card a level's histograms are
the bits of one launch over all rows, so the first tree of a dp fit is the
single-device direct fit's, split for split. The leaf sums are added in
float32 across shards, as the reference's psum adds them, so later trees
may differ from the single device's in the last bits of g and h (and
near-tie splits with them); hold a dp forest to AUC and margins.

A one-entry dp axis is the single-device fit itself (`models.gbdt.fit_binned`,
with sibling subtraction as asked); with more than one shard subtraction is
off, as in the reference.
"""

from __future__ import annotations

import torch

from cobalt_smart_lender_ai_tpu_torch.models.gbdt import (
    Forest,
    GBDTHyperparams,
    concat_forest_chunks,
    fit_binned,
    fit_binned_chunked,
    fit_binned_resumable,
    predict_margin,
)
from cobalt_smart_lender_ai_tpu_torch.parallel.mesh import Mesh, RowShards

__all__ = ["fit_binned_dp", "fit_binned_dp_chunked", "predict_margin_dp"]


def _dp_rows(mesh: Mesh, dp_axis: str, n_rows: int) -> RowShards:
    if dp_axis != mesh.axis_dp:
        raise ValueError(f"the mesh's dp axis is {mesh.axis_dp!r}, not {dp_axis!r}")
    return mesh.row_shards(0, n_rows)


def _prep(mesh, bins, y, sample_weight, feature_mask):
    """The inputs on the mesh's first device, weights and mask defaulted."""
    dev = mesh.devices[0, 0]
    N, F = bins.shape
    sw = (
        torch.ones(N, dtype=torch.float32, device=dev)
        if sample_weight is None
        else sample_weight.to(device=dev, dtype=torch.float32)
    )
    fm = (
        torch.ones(F, dtype=torch.bool, device=dev)
        if feature_mask is None
        else feature_mask.to(device=dev, dtype=torch.bool)
    )
    return bins.to(dev), y.to(dev), sw, fm


def fit_binned_dp(
    mesh: Mesh,
    bins: torch.Tensor,  # (N, F)
    y: torch.Tensor,  # (N,)
    sample_weight: torch.Tensor | None,
    feature_mask: torch.Tensor | None,
    hp: GBDTHyperparams,
    seed: int,
    *,
    n_trees_cap: int,
    depth_cap: int,
    n_bins: int,
    dp_axis: str = "dp",
    hist_subtract: bool = True,
) -> Forest:
    """Data-parallel `fit_binned`: the rows split over the mesh's dp axis,
    histograms reduced exactly, the forest replicated (on the mesh's first
    device). A one-entry dp axis is `fit_binned` itself; with more shards
    the histograms are direct (``hist_subtract`` off, as the reference's)."""
    bins, y, sw, fm = _prep(mesh, bins, y, sample_weight, feature_mask)
    kw = dict(n_trees_cap=n_trees_cap, depth_cap=depth_cap, n_bins=n_bins)
    if mesh.shape[dp_axis] == 1:
        return fit_binned(bins, y, sw, fm, hp, seed, hist_subtract=hist_subtract, **kw)
    forest, _ = fit_binned_resumable(
        bins, y, sw, fm, hp, seed, hist_subtract=False, dp=_dp_rows(mesh, dp_axis, bins.shape[0]),
        **kw,
    )
    return forest


def fit_binned_dp_chunked(
    mesh: Mesh,
    bins: torch.Tensor,
    y: torch.Tensor,
    sample_weight: torch.Tensor | None,
    feature_mask: torch.Tensor | None,
    hp: GBDTHyperparams,
    seed: int,
    *,
    n_trees_cap: int,
    depth_cap: int,
    n_bins: int,
    chunk_trees: int,
    dp_axis: str = "dp",
    hist_subtract: bool = True,
) -> Forest:
    """`fit_binned_dp` in chunks of ``chunk_trees`` rounds, the margin
    carried between them: the same forest as one chunk, bit for bit (the
    tree streams key on the global tree index), as `fit_binned_chunked` is
    to `fit_binned`."""
    if chunk_trees <= 0:
        raise ValueError(f"chunk_trees must be positive, got {chunk_trees}")
    bins, y, sw, fm = _prep(mesh, bins, y, sample_weight, feature_mask)
    if mesh.shape[dp_axis] == 1:
        return fit_binned_chunked(
            bins, y, sw, fm, hp, seed, n_trees_cap=n_trees_cap, depth_cap=depth_cap,
            n_bins=n_bins, chunk_trees=chunk_trees, hist_subtract=hist_subtract,
        )
    dp = _dp_rows(mesh, dp_axis, bins.shape[0])
    margin = torch.zeros(bins.shape[0], dtype=torch.float32, device=bins.device)
    chunks = []
    for off in range(0, n_trees_cap, chunk_trees):
        forest_c, margin = fit_binned_resumable(
            bins, y, sw, fm, hp, seed, n_trees_cap=min(chunk_trees, n_trees_cap - off),
            depth_cap=depth_cap, n_bins=n_bins, init_margin=margin, tree_offset=off,
            hist_subtract=False, dp=dp,
        )
        chunks.append(forest_c)
    return concat_forest_chunks(chunks, n_trees_cap, depth_cap)


def predict_margin_dp(
    mesh: Mesh,
    forest: Forest,
    X: torch.Tensor,
    *,
    use_binned: bool = False,
    dp_axis: str = "dp",
) -> torch.Tensor:
    """Row-sharded predict: each dp shard walks its rows through the
    replicated forest on its device and stream, and the margins come back
    in row order on the mesh's first device (this process's shards' rows).
    A row's margin depends only on that row, so the bits are the single
    device's."""
    X = X.to(mesh.devices[0, 0])
    if mesh.shape[dp_axis] == 1:
        return predict_margin(forest.to(X.device), X, use_binned=use_binned)
    dp = _dp_rows(mesh, dp_axis, X.shape[0])
    parts = dp.split(X)
    forests = [forest.to(d) for d in dp.devices]
    return dp.gather(dp.run(lambda s: predict_margin(forests[s], parts[s], use_binned=use_binned)))
