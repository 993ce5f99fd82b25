"""Quantile binning for histogram gradient boosting.

Bin 0 is reserved for missing values (NaN); real values occupy bins
``1 .. n_bins-1`` bounded by ``n_bins - 2`` per-feature quantile edges. The
edges and bins are bit-identical to the reference package's
``ops/binning.py`` on the CPU, and the same functions give the same bits on
the card:

- the quantile levels are ``float32(1 / (n_bins - 2)) * arange`` in float32,
  which is what the reference's ``linspace`` computes;
- the quantiles follow the reference's ``nanquantile`` formula (sort with NaN
  last, per-column non-NaN counts in float32, linear interpolation), column
  by column, rather than ``torch.nanquantile``: that one interpolates
  differently (up to 1.6e-4 apart) and refuses inputs over 16M elements;
- the interpolation ``lv*lw + hv*hw`` is rounded once, as the fused
  multiply-add the reference's compiler emits on the CPU: ``lv*lw`` in
  float32, the rest in float64, then rounded to float32.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "BinSpec",
    "bin_edges_and_transform",
    "compute_bin_edges",
    "float_threshold",
    "quantile_levels",
    "transform",
]


@dataclasses.dataclass(frozen=True)
class BinSpec:
    """Per-feature quantile bin edges, ``(F, n_bins - 2)`` float32, sorted
    ascending per row; entries may repeat (the duplicate bins stay empty).
    All-NaN features get ``+inf`` edges, so every value lands in bin 1."""

    edges: torch.Tensor

    @property
    def n_features(self) -> int:
        return self.edges.shape[0]

    @property
    def n_bins(self) -> int:
        return self.edges.shape[1] + 2


def quantile_levels(n_bins: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """The ``n_bins - 3`` interior quantile levels, float32: the reference's
    ``linspace(0, 1, n_bins - 1)[1:-1]`` bit for bit."""
    n = n_bins - 1
    step = torch.tensor(1.0 / (n - 1), dtype=torch.float32)
    return (step.to(device) * torch.arange(n, dtype=torch.float32, device=device))[1:-1]


def _nanquantile_column(col: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """Linear-interpolation quantiles of one float32 column, NaN ignored; an
    all-NaN column gives NaN."""
    srt = torch.sort(col).values  # NaN sorts last
    count = (~torch.isnan(col)).sum().to(torch.float32)
    q = qs * (count - 1.0)
    top = count - 1.0
    lo = torch.clamp(torch.minimum(torch.floor(q), top), min=0.0)
    hi = torch.clamp(torch.minimum(torch.ceil(q), top), min=0.0)
    hw = q - torch.floor(q)
    lw = 1.0 - hw
    lv = srt[lo.long()]
    hv = srt[hi.long()]
    return ((lv * lw).double() + hv.double() * hw.double()).float()


def compute_bin_edges(X: torch.Tensor, n_bins: int = 255) -> BinSpec:
    """Quantile edges per feature, NaN-aware. ``X`` is ``(N, F)`` float."""
    if n_bins < 4:
        raise ValueError(f"n_bins must be at least 4, got {n_bins}")
    Xf = X.to(torch.float32)
    qs = quantile_levels(n_bins, Xf.device)
    interior = torch.stack([_nanquantile_column(Xf[:, f], qs) for f in range(Xf.shape[1])])
    top = torch.full((Xf.shape[1], 1), float("inf"), dtype=torch.float32, device=Xf.device)
    edges = torch.cat([interior, top], dim=1)
    return BinSpec(edges=torch.where(torch.isnan(edges), float("inf"), edges).contiguous())


def transform(spec: BinSpec, X: torch.Tensor) -> torch.Tensor:
    """Map ``(N, F)`` float values to ``(N, F)`` bin indices: a finite value v
    lands in bin ``1 + #{edges < v}`` (so ``bin <= t`` <=> ``v <=
    edges[t-1]``), NaN in bin 0. uint8 for ``n_bins <= 256``, else int32.

    The bins are uint8: index with them only after ``.long()`` (a uint8
    tensor used as an index is a boolean mask in PyTorch)."""
    Xf = X.to(torch.float32)
    dtype = torch.uint8 if spec.n_bins <= 256 else torch.int32
    out = torch.empty(Xf.shape, dtype=dtype, device=Xf.device)
    for f in range(Xf.shape[1]):
        col = Xf[:, f].contiguous()
        b = torch.searchsorted(spec.edges[f].contiguous(), col, right=False) + 1
        out[:, f] = torch.where(torch.isnan(col), 0, b).to(dtype)
    return out


def bin_edges_and_transform(X: torch.Tensor, n_bins: int = 255) -> tuple[BinSpec, torch.Tensor]:
    """The quantile edges of ``X`` and its bins, on ``X``'s device: the
    device ingest's features go to the GBDT sketch without leaving the
    device. The same bits as `compute_bin_edges` then `transform`."""
    spec = compute_bin_edges(X, n_bins=n_bins)
    return spec, transform(spec, X)


def float_threshold(spec: BinSpec, feature: torch.Tensor, thr_bin: torch.Tensor) -> torch.Tensor:
    """The float threshold of each bin threshold: ``go_left = x <=
    edges[feature, thr_bin - 1]``. Trivial splits (``thr_bin = n_bins - 1``)
    clamp to the +inf top edge, so everything routes left."""
    idx = torch.clamp(thr_bin.long() - 1, 0, spec.edges.shape[1] - 1)
    return spec.edges[feature.long(), idx]
