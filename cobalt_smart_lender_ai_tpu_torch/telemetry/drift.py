"""Feature-distribution sketches + population-stability-index drift scoring.

The canary shadow tap (`serve/canary.py`) sees every sampled live row anyway;
drift detection falls out of keeping a tiny histogram per feature and
comparing it against the snapshot of the *training* distribution stored with
the model's registry provenance. The comparison is the credit-risk industry's
standard population stability index:

    PSI(f) = sum_bins (p_live - p_train) * ln(p_live / p_train)

with the usual reading: < 0.1 stable, 0.1-0.25 drifting, > 0.25 act (the
default ``ServeConfig.drift_psi_alert``). Bin edges are training-set
quantiles, fixed at train time and shipped in the provenance record, so the
serve side never re-bins and the two histograms are always comparable.

Everything here is plain numpy over O(features x bins) integers — cheap
enough to recompute on every `/drift` scrape or metrics collect.
"""

from __future__ import annotations

import threading
from typing import Iterable, Mapping

import numpy as np

# Laplace smoothing applied to both histograms before the log-ratio: PSI is
# undefined on empty bins, and a single unlucky empty live bin must not spike
# the score to infinity.
_SMOOTH = 0.5


def psi(expected_counts: np.ndarray, actual_counts: np.ndarray) -> float:
    """PSI between two aligned histograms (counts, not proportions)."""
    e = np.asarray(expected_counts, dtype=np.float64) + _SMOOTH
    a = np.asarray(actual_counts, dtype=np.float64) + _SMOOTH
    e /= e.sum()
    a /= a.sum()
    return float(np.sum((a - e) * np.log(a / e)))


class FeatureSketch:
    """Per-feature fixed-edge histograms, thread-safe to update.

    ``edges[i]`` holds the *interior* cut points for feature ``i`` (so
    ``bins`` counts per feature via ``searchsorted``); NaNs land in a
    dedicated overflow bin so missing-rate drift is scored like any other
    shape change.
    """

    def __init__(
        self,
        feature_names: Iterable[str],
        edges: list[np.ndarray],
        counts: np.ndarray | None = None,
    ):
        self.feature_names = list(feature_names)
        self.edges = [np.asarray(e, dtype=np.float64) for e in edges]
        if len(self.edges) != len(self.feature_names):
            raise ValueError("one edge vector per feature required")
        # Widest feature + value-overflow bin + NaN bin; features with fewer
        # distinct quantile edges simply leave their trailing bins at zero.
        bins = (max(e.size for e in self.edges) + 2) if self.edges else 2
        self.counts = (
            np.zeros((len(self.feature_names), bins), dtype=np.int64)
            if counts is None
            else np.asarray(counts, dtype=np.int64).copy()
        )
        self._lock = threading.Lock()

    @classmethod
    def from_data(
        cls,
        X: np.ndarray,
        feature_names: Iterable[str],
        *,
        bins: int = 10,
    ) -> "FeatureSketch":
        """Training-snapshot constructor: quantile edges per feature, counts
        filled from the same data. Degenerate (near-constant) features get
        whatever distinct quantiles exist — PSI over fewer bins is fine."""
        X = np.asarray(X, dtype=np.float64)
        names = list(feature_names)
        qs = np.linspace(0.0, 1.0, bins + 1)[1:-1]
        edges = []
        for j in range(X.shape[1]):
            col = X[:, j]
            col = col[np.isfinite(col)]
            e = (np.unique(np.quantile(col, qs)) if col.size
                 else np.asarray([0.0]))
            edges.append(e)
        sk = cls(names, edges)
        sk.observe(X)
        return sk

    def empty_like(self) -> "FeatureSketch":
        """A zero-count sketch over the SAME edges — the live accumulator."""
        return FeatureSketch(self.feature_names, self.edges)

    @property
    def n(self) -> int:
        """Rows observed (read off feature 0; every row updates all rows)."""
        return int(self.counts[0].sum()) if len(self.feature_names) else 0

    def observe(self, X: np.ndarray) -> None:
        """Fold a batch of rows (N, F) into the histograms."""
        X = np.asarray(X, dtype=np.float64)
        if X.ndim == 1:
            X = X[None, :]
        with self._lock:
            for j, e in enumerate(self.edges):
                col = X[:, j]
                finite = np.isfinite(col)
                idx = np.searchsorted(e, col[finite], side="right")
                np.add.at(self.counts[j], idx, 1)
                self.counts[j, -1] += int((~finite).sum())  # NaN bin

    def observe_row(self, row: Mapping[str, float]) -> None:
        """Fold one validated request row (keyed by feature name)."""
        vals = np.asarray(
            [float(row.get(f, np.nan)) for f in self.feature_names],
            dtype=np.float64,
        )
        self.observe(vals)

    def psi_vs(self, live: "FeatureSketch") -> dict[str, float]:
        """Per-feature PSI of ``live`` against this (baseline) sketch."""
        with live._lock:
            live_counts = live.counts.copy()
        return {
            name: psi(self.counts[j], live_counts[j])
            for j, name in enumerate(self.feature_names)
        }

    # -- JSON round-trip (registry provenance records) ------------------------

    def to_json(self) -> dict:
        return {
            "feature_names": list(self.feature_names),
            "edges": [e.tolist() for e in self.edges],
            "counts": self.counts.tolist(),
        }

    @classmethod
    def from_json(cls, obj: Mapping) -> "FeatureSketch":
        return cls(
            obj["feature_names"],
            [np.asarray(e) for e in obj["edges"]],
            counts=np.asarray(obj["counts"]),
        )


__all__ = ["FeatureSketch", "psi"]
