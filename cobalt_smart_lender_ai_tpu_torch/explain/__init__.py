"""Model explanations: path-dependent TreeSHAP and gain importances."""

from __future__ import annotations

import numpy as np
import torch

from cobalt_smart_lender_ai_tpu_torch.explain.treeshap import shap_values
from cobalt_smart_lender_ai_tpu_torch.models.gbdt import GBDTClassifier, gain_importances


class TreeExplainer:
    """``shap.TreeExplainer``-shaped facade over the fitted model's forest,
    the drop-in for the reference API's explainer.

    Each chunk of `shap_values` is one call of the scoring entry that
    serving uses (`ops.score.fused_score` on the forest's f32 pack): on a
    card one launch of ``score_forest``'s SHAP kernel, on the CPU its plain
    version. The pack is built at the first call."""

    def __init__(self, model: GBDTClassifier):
        if model.forest is None:
            raise RuntimeError("TreeExplainer needs a fitted model; call fit first")
        self.model = model
        self._pack = None
        self._base: float | None = None

    def _packed(self):
        from cobalt_smart_lender_ai_tpu_torch.ops.score import pack_forest

        if self._pack is None:
            self._pack = pack_forest(self.model.forest, self.model.n_features_, "f32")
        return self._pack

    def shap_values(self, X, chunk_size: int = 256) -> np.ndarray:
        """(N, F) float32 attributions of the margin (log-odds) for rows
        ``X`` (an array or a tensor on any device), ``chunk_size`` rows a
        call on the forest's device."""
        from cobalt_smart_lender_ai_tpu_torch.ops.score import fused_score

        if chunk_size <= 0:
            raise ValueError(f"chunk_size must be positive, got {chunk_size}")
        pack = self._packed()
        F = self.model.n_features_
        X = torch.as_tensor(X, dtype=torch.float32).to(pack.device).contiguous()
        out = []
        for start in range(0, X.shape[0], chunk_size):
            _, _, phis, base = fused_score(pack, X[start : start + chunk_size], n_features=F)
            self._base = float(base)
            out.append(phis.cpu().numpy())
        return np.concatenate(out, axis=0) if out else np.zeros((0, F), np.float32)

    @property
    def expected_value(self) -> float:
        """The SHAP base value (the cover-weighted expected margin) that
        the scoring entry returns beside the phis, cached after the first
        call."""
        if self._base is None:
            self._base = float(self._packed().base)
        return self._base


__all__ = ["shap_values", "TreeExplainer", "gain_importances"]
