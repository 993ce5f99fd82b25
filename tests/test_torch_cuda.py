"""The ``score_forest`` CUDA kernel against its plain PyTorch version, on the card.

These tests need an NVIDIA GPU (the kernel has no CPU mode) and skip
elsewhere. They import nothing of JAX, so they also run on a machine without
it, skipping the JAX-only conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: margins bit-identical (both sum the landed leaf values one f32 add
per tree, in tree order); prob within 1e-6 (two sigmoid implementations);
phis within 1e-5 (the kernel adds a tree's contributions with atomics in no
fixed order).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from cobalt_smart_lender_ai_tpu_torch.io import GBDTArtifact, ObjectStore
from cobalt_smart_lender_ai_tpu_torch.ops.score import (
    fused_score,
    fused_score_reference,
    pack_forest,
)

ROOT = Path(__file__).resolve().parent.parent
TOL_PROB = 1e-6
TOL_SHAP = 1e-5


@pytest.fixture(scope="module")
def card_pack():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the score_forest kernel has no CPU mode")
    art = GBDTArtifact.load(ObjectStore(str(ROOT / "artifacts")), "models/gbdt/model_tree", "cuda")
    F = len(art.feature_names)
    return pack_forest(art.forest, F), pack_forest(art.forest.to("cpu"), F), F


def _rows(pack, n: int, seed: int) -> np.ndarray:
    """Rows straddling the forest's own thresholds, ~10% NaN cells."""
    rng = np.random.default_rng(seed)
    thr, feat = pack.thr.cpu().numpy(), pack.feature.cpu().numpy()
    X = rng.normal(size=(n, pack.n_features)).astype(np.float32)
    for f in range(pack.n_features):
        vals = thr[(feat == f) & np.isfinite(thr)]
        if vals.size:
            X[:, f] = rng.choice(vals, n) * (1.0 + 0.05 * rng.normal(size=n)).astype(np.float32)
    X[rng.random(X.shape) < 0.1] = np.nan
    return X


@pytest.mark.cuda
@pytest.mark.parametrize("rows, with_shap", [(1, True), (64, True), (4096, False)])
def test_kernel_matches_plain_on_card(card_pack, rows, with_shap):
    pack, cpu_pack, F = card_pack
    Xn = _rows(pack, rows, seed=rows)
    X = torch.from_numpy(Xn).cuda()
    before = fused_score.launches
    out = fused_score(pack, X, n_features=F, with_shap=with_shap)
    torch.cuda.synchronize()
    assert fused_score.launches == before + 1
    ref = fused_score_reference(pack, X, n_features=F, with_shap=with_shap)
    assert torch.equal(out[0], ref[0])
    cpu_margin = fused_score_reference(cpu_pack, torch.from_numpy(Xn), n_features=F, with_shap=False)[0]
    assert torch.equal(out[0].cpu(), cpu_margin)
    assert float((out[1] - ref[1]).abs().max()) <= TOL_PROB
    if with_shap:
        assert float((out[2] - ref[2]).abs().max()) <= TOL_SHAP
        additivity = (out[3] + out[2].sum(1) - out[0]).abs().max()
        assert float(additivity) <= 1e-4
