"""The port's `rfe_select` against the JAX package's, on the CPU.

Seeded rows (4000 x 30: a few informative columns of decreasing weight, a
0/1 column, noise, ~5% NaN). The selector draws nothing at random
(subsample = colsample_bytree = 1), so the port's refits grow the
reference's trees and eliminate the same features: ``support_`` and
``ranking_`` equal the reference's host-stepped loop
(``steps_per_dispatch=0``) exactly, and each refit's total gain per
feature is within rtol 1e-5 of the reference's (the two sigmoids differ in
the last bit, which moves margins from the second tree on). ``cv_folds``
(RFECV) is not ported and raises.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cobalt_smart_lender_ai_tpu.config import RFEConfig as JaxRFEConfig
from cobalt_smart_lender_ai_tpu.parallel import rfe as jax_rfe
from cobalt_smart_lender_ai_tpu_torch.config import RFEConfig
from cobalt_smart_lender_ai_tpu_torch.parallel import rfe

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    N, F = 4000, 30
    X = rng.normal(size=(N, F)).astype(np.float32)
    X[:, 5] = rng.integers(0, 2, N)
    X[:, 7] = rng.lognormal(size=N)
    weights = np.zeros(F, np.float32)
    weights[[0, 3, 5, 7, 11, 12, 19, 26]] = [1.5, -1.1, 0.9, 0.7, 0.5, -0.4, 0.3, 0.2]
    logit = np.nan_to_num(X) @ weights - 1.2
    y = (rng.random(N) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    return X, y


def _recording(module, monkeypatch) -> list[np.ndarray]:
    """Record each refit's total gains as ``module``'s loop takes them."""
    seen: list[np.ndarray] = []
    inner = module.gain_importances

    def record(forest, n_features):
        out = inner(forest, n_features)
        seen.append(np.array(out[0], dtype=np.float64))
        return out

    monkeypatch.setattr(module, "gain_importances", record)
    return seen


@pytest.mark.parametrize(
    "kw",
    [
        dict(n_select=8, step=3, n_estimators=10, max_depth=3, scale_pos_weight=2.0),
        dict(n_select=20, step=1, n_estimators=6, max_depth=3),
    ],
    ids=["step3", "step1"],
)
def test_rfe_matches_jax(data, kw, monkeypatch):
    X, y = data
    port_gains = _recording(rfe, monkeypatch)
    jax_gains = _recording(jax_rfe, monkeypatch)
    got = rfe.rfe_select(X, y, RFEConfig(**kw), device="cpu")
    ref = jax_rfe.rfe_select(jnp.asarray(X), jnp.asarray(y), JaxRFEConfig(**kw, steps_per_dispatch=0))
    np.testing.assert_array_equal(got.support_, np.asarray(ref.support_))
    np.testing.assert_array_equal(got.ranking_, np.asarray(ref.ranking_))
    assert got.n_features_ == ref.n_features_ == kw["n_select"]
    assert got.cv_scores_ is None
    n_iters = -(-(X.shape[1] - kw["n_select"]) // kw["step"])
    assert len(port_gains) == len(jax_gains) == n_iters
    assert sorted(set(got.ranking_.tolist())) == list(range(1, n_iters + 2))
    for i, (a, b) in enumerate(zip(port_gains, jax_gains)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=0.0, err_msg=f"refit {i}")


def test_rfe_keeps_everything_when_nothing_to_drop(data):
    X, y = data
    got = rfe.rfe_select(X[:500, :6], y[:500], RFEConfig(n_select=6, n_estimators=2), device="cpu")
    assert got.support_.all() and (got.ranking_ == 1).all()


def test_rfecv_is_not_ported(data):
    X, y = data
    with pytest.raises(NotImplementedError, match="A4"):
        rfe.rfe_select(X, y, RFEConfig(n_select=8), cv_folds=3, device="cpu")
