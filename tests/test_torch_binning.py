"""The port's quantile binning against the JAX package's, on the CPU.

Edges and bins must be bit-identical: the same seeded numpy matrix (NaN
cells, a 0/1 column, a constant column and an all-NaN column) goes through
`compute_bin_edges` / `transform` of both packages.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cobalt_smart_lender_ai_tpu.ops import binning as jax_binning
from cobalt_smart_lender_ai_tpu_torch.convert import bin_spec_from_numpy
from cobalt_smart_lender_ai_tpu_torch.ops import binning


def _matrix(n: int = 4000, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    X = rng.lognormal(size=(n, 7)).astype(np.float32)
    X[:, 1] = rng.normal(size=n).astype(np.float32) * 1e4
    X[rng.random(X.shape) < 0.1] = np.nan
    X[:, 3] = rng.integers(0, 2, n)  # one-hot indicator
    X[:, 4] = 7.0  # constant
    X[:, 5] = np.nan  # all missing
    return X


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("n_bins", [16, 64, 255, 300])
def test_edges_and_bins_bit_identical_to_jax(n_bins):
    X = _matrix()
    jspec = jax_binning.compute_bin_edges(jnp.asarray(X), n_bins=n_bins)
    spec = binning.compute_bin_edges(torch.from_numpy(X), n_bins)
    assert spec.n_bins == n_bins and spec.n_features == X.shape[1]
    np.testing.assert_array_equal(_bits(spec.edges.numpy()), _bits(np.asarray(jspec.edges)))
    assert np.isinf(spec.edges[5].numpy()).all()  # the all-NaN column

    jb = np.asarray(jax_binning.transform(jspec, jnp.asarray(X)))
    tb = binning.transform(spec, torch.from_numpy(X)).numpy()
    assert tb.dtype == jb.dtype == (np.uint8 if n_bins <= 256 else np.int32)
    np.testing.assert_array_equal(tb, jb)
    assert (tb[np.isnan(X)] == 0).all() and (tb[~np.isnan(X)] >= 1).all()


@pytest.mark.parametrize("n_bins", [16, 255])
def test_quantile_levels_match_linspace(n_bins):
    ref = np.asarray(jnp.linspace(0.0, 1.0, n_bins - 1)[1:-1])
    np.testing.assert_array_equal(_bits(binning.quantile_levels(n_bins).numpy()), _bits(ref))


def test_float_threshold_matches_jax():
    X = _matrix(seed=3)
    jspec = jax_binning.compute_bin_edges(jnp.asarray(X), n_bins=64)
    spec = bin_spec_from_numpy(np.asarray(jspec.edges))
    rng = np.random.default_rng(1)
    feature = rng.integers(0, X.shape[1], (5, 15)).astype(np.int32)
    thr_bin = rng.integers(1, 64, (5, 15)).astype(np.int32)  # 63 = trivial
    ref = np.asarray(jax_binning.float_threshold(jspec, jnp.asarray(feature), jnp.asarray(thr_bin)))
    got = binning.float_threshold(spec, torch.from_numpy(feature), torch.from_numpy(thr_bin))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))
    assert np.isinf(got.numpy()[thr_bin == 63]).all()


def test_bin_spec_from_numpy_checks_rank():
    with pytest.raises(ValueError, match="n_bins - 2"):
        bin_spec_from_numpy(np.zeros(5, np.float32))
