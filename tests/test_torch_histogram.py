"""The port's gradient histogram against the JAX package's, on the CPU.

On CPU tensors `gradient_histogram_channels` runs its plain version (a
segment sum per channel); it is held to the JAX package's exact
formulation, ``gradient_histogram(impl="segsum")``: cover bit for bit, g and
h within 1e-5 of the largest |value| of the channel (float32 sums taken in
another order). The CUDA kernel is held to the same plain version on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cobalt_smart_lender_ai_tpu.ops.histogram import gradient_histogram as jax_histogram
from cobalt_smart_lender_ai_tpu_torch.ops.histogram import (
    gradient_histogram,
    gradient_histogram_channels,
    gradient_histogram_reference,
    histogram_supported,
)

TOL = 1e-5


def _inputs(N, F, B, K, seed, *, subtracted=False):
    """Seeded level inputs. ``subtracted`` mimics the fit's sibling-subtracted
    call: rows of right children (odd child index) carry zero g, h and w,
    and the node index is the parent's."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, (N, F)).astype(np.uint8 if B <= 256 else np.int32)
    g = rng.normal(size=N).astype(np.float32)
    h = (np.abs(g) + 0.1).astype(np.float32)
    w = (rng.random(N) < 0.9).astype(np.float32)
    if subtracted:
        child = rng.integers(0, 2 * K, N)
        node = (child // 2).astype(np.int32)
        left = (child % 2 == 0).astype(np.float32)
        g, h, w = g * left, h * left, w * left
    else:
        node = rng.integers(0, K, N).astype(np.int32)
    return bins, node, g, h, w


@pytest.mark.parametrize(
    "N,F,B,K,subtracted",
    [
        (3000, 10, 16, 4, False),
        (1000, 7, 16, 1, False),
        (5000, 33, 64, 2, False),
        (2048, 4, 256, 8, False),
        (4000, 20, 255, 32, True),  # the fit's level-6 subtracted call
    ],
)
def test_plain_histogram_matches_jax_segsum(N, F, B, K, subtracted):
    bins, node, g, h, w = _inputs(N, F, B, K, N + F + B + K, subtracted=subtracted)
    ref = np.asarray(
        jax_histogram(
            jnp.asarray(bins), jnp.asarray(node), jnp.asarray(g), jnp.asarray(h),
            jnp.asarray(w), n_nodes=K, n_bins=B, impl="segsum",
        )
    )
    t = [torch.from_numpy(a) for a in (bins, node, g, h, w)]
    got = gradient_histogram(*t, n_nodes=K, n_bins=B).numpy()
    assert got.shape == ref.shape == (K, F, B, 3)
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    for c in (0, 1):
        scale = np.abs(ref[..., c]).max()
        np.testing.assert_allclose(got[..., c], ref[..., c], rtol=0, atol=TOL * scale)
    # Node cover from any feature's bins; the channel-split views agree.
    hg, hh, hw = gradient_histogram_channels(*t, n_nodes=K, n_bins=B)
    np.testing.assert_array_equal(hw.sum(-1).numpy(), np.broadcast_to(hw[:, :1].sum(-1).numpy(), (K, F)))
    np.testing.assert_array_equal(np.stack([hg, hh, hw], -1), got)


def test_zero_rows_add_nothing():
    bins, node, g, h, w = _inputs(515, 5, 16, 2, 0)
    t = [torch.from_numpy(a) for a in (bins, node)]
    z = torch.zeros(515)
    out = gradient_histogram_reference(*t, z, z, z, n_nodes=2, n_bins=16)
    assert out.shape == (3, 2, 5, 16) and not out.any()


def _fixed_point_sum(bins, node, v, K, B):
    """The CUDA kernel's arithmetic, in numpy: scale by 2^e with e = 62 -
    ceil-log2(N * max|v|), round each value to int64, add as integers, scale
    back and round once to float32."""
    N, F = bins.shape
    m = np.float32(np.abs(v).max())
    e = 0 if m == 0 else 62 - np.frexp(float(m) * N)[1]
    q = np.rint(np.ldexp(v.astype(np.float64), e)).astype(np.int64)
    acc = np.zeros((K, F, B), np.int64)
    for f in range(F):
        np.add.at(acc[:, f, :], (node, bins[:, f].astype(np.int64)), q)
    return np.ldexp(acc.astype(np.float64), -e).astype(np.float32), e


def test_fixed_point_design_meets_the_tolerance():
    """The kernel's determinism rests on int64 fixed-point sums; this holds
    that arithmetic to the float64 sums: every g and h sum within its own
    float32 rounding plus N * 2^-(e+1), a 0/1 cover exact."""
    N, F, B, K = 6000, 6, 64, 4
    bins, node, g, h, w = _inputs(N, F, B, K, 5)
    g = g * 3.7  # the full-width fit's largest |g| is about scale_pos_weight
    for v, exact in ((g, False), (h, False), (w, True)):
        got, e = _fixed_point_sum(bins, node, v, K, B)
        ref64 = np.zeros((K, F, B))
        for f in range(F):
            np.add.at(ref64[:, f, :], (node, bins[:, f].astype(np.int64)), v.astype(np.float64))
        if exact:
            np.testing.assert_array_equal(got, ref64.astype(np.float32))
        else:
            err = np.abs(got.astype(np.float64) - ref64)
            bound = np.abs(ref64) * 2.0**-24 + N * 2.0 ** -(e + 1)
            assert (err <= bound).all(), (err - bound).max()
            assert N * 2.0 ** -(e + 1) < 1e-6 * TOL * np.abs(ref64).max()


def test_shape_guard():
    assert histogram_supported(255) and histogram_supported(9000)
    assert not histogram_supported(10_000) and not histogram_supported(0)


def test_plain_version_nonfinite_bins():
    """Pins what the plain version does with non-finite inputs, which the
    kernel is held to on the card: a bin that a NaN or both infinities reach
    holds NaN, one that only one sign of infinity reaches holds it, and the
    other bins their finite sums."""
    inf, nan = float("inf"), float("nan")
    bins = torch.tensor([[0, 1], [0, 2], [1, 1], [1, 3], [2, 3]], dtype=torch.uint8)
    node = torch.zeros(5, dtype=torch.int32)
    g = torch.tensor([1.0, nan, 2.0, inf, 3.0])
    h = torch.tensor([inf, -inf, 1.0, 1.0, 1.0])
    w = torch.tensor([1.0, 1.0, -inf, 1.0, 1.0])
    hg, hh, hw = gradient_histogram_channels(bins, node, g, h, w, n_nodes=1, n_bins=4)
    want_g = [[nan, inf, 3.0, 0.0], [0.0, 3.0, nan, 3.0 + inf]]
    want_h = [[nan, 2.0, 1.0, 0.0], [0.0, inf + 1.0, -inf, 2.0]]
    want_w = [[2.0, -inf, 1.0, 0.0], [0.0, -inf, 1.0, 2.0]]
    for got, want in ((hg, want_g), (hh, want_h), (hw, want_w)):
        torch.testing.assert_close(got[0], torch.tensor(want), equal_nan=True, rtol=0, atol=0)
