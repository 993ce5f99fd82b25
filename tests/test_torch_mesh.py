"""The port's device mesh and data-parallel fit against the JAX package's.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port's mesh names the CPU several times (each entry one shard), as
``chip_smoke.py`` names the one card. Tolerances:

- `make_mesh` gives the JAX mesh's shape for every device count and
  config, and raises where it raises; `pad_rows` equals the reference's;
- the sharded plain histogram over 1, 2 and 4 shards (J = 1 and J = 3, a
  NaN and an infinity in one shard) against one call: the cover, whose
  sums are integers, and the NaN pattern bit for bit, g and h within one
  float32 ulp (float64 partials added across shards, then rounded once);
- `fit_binned_dp` on a (1, 4) mesh against the port's single direct fit and
  the JAX package's `fit_binned_dp` on its (1, 4) mesh (the data of
  ``tests/test_parallel.py::small_binned``): features, ``thr_bin`` and
  ``missing_left`` equal, margins within 1e-4 (float32 leaf sums added in
  another order); `fit_binned_dp_chunked` and `predict_margin_dp` bit for
  bit against the unchunked fit and `predict_margin`;
- the search over an hp-only mesh is one device's bit for bit (scores,
  survivors, halving report); over a (2, 2) mesh, without row samples, it
  is one device's with ``hist_subtract`` off within 1e-6 of AUC; RFE over a
  dp mesh selects and ranks as the host RFE with ``hist_subtract`` off;
- the pipeline's RFE and search fingerprints follow the resolved mesh's dp
  size (hp-only meshes share one device's).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.datasets import make_classification

from cobalt_smart_lender_ai_tpu.config import GBDTConfig as JaxGBDTConfig
from cobalt_smart_lender_ai_tpu.config import MeshConfig as JaxMeshConfig
from cobalt_smart_lender_ai_tpu.models.gbdt import GBDTHyperparams as JaxHyperparams
from cobalt_smart_lender_ai_tpu.ops.binning import compute_bin_edges as jax_edges
from cobalt_smart_lender_ai_tpu.ops.binning import transform as jax_transform
from cobalt_smart_lender_ai_tpu.parallel import fit_binned_dp as jax_fit_binned_dp
from cobalt_smart_lender_ai_tpu.parallel import make_mesh as jax_make_mesh
from cobalt_smart_lender_ai_tpu.parallel import pad_rows as jax_pad_rows
from cobalt_smart_lender_ai_tpu.parallel import predict_margin_dp as jax_predict_margin_dp
from cobalt_smart_lender_ai_tpu_torch.config import GBDTConfig, MeshConfig, RFEConfig, TuneConfig
from cobalt_smart_lender_ai_tpu_torch.models.gbdt import GBDTHyperparams, fit_binned, predict_margin
from cobalt_smart_lender_ai_tpu_torch.ops.histogram import (
    gradient_histogram_jobs,
    gradient_histogram_sharded,
    histogram_scale_state,
    reduce_scale_states,
)
from cobalt_smart_lender_ai_tpu_torch.parallel import tune
from cobalt_smart_lender_ai_tpu_torch.parallel.mesh import make_mesh, pad_rows, row_bounds
from cobalt_smart_lender_ai_tpu_torch.parallel.rfe import rfe_select
from cobalt_smart_lender_ai_tpu_torch.parallel.sharded import (
    fit_binned_dp,
    fit_binned_dp_chunked,
    predict_margin_dp,
)

CPU = torch.device("cpu")
TOL_MARGIN = 1e-4
TOL_CV_AUC = 1e-6


def _mesh(hp: int, n: int, dp: int = -1):
    return make_mesh(MeshConfig(hp=hp, dp=dp), devices=[CPU] * n)


# -- make_mesh and pad_rows -----------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("hp,dp", [(1, -1), (2, -1), (4, -1), (2, 2), (1, 4), (3, -1), (2, 3)])
def test_make_mesh_shapes_and_errors_are_the_references(n, hp, dp):
    cfg = dict(hp=hp, dp=dp)
    try:
        want = jax_make_mesh(JaxMeshConfig(**cfg), devices=jax.devices()[:n])
    except ValueError as exc:
        with pytest.raises(ValueError, match=str(exc).replace("x", ".")):
            make_mesh(MeshConfig(**cfg), devices=[CPU] * n)
        return
    got = make_mesh(MeshConfig(**cfg), devices=[CPU] * n)
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    assert all(d == CPU for d in got.devices.flat) and got.size == n


def test_make_mesh_defaults_to_the_card():
    """Without devices the mesh takes the visible cards, and raises without
    one: nothing moves to the CPU on its own."""
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh(MeshConfig())
    assert make_mesh(MeshConfig(), devices=["cpu"]).shape == {"hp": 1, "dp": 1}


@pytest.mark.parametrize("n,m", [(0, 4), (1, 4), (4, 4), (5, 4), (2003, 8), (7, 1)])
def test_pad_rows_is_the_references(n, m):
    assert pad_rows(n, m) == jax_pad_rows(n, m)


def test_row_bounds_cut_contiguous_blocks():
    assert row_bounds(10, 4) == [(0, 3), (3, 6), (6, 8), (8, 10)]
    assert row_bounds(4, 4) == [(0, 1), (1, 2), (2, 3), (3, 4)]
    with pytest.raises(ValueError, match="cannot fill"):
        row_bounds(3, 4)


# -- the sharded histogram's plain version ----------------------------------------------


def _level(seed: int, J: int, N: int, F: int, B: int, K: int):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, (N, F)).astype(np.uint8)
    node = rng.integers(0, K, (J, N)).astype(np.int32)
    g = (rng.normal(size=(J, N)) * rng.uniform(0.5, 4.0, (J, 1))).astype(np.float32)
    h = (np.abs(g) * 0.25 + 0.01).astype(np.float32)
    w = (rng.random((J, N)) < 0.8).astype(np.float32)
    return bins, node, g, h, w


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("J", [1, 3])
def test_sharded_plain_histogram_is_one_call(n_shards, J):
    N, F, B, K = 3001, 7, 32, 8
    bins, node, g, h, w = _level(50 + J, J, N, F, B, K)
    g[J - 1, N - 2] = np.nan  # in the last shard
    h[0, N - 5] = np.inf
    t = [torch.from_numpy(a) for a in (bins, node, g, h, w)]
    one = torch.stack(gradient_histogram_jobs(*t, n_nodes=K, n_bins=B))
    dp = _mesh(1, n_shards).row_shards(0, N)
    parts = [(t[0][a:b], *(x[:, a:b].contiguous() for x in t[1:])) for a, b in dp.bounds]
    got = torch.stack(gradient_histogram_sharded(parts, n_nodes=K, n_bins=B, n_rows=N, run=dp.run))
    assert torch.equal(torch.isnan(got), torch.isnan(one)) and bool(torch.isnan(one).any())
    assert torch.equal(torch.isinf(got), torch.isinf(one))
    assert torch.equal(got[2], one[2])
    ok = torch.isfinite(one[:2])
    ulp = torch.abs(torch.nextafter(one[:2], torch.tensor(np.inf)) - one[:2])
    assert bool((torch.abs(got[:2] - one[:2])[ok] <= ulp[ok]).all())


def test_scale_states_reduce_to_the_whole_tables():
    """Each shard's state reduces (max of the bits, OR of the flags) to the
    state of all rows at once."""
    bins, node, g, h, w = _level(3, 3, 1000, 4, 16, 4)
    g[1, 900] = np.nan
    w[2, 10] = -np.inf
    t = [torch.from_numpy(a) for a in (g, h, w)]
    whole = histogram_scale_state(*t)
    states = [histogram_scale_state(*(x[:, a:b].contiguous() for x in t))
              for a, b in row_bounds(1000, 4)]
    assert torch.equal(reduce_scale_states(states, CPU), whole)
    assert whole[:, 3].tolist() == [0, 1, 4]


# -- the data-parallel fit ------------------------------------------------------------


@pytest.fixture(scope="module")
def small_binned():
    """The data of the JAX package's ``tests/test_parallel.py::small_binned``."""
    X, y = make_classification(n_samples=2003, n_features=12, n_informative=5, random_state=0)
    X = jnp.asarray(X, jnp.float32)
    bins = np.asarray(jax_transform(jax_edges(X, n_bins=32), X))
    return bins, np.asarray(y, np.float32)


def _fit_kw(n_trees=20, depth=3):
    return dict(n_trees_cap=n_trees, depth_cap=depth, n_bins=32)


def test_fit_binned_dp_matches_the_single_fit_and_the_references(small_binned):
    bins_np, y_np = small_binned
    bins, y = torch.from_numpy(bins_np), torch.from_numpy(y_np)
    hp = GBDTHyperparams.from_config(GBDTConfig(n_estimators=20, max_depth=3))
    mesh = _mesh(1, 4)
    f_dp = fit_binned_dp(mesh, bins, y, None, None, hp, 0, **_fit_kw())
    f_1 = fit_binned(bins, y, torch.ones(len(y)), torch.ones(12, dtype=torch.bool), hp, 0,
                     hist_subtract=False, **_fit_kw())
    jmesh = jax_make_mesh(JaxMeshConfig(hp=1), devices=jax.devices()[:4])
    jhp = JaxHyperparams.from_config(JaxGBDTConfig(n_estimators=20, max_depth=3))
    f_jax = jax_fit_binned_dp(jmesh, jnp.asarray(bins_np), jnp.asarray(y_np), None, None, jhp,
                              jax.random.PRNGKey(0), **_fit_kw())
    for f in ("feature", "thr_bin", "missing_left"):
        assert torch.equal(getattr(f_dp, f), getattr(f_1, f)), f
        assert np.array_equal(getattr(f_dp, f).numpy(), np.asarray(getattr(f_jax, f))), f
    m_dp = predict_margin_dp(mesh, f_dp, bins, use_binned=True)
    m_1 = predict_margin(f_1, bins, use_binned=True)
    m_jax = np.asarray(jax_predict_margin_dp(jmesh, f_jax, jnp.asarray(bins_np), use_binned=True))
    assert float((m_dp - m_1).abs().max()) <= TOL_MARGIN
    assert float(np.abs(m_dp.numpy() - m_jax).max()) <= TOL_MARGIN


def test_fit_binned_dp_on_one_device_is_fit_binned(small_binned):
    """A one-entry dp axis is the single-device fit, sibling subtraction
    included, bit for bit."""
    bins, y = (torch.from_numpy(a) for a in small_binned)
    hp = GBDTHyperparams.from_config(GBDTConfig(n_estimators=6, max_depth=4, subsample=0.8))
    got = fit_binned_dp(_mesh(1, 1), bins, y, None, None, hp, 5, **_fit_kw(6, 4))
    want = fit_binned(bins, y, torch.ones(len(y)), torch.ones(12, dtype=torch.bool), hp, 5,
                      **_fit_kw(6, 4))
    for f in ("feature", "thr_bin", "missing_left", "gain", "cover", "leaf_value"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_fit_binned_dp_chunked_is_unchunked(small_binned):
    bins, y = (torch.from_numpy(a) for a in small_binned)
    hp = GBDTHyperparams.from_config(GBDTConfig(n_estimators=7, max_depth=3, subsample=0.8,
                                                colsample_bytree=0.8))
    mesh = _mesh(1, 3)
    whole = fit_binned_dp(mesh, bins, y, None, None, hp, 9, **_fit_kw(7))
    chunked = fit_binned_dp_chunked(mesh, bins, y, None, None, hp, 9, chunk_trees=3, **_fit_kw(7))
    for f in ("feature", "thr_bin", "missing_left", "gain", "cover", "leaf_value"):
        assert torch.equal(getattr(whole, f), getattr(chunked, f)), f


def test_predict_margin_dp_is_bitwise(small_binned):
    bins, y = (torch.from_numpy(a) for a in small_binned)
    hp = GBDTHyperparams.from_config(GBDTConfig(n_estimators=5, max_depth=3))
    forest = fit_binned(bins, y, torch.ones(len(y)), torch.ones(12, dtype=torch.bool), hp, 1,
                        **_fit_kw(5))
    want = predict_margin(forest, bins, use_binned=True)
    for n in (2, 4, 7):
        assert torch.equal(predict_margin_dp(_mesh(1, n), forest, bins, use_binned=True), want)


# -- the search and RFE over the mesh ----------------------------------------------------


def _search_data(n=1500, f=6, b=32, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] + 0.7 * X[:, 1] + rng.normal(0, 1, n) > 0.3).astype(np.float32)
    bins = torch.from_numpy(np.asarray(jax_transform(jax_edges(jnp.asarray(X), n_bins=b), jnp.asarray(X))))
    return bins, torch.from_numpy(y)


def test_search_over_hp_is_one_devices_bit_for_bit():
    bins, y = _search_data()
    base = GBDTConfig(n_bins=32)
    cfg = TuneConfig(n_iter=6, cv_folds=2, chunk_trees=2, halving_eta=2, param_space={
        "n_estimators": (4, 8), "max_depth": (2, 3), "learning_rate": (0.1, 0.3),
        "subsample": (0.8, 1.0), "colsample_bytree": (0.6, 1.0)})
    cands = tune.sample_candidates(cfg.param_space, cfg.n_iter, cfg.seed)
    val = torch.from_numpy(tune.stratified_kfold_masks(y.numpy(), cfg.cv_folds, cfg.seed))
    one = tune.successive_halving_search(bins, y, cands, base, cfg, val, cfg.seed)
    hp2 = tune.successive_halving_search(bins, y, cands, base, cfg, val, cfg.seed, mesh=_mesh(2, 2, 1))
    hp3 = tune.successive_halving_search(bins, y, cands, base, cfg, val, cfg.seed, mesh=_mesh(3, 3))
    assert one is not None
    for got in (hp2, hp3):
        assert np.array_equal(got[0], one[0])
        assert got[1] == one[1]
    hps = [GBDTHyperparams.from_config(base.replace(**c)) for c in cands[:3]]
    cv1 = tune.cross_validate_gbdt(bins, y, hps, val, 4, n_bins=32, chunk_trees=3)
    cv2 = tune.cross_validate_gbdt(bins, y, hps, val, 4, n_bins=32, chunk_trees=3, mesh=_mesh(2, 2, 1))
    assert np.array_equal(cv1, cv2)


def test_search_over_hp_and_dp_is_one_devices_direct_fit():
    """A (2, 2) mesh: jobs over hp, rows over dp with exact histograms; the
    candidates draw no row sample (a dp shard draws its own), so the scores
    are one device's with direct histograms."""
    bins, y = _search_data(seed=1)
    val = torch.from_numpy(tune.stratified_kfold_masks(y.numpy(), 3, 0))
    hps = [GBDTHyperparams.from_config(GBDTConfig(n_estimators=6, max_depth=3, gamma=g,
                                                  colsample_bytree=cs, n_bins=32))
           for g, cs in ((0.0, 0.8), (1.0, 1.0), (0.5, 0.6))]
    direct = tune.cross_validate_gbdt(bins, y, hps, val, 5, n_bins=32, chunk_trees=2,
                                      hist_subtract=False)
    mesh = tune.cross_validate_gbdt(bins, y, hps, val, 5, n_bins=32, chunk_trees=2,
                                    mesh=_mesh(2, 4))
    assert float(np.abs(direct - mesh).max()) <= TOL_CV_AUC


def test_rfe_over_dp_is_the_host_rfe_without_subtraction():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(600, 10)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 3] + rng.normal(0, 1, 600) > 0).astype(np.int32)
    cfg = RFEConfig(n_select=4, step=2, n_estimators=10, max_depth=3, hist_subtract=False)
    host = rfe_select(X, y, cfg, device="cpu")
    dp = rfe_select(X, y, cfg, device="cpu", mesh=_mesh(1, 4))
    assert np.array_equal(host.support_, dp.support_)
    assert np.array_equal(host.ranking_, dp.ranking_)
    chunked = rfe_select(X, y, RFEConfig(n_select=4, step=2, n_estimators=10, max_depth=3,
                                         hist_subtract=False, chunk_trees=4),
                         device="cpu", mesh=_mesh(1, 4))
    assert np.array_equal(host.support_, chunked.support_)


# -- the pipeline's stage fingerprints --------------------------------------------------


def test_stage_fingerprints_take_the_resolved_dp_size():
    """RFE's and the search's checkpoints are keyed by the resolved mesh's
    dp size, not by the `MeshConfig`: hp-only meshes give one device's bits
    and share its fingerprints; a dp axis changes the splits and the key."""
    import dataclasses

    from cobalt_smart_lender_ai_tpu_torch.config import PipelineConfig
    from cobalt_smart_lender_ai_tpu_torch.pipeline import stage_fingerprints

    cfg = PipelineConfig()
    one = stage_fingerprints(cfg)
    assert stage_fingerprints(cfg, _mesh(1, 1)) == one
    assert stage_fingerprints(cfg, _mesh(2, 2)) == one
    two = stage_fingerprints(cfg, _mesh(1, 2))
    assert two["clean"] == one["clean"] and two["engineer"] == one["engineer"]
    assert two["rfe"] != one["rfe"] and two["search"] != one["search"]
    assert stage_fingerprints(dataclasses.replace(cfg, mesh=MeshConfig(hp=2, dp=2)), _mesh(2, 4, 2)) == two
    assert stage_fingerprints(cfg, _mesh(1, 4))["search"] not in (one["search"], two["search"])
