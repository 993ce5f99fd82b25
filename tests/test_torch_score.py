"""The PyTorch port's scoring functions against the JAX package.

The same seeded numpy rows (NaN cells included) go through the JAX function
and its port counterpart:

- margins: bit-identical (both sum the landed leaf values one f32 add per
  tree, in tree order, from 0.0);
- probabilities: within 1e-6 (two sigmoid implementations);
- SHAP phis and base value: within 1e-5 (same algebra, other summation
  order). The port sums each tree's attributions in f32 and the trees in
  f64; the JAX package adds 300 per-tree sums into an f32 running total,
  which on the committed model drifts up to ~4e-5 from float64 where phis
  reach |8|. So phis are held within 1e-5 of JAX's own `shap_values` run
  one tree at a time and summed in float64 (`_jax_phis_f64`), and within
  1e-5 of JAX's f32 outputs plus JAX's own measured drift from that sum.

On the CPU the port's `fused_score` runs its plain version; the JAX
`fused_score` runs its Pallas kernel in interpret mode, as the JAX package's
own tests run it. The CUDA kernel itself is held to the plain version in
``tests/test_torch_cuda.py``, which needs a GPU.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cobalt_smart_lender_ai_tpu.explain import treeshap as jax_treeshap
from cobalt_smart_lender_ai_tpu.io import GBDTArtifact as JaxArtifact
from cobalt_smart_lender_ai_tpu.io import ObjectStore as JaxStore
from cobalt_smart_lender_ai_tpu.models.gbdt import GBDTClassifier
from cobalt_smart_lender_ai_tpu.models.gbdt import gain_importances as jax_gains
from cobalt_smart_lender_ai_tpu.models.gbdt import predict_margin as jax_predict_margin
from cobalt_smart_lender_ai_tpu.ops import score_pallas
from cobalt_smart_lender_ai_tpu_torch.convert import forest_from_numpy
from cobalt_smart_lender_ai_tpu_torch.explain import treeshap
from cobalt_smart_lender_ai_tpu_torch.io import GBDTArtifact, ObjectStore
from cobalt_smart_lender_ai_tpu_torch.models.gbdt import gain_importances, predict_margin
from cobalt_smart_lender_ai_tpu_torch.ops import _build
from cobalt_smart_lender_ai_tpu_torch.ops.score import (
    MAX_DEPTH,
    MAX_ROWS_PER_BLOCK,
    MAX_SHAP_THREADS,
    SHAP_TARGET_BLOCKS,
    SMEM_LIMIT,
    WALK_TARGET_BLOCKS,
    fused_score,
    fused_score_reference,
    fused_supported,
    launch_plan,
    pack_forest,
    SHAP_FIXED_LIMIT,
    shap_fits,
    shap_smem_bytes,
    shap_supported,
    tree_table_layout,
    wt_table,
)

ROOT = Path(__file__).resolve().parent.parent
FIELDS = ("feature", "thr_bin", "thr_float", "missing_left", "gain", "cover", "leaf_value")
TOL_PROB = 1e-6
TOL_SHAP = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU tests: the suite shares its
    cores with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_forest(jax_forest):
    arrays = {f: np.asarray(getattr(jax_forest, f)) for f in FIELDS}
    return forest_from_numpy(arrays, jax_forest.depth)


def _rows(jax_forest, n: int, F: int, seed: int) -> np.ndarray:
    """Rows straddling the forest's own thresholds, ~10% NaN cells, and one
    all-NaN row (every node follows its missing direction)."""
    rng = np.random.default_rng(seed)
    thr = np.asarray(jax_forest.thr_float)
    feat = np.asarray(jax_forest.feature)
    X = rng.normal(size=(n, F)).astype(np.float32)
    for f in range(F):
        vals = thr[(feat == f) & np.isfinite(thr)]
        if vals.size:
            X[:, f] = rng.choice(vals, n) * (1.0 + 0.05 * rng.normal(size=n)).astype(np.float32)
    X[rng.random(X.shape) < 0.1] = np.nan
    X[0] = np.nan
    return X


@pytest.fixture(scope="module", params=[3, 4], ids=["depth3", "depth4"])
def mini(request):
    """A mini forest trained by the JAX GBDTClassifier (F=12)."""
    rng = np.random.default_rng(5)
    F = 12
    X = rng.normal(size=(1024, F)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] - 0.25 * X[:, 2] > 0).astype(np.int32)
    model = GBDTClassifier(n_estimators=20, max_depth=request.param, n_bins=64)
    model.fit(X, y)
    return model.forest, _port_forest(model.forest), F


@pytest.fixture(scope="module")
def committed():
    """The committed serving artifact (300 trees, depth 7, 20 features),
    loaded by both packages."""
    jax_art = JaxArtifact.load(JaxStore(str(ROOT / "artifacts")), "models/gbdt/model_tree")
    art = GBDTArtifact.load(ObjectStore(str(ROOT / "artifacts")), "models/gbdt/model_tree", "cpu")
    return jax_art.forest, art.forest, len(art.feature_names)


def _jax_phis_f64(jax_forest, X: np.ndarray, F: int) -> np.ndarray:
    """JAX `shap_values` of each single-tree forest (a tree's phis are sums
    of ~10^2 terms, accurate in f32), summed over trees in float64."""
    total = np.zeros((X.shape[0], F))
    for t in range(jax_forest.n_trees):
        tree = jax.tree_util.tree_map(lambda a, t=t: a[t : t + 1], jax_forest)
        total += np.asarray(jax_treeshap.shap_values(tree, jnp.asarray(X), n_features=F)[0])
    return total


def _check_phis(phis: np.ndarray, jax_phis, ref64: np.ndarray) -> None:
    jax_phis = np.asarray(jax_phis, np.float64)
    np.testing.assert_allclose(phis, ref64, rtol=0, atol=TOL_SHAP)
    drift = np.abs(jax_phis - ref64)  # JAX's own f32 running-total error
    assert (np.abs(phis - jax_phis) <= TOL_SHAP + drift).all()


def _check_against_jax(jax_forest, forest, F: int, X: np.ndarray) -> None:
    pack = pack_forest(forest, F)
    margin, prob, phis, base = fused_score(pack, torch.from_numpy(X), n_features=F)
    j_margin, j_prob, j_phis, j_base = score_pallas.fused_score(
        score_pallas.pack_forest(jax_forest, F, "f32"), jnp.asarray(X), n_features=F
    )
    ref_margin = np.asarray(jax_predict_margin(jax_forest, jnp.asarray(X)))
    np.testing.assert_array_equal(margin.numpy(), np.asarray(j_margin))
    np.testing.assert_array_equal(margin.numpy(), ref_margin)
    np.testing.assert_allclose(prob.numpy(), np.asarray(j_prob), rtol=0, atol=TOL_PROB)
    _check_phis(phis.numpy(), j_phis, _jax_phis_f64(jax_forest, X, F))
    assert abs(float(base) - float(j_base)) <= TOL_SHAP
    np.testing.assert_allclose(
        float(base) + phis.numpy().sum(1), margin.numpy(), rtol=0, atol=1e-4
    )


@pytest.mark.parametrize("rows", [1, 7, 16])
def test_mini_fused_score_matches_jax(mini, rows):
    jax_forest, forest, F = mini
    _check_against_jax(jax_forest, forest, F, _rows(jax_forest, rows, F, seed=rows))


def test_committed_fused_score_matches_jax(committed):
    jax_forest, forest, F = committed
    _check_against_jax(jax_forest, forest, F, _rows(jax_forest, 16, F, seed=11))


def _check_margin_only(jax_forest, forest, F: int) -> None:
    X = _rows(jax_forest, 64, F, seed=3)
    margin, prob = fused_score(
        pack_forest(forest, F), torch.from_numpy(X), n_features=F, with_shap=False
    )
    j_margin, j_prob = score_pallas.fused_score(
        score_pallas.pack_forest(jax_forest, F, "f32"),
        jnp.asarray(X),
        n_features=F,
        with_shap=False,
    )
    np.testing.assert_array_equal(margin.numpy(), np.asarray(j_margin))
    np.testing.assert_allclose(prob.numpy(), np.asarray(j_prob), rtol=0, atol=TOL_PROB)


def test_mini_margin_only_matches_jax(mini):
    _check_margin_only(*mini)


def test_committed_margin_only_matches_jax(committed):
    _check_margin_only(*committed)


def test_plain_shap_is_accurate_to_float64(committed):
    """The port sums each tree's attributions in f32 and the trees in f64:
    its phis stay within 2e-6 of the same computation in float64, even on
    rows whose phis reach |8| (where an f32 running total over 300 trees
    loses up to ~3e-5)."""
    _, forest, F = committed
    pack = pack_forest(forest, F)
    X = torch.from_numpy(_rows(committed[0], 32, F, seed=64))
    phis = fused_score_reference(pack, X, n_features=F)[2]
    exact = treeshap.shap_phis(
        X.double(),
        pack.thr.double(),
        pack.missing_left,
        pack.leaf.double(),
        pack.path_feature,
        pack.slot,
        pack.r_play.double(),
        pack.depth,
        F,
    )
    assert float((phis.double() - exact).abs().max()) <= 2e-6


def test_predict_margin_and_shap_values_match_jax(committed):
    jax_forest, forest, F = committed
    X = _rows(jax_forest, 16, F, seed=21)
    np.testing.assert_array_equal(
        predict_margin(forest, torch.from_numpy(X)).numpy(),
        np.asarray(jax_predict_margin(jax_forest, jnp.asarray(X))),
    )
    phis, base = treeshap.shap_values(forest, torch.from_numpy(X), n_features=F)
    j_phis, j_base = jax_treeshap.shap_values(jax_forest, jnp.asarray(X), n_features=F)
    _check_phis(phis.numpy(), j_phis, _jax_phis_f64(jax_forest, X, F))
    assert abs(float(base) - float(j_base)) <= TOL_SHAP


def test_gain_importances_match_jax(committed):
    jax_forest, forest, F = committed
    total, n_splits = gain_importances(forest, F)
    j_total, j_splits = jax_gains(jax_forest, F)
    np.testing.assert_allclose(total.numpy(), np.asarray(j_total), rtol=1e-6)
    np.testing.assert_array_equal(n_splits.numpy(), np.asarray(j_splits))


@pytest.mark.parametrize("depth", [1, 3, 7, 10])
def test_static_tables_match_jax(depth):
    paths, dirs = treeshap.path_structure(depth)
    j_paths, j_dirs = jax_treeshap.path_structure(depth)
    np.testing.assert_array_equal(paths, j_paths)
    np.testing.assert_array_equal(dirs, j_dirs)
    np.testing.assert_array_equal(treeshap.bilinear_kernel(depth), jax_treeshap.bilinear_kernel(depth))
    wt = wt_table()
    np.testing.assert_array_equal(
        wt[depth, : depth + 1, : depth + 1], jax_treeshap.bilinear_kernel(depth).astype(np.float32)
    )
    assert not wt[depth, depth + 1 :].any() and not wt[depth, :, depth + 1 :].any()


def test_leaf_tables_mark_duplicate_features(committed):
    _, forest, _ = committed
    pf, slot, r_play, ratio = treeshap.leaf_tables(forest.feature, forest.cover, forest.depth)
    d = forest.depth
    pf, slot = pf.numpy(), slot.numpy().astype(int)
    for t, leaf in [(0, 0), (17, 99), (299, 127)]:
        for p in range(d):
            first = min(q for q in range(p + 1) if pf[t, leaf, q] == pf[t, leaf, p])
            assert slot[t, leaf, p] == first
    # Cover ratios are probabilities; a player's r is the product of its own.
    assert float(ratio.min()) >= 0.0 and float(ratio.max()) <= 1.0 + 1e-6
    assert float(r_play.max()) <= 1.0 + 1e-6


def test_artifact_loads_the_reference_format(committed):
    jax_forest, forest, F = committed
    assert F == 20 and forest.depth == 7 and forest.n_trees == 300
    for f in ("feature", "thr_float", "missing_left", "gain", "cover", "leaf_value"):
        np.testing.assert_array_equal(getattr(forest, f).numpy(), np.asarray(getattr(jax_forest, f)))


def test_forest_from_numpy_checks_shapes(committed):
    jax_forest, _, _ = committed
    arrays = {f: np.asarray(getattr(jax_forest, f)) for f in FIELDS}
    with pytest.raises(ValueError, match="expected"):
        forest_from_numpy(arrays, jax_forest.depth - 1)


def test_pack_rejects_unported_precisions(mini):
    """Every precision the reference packs is ported (bf16 and int8 are held
    to JAX in ``tests/test_torch_quantized.py``); any other is refused."""
    _, forest, F = mini
    for precision in ("bf16", "int8"):
        assert pack_forest(forest, F, precision, check=False).precision == precision
    for precision in ("f64", "fp8", "F32"):
        with pytest.raises(ValueError, match="forest_precision"):
            pack_forest(forest, F, precision)
    with pytest.raises(ValueError, match="outside"):
        pack_forest(forest, 2)


def test_shape_guards():
    assert fused_supported(7) and fused_supported(MAX_DEPTH)
    assert not fused_supported(MAX_DEPTH + 1) and not fused_supported(0)
    assert shap_supported(7, 20)
    assert not shap_supported(7, 10_000)
    assert not shap_supported(MAX_DEPTH + 1, 20)
    # The serving tile fits easily: well under the 48 KB static limit.
    assert shap_smem_bytes(7, 20, 1) < 48 * 1024


def test_shap_fits_refuses_forests_outside_the_fixed_point_range(committed):
    """The SHAP kernel sums phis as int64 in units of 2^-40: a forest whose
    phis could reach `SHAP_FIXED_LIMIT`, or with a non-finite leaf, is
    refused rather than wrapped into finite garbage."""
    _, forest, F = committed
    assert shap_fits(pack_forest(forest, F))
    peak = float(forest.leaf_value.abs().max())
    T = forest.leaf_value.shape[0]
    edge = SHAP_FIXED_LIMIT / (2.0 * peak * T)  # scales 2 max|leaf| T to the limit

    def scaled(factor: float, nan: bool = False):
        leaf = forest.leaf_value * factor
        if nan:
            leaf = leaf.clone()
            leaf[0, 0] = float("nan")
        return pack_forest(dataclasses.replace(forest, leaf_value=leaf), F)

    assert shap_fits(scaled(edge * 0.99))
    assert not shap_fits(scaled(edge * 1.01))
    assert not shap_fits(scaled(1.0, nan=True))


@pytest.mark.parametrize("with_shap", [True, False], ids=["shap", "margin"])
@pytest.mark.parametrize("n_trees", [1, 7, 300])
@pytest.mark.parametrize("n_rows", [1, 8, 64, 256, 4096])
def test_launch_plan_covers_each_row_and_tree_once(n_rows, n_trees, with_shap):
    """Block (i, g) of the walk's grid takes rows [i R, (i+1) R) and trees
    [g G, (g+1) G), cut at the ends: together they cover every (row, tree)
    once, no block is empty, and the scratches have the kernel's shapes."""
    F = 20
    plan = launch_plan(n_rows, n_trees, 7, with_shap)
    R, G = plan.rows_per_block, plan.trees_per_group
    hits = np.zeros((n_rows, n_trees), np.int32)
    for i in range(plan.row_tiles):
        for g in range(plan.groups):
            hits[i * R : (i + 1) * R, g * G : (g + 1) * G] += 1
    assert (hits == 1).all()
    assert (plan.row_tiles - 1) * R < n_rows and (plan.groups - 1) * G < n_trees
    assert plan.blocks == plan.row_tiles * plan.groups
    # Trees are split only while the row tiles fall short of the target.
    target = SHAP_TARGET_BLOCKS if with_shap else WALK_TARGET_BLOCKS
    assert plan.blocks >= min(plan.row_tiles * n_trees, target // 2)
    if plan.row_tiles >= target:
        assert plan.groups == 1
    assert plan.threads % 32 == 0
    if with_shap:
        assert R <= min(MAX_ROWS_PER_BLOCK, n_rows) and R <= plan.threads <= MAX_SHAP_THREADS
        assert shap_smem_bytes(7, F, R) <= SMEM_LIMIT
    else:
        assert plan.threads == R
    shapes = plan.scratch_shapes(F)
    assert shapes["leaf_val"] == (n_trees, n_rows)
    assert shapes.get("phi_part") == ((plan.groups, n_rows, F) if with_shap else None)
    nbytes, phi_offset = plan.scratch_bytes(F)
    assert phi_offset % 8 == 0 and phi_offset >= 4 * n_trees * n_rows
    assert nbytes == phi_offset + (8 * plan.groups * n_rows * F if with_shap else 0)


def test_launch_plan_spreads_the_serving_buckets():
    """One tree a block at 1 row; 8-row tiles at 64 rows; at 4096 rows
    without SHAP mostly row tiles."""
    one = launch_plan(1, 300, 7, True)
    assert (one.rows_per_block, one.trees_per_group, one.blocks) == (1, 1, 300)
    sixty_four = launch_plan(64, 300, 7, True)
    assert sixty_four.rows_per_block == 8 and sixty_four.row_tiles == 8
    assert sixty_four.blocks >= SHAP_TARGET_BLOCKS // 2
    bulk = launch_plan(4096, 300, 7, False)
    assert bulk.row_tiles == 32 and bulk.trees_per_group > 1
    with pytest.raises(ValueError, match="no launch plan"):
        launch_plan(0, 300, 7, True)
    with pytest.raises(ValueError, match="no launch plan"):
        launch_plan(8, 300, MAX_DEPTH + 1, False)


@pytest.mark.parametrize("depth", range(1, MAX_DEPTH + 1))
def test_shap_smem_fits_at_every_depth(depth):
    """Two tree records and the largest tile's accumulators fit in a
    block's shared memory at every depth the kernel is built for (F=20)."""
    assert shap_smem_bytes(depth, 20, MAX_ROWS_PER_BLOCK) <= SMEM_LIMIT
    assert shap_supported(depth, 20)
    layout, words = tree_table_layout(depth)
    assert words % 4 == 0 and all(offset % 4 == 0 for offset, _ in layout.values())


def test_tree_tables_hold_each_section(mini):
    """Each tree's record holds the pack's tables at `tree_table_layout`'s
    offsets: 4-byte tables bit for bit, byte tables four to a word."""
    _, forest, F = mini
    pack = pack_forest(forest, F)
    layout, words = tree_table_layout(pack.depth)
    assert pack.tables.shape == (pack.n_trees, words) and pack.tables.dtype == torch.int32
    T = pack.n_trees
    for name, (offset, n) in layout.items():
        section = pack.tables[:, offset : offset + n].contiguous()
        want = getattr(pack, name).reshape(T, -1)
        if want.element_size() == 4:
            got = section.view(want.dtype)
        else:
            got = section.view(torch.uint8)[:, : want.shape[1]].to(want.dtype)
        assert torch.equal(got, want), name


def test_cpu_tensors_run_the_plain_version(mini):
    _, forest, F = mini
    pack = pack_forest(forest, F)
    X = torch.zeros((4, F))
    before = fused_score.launches
    out = fused_score(pack, X, n_features=F)
    ref = fused_score_reference(pack, X, n_features=F)
    assert fused_score.launches == before  # the CPU path launches nothing
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_other_devices_raise(mini):
    _, forest, F = mini
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_score(pack_forest(forest, F), torch.zeros((2, F), device="meta"), n_features=F)


def test_kernel_build_is_keyed_by_source_and_targets_sm90a():
    path = _build.library_path("score_forest")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("score_forest-") and path.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS

