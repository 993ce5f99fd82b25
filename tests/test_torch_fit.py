"""The port's GBDT fit, artifact and AUC against the JAX package's, on the CPU.

With ``subsample = colsample_bytree = 1`` nothing is random, and the port's
fit (plain histogram on CPU tensors) must grow the JAX fit's trees: split
features and covers equal at every node, and every training row in the
same leaf of every tree. Bin thresholds and missing directions are equal at
every node with direct histograms. With sibling subtraction they may differ
where it makes no difference to the node's rows: when the bins between two
thresholds (or the missing bin) hold none of a node's rows, both choices
give the same split, and which one wins is decided by the last-bit residues
that ``parent - left`` leaves in those empty bins; the port's histogram
rounds its sums once from float64 and the sigmoid difference below moves
the margins, so those residues differ from JAX's. Beyond that, gains and leaf values within rtol 1e-5 plus 1e-5 of the forest's
largest |value|; margins within 1e-5. The scale term is there because the
two sigmoids differ: XLA's exp and PyTorch's round differently (up to
1.2e-7 in p), the difference rides the margins from tree to tree, and a
gain or leaf value is a difference of large sums (G^2/(H+lambda) terms,
g = p - y), so its error follows those sums, not its own size. With the committed model's sampling (0.8 /
0.8) the two fits draw from different random streams (threefry vs
`torch.Generator`), so they are held to held-out AUC within 0.005.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cobalt_smart_lender_ai_tpu.config import GBDTConfig as JaxConfig
from cobalt_smart_lender_ai_tpu.io import GBDTArtifact as JaxArtifact
from cobalt_smart_lender_ai_tpu.models import gbdt as jax_gbdt
from cobalt_smart_lender_ai_tpu.ops.binning import compute_bin_edges as jax_edges
from cobalt_smart_lender_ai_tpu.ops.binning import transform as jax_transform
from cobalt_smart_lender_ai_tpu.ops.metrics import roc_auc as jax_roc_auc
from cobalt_smart_lender_ai_tpu_torch.config import GBDTConfig
from cobalt_smart_lender_ai_tpu_torch.convert import forest_from_numpy
from cobalt_smart_lender_ai_tpu_torch.io import GBDTArtifact, ObjectStore
from cobalt_smart_lender_ai_tpu_torch.models import gbdt
from cobalt_smart_lender_ai_tpu_torch.ops.binning import compute_bin_edges, transform
from cobalt_smart_lender_ai_tpu_torch.ops.metrics import roc_auc

STRUCTURE = ("feature", "thr_bin", "missing_left", "cover")
FIELDS = ("feature", "thr_bin", "thr_float", "missing_left", "gain", "cover", "leaf_value")
RTOL = 1e-5
N_BINS = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite shares its cores with other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    """(X, y) with NaN cells, a 0/1 indicator and a logistic label."""
    rng = np.random.default_rng(11)
    N, F = 2500, 8
    X = rng.normal(size=(N, F)).astype(np.float32)
    X[:, 2] = rng.lognormal(size=N)
    X[:, 3] = rng.integers(0, 2, N)
    logit = 1.2 * X[:, 0] - 0.8 * X[:, 1] + X[:, 3] + 0.3 * np.log(X[:, 2]) - 1.0
    y = (rng.random(N) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    X[rng.random(X.shape) < 0.08] = np.nan
    return X, y


def _cfg(**kw) -> dict:
    return dict(n_bins=N_BINS, learning_rate=0.3, scale_pos_weight=2.0, **kw)


@pytest.mark.parametrize(
    "depth,trees,subtract",
    [(3, 20, True), (3, 20, False), (4, 10, True), (4, 10, False)],
)
def test_fit_grows_the_jax_trees(data, depth, trees, subtract):
    X, y = data
    N, F = X.shape
    cfg = _cfg(n_estimators=trees, max_depth=depth)
    jbins = jax_transform(jax_edges(jnp.asarray(X), n_bins=N_BINS), jnp.asarray(X))
    jf = jax_gbdt.fit_binned(
        jbins, jnp.asarray(y), jnp.ones(N), jnp.ones(F, bool),
        jax_gbdt.GBDTHyperparams.from_config(JaxConfig(**cfg)), jax.random.PRNGKey(0),
        n_trees_cap=trees, depth_cap=depth, n_bins=N_BINS, hist_subtract=subtract,
    )
    Xt = torch.from_numpy(X)
    bins = transform(compute_bin_edges(Xt, N_BINS), Xt)
    tf = gbdt.fit_binned(
        bins, torch.from_numpy(y), torch.ones(N), torch.ones(F, dtype=torch.bool),
        gbdt.GBDTHyperparams.from_config(GBDTConfig(**cfg)), 0,
        n_trees_cap=trees, depth_cap=depth, n_bins=N_BINS, hist_subtract=subtract,
    )
    for f in STRUCTURE:
        if f in ("feature", "cover") or not subtract:
            np.testing.assert_array_equal(getattr(tf, f).numpy(), np.asarray(getattr(jf, f)), err_msg=f)
    jforest = forest_from_numpy({f: np.asarray(getattr(jf, f)) for f in FIELDS}, depth)
    jl, tl = (  # every training row in the same leaf of every tree
        gbdt.landed_leaves(f.feature, f.thr_bin, f.missing_left, depth, bins, binned=True)
        for f in (jforest, tf)
    )
    assert torch.equal(tl, jl)
    assert (tf.gain.numpy() > 0).any()
    for f in ("gain", "leaf_value"):
        ref = np.asarray(getattr(jf, f))
        np.testing.assert_allclose(
            getattr(tf, f).numpy(), ref, rtol=RTOL, atol=RTOL * np.abs(ref).max(), err_msg=f
        )
    jm = np.asarray(jax_gbdt.predict_margin(jf, jbins, use_binned=True))
    tm = gbdt.predict_margin(tf, bins, use_binned=True).numpy()
    np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-5)


def test_chunked_fit_is_bit_identical(data):
    X, y = data
    kw = _cfg(n_estimators=7, max_depth=3, subsample=0.8, colsample_bytree=0.5)
    one = gbdt.GBDTClassifier(device="cpu", **kw).fit(X, y).forest
    chunked = gbdt.GBDTClassifier(device="cpu", chunk_trees=3, **kw).fit(X, y).forest
    for f in FIELDS:
        assert torch.equal(getattr(one, f), getattr(chunked, f)), f


def test_sampled_fit_auc_matches_jax(train_test):
    """The committed model's sampling (0.8 / 0.8, scale_pos_weight 3.77) on
    the synthetic LendingClub split: held-out AUC within 0.005 of JAX's."""
    X_tr, X_te, y_tr, y_te, _ = train_test
    X_tr, X_te, y_tr, y_te = (np.array(a) for a in (X_tr, X_te, y_tr, y_te))
    kw = dict(
        n_estimators=60, max_depth=4, n_bins=N_BINS, learning_rate=0.1, subsample=0.8,
        colsample_bytree=0.8, scale_pos_weight=3.767127752304077, seed=42,
    )
    jm = jax_gbdt.GBDTClassifier(**kw).fit(X_tr, y_tr).predict_margin(X_te)
    j_auc = float(jax_roc_auc(jnp.asarray(y_te), jm))
    model = gbdt.GBDTClassifier(device="cpu", **kw).fit(X_tr, y_tr)
    t_auc = float(roc_auc(torch.from_numpy(np.asarray(y_te)), model.predict_margin(X_te)))
    assert abs(t_auc - j_auc) <= 0.005, (t_auc, j_auc)
    proba = model.predict_proba(X_te)
    assert proba.shape == (len(y_te), 2) and torch.allclose(proba.sum(1), torch.ones(len(y_te)))
    imp = model.feature_importances_
    assert imp.shape == (X_tr.shape[1],) and abs(imp.sum() - 1.0) < 1e-5


@pytest.fixture(scope="module")
def small_model(data):
    X, y = data
    return gbdt.GBDTClassifier(device="cpu", **_cfg(n_estimators=12, max_depth=3)).fit(X, y)


def test_artifact_loads_and_scores_identically_in_jax(small_model, data, tmp_path):
    X, _ = data
    names = tuple(f"f{i}" for i in range(X.shape[1]))
    art = GBDTArtifact(
        forest=small_model.forest,
        feature_names=names,
        bin_edges=small_model.bin_spec.edges.numpy(),
        config={"n_estimators": 12, "max_depth": 3},
        metrics={"test_auc": 0.5},
    )
    store = ObjectStore(str(tmp_path))
    art.save(store, "models/gbdt/model_tree")
    assert store.get_json("models/gbdt/model_tree.features.json") == list(names)
    jart = JaxArtifact.from_bytes(store.get_bytes("models/gbdt/model_tree.npz"))
    assert jart.feature_names == names and jart.config["max_depth"] == 3
    assert jart.forest.depth == 3 and jart.metrics == {"test_auc": 0.5}
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jart.forest, f)), getattr(small_model.forest, f).numpy())
    np.testing.assert_array_equal(np.asarray(jart.bin_spec.edges), small_model.bin_spec.edges.numpy())
    jm = np.asarray(jax_gbdt.predict_margin(jart.forest, jnp.asarray(X)))
    np.testing.assert_array_equal(small_model.predict_margin(X).numpy(), jm)
    # And back into the port, forest intact.
    back = GBDTArtifact.load(store, "models/gbdt/model_tree", "cpu")
    assert torch.equal(back.forest.thr_bin, small_model.forest.thr_bin)


def test_float_thresholds_match_jax(small_model, data):
    X, _ = data
    jspec = jax_edges(jnp.asarray(X), n_bins=N_BINS)
    f = small_model.forest
    ref = jax_gbdt.float_threshold(jspec, jnp.asarray(f.feature.numpy()), jnp.asarray(f.thr_bin.numpy()))
    np.testing.assert_array_equal(f.thr_float.numpy(), np.asarray(ref))
    # Binned and raw-float walks land in the same leaves.
    bins = transform(small_model.bin_spec, torch.from_numpy(X))
    assert torch.equal(
        gbdt.predict_margin(f, bins, use_binned=True), small_model.predict_margin(X)
    )


@pytest.mark.parametrize("ties", [False, True])
def test_roc_auc_matches_jax(ties):
    rng = np.random.default_rng(4)
    y = (rng.random(700) < 0.3).astype(np.float32)
    s = (rng.normal(size=700) + y).astype(np.float32)
    if ties:
        s = np.round(s, 1)
    w = rng.random(700).astype(np.float32)
    for weight in (None, w):
        ref = float(jax_roc_auc(jnp.asarray(y), jnp.asarray(s), None if weight is None else jnp.asarray(weight)))
        got = float(roc_auc(torch.from_numpy(y), torch.from_numpy(s), None if weight is None else torch.from_numpy(weight)))
        assert abs(got - ref) <= 1e-6, (got, ref)


def test_unfitted_and_config_guards():
    with pytest.raises(RuntimeError, match="fit"):
        gbdt.GBDTClassifier(device="cpu").predict_margin(np.zeros((1, 2), np.float32))
    with pytest.raises(NotImplementedError, match="auto"):
        GBDTConfig(chunk_trees="auto")
    with pytest.raises(ValueError, match="positive"):
        GBDTConfig(chunk_trees=0)
