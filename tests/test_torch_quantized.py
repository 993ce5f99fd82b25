"""The port's bf16 and int8 forests against the JAX package's.

The same forests (the committed 300-tree model, and two seeded mini forests
of depth 3 and 7 with trivial ``+inf`` splits) are packed by both packages
at each quantized precision, and the same seeded numpy rows (NaN cells and
an all-NaN row included) are scored by the JAX `fused_score` (its Pallas
kernel in interpret mode) and by the port's plain version:

- every stored array byte-equal and ``table_hash`` equal (on the committed
  model the hashes the reference publishes);
- margins bit-identical: both dequantize int8 as ``q * scale + zero``
  rounded once (XLA's CPU FMA; `_fma_f32` on the port's side) and sum the
  landed leaf values one f32 add per tree in tree order;
- probabilities within 1e-6 (two sigmoids), phis and the SHAP base value
  within 1e-5 (same algebra, other summation order), ``base + sum(phis)``
  within 1e-4 of the margin;
- `quantization_report` and `probe_rows` equal to the reference's.

The publish gate refuses a pack outside a tightened `PRECISION_TOLERANCES`,
the CPU service serves an int8 pack as the plain scorer scores it, and the
f32 pack's records are what they were before the quantized paths existed.
The CUDA kernel at these precisions is held to the plain version in
``tests/test_torch_cuda.py``, which needs a GPU.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cobalt_smart_lender_ai_tpu.io import GBDTArtifact as JaxArtifact
from cobalt_smart_lender_ai_tpu.io import ObjectStore as JaxStore
from cobalt_smart_lender_ai_tpu.models.gbdt import Forest as JaxForest
from cobalt_smart_lender_ai_tpu.ops import score_pallas
from cobalt_smart_lender_ai_tpu_torch.config import ServeConfig
from cobalt_smart_lender_ai_tpu_torch.convert import forest_from_numpy
from cobalt_smart_lender_ai_tpu_torch.data import schema
from cobalt_smart_lender_ai_tpu_torch.io import GBDTArtifact, ObjectStore
from cobalt_smart_lender_ai_tpu_torch.ops import score
from cobalt_smart_lender_ai_tpu_torch.ops.score import (
    MAX_ROWS_PER_BLOCK,
    SMEM_LIMIT,
    fused_score,
    fused_score_reference,
    pack_forest,
    probe_rows,
    quantization_report,
    shap_smem_bytes,
    shap_supported,
    tree_table_layout,
)
from cobalt_smart_lender_ai_tpu_torch.serve import __main__ as serve_cli
from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService

ROOT = Path(__file__).resolve().parent.parent
KEY = "models/gbdt/model_tree"
QUANTIZED = ("bf16", "int8")
#: The table hashes the reference publishes for the committed model.
COMMITTED_HASHES = {
    "bf16": "544336748d6c75b21a14cb2137f5eb85",
    "int8": "b224a0d5f29adcbfbd181d98babcdffd",
}
#: md5 of the committed model's f32 records as the f32-only port built them.
F32_TABLES_MD5 = "f26838e09d0f007d7c66d2e23e1e3d91"
PACK_ARRAYS = (
    "feature", "thr_q", "missing_left", "all_left", "leaf_q",
    "thr_scale", "thr_zero", "leaf_scale", "leaf_zero",
)
TOL_PROB = 1e-6
TOL_SHAP = 1e-5
TOL_ADDITIVITY = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the port's CPU tests: the suite shares its
    cores with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mini_arrays(depth: int, n_trees: int, F: int, seed: int) -> dict[str, np.ndarray]:
    """A seeded forest: random splits and leaf values, covers consistent
    (each internal node's cover is its children's sum), ~10% of thresholds
    ``+inf`` (trivial splits) and one feature no node tests."""
    rng = np.random.default_rng(seed)
    L = 2**depth
    I = L - 1
    cover = np.zeros((n_trees, I + L), np.float32)
    cover[:, I:] = rng.integers(1, 100, (n_trees, L))
    for n in range(I - 1, -1, -1):
        cover[:, n] = cover[:, 2 * n + 1] + cover[:, 2 * n + 2]
    feature = rng.integers(0, F - 1, (n_trees, I)).astype(np.int32)
    spread = 10.0 ** rng.integers(-3, 4, F)  # each feature on its own scale
    thr = (rng.normal(size=(n_trees, I)) * spread[feature]).astype(np.float32)
    thr[rng.random(thr.shape) < 0.1] = np.inf
    return dict(
        feature=feature,
        thr_bin=np.zeros((n_trees, I), np.int32),
        thr_float=thr,
        missing_left=rng.random((n_trees, I)) < 0.5,
        gain=np.zeros((n_trees, I), np.float32),
        cover=cover,
        leaf_value=(0.1 * rng.normal(size=(n_trees, L))).astype(np.float32),
    )


def _committed():
    jax_art = JaxArtifact.load(JaxStore(str(ROOT / "artifacts")), KEY)
    art = GBDTArtifact.load(ObjectStore(str(ROOT / "artifacts")), KEY, "cpu")
    return jax_art.forest, art.forest, len(art.feature_names)


def _mini(depth: int):
    F = 12
    arrays = _mini_arrays(depth, 23, F, seed=depth)
    jax_forest = JaxForest(**{k: jnp.asarray(v) for k, v in arrays.items()}, depth=depth)
    return jax_forest, forest_from_numpy(arrays, depth), F


@pytest.fixture(scope="module", params=["committed", "mini3", "mini7"])
def forests(request):
    """(JAX forest, port forest, F) of each forest the tests hold."""
    if request.param == "committed":
        return _committed()
    return _mini(int(request.param[-1]))


@pytest.fixture(scope="module")
def committed():
    return _committed()


def _rows(forest, n: int, F: int, seed: int) -> np.ndarray:
    """Rows straddling the forest's own thresholds, ~10% NaN cells, and one
    all-NaN row (every node follows its missing direction)."""
    rng = np.random.default_rng(seed)
    thr = forest.thr_float.numpy()
    feat = forest.feature.numpy()
    X = rng.normal(size=(n, F)).astype(np.float32)
    for f in range(F):
        vals = thr[(feat == f) & np.isfinite(thr)]
        if vals.size:
            X[:, f] = rng.choice(vals, n) * (1.0 + 0.05 * rng.normal(size=n)).astype(np.float32)
    X[rng.random(X.shape) < 0.1] = np.nan
    X[0] = np.nan
    return X


def _packs(forests, precision):
    jax_forest, forest, F = forests
    return (
        score_pallas.pack_forest(jax_forest, F, precision, check=False),
        pack_forest(forest, F, precision, check=False),
    )


def _bytes(t: torch.Tensor) -> bytes:
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


@pytest.mark.parametrize("precision", QUANTIZED)
def test_pack_arrays_and_hash_match_jax(forests, precision):
    jax_pack, pack = _packs(forests, precision)
    for name in PACK_ARRAYS:
        want = np.asarray(getattr(jax_pack, name))
        got = getattr(pack, name)
        assert tuple(got.shape) == want.shape, name
        assert _bytes(got) == want.tobytes(), name
    assert pack.table_hash == jax_pack.table_hash
    if forests[1].n_trees == 300:
        assert pack.table_hash == COMMITTED_HASHES[precision]


@pytest.mark.parametrize("precision", QUANTIZED)
def test_plain_scores_match_jax(forests, precision):
    jax_pack, pack = _packs(forests, precision)
    _, forest, F = forests
    X = _rows(forest, 64, F, seed=11)
    jm, jp, jphi, jbase = score_pallas.fused_score(
        jax_pack, jnp.asarray(X), n_features=F, interpret=True
    )
    m, p, phi, base = fused_score(pack, torch.from_numpy(X), n_features=F)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    assert float(np.abs(p.numpy() - np.asarray(jp)).max()) <= TOL_PROB
    assert float(np.abs(phi.numpy() - np.asarray(jphi)).max()) <= TOL_SHAP
    assert abs(float(base) - float(jbase)) <= TOL_SHAP
    assert float((base + phi.sum(1) - m).abs().max()) <= TOL_ADDITIVITY
    # The margin-only call lands on the same margins.
    m_only, p_only = fused_score(pack, torch.from_numpy(X), n_features=F, with_shap=False)
    assert torch.equal(m_only, m) and torch.equal(p_only, p)


@pytest.mark.parametrize("precision", QUANTIZED)
def test_quantization_report_matches_jax(forests, precision):
    jax_pack, pack = _packs(forests, precision)
    jax_forest, forest, F = forests
    assert quantization_report(forest, pack, F) == score_pallas.quantization_report(
        jax_forest, jax_pack, F
    )


@pytest.mark.parametrize("rows", [64, 7])
def test_probe_rows_match_jax(forests, rows):
    jax_forest, forest, F = forests
    np.testing.assert_array_equal(
        probe_rows(forest, F, rows), score_pallas.probe_rows(jax_forest, F, rows)
    )


@pytest.mark.parametrize("precision", QUANTIZED)
def test_committed_model_passes_the_gate(committed, precision):
    _, forest, F = committed
    pack = pack_forest(forest, F, precision, check=True)
    report = quantization_report(forest, pack, F)
    assert report["within_tolerance"]
    tol = score.PRECISION_TOLERANCES[precision]
    assert all(report[k] <= tol[k] for k in tol)


@pytest.mark.parametrize("precision", QUANTIZED)
def test_out_of_tolerance_pack_is_refused(committed, precision, monkeypatch):
    """A gate tightened below the committed model's report refuses the pack,
    and the service built on it refuses to start."""
    _, forest, F = committed
    tight = {k: 1e-9 for k in score.PRECISION_TOLERANCES[precision]}
    monkeypatch.setitem(score.PRECISION_TOLERANCES, precision, tight)
    with pytest.raises(ValueError, match="exceeds the committed tolerance"):
        pack_forest(forest, F, precision)
    pack_forest(forest, F, precision, check=False)  # the gate is what refuses
    art = GBDTArtifact.load(ObjectStore(str(ROOT / "artifacts")), KEY, "cpu")
    with pytest.raises(ValueError, match="exceeds the committed tolerance"):
        ScorerService(art, ServeConfig(forest_precision=precision), device="cpu")


def test_the_three_table_hashes_differ(committed):
    _, forest, F = committed
    hashes = {p: pack_forest(forest, F, p).table_hash for p in score.PRECISIONS}
    assert hashes["f32"] == "f32"
    assert len(set(hashes.values())) == 3
    assert {p: hashes[p] for p in QUANTIZED} == COMMITTED_HASHES


def test_f32_records_are_unchanged(committed):
    """The f32 pack's records are the f32-only port's, bit for bit, and the
    f32 layout has its old sections and sizes."""
    _, forest, F = committed
    pack = pack_forest(forest, F)
    assert hashlib.md5(pack.tables.numpy().tobytes()).hexdigest() == F32_TABLES_MD5
    assert pack.thr is pack.thr_q and pack.leaf is pack.leaf_q
    for depth in range(1, score.MAX_DEPTH + 1):
        L = 2**depth
        I, LD = L - 1, L * depth
        old = [I, I, L, LD, LD, -(-I // 4), -(-LD // 4)]
        layout, words = tree_table_layout(depth)
        assert [n for _, n in layout.values()] == old
        assert words == sum(-(-n // 4) * 4 for n in old)


@pytest.mark.parametrize("precision", QUANTIZED)
def test_records_hold_each_quantized_section(forests, precision):
    """Each tree's record holds the stored tables at `tree_table_layout`'s
    offsets, and the tree's leaf scale and zero in ``leaf_affine``."""
    _, pack = _packs(forests, precision)
    layout, words = tree_table_layout(pack.depth, precision)
    assert pack.tables.shape == (pack.n_trees, words)
    assert all(offset % 4 == 0 for offset, _ in layout.values())
    assert words <= tree_table_layout(pack.depth)[1]
    record = pack.tables.view(torch.uint8).view(pack.n_trees, 4 * words)
    for name, (offset, n) in layout.items():
        if name == "leaf_affine":
            want = torch.stack([pack.leaf_scale[0], pack.leaf_zero[0]], 1)
        else:
            want = getattr(pack, name)
        want = want.reshape(pack.n_trees, -1).contiguous().view(torch.uint8)
        got = record[:, 4 * offset : 4 * offset + want.shape[1]]
        assert torch.equal(got, want), name


@pytest.mark.parametrize("precision", QUANTIZED)
@pytest.mark.parametrize("depth", range(1, score.MAX_DEPTH + 1))
def test_quantized_shap_fits_at_every_depth(depth, precision):
    """Two staged trees (each the f32 image plus the stored values) and the
    largest tile's accumulators fit in a block's shared memory at every
    depth at the serving width. From depth 3 on no quantized record
    outgrows f32's (below it the all_left and leaf affine sections, padded
    to 16 bytes, outweigh the narrower values)."""
    assert shap_smem_bytes(depth, 20, MAX_ROWS_PER_BLOCK, precision) <= SMEM_LIMIT
    assert shap_supported(depth, 20, precision)
    assert shap_smem_bytes(depth, 20, 1, precision) > shap_smem_bytes(depth, 20, 1)
    words, f32_words = tree_table_layout(depth, precision)[1], tree_table_layout(depth)[1]
    assert words <= f32_words if depth >= 3 else words > f32_words


@pytest.mark.parametrize("precision", QUANTIZED)
def test_dequantized_values(forests, precision):
    """``thr`` and ``leaf`` are the stored values widened (bf16) or, at
    int8, XLA's ``q * scale + zero`` on the reference's tables (as its
    kernel dequantizes), with ``+inf`` at every ``all_left``."""
    _, pack = _packs(forests, precision)
    assert pack.thr.dtype == pack.leaf.dtype == torch.float32
    assert bool(torch.isposinf(pack.thr[pack.all_left]).all())
    kept = ~pack.all_left
    thr, leaf = pack.thr_q.float(), pack.leaf_q.float()
    if precision == "int8":
        affine = jax.jit(lambda q, s, z: q * s + z)
        f = pack.feature.long()
        thr = torch.from_numpy(np.array(affine(
            thr.numpy(), pack.thr_scale[0][f].numpy(), pack.thr_zero[0][f].numpy()
        )))
        leaf = torch.from_numpy(np.array(affine(
            leaf.numpy(), pack.leaf_scale[0][:, None].numpy(), pack.leaf_zero[0][:, None].numpy()
        )))
    assert torch.equal(pack.thr[kept], thr[kept])
    assert torch.equal(pack.leaf, leaf)


def test_fma_rounds_once_as_xla_does():
    """`_fma_f32` equals XLA's CPU ``a * b + c`` (one FMA) on values whose
    exponents span 16 decades; two float32 roundings, or a float64 sum
    rounded to nearest, differ on some of them."""
    rng = np.random.default_rng(0)
    n = 200_000
    q = rng.integers(-127, 128, n).astype(np.float32)
    scale = (rng.random(n) * 10.0 ** rng.integers(-8, 8, n)).astype(np.float32)
    zero = (rng.normal(size=n) * 10.0 ** rng.integers(-8, 8, n)).astype(np.float32)
    xla = np.asarray(jax.jit(lambda a, b, c: a * b + c)(q, scale, zero))
    got = score._fma_f32(torch.from_numpy(q), torch.from_numpy(scale), torch.from_numpy(zero))
    np.testing.assert_array_equal(got.numpy(), xla)
    twice = q * scale + zero
    nearest = (q.astype(np.float64) * scale + zero).astype(np.float32)
    assert (twice != xla).any() and (nearest != xla).any()


def _requests(n: int, seed: int) -> list[dict]:
    """``n`` valid /predict bodies: floats for continuous fields, 0/1 ints
    for the one-hot indicators, aliases for the names with spaces."""
    rng = np.random.default_rng(seed)
    alias = {v: k for k, v in schema.SERVING_FIELD_ALIASES.items()}
    bodies = []
    for _ in range(n):
        body = {}
        for name in schema.SERVING_FEATURES:
            if name in schema.SERVING_INT_FEATURES:
                body[alias.get(name, name)] = int(rng.integers(0, 2))
            else:
                body[alias.get(name, name)] = float(np.round(rng.uniform(0, 1) * 10 ** rng.integers(0, 5), 3))
        bodies.append(body)
    return bodies


def test_int8_service_serves_the_plain_scorer(committed):
    """A CPU `ScorerService` at int8: /predict answers as the plain scorer
    scores the int8 pack, bulk too, and /readyz names the table."""
    _, forest, F = committed
    art = GBDTArtifact.load(ObjectStore(str(ROOT / "artifacts")), KEY, "cpu")
    service = ScorerService(art, ServeConfig(forest_precision="int8"), device="cpu")
    try:
        ok, ready = service.ready()
        assert ok and ready["precision"] == "int8"
        assert ready["quant_table"] == COMMITTED_HASHES["int8"]
        pack = pack_forest(forest, F, "int8")
        names = service.feature_names
        resps = [service.predict_single(body) for body in _requests(6, seed=3)]
        X = torch.tensor([[resp["input_row"][n] for n in names] for resp in resps])
        _, prob, phis, base = fused_score_reference(pack, X, n_features=F)
        for i, resp in enumerate(resps):
            assert abs(resp["prob_default"] - float(prob[i])) <= TOL_PROB
            np.testing.assert_allclose(resp["shap_values"], phis[i].numpy(), rtol=0, atol=TOL_SHAP)
            assert abs(resp["base_value"] - float(base)) <= TOL_SHAP
        Xb = _rows(forest, 300, F, seed=4)
        want = fused_score_reference(pack, torch.from_numpy(Xb), n_features=F, with_shap=False)[1]
        assert float(np.abs(service.predict_proba(Xb) - want.numpy()).max()) <= TOL_PROB
    finally:
        service.close()


def test_cli_serves_int8_on_the_cpu():
    args = serve_cli.parse_args(
        ["--store", str(ROOT / "artifacts"), "--device", "cpu", "--forest-precision", "int8"]
    )
    service = serve_cli.build_service(args)
    try:
        _, ready = service.ready()
        assert (ready["kernel"], ready["precision"]) == ("plain", "int8")
        assert ready["quant_table"] == COMMITTED_HASHES["int8"]
    finally:
        service.close()
