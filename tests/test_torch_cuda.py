"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (the kernel has no CPU mode) and skip
elsewhere. They import nothing of JAX, so they also run on a machine without
it, skipping the JAX-only conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances of ``score_forest``: margins bit-identical (both sum the landed
leaf values one f32 add per tree, in tree order; the kernel's finalize pass
does so after its walk spread the trees over blocks), also across two calls;
prob within 1e-6 (two sigmoid implementations); phis within 1e-5 (the
kernel adds a tree's contributions in another order than the plain
version, in int64 fixed point), and ``base + sum(phis)`` within 1e-4 of
the margin; and the phis of repeated launches are the same bits (a
resumed portfolio sweep needs them to be). The cases cover what the
grid of (row tile x tree group) can get wrong: forests whose last tree
group is not full, depths 1 to 10, ragged row tiles, an all-NaN row and a
zero-padded bucket. The bf16 and int8 packs are held to the same
tolerances (the kernel dequantizes as the plain version does: margins
bitwise), on the committed model and on synthetic forests with all-left
splits at depths 1 to 10, and an int8 service serves as the plain int8
scorer. Of ``gradient_histogram``: cover bit-identical, g and h of
each node within 1e-5 of that node's largest |value| in the channel, two
launches bit-identical (integer fixed-point sums), the same rows in another
order bit-identical (the kernel groups rows by node in no fixed order), and
a small fit on the card bit-identical twice over; non-finite g, h or w
give the plain version's NaN or infinity in the bins they reach, and the
other bins their exact sums. Of its job axis: one launch of J jobs (1, 3
and 15; K 1 to 256; F 20 and 104; B 64 and 255; uint8 and int32 bins)
gives each job the bits of a launch on that job alone, a job with no
active row all zeros and a NaN in one job leaves the other jobs' bins as
they were; and `fit_binned_jobs` on the card gives each job the forest and
margin of its own fit bit for bit, with one launch per level for all
jobs. Of the raw path: the device ingest on the card
equals the CPU's (bitwise outside the log1p columns, which are within
3e-7), so does the host path (clean and prepare on the host, engineer on
the card) against the device ingest on the card and against its own
engineering on the CPU, and `predict_raw` on the card reproduces each raw row's ingested row
bit for bit and scores it as the margin-only launch does. Of the training
protocol: RFE eliminates the CPU's features, and each CV job's AUC is
within 1e-4 of the CPU's; RFECV selects the CPU's features with every
count's score within 1e-6 of the CPU's; and a chunked successive-halving
search gives the CPU's report (rungs, pruned, survivors, scored trees),
scores within 1e-4 (as the CV jobs above: up to 40 trees of depth 5, whose
margins drift by ulps between the card's fixed-point sums and the CPU's
float sums) and the CPU's winner, its histogram launches one per level of
every tree a bucket's jobs boosted together in whole chunks. Of the program accounting:
recording launches makes no device synchronisation and waits on an event
only beyond the pool's bound, and every launch lands on its program with
CUDA-event seconds. Of the continuous-training loop: a shadow row of the
canary is exactly one margin-only ``score_forest`` launch at bucket 1, its
probability the host sigmoid of the kernel's margin, which equals the plain
version's bit for bit; and a promotion's reload launches only the kernel
(its warm-up buckets and the smoke row). Of the serving fleet: four
replicas on the one card launch only the kernel, from their worker threads
at once, each launch on its program (dispatches equal launches, equal the
micro-batches, bulk chunks and warm-ups); a replica the supervisor rebuilds
scores the old one's margins bit for bit and the old one's bytes come back;
and at brownout rung 2 single rows launch only margin-only programs. Of
the fleet's load control: a scale-up on the card launches only the kernel
(its warm-ups, the smoke row, then micro-batches) and the new replica's
margins are the plain version's; a replica the autoscaler retires gives
its bytes back; after the busy retune the 128- and 256-row SHAP buckets,
never warmed, equal the plain version; and a four-replica fleet whose
history sampler renders every registry meanwhile waits on no event but the
pool's oldest. Of the per-replica streams: each card replica launches on
its own CUDA stream, and while replica 1 floods the card replica 0's
launch reads at most twice its idle seconds on its program, every launch's
margins those of the rows launched alone. Of the challengers: the MLP,
FT-Transformer and TabNet with one set of weights give the CPU's logits on
the card (1e-4), and 3 full-batch epochs from them the CPU's losses (1e-5
relative) and weights (1e-4; the attentive layers, FT's key bias and
TabNet's attn.*, within lr per update). Of the portfolio stress path: the
2048- and 4096-row SHAP launches (a portfolio chunk, a ``shap_bulk``
chunk) equal the plain version as above, and their margins the margin-only
launch's bit for bit; a sweep on the card is one SHAP launch per chunk,
its scores the CPU engine's bit for bit, and killed and resumed it gives
every chunk's arrays bit for bit; ``shap_bulk`` on the card is one SHAP
launch per chunk, its phis the plain version's within 1e-5. Of the mesh,
the card named 1, 2 and 4 times (each shard on its own stream): the sharded
histogram entry gives the bits of one launch over all rows, J = 1 and 3,
with a NaN in one shard; a dp fit's first tree is the single-device direct
fit's, split for split; `MeshPartitioner` scores margins and SHAP bit for
bit as `SingleDevicePartitioner` at f32, bf16 and int8, one launch per
shard. Of the operator's layer: a second process over the same build cache
compiles nothing (3 hits: the two nvcc libraries and the g++ reader);
`debug.profile_trace` records ``shap_kernel<7>`` and
``score_finalize_kernel`` on the card; ``tools.train_artifact`` at 20,000
rows launches the histogram 300 x 7 times and its artifact serves on the
card as the plain scorer does on the CPU. Each of 20 `debug.profile_trace`
sessions of 24 SHAP launches keeps 24 records of each scoring kernel, and
`explain.TreeExplainer` on the card launches once a chunk and matches
itself on the CPU within 1e-5.
"""

from __future__ import annotations

import dataclasses
import gc
import threading
import time
from datetime import datetime
from pathlib import Path

import numpy as np
import pytest
import torch

from cobalt_smart_lender_ai_tpu_torch.config import (
    GBDTConfig,
    MeshConfig,
    RFEConfig,
    ServeConfig,
    TuneConfig,
)
from cobalt_smart_lender_ai_tpu_torch.convert import forest_from_numpy
from cobalt_smart_lender_ai_tpu_torch.data import schema
from cobalt_smart_lender_ai_tpu_torch.data.clean import clean_raw_frame
from cobalt_smart_lender_ai_tpu_torch.data.device_pipeline import (
    run_device_ingest,
    tokenize_raw_frame,
    transform_raw_rows,
)
from cobalt_smart_lender_ai_tpu_torch.data.features import engineer_features, prepare_cleaned_frame
from cobalt_smart_lender_ai_tpu_torch.data.frame import row_dicts
from cobalt_smart_lender_ai_tpu_torch.data.synthetic import synthetic_lendingclub_frame
from cobalt_smart_lender_ai_tpu_torch.io import GBDTArtifact, ModelRegistry, ObjectStore
from cobalt_smart_lender_ai_tpu_torch.models.gbdt import (
    GBDTClassifier,
    GBDTHyperparams,
    fit_binned_jobs,
    fit_binned_resumable,
    predict_margin,
)
from cobalt_smart_lender_ai_tpu_torch.ops.binning import compute_bin_edges, transform
from cobalt_smart_lender_ai_tpu_torch.ops.histogram import (
    gradient_histogram_channels,
    gradient_histogram_jobs,
    gradient_histogram_jobs_reference,
    gradient_histogram_reference,
    gradient_histogram_sharded,
    histogram_accumulate,
)
from cobalt_smart_lender_ai_tpu_torch.ops.score import (
    fused_score,
    fused_score_reference,
    pack_forest,
)
from cobalt_smart_lender_ai_tpu_torch.parallel.mesh import make_mesh
from cobalt_smart_lender_ai_tpu_torch.parallel.partitioner import (
    MeshPartitioner,
    SingleDevicePartitioner,
)
from cobalt_smart_lender_ai_tpu_torch.parallel.rfe import rfe_select
from cobalt_smart_lender_ai_tpu_torch.parallel.sharded import fit_binned_dp
from cobalt_smart_lender_ai_tpu_torch.parallel.tune import (
    cross_validate_gbdt,
    randomized_search,
    search_buckets,
    stratified_kfold_masks,
)
from cobalt_smart_lender_ai_tpu_torch.serve.replicas import ReplicaSet
from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService
from cobalt_smart_lender_ai_tpu_torch.telemetry.programs import (
    EVENT_POOL,
    ProgramRegistry,
    set_default_program_registry,
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


def _assert_kernel_matches_plain(pack, cpu_pack, Xn: np.ndarray, with_shap: bool) -> None:
    """One call of the kernel against the plain version on the card and on
    the CPU, and a second call's margins against the first's."""
    F = pack.n_features
    X = torch.from_numpy(np.ascontiguousarray(Xn)).cuda()
    before = fused_score.launches
    out = fused_score(pack, X, n_features=F, with_shap=with_shap)
    again = fused_score(pack, X, n_features=F, with_shap=with_shap)
    torch.cuda.synchronize()
    assert fused_score.launches == before + 2
    assert torch.equal(out[0], again[0])
    ref = fused_score_reference(pack, X, n_features=F, with_shap=with_shap)
    assert torch.equal(out[0], ref[0])
    cpu_margin = fused_score_reference(cpu_pack, torch.from_numpy(Xn), n_features=F, with_shap=False)[0]
    assert torch.equal(out[0].cpu(), cpu_margin)
    assert float((out[1] - ref[1]).abs().max()) <= TOL_PROB
    if with_shap:
        assert bool(torch.isfinite(out[2]).all())
        assert float((out[2] - ref[2]).abs().max()) <= TOL_SHAP
        additivity = (out[3] + out[2].sum(1) - out[0]).abs().max()
        assert float(additivity) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize(
    "rows, with_shap",
    [(1, True), (3, True), (64, True), (65, True), (257, True),
     (1, False), (4096, False), (4097, False)],
)
def test_kernel_matches_plain_on_card(card_pack, rows, with_shap):
    pack, cpu_pack, _ = card_pack
    _assert_kernel_matches_plain(pack, cpu_pack, _rows(pack, rows, seed=rows), with_shap)


@pytest.mark.cuda
@pytest.mark.parametrize("n_trees", [1, 7, 299])
def test_kernel_takes_any_tree_count_on_card(card_pack, n_trees):
    """The committed forest's first T trees: at 7 and 299 trees the last
    tree group of some bucket is not full."""
    _, cpu_pack, F = card_pack
    art = GBDTArtifact.load(ObjectStore(str(ROOT / "artifacts")), "models/gbdt/model_tree", "cpu")
    forest = art.forest
    sliced = dataclasses.replace(
        forest,
        **{f.name: getattr(forest, f.name)[:n_trees] for f in dataclasses.fields(forest) if f.name != "depth"},
    )
    pack, cpu_sliced = pack_forest(sliced.to("cuda"), F), pack_forest(sliced, F)
    for rows, with_shap in ((1, True), (64, True), (300, False)):
        _assert_kernel_matches_plain(pack, cpu_sliced, _rows(cpu_pack, rows, seed=n_trees + rows), with_shap)


def _synthetic_forest(depth: int, n_trees: int, F: int, seed: int):
    """Random splits and leaf values; covers positive and consistent (each
    internal node's cover is its children's sum), some thresholds +inf."""
    rng = np.random.default_rng(seed)
    L = 2**depth
    I = L - 1
    cover = np.zeros((n_trees, I + L), np.float32)
    cover[:, I:] = rng.integers(1, 100, (n_trees, L))
    for n in range(I - 1, -1, -1):
        cover[:, n] = cover[:, 2 * n + 1] + cover[:, 2 * n + 2]
    thr = rng.normal(size=(n_trees, I)).astype(np.float32)
    thr[rng.random(thr.shape) < 0.05] = np.inf
    arrays = dict(
        feature=rng.integers(0, F, (n_trees, I)),
        thr_bin=np.zeros((n_trees, I)),
        thr_float=thr,
        missing_left=rng.random((n_trees, I)) < 0.5,
        gain=np.zeros((n_trees, I)),
        cover=cover,
        leaf_value=(0.1 * rng.normal(size=(n_trees, L))).astype(np.float32),
    )
    return forest_from_numpy(arrays, depth)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 3, 10])
def test_kernel_synthetic_depths_on_card(card_pack, depth):
    F = 12
    forest = _synthetic_forest(depth, 37, F, seed=depth)
    pack, cpu_pack = pack_forest(forest.to("cuda"), F), pack_forest(forest, F)
    rng = np.random.default_rng(depth)
    for rows, with_shap in ((1, True), (9, True), (130, False)):
        X = rng.normal(size=(rows, F)).astype(np.float32)
        X[rng.random(X.shape) < 0.1] = np.nan
        _assert_kernel_matches_plain(pack, cpu_pack, X, with_shap)


@pytest.mark.cuda
@pytest.mark.parametrize("with_shap", [True, False], ids=["shap", "margin"])
def test_kernel_all_nan_and_padded_rows_on_card(card_pack, with_shap):
    """An all-NaN row (every node takes its missing direction) and a bucket
    of 8 whose last 3 rows are the zero padding the micro-batcher adds."""
    pack, cpu_pack, _ = card_pack
    X = _rows(pack, 8, seed=17)
    X[0] = np.nan
    X[5:] = 0.0
    _assert_kernel_matches_plain(pack, cpu_pack, X, with_shap)


QUANTIZED = ("bf16", "int8")


@pytest.fixture(scope="module")
def card_quantized_packs():
    """The committed forest packed at bf16 and int8 on the card (through
    the publish gate) and on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the score_forest kernel has no CPU mode")
    art = GBDTArtifact.load(ObjectStore(str(ROOT / "artifacts")), "models/gbdt/model_tree", "cpu")
    F = len(art.feature_names)
    card_forest = art.forest.to("cuda")
    return {
        p: (pack_forest(card_forest, F, p), pack_forest(art.forest, F, p)) for p in QUANTIZED
    }


@pytest.mark.cuda
@pytest.mark.parametrize("precision", QUANTIZED)
@pytest.mark.parametrize(
    "rows, with_shap",
    [(1, True), (8, True), (64, True), (65, True), (256, False), (4096, False), (4097, False)],
)
def test_quantized_kernel_matches_plain_on_card(card_pack, card_quantized_packs, precision, rows, with_shap):
    """The kernel dequantizes the bf16 or int8 pack as the plain version
    does: margins bitwise, on the card and on the CPU."""
    pack, cpu_pack = card_quantized_packs[precision]
    _assert_kernel_matches_plain(pack, cpu_pack, _rows(card_pack[0], rows, seed=rows), with_shap)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", QUANTIZED)
@pytest.mark.parametrize("depth", range(1, 11))
def test_quantized_kernel_synthetic_depths_on_card(card_pack, precision, depth):
    """Synthetic forests with +inf (all-left) splits at every depth the
    kernel takes; an all-NaN row and a zero-padded tail in each batch."""
    F = 12
    forest = _synthetic_forest(depth, 37, F, seed=depth)
    pack = pack_forest(forest.to("cuda"), F, precision, check=False)
    cpu_pack = pack_forest(forest, F, precision, check=False)
    rng = np.random.default_rng(depth)
    for rows, with_shap in ((1, True), (9, True), (130, False)):
        X = rng.normal(size=(rows, F)).astype(np.float32)
        X[rng.random(X.shape) < 0.1] = np.nan
        X[0] = np.nan
        X[rows - rows // 3 :] = 0.0
        _assert_kernel_matches_plain(pack, cpu_pack, X, with_shap)


@pytest.mark.cuda
def test_int8_service_on_card(card_pack):
    """`ScorerService` at int8 on the card: it starts through the gate and
    answers /predict and bulk as the plain int8 scorer on the CPU."""
    art = GBDTArtifact.load(ObjectStore(str(ROOT / "artifacts")), "models/gbdt/model_tree", "cuda")
    F = len(art.feature_names)
    service = ScorerService(art, ServeConfig(forest_precision="int8"), device="cuda")
    try:
        _, ready = service.ready()
        assert (ready["kernel"], ready["precision"]) == ("score_forest", "int8")
        cpu_pack = pack_forest(art.forest.to("cpu"), F, "int8")
        assert ready["quant_table"] == cpu_pack.table_hash
        X = _rows(card_pack[0], 300, seed=5)
        want = fused_score_reference(cpu_pack, torch.from_numpy(X), n_features=F, with_shap=False)[1]
        assert float(np.abs(service.predict_proba(X) - want.numpy()).max()) <= TOL_PROB
    finally:
        service.close()


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the gradient_histogram kernel has no CPU mode")
    return torch.device("cuda")


def _assert_matches_plain(card, bins, node, g, h, w, K, B, plain_args=None):
    """The histogram contract on the card: two launches bit-equal, cover
    bit-equal to the plain version, g and h of each node within 1e-5 of that
    node's largest |value|. ``plain_args`` are the plain version's inputs
    where they differ from the kernel's. Returns the kernel's output."""
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(card) for a in (bins, node, g, h, w)]
    before = gradient_histogram_channels.launches
    got = torch.stack(gradient_histogram_channels(*t, n_nodes=K, n_bins=B))
    again = torch.stack(gradient_histogram_channels(*t, n_nodes=K, n_bins=B))
    torch.cuda.synchronize()
    assert gradient_histogram_channels.launches == before + 2
    assert torch.equal(got, again)
    if plain_args is not None:
        t = [torch.from_numpy(np.ascontiguousarray(a)).to(card) for a in plain_args]
    ref = gradient_histogram_reference(*t, n_nodes=K, n_bins=B)
    assert torch.equal(got[2], ref[2])
    for c in (0, 1):  # per node, against that node's largest |value|
        scale = ref[c].abs().amax(dim=(1, 2))
        assert bool(((got[c] - ref[c]).abs().amax(dim=(1, 2)) <= 1e-5 * scale).all())
    return got


def _histogram_inputs(seed, N, F, B, K, bin_dtype):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, (N, F)).astype(bin_dtype)
    node = rng.integers(0, K, N).astype(np.int32)
    g = (rng.normal(size=N) * 3).astype(np.float32)
    h = (np.abs(g) * 0.25 + 0.01).astype(np.float32)
    w = (rng.random(N) < 0.8).astype(np.float32)
    return bins, node, g, h, w


@pytest.mark.cuda
@pytest.mark.parametrize(
    "N,F,B,K,bin_dtype",
    [(100_000, 20, 255, 1, np.uint8), (100_000, 20, 255, 32, np.uint8),
     (50_000, 7, 300, 4, np.int32), (30_000, 33, 64, 64, np.uint8)],
)
def test_histogram_kernel_matches_plain_on_card(card, N, F, B, K, bin_dtype):
    _assert_matches_plain(card, *_histogram_inputs(N + K, N, F, B, K, bin_dtype), K, B)


def _empty_middle_node():
    bins, node, g, h, w = _histogram_inputs(1, 60_000, 20, 255, 3, np.uint8)
    idle = node == 1  # node 1 keeps rows, but none of them is active
    g[idle], h[idle], w[idle] = 0.0, 0.0, 0.0
    return bins, node, g, h, w, 3, 255


def _one_node_of_64():
    bins, node, g, h, w = _histogram_inputs(2, 80_000, 20, 255, 64, np.uint8)
    return bins, np.full_like(node, 37), g, h, w, 64, 255


def _all_zero():
    bins, node, g, h, w = _histogram_inputs(4, 20_000, 20, 255, 8, np.uint8)
    z = np.zeros_like(g)
    return bins, node, z, z, z, 8, 255


GROUPING_CASES = {
    "empty-middle-node": _empty_middle_node,
    "one-node-of-64": _one_node_of_64,
    "all-zero": _all_zero,
    "one-row": lambda: (*_histogram_inputs(5, 1, 20, 255, 2, np.uint8), 2, 255),
    "ragged-rows": lambda: (*_histogram_inputs(6, 100_003, 20, 255, 16, np.uint8), 16, 255),
    "int32-bins-300": lambda: (*_histogram_inputs(7, 60_000, 20, 300, 8, np.int32), 8, 300),
    "depth-10-direct": lambda: (*_histogram_inputs(8, 200_000, 20, 255, 512, np.uint8), 512, 255),
    # Above 4096 nodes the kernel counts and scatters with global counters.
    "depth-14-direct": lambda: (*_histogram_inputs(11, 50_000, 4, 64, 8192, np.uint8), 8192, 64),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GROUPING_CASES))
def test_histogram_kernel_grouping_cases_on_card(card, case):
    bins, node, g, h, w, K, B = GROUPING_CASES[case]()
    _assert_matches_plain(card, bins, node, g, h, w, K, B)


@pytest.mark.cuda
def test_histogram_kernel_drops_rows_outside_the_nodes_on_card(card):
    """Rows whose node lies outside [0, K) add nothing: the kernel on all
    rows equals the plain version on the rows inside, the others zeroed."""
    K, B = 8, 255
    bins, node, g, h, w = _histogram_inputs(9, 50_000, 20, B, K, np.uint8)
    rng = np.random.default_rng(9)
    node = rng.integers(-3, K + 3, node.shape[0]).astype(np.int32)
    inside = (node >= 0) & (node < K)
    plain = (bins, np.where(inside, node, 0).astype(np.int32), g * inside, h * inside, w * inside)
    _assert_matches_plain(card, bins, node, g, h, w, K, B, plain_args=plain)


@pytest.mark.cuda
def test_histogram_kernel_ignores_row_order_on_card(card):
    K, B = 32, 255
    bins, node, g, h, w = _histogram_inputs(10, 120_000, 20, B, K, np.uint8)
    got = _assert_matches_plain(card, bins, node, g, h, w, K, B)
    perm = np.random.default_rng(10).permutation(node.shape[0])
    shuffled = [torch.from_numpy(np.ascontiguousarray(a[perm])).to(card) for a in (bins, node, g, h, w)]
    again = torch.stack(gradient_histogram_channels(*shuffled, n_nodes=K, n_bins=B))
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_fit_on_card_is_deterministic(card):
    rng = np.random.default_rng(3)
    X = rng.normal(size=(20_000, 6)).astype(np.float32)
    X[rng.random(X.shape) < 0.1] = np.nan
    y = (rng.random(20_000) < 1 / (1 + np.exp(-np.nan_to_num(X[:, 0])))).astype(np.float32)
    kw = dict(n_estimators=8, max_depth=4, subsample=0.8, colsample_bytree=0.8)
    before = gradient_histogram_channels.launches
    a = GBDTClassifier(device="cuda", **kw).fit(X, y).forest
    assert gradient_histogram_channels.launches == before + 8 * 4
    b = GBDTClassifier(device="cuda", **kw).fit(X, y).forest
    for f in ("feature", "thr_bin", "missing_left", "gain", "cover", "leaf_value"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _nonfinite_inputs():
    """Level inputs with NaN, +inf and -inf in each of g, h and w, plus two
    rows of one node that share every bin, one +inf and one -inf in g."""
    K, B = 8, 255
    bins, node, g, h, w = _histogram_inputs(12, 40_000, 20, B, K, np.uint8)
    rng = np.random.default_rng(12)
    for v in (g, h, w):
        idx = rng.choice(node.shape[0], 12, replace=False)
        v[idx[:4]], v[idx[4:8]], v[idx[8:]] = np.nan, np.inf, -np.inf
    bins[1], node[1] = bins[0], node[0]
    g[0], g[1] = np.inf, -np.inf
    return bins, node, g, h, w, K, B


@pytest.mark.cuda
def test_histogram_kernel_nonfinite_inputs_on_card(card):
    """NaN and infinities reach only their bins, as in the plain version:
    NaN where a NaN or both infinities landed, the infinity where only one
    sign did; every other bin bit-equal to a launch with those values
    zeroed (the scale is taken over the finite values only)."""
    bins, node, g, h, w, K, B = _nonfinite_inputs()
    t = [torch.from_numpy(a).to(card) for a in (bins, node, g, h, w)]
    got = torch.stack(gradient_histogram_channels(*t, n_nodes=K, n_bins=B))
    ref = gradient_histogram_reference(*t, n_nodes=K, n_bins=B)
    zeroed = [torch.from_numpy(np.nan_to_num(a, nan=0.0, posinf=0.0, neginf=0.0)).to(card)
              for a in (g, h, w)]
    finite = torch.stack(gradient_histogram_channels(*t[:2], *zeroed, n_nodes=K, n_bins=B))
    torch.cuda.synchronize()
    assert bool(torch.isnan(ref[0]).any()) and bool(torch.isposinf(ref[1]).any())
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    assert torch.equal(torch.isposinf(got), torch.isposinf(ref))
    assert torch.equal(torch.isneginf(got), torch.isneginf(ref))
    ok = torch.isfinite(ref)
    assert torch.equal(got[ok], finite[ok])
    assert torch.equal(got[2][ok[2]], ref[2][ok[2]])


def _jobs_inputs(seed, J, N, F, B, K, bin_dtype):
    """Level inputs of J jobs over one bins matrix: each job's g on its own
    scale (so each has its own fixed-point exponent) and a third of its
    rows at weight 0, as a CV job's fold."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, (N, F)).astype(bin_dtype)
    node = rng.integers(0, K, (J, N)).astype(np.int32)
    g = (rng.normal(size=(J, N)) * rng.uniform(0.5, 4.0, (J, 1))).astype(np.float32)
    h = (np.abs(g) * 0.25 + 0.01).astype(np.float32)
    w = (rng.random((J, N)) < 0.8).astype(np.float32)
    fold = rng.random((J, N)) < 1 / 3
    g[fold], h[fold], w[fold] = 0.0, 0.0, 0.0
    return bins, node, g, h, w


def _single_launches(t, K, B):
    """(3, J, K, F, B): one launch of `gradient_histogram_channels` per job."""
    bins, node, g, h, w = t
    return torch.stack([
        torch.stack(gradient_histogram_channels(bins, node[j], g[j], h[j], w[j], n_nodes=K, n_bins=B))
        for j in range(node.shape[0])
    ], dim=1)


#: (J, N, F, B, K, bin dtype): J 1, 3 and 15 (the protocol's largest
#: bucket), K 1 to 256, F 20 and 104, B 64 and 255, uint8 and int32 bins.
JOB_CASES = [
    (1, 60_000, 20, 255, 32, np.uint8),
    (3, 40_000, 104, 64, 1, np.uint8),
    (3, 30_000, 20, 255, 256, np.int32),
    (15, 20_000, 20, 255, 128, np.uint8),
    (15, 12_000, 104, 64, 8, np.int32),
    (15, 20_000, 20, 64, 256, np.uint8),
]


@pytest.mark.cuda
@pytest.mark.parametrize("J,N,F,B,K,bin_dtype", JOB_CASES)
def test_histogram_jobs_kernel_matches_single_launches_on_card(card, J, N, F, B, K, bin_dtype):
    """One launch of J jobs gives each job the bits of a launch on its own
    inputs; against the plain version the cover is bit-equal and g and h
    of each (job, node) within 1e-5 of its largest |value|; job 1 (J > 1)
    has no active row and gets zeros."""
    bins, node, g, h, w = _jobs_inputs(J * 1000 + K, J, N, F, B, K, bin_dtype)
    if J > 1:
        g[1], h[1], w[1] = 0.0, 0.0, 0.0
    t = [torch.from_numpy(a).to(card) for a in (bins, node, g, h, w)]
    before = gradient_histogram_channels.launches
    got = torch.stack(gradient_histogram_jobs(*t, n_nodes=K, n_bins=B))
    torch.cuda.synchronize()
    assert gradient_histogram_channels.launches == before + 1
    assert got.shape == (3, J, K, F, B)
    assert torch.equal(got, _single_launches(t, K, B))
    if J > 1:
        assert not got[:, 1].any()
    ref = gradient_histogram_jobs_reference(*t, n_nodes=K, n_bins=B)
    assert torch.equal(got[2], ref[2])
    for c in (0, 1):
        scale = ref[c].abs().amax(dim=(2, 3))
        assert bool(((got[c] - ref[c]).abs().amax(dim=(2, 3)) <= 1e-5 * scale).all())


@pytest.mark.cuda
def test_histogram_jobs_kernel_nan_in_one_job_on_card(card):
    """A NaN in job 1's g leaves jobs 0 and 2 bit-equal to their single
    launches (the scale and the non-finite flags are per job); job 1 has
    NaN where the plain version does and its single launch's bits
    elsewhere."""
    J, K, B = 3, 16, 255
    bins, node, g, h, w = _jobs_inputs(21, J, 50_000, 20, B, K, np.uint8)
    g[1, np.random.default_rng(21).choice(50_000, 5, replace=False)] = np.nan
    t = [torch.from_numpy(a).to(card) for a in (bins, node, g, h, w)]
    got = torch.stack(gradient_histogram_jobs(*t, n_nodes=K, n_bins=B))
    single = _single_launches(t, K, B)
    ref = gradient_histogram_jobs_reference(*t, n_nodes=K, n_bins=B)
    torch.cuda.synchronize()
    for j in (0, 2):
        assert torch.equal(got[:, j], single[:, j]) and not bool(got[:, j].isnan().any())
    nan = got[:, 1].isnan()
    assert bool(nan.any()) and torch.equal(nan, ref[:, 1].isnan())
    assert torch.equal(got[:, 1][~nan], single[:, 1][~nan])


@pytest.mark.cuda
def test_fit_binned_jobs_matches_per_job_fits_on_card(card):
    """Four CV-like jobs (their own fold at weight 0, hyperparameters,
    seeds and carried margins) through one level loop on the card: each
    job's forest and margin bit-equal to its own fit, one launch per level
    for all of them against one per level per job."""
    rng = np.random.default_rng(17)
    N, F, B, depth, T = 30_000, 12, 64, 5, 4
    bins = torch.from_numpy(rng.integers(0, B, (N, F)).astype(np.uint8)).to(card)
    y = torch.from_numpy((rng.random(N) < 0.3).astype(np.float32)).to(card)
    fm = torch.ones(F, dtype=torch.bool, device=card)
    hps = [GBDTHyperparams(learning_rate=lr, gamma=gm, reg_lambda=1.0, min_child_weight=1.0,
                           scale_pos_weight=2.5, subsample=ss, colsample_bytree=cs,
                           n_estimators=ne, max_depth=md)
           for lr, gm, ss, cs, ne, md in ((0.1, 0.0, 0.8, 0.8, 6, 5), (0.3, 1.0, 1.0, 0.6, 6, 5),
                                          (0.05, 0.5, 0.7, 1.0, 5, 4), (0.2, 0.0, 1.0, 1.0, 6, 5))]
    seeds = [3, 5, 7, 9]
    sw = torch.from_numpy((rng.random((4, N)) >= 1 / 3).astype(np.float32)).to(card)
    init = torch.from_numpy(rng.normal(size=(4, N)).astype(np.float32)).to(card)
    kw = dict(n_trees_cap=T, depth_cap=depth, n_bins=B, tree_offset=2)
    before = gradient_histogram_channels.launches
    forests, margins = fit_binned_jobs(bins, y, sw, fm, hps, seeds, init_margin=init, **kw)
    torch.cuda.synchronize()
    assert gradient_histogram_channels.launches - before == T * depth
    for j in range(4):
        forest, margin = fit_binned_resumable(bins, y, sw[j], fm, hps[j], seeds[j],
                                              init_margin=init[j], **kw)
        assert torch.equal(margin, margins[j]), j
        for f in ("feature", "thr_bin", "missing_left", "gain", "cover", "leaf_value"):
            assert torch.equal(getattr(forest, f), getattr(forests[j], f)), (j, f)
    assert gradient_histogram_channels.launches - before == 5 * T * depth


TODAY = datetime(2026, 8, 1)
LOG_RTOL = 3e-7


@pytest.fixture(scope="module")
def raw_ingests():
    """One seeded raw table, tokenized once, ingested on the card and on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the raw path's fit and scoring run the kernels")
    frame = synthetic_lendingclub_frame(20_000, seed=5)
    tok = tokenize_raw_frame(frame, today=TODAY)
    return frame, run_device_ingest(tok, device="cuda"), run_device_ingest(tok, device="cpu")


@pytest.mark.cuda
def test_device_ingest_on_card_matches_cpu(raw_ingests):
    _, card, cpu = raw_ingests
    assert dataclasses.asdict(card.report) == dataclasses.asdict(cpu.report)
    log_cols = set(cpu.plan.log_cols)
    assert dataclasses.replace(card.plan, medians={}) == dataclasses.replace(cpu.plan, medians={})
    for k, v in cpu.plan.medians.items():
        assert np.isclose(card.plan.medians[k], v, rtol=LOG_RTOL, atol=0) if k in log_cols \
            else card.plan.medians[k] == v, k
    for a, b in ((card.tree, cpu.tree), (card.nn, cpu.nn)):
        A, B = a.X.cpu().numpy(), b.X.numpy()
        nan = np.isnan(A) & np.isnan(B)
        for j, name in enumerate(a.feature_names):
            ok = np.isclose(A[:, j], B[:, j], rtol=LOG_RTOL, atol=0) if name in log_cols \
                else A[:, j] == B[:, j]
            assert (ok | nan[:, j]).all(), name
    exact = [j for j, n in enumerate(cpu.tree.feature_names) if n not in log_cols]
    assert torch.equal(card.bins.cpu()[:, exact], cpu.bins[:, exact])


def _assert_same_engineering(a, b) -> None:
    """``(report, plan, tree, nn)`` twice: the same report and plan (medians
    within LOG_RTOL in the log1p columns), the columns bitwise outside the
    log1p columns and within LOG_RTOL in them, the same labels."""
    (ra, pa, ta, na), (rb, pb, tb, nb) = a, b
    assert dataclasses.asdict(ra) == dataclasses.asdict(rb)
    assert dataclasses.replace(pa, medians={}) == dataclasses.replace(pb, medians={})
    log_cols = set(pa.log_cols)
    for k, v in pa.medians.items():
        assert np.isclose(pb.medians[k], v, rtol=LOG_RTOL, atol=0) if k in log_cols \
            else pb.medians[k] == v, k
    for x, y in ((ta, tb), (na, nb)):
        assert x.feature_names == y.feature_names
        A, B = x.X.cpu().numpy(), y.X.cpu().numpy()
        nan = np.isnan(A) & np.isnan(B)
        for j, name in enumerate(x.feature_names):
            ok = np.isclose(A[:, j], B[:, j], rtol=LOG_RTOL, atol=0) if name in log_cols \
                else A[:, j] == B[:, j]
            assert (ok | nan[:, j]).all(), name
        assert torch.equal(x.y.cpu().nan_to_num(-1.0), y.y.cpu().nan_to_num(-1.0))


@pytest.fixture(scope="module")
def host_path_runs(raw_ingests):
    """The raw table of `raw_ingests` through the host path: cleaned and
    prepared on the host, engineered on the card and on the CPU."""
    frame, _, _ = raw_ingests
    cleaned, report = clean_raw_frame(frame)
    prepared = prepare_cleaned_frame(cleaned, today=TODAY)
    card = engineer_features(prepared, device="cuda")
    cpu = engineer_features(prepared, device="cpu")
    return report, card, cpu


@pytest.mark.cuda
def test_host_path_on_card_matches_the_device_ingest(raw_ingests, host_path_runs):
    _, ingest, _ = raw_ingests
    report, (tree, nn, plan), _ = host_path_runs
    assert tree.X.is_cuda and nn.X.is_cuda
    _assert_same_engineering(
        (report, plan, tree, nn),
        (ingest.report, dataclasses.replace(ingest.plan, asof=None), ingest.tree, ingest.nn),
    )


@pytest.mark.cuda
def test_host_path_engineering_on_card_matches_cpu(host_path_runs):
    report, (tree, nn, plan), (cpu_tree, cpu_nn, cpu_plan) = host_path_runs
    _assert_same_engineering((report, plan, tree, nn), (report, cpu_plan, cpu_tree, cpu_nn))


@pytest.mark.cuda
def test_predict_raw_on_card_reproduces_batch_rows(raw_ingests, tmp_path):
    frame, card, _ = raw_ingests
    sel = card.tree.select(schema.SERVING_FEATURES)
    model = GBDTClassifier(n_estimators=8, max_depth=4, n_bins=64, device="cuda").fit(sel.X, sel.y)
    GBDTArtifact(
        forest=model.forest.to("cpu"),
        feature_names=tuple(schema.SERVING_FEATURES),
        bin_edges=model.bin_spec.edges.cpu().numpy(),
        plan=card.plan,
    ).save(ObjectStore(str(tmp_path)), "m")
    svc = ScorerService.from_store(ObjectStore(str(tmp_path)), ServeConfig(model_key="m"), device="cuda")
    try:
        payloads = row_dicts(frame, np.arange(32))
        raw = transform_raw_rows(card.plan, payloads, device="cuda")
        tree = card.tree.X
        idx = [card.plan.tree_feature_names.index(n) for n in schema.SERVING_FEATURES]
        matched = 0
        for payload, r in zip(payloads, raw):
            hit = ((tree == r) | (torch.isnan(tree) & torch.isnan(r))).all(dim=1).nonzero()
            if hit.numel() == 0:
                continue  # dropped by cleaning
            before = fused_score.launches
            resp = svc.predict_raw(payload)
            assert fused_score.launches == before + 1
            row = tree[int(hit[0, 0])].cpu().numpy()[idx]
            got = np.array([resp["engineered_row"][n] for n in schema.SERVING_FEATURES], np.float32)
            assert np.array_equal(got.view(np.int32), row.view(np.int32))
            assert resp["prob_default"] == float(svc._model.score(row[None, :], with_shap=False)[0][0])
            matched += 1
        assert matched >= 28
    finally:
        svc.close()


@pytest.mark.cuda
def test_protocol_fits_on_card_match_the_cpu(card):
    """RFE and CV jobs (a third of the rows at weight 0, depths 3 to 9, up
    to K = 256 nodes) through the kernel: the same eliminated features and
    every job's AUC within 1e-4 of the CPU's plain fits. The candidates draw
    no samples (the card's random generator is not the CPU's)."""
    rng = np.random.default_rng(3)
    N, F = 20_000, 24
    X = rng.normal(size=(N, F)).astype(np.float32)
    logit = X[:, 0] - 0.8 * X[:, 1] + 0.5 * X[:, 2] * X[:, 3] - 1.0
    y = (rng.random(N) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    cfg = RFEConfig(n_select=8, step=5, n_estimators=10, max_depth=6)
    got = rfe_select(X, y, cfg, device="cuda")
    ref = rfe_select(X, y, cfg, device="cpu")
    assert np.array_equal(got.support_, ref.support_) and np.array_equal(got.ranking_, ref.ranking_)
    Xt = torch.from_numpy(X)
    bins = transform(compute_bin_edges(Xt, n_bins=255), Xt)
    val = torch.from_numpy(stratified_kfold_masks(y, 3, 22))
    hps = [GBDTHyperparams.from_config(GBDTConfig(n_estimators=n, max_depth=d, learning_rate=0.1))
           for n, d in ((20, 3), (10, 5), (6, 9))]
    before = gradient_histogram_channels.launches
    on_card = cross_validate_gbdt(bins.cuda(), torch.from_numpy(y).cuda(), hps, val.cuda(), 22, n_bins=255)
    # One launch per tree level for a candidate's three folds together.
    assert gradient_histogram_channels.launches - before == 20 * 3 + 10 * 5 + 6 * 9
    on_cpu = cross_validate_gbdt(bins, torch.from_numpy(y), hps, val, 22, n_bins=255)
    assert float(np.abs(on_card - on_cpu).max()) <= 1e-4


def _selection_rows():
    rng = np.random.default_rng(4)
    N, F = 20_000, 30
    X = rng.normal(size=(N, F)).astype(np.float32)
    logit = X[:, 0] - 0.8 * X[:, 1] + 0.5 * X[:, 2] * X[:, 3] + 0.3 * X[:, 4] - 1.0
    y = (rng.random(N) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    return X, y


@pytest.mark.cuda
def test_rfecv_on_card_matches_the_cpu(card):
    X, y = _selection_rows()
    cfg = RFEConfig(n_select=6, step=8, n_estimators=10, max_depth=3)
    got = rfe_select(X, y, cfg, cv_folds=3, device="cuda")
    ref = rfe_select(X, y, cfg, cv_folds=3, device="cpu")
    assert np.array_equal(got.support_, ref.support_) and np.array_equal(got.ranking_, ref.ranking_)
    assert sorted(got.cv_scores_) == sorted(ref.cv_scores_) == [6, 14, 22, 30]
    assert max(abs(got.cv_scores_[n] - ref.cv_scores_[n]) for n in ref.cv_scores_) <= 1e-6


@pytest.mark.cuda
def test_halving_search_on_card_matches_the_cpu(card):
    X, y = _selection_rows()
    tune = TuneConfig(
        n_iter=4, cv_folds=2, chunk_trees=10,
        param_space={"n_estimators": (20, 40), "max_depth": (3, 5), "learning_rate": (0.1, 0.3)},
    )
    before = gradient_histogram_channels.launches
    got = randomized_search(X, y, GBDTConfig(), tune, device="cuda")
    launches = gradient_histogram_channels.launches - before
    ref = randomized_search(X, y, GBDTConfig(), tune, device="cpu")
    report = ref.cv_results_["halving"]
    assert got.cv_results_["halving"] == report and report["pruned_candidates"] == 3
    assert float(np.abs(got.cv_results_["split_test_scores"] - ref.cv_results_["split_test_scores"]).max()) <= 1e-4
    assert got.best_params_ == ref.best_params_
    # One launch per tree level for a bucket's live jobs together: the
    # trees of its candidate boosted furthest, in whole chunks.
    expect = 0
    for idxs in search_buckets(ref.cv_results_["params"], GBDTConfig()):
        g = GBDTConfig(**ref.cv_results_["params"][idxs[0]])
        chunk = report["chunk_trees"][g.max_depth]
        trees = max(min(chunk * -(-report["scored_at_trees"][c] // chunk), g.n_estimators) for c in idxs)
        expect += trees * g.max_depth
    best = GBDTConfig(**got.best_params_)
    assert launches == expect + best.n_estimators * best.max_depth


@pytest.fixture
def fresh_programs():
    """A program registry of the test's own, the process default restored
    after it."""
    reg = ProgramRegistry()
    prev = set_default_program_registry(reg)
    yield reg
    set_default_program_registry(prev)


@pytest.mark.cuda
def test_program_accounting_makes_no_sync_per_launch_on_card(card, fresh_programs, monkeypatch):
    """1,000 histogram launches recorded through CUDA events: no device or
    stream synchronisation, and event waits only beyond the pool's bound
    (each on the oldest pair's end event); once the launches are done the
    table holds every dispatch with its device seconds."""
    n = 1000
    bins, node, g, h, w = (
        torch.from_numpy(np.ascontiguousarray(a)).to(card)
        for a in _histogram_inputs(11, 20_000, 20, 255, 8, np.uint8)
    )
    gradient_histogram_channels(bins, node, g, h, w, n_nodes=8, n_bins=255)  # built, warm
    torch.cuda.synchronize()
    fresh_programs.reset()
    calls = {"device": 0, "event": 0}
    real_sync, real_event_sync = torch.cuda.synchronize, torch.cuda.Event.synchronize

    def count(kind, fn):
        def wrapped(*args, **kwargs):
            calls[kind] += 1
            return fn(*args, **kwargs)

        return wrapped

    monkeypatch.setattr(torch.cuda, "synchronize", count("device", real_sync))
    monkeypatch.setattr(torch.cuda.Event, "synchronize", count("event", real_event_sync))
    before = gradient_histogram_channels.launches
    for _ in range(n):
        gradient_histogram_channels(bins, node, g, h, w, n_nodes=8, n_bins=255)
    assert calls["device"] == 0
    assert calls["event"] <= max(0, n - EVENT_POOL)
    monkeypatch.undo()
    torch.cuda.synchronize()
    (row,) = fresh_programs.table()
    assert row["name"] == "gradient_histogram/F20xB255" and row["kind"] == "kernel"
    assert row["dispatches"] == gradient_histogram_channels.launches - before == n
    assert row["dispatch_seconds"] > 0 and row["dispatches_in_flight"] == 0
    assert row["device_kind"] == torch.cuda.get_device_name(card)


@pytest.mark.cuda
def test_scoring_programs_count_the_launches_on_card(card_pack, fresh_programs):
    """Every `fused_score` launch lands on its bucket's program, with event
    seconds, the kernel's FLOPs and bytes and, on an H100, a roofline."""
    pack, _, F = card_pack
    before = fused_score.launches
    for rows, with_shap in ((1, True), (64, True), (50, True), (4096, False)):
        X = torch.from_numpy(_rows(pack, rows, rows)).cuda()
        fused_score(pack, X, n_features=F, with_shap=with_shap)
    torch.cuda.synchronize()
    table = {r["name"]: r for r in fresh_programs.table()}
    assert sorted(table) == [
        "score_forest/f32/1/shap", "score_forest/f32/4096/margin", "score_forest/f32/64/shap"
    ]
    assert sum(r["dispatches"] for r in table.values()) == fused_score.launches - before == 4
    assert table["score_forest/f32/64/shap"]["dispatches"] == 2
    assert all(r["dispatch_seconds"] > 0 and r["flops"] > 0 for r in table.values())
    h100 = torch.cuda.get_device_name(card).startswith("NVIDIA H100")
    assert all((r["roofline_utilization"] is not None) == h100 for r in table.values())


def _predict_payload(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    alias = {v: k for k, v in schema.SERVING_FIELD_ALIASES.items()}
    return {
        alias.get(n, n): int(rng.integers(0, 2)) if n in schema.SERVING_INT_FEATURES
        else float(np.round(rng.uniform(0, 1000), 3))
        for n in schema.SERVING_FEATURES
    }


@pytest.mark.cuda
def test_cache_hit_launches_nothing_on_card(card_pack, fresh_programs):
    """A miss is one launch on its program; the same payload again is a hit:
    no launch and no dispatch on any program, the miss's response bit for
    bit."""
    service = ScorerService.from_store(
        ObjectStore(str(ROOT / "artifacts")), ServeConfig(), device="cuda"
    )
    try:
        payload = _predict_payload(7)
        before = fused_score.launches
        first = service.predict_single(payload)
        torch.cuda.synchronize()
        launches = fused_score.launches
        dispatches = sum(r["dispatches"] for r in fresh_programs.table())
        assert launches == before + 1
        second = service.predict_single(payload)
        assert fused_score.launches == launches
        assert sum(r["dispatches"] for r in fresh_programs.table()) == dispatches
        assert second == first
        assert service.ready()[1]["score_cache"]["hits"] == 1
    finally:
        service.close()


@pytest.mark.cuda
def test_reload_warms_the_candidate_on_card(card_pack, fresh_programs):
    """A reload packs, warms and smoke-scores the candidate with the kernel:
    every program it dispatches is of kind ``kernel``, and the launches are
    its warm-up buckets plus the smoke row."""
    service = ScorerService.from_store(
        ObjectStore(str(ROOT / "artifacts")), ServeConfig(), device="cuda"
    )
    try:
        fresh_programs.reset()
        before = fused_score.launches
        result = service.reload_from_store()
        torch.cuda.synchronize()
        assert result["status"] == "ok"
        warm = service._model.warm_buckets
        assert fused_score.launches - before == len(warm["shap"]) + len(warm["margin"]) + 1
        table = fresh_programs.table()
        assert table and all(r["kind"] == "kernel" for r in table)
        assert all(r["name"].startswith("score_forest/f32/") for r in table)
        assert sum(r["dispatches"] for r in table) == fused_score.launches - before
    finally:
        service.close()


def _canary_lake(root: Path) -> ObjectStore:
    """A registry holding the committed model as v1 in ``latest`` and its
    first 150 trees as v2 in ``canary``."""
    store = ObjectStore(str(root))
    art = GBDTArtifact.load(ObjectStore(str(ROOT / "artifacts")), "models/gbdt/model_tree", "cpu")
    reg = ModelRegistry(store)
    reg.publish("gbdt", art)
    reg.promote("gbdt")
    cut = dataclasses.replace(art.forest, **{
        f.name: getattr(art.forest, f.name)[:150]
        for f in dataclasses.fields(art.forest) if f.name != "depth"
    })
    reg.publish("gbdt", dataclasses.replace(art, forest=cut))
    return store


@pytest.mark.cuda
def test_shadow_row_is_one_margin_launch_on_card(card_pack, fresh_programs, tmp_path):
    store = _canary_lake(tmp_path / "lake")
    service = ScorerService.from_store(
        store, ServeConfig(canary_enabled=True, microbatch_enabled=False, score_cache_size=0),
        device="cuda",
    )
    try:
        canary = service.canary
        assert canary.status()["loaded"] and service.model_info["version"] == "v1"
        model = canary._canary_model
        assert model.kernel == "score_forest" and model.device.type == "cuda"
        seen = []
        margin_fn = model.margin_fn
        model.margin_fn = lambda X: seen.append(X.clone()) or margin_fn(X)
        torch.cuda.synchronize()
        fresh_programs.reset()
        before = fused_score.launches
        payload = _predict_payload(11)
        resp = service.predict_single(payload)
        assert canary.flush()
        torch.cuda.synchronize()
        assert resp["model_version"] == "v1"
        assert fused_score.launches - before == 2  # the champion's SHAP call, the shadow's
        table = {r["name"]: r for r in fresh_programs.table()}
        assert table["score_forest/f32/1/margin"]["dispatches"] == 1
        assert table["score_forest/f32/1/shap"]["dispatches"] == 1
        assert all(r["kind"] == "kernel" for r in table.values())
        (X,) = seen
        margin, _ = fused_score_reference(model.pack, X, n_features=X.shape[1], with_shap=False)
        champ, shadow = list(canary._window)[0][:2]
        assert champ == resp["prob_default"]
        assert shadow == float(1.0 / (1.0 + np.exp(-float(margin[0]))))
    finally:
        service.close()


@pytest.mark.cuda
def test_promotion_reload_launches_only_kernels_on_card(card_pack, fresh_programs, tmp_path):
    store = _canary_lake(tmp_path / "lake")
    service = ScorerService.from_store(store, ServeConfig(canary_enabled=True), device="cuda")
    try:
        torch.cuda.synchronize()
        fresh_programs.reset()
        before = fused_score.launches
        result = service.promote_canary(force=True)
        torch.cuda.synchronize()
        assert result["status"] == "promoted" and result["promoted_version"] == 2
        assert service.model_info["version"] == "v2" and service._model.pack.n_trees == 150
        warm = service._model.warm_buckets
        assert fused_score.launches - before == len(warm["shap"]) + len(warm["margin"]) + 1
        table = fresh_programs.table()
        assert table and all(r["kind"] == "kernel" and r["name"].startswith("score_forest/f32/")
                             for r in table)
        assert sum(r["dispatches"] for r in table) == fused_score.launches - before
    finally:
        service.close()


def _fleet(**kw) -> ReplicaSet:
    cfg = dict(replicas=4, score_cache_size=0, supervisor_probe_interval_s=3600.0)
    return ReplicaSet.from_store(
        ObjectStore(str(ROOT / "artifacts")), ServeConfig(**{**cfg, **kw}), device="cuda"
    )


@pytest.mark.cuda
def test_fleet_launches_only_the_kernel_on_card(card_pack, fresh_programs):
    """Four replicas on the one card: every launch is the kernel's, from the
    replicas' worker threads at once, and the programs' dispatches equal the
    launches, which equal the warm-ups, micro-batches and bulk chunks."""
    before = fused_score.launches
    fleet = _fleet()
    try:
        warm = sum(len(r._model.warm_buckets["shap"]) + len(r._model.warm_buckets["margin"])
                   for r in fleet.replicas)
        assert fused_score.launches - before == warm
        assert {str(r.device) for r in fleet.replicas} == {"cuda:0"}
        assert all(r._model.kernel == "score_forest" for r in fleet.replicas)
        answers = []

        def client(seed: int) -> None:
            for i in range(8):
                answers.append(fleet.predict_single(_predict_payload(seed * 100 + i)))

        threads = [threading.Thread(target=client, args=(s,)) for s in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        X = _rows(card_pack[0], 5000, 3)
        prob = fleet.predict_proba(X)
        torch.cuda.synchronize()
        assert len(answers) == 128 and all(a["shap_values"] is not None for a in answers)
        ref = fused_score_reference(card_pack[1], torch.from_numpy(X), n_features=card_pack[2],
                                    with_shap=False)[1]
        assert float(np.abs(prob - ref.numpy()).max()) <= TOL_PROB
        routed = [int(fleet._m_routed.labels(replica=str(i)).value) for i in range(4)]
        assert sum(routed) == 129 and min(routed) > 0
        batches = sum(r.batcher.batches for r in fleet.replicas)
        launched = fused_score.launches - before
        table = fresh_programs.table()
        assert table and all(r["kind"] == "kernel" and r["name"].startswith("score_forest/f32/")
                             for r in table)
        assert sum(r["dispatches"] for r in table) == launched == warm + batches + 2
    finally:
        fleet.close()


@pytest.mark.cuda
def test_rebuilt_replica_is_bitwise_and_frees_the_old_on_card(card_pack, fresh_programs):
    """A quarantined replica healed by the supervisor: the rebuilt one's
    margins equal the old one's bit for bit, and once the old one is closed
    the bytes the live tensors asked for are what they were."""
    fleet = _fleet(replicas=2)
    try:
        X = torch.from_numpy(_rows(card_pack[0], 64, 5)).cuda()
        old_margin = fleet.replicas[1]._model.margin_fn(X)[0].clone()
        gc.collect()
        torch.cuda.synchronize()
        bytes_before = torch.cuda.memory_stats()["requested_bytes.all.current"]
        fleet.quarantine_replica(1)
        fleet.replica_health[1].manual = False  # an automatic quarantine heals
        old = fleet.replicas[1]
        assert fleet.supervisor.tick()["healed"] == 1
        assert fleet.replicas[1] is not old and fleet.replicas[1]._model.kernel == "score_forest"
        assert torch.equal(fleet.replicas[1]._model.margin_fn(X)[0], old_margin)
        del old
        for t in threading.enumerate():
            if t.name.startswith("replica-reaper-"):
                t.join(timeout=30)
        gc.collect()
        torch.cuda.synchronize()
        assert torch.cuda.memory_stats()["requested_bytes.all.current"] == bytes_before
    finally:
        fleet.close()


@pytest.mark.cuda
def test_brownout_rung_two_launches_margin_only_on_card(card_pack, fresh_programs):
    fleet = _fleet(replicas=2, brownout_max_level=5)
    try:
        fleet.brownout.engage("test")
        fleet.brownout.engage("test")
        torch.cuda.synchronize()
        fresh_programs.reset()
        before = fused_score.launches
        answers = [fleet.predict_single(_predict_payload(40 + i)) for i in range(6)]
        torch.cuda.synchronize()
        assert all(a["degraded"] is True and a["shap_values"] is None for a in answers)
        table = fresh_programs.table()
        assert table and all(r["name"].endswith("/margin") and r["kind"] == "kernel" for r in table)
        assert sum(r["dispatches"] for r in table) == fused_score.launches - before == 6
    finally:
        fleet.close()


def _busy(fleet) -> None:
    """The autoscaler reads a fast burn, whatever the telemetry says."""
    fleet.autoscaler._signals = lambda: {"fast_burn": True, "queue_wait_p95_ms": None, "util": 0.0,
                                         "queue_depth": 0, "in_flight": 0, "replicas": len(fleet.replicas)}


@pytest.mark.cuda
def test_autoscaler_scale_up_launches_only_the_kernel_on_card(card_pack, fresh_programs):
    """A scale-up packs, warms and smoke-checks the new replica on the fleet's
    card: every launch is the kernel's, the dispatches equal the launches,
    which equal its warm-ups, the smoke row and the micro-batches; the new
    replica takes traffic and its margins are the plain version's bit for
    bit."""
    fleet = _fleet(replicas=2, autoscaler_enabled=True, autoscaler_max_replicas=3)
    try:
        torch.cuda.synchronize()
        fresh_programs.reset()
        before = fused_score.launches
        batches0 = sum(r.batcher.batches for r in fleet.replicas)
        _busy(fleet)
        assert fleet.autoscaler.tick()["actions"] == ["scale_up", "retune:busy"]
        new = fleet.replicas[2]
        assert new.device == fleet.replicas[0].device == torch.device("cuda", 0)
        assert new._model.kernel == "score_forest"
        warm = len(new._model.warm_buckets["shap"]) + len(new._model.warm_buckets["margin"])
        answers = [fleet.predict_single(_predict_payload(60 + i)) for i in range(12)]
        torch.cuda.synchronize()
        assert all(a["shap_values"] is not None for a in answers)
        assert int(fleet._m_routed.labels(replica="2").value) > 0
        batches = sum(r.batcher.batches for r in fleet.replicas) - batches0
        launched = fused_score.launches - before
        table = fresh_programs.table()
        assert table and all(r["kind"] == "kernel" and r["name"].startswith("score_forest/f32/")
                             for r in table)
        assert sum(r["dispatches"] for r in table) == launched == warm + 1 + batches
        X = torch.from_numpy(_rows(card_pack[0], 64, 13)).cuda()
        ref = fused_score_reference(card_pack[1], X.cpu(), n_features=card_pack[2], with_shap=False)[0]
        assert torch.equal(new._model.margin_fn(X)[0].cpu(), ref)
    finally:
        fleet.close()


@pytest.mark.cuda
def test_autoscaler_retired_replica_frees_its_bytes_on_card(card_pack):
    """A replica added and then retired by the autoscaler: once its reaper
    thread has closed it, the bytes the live tensors asked for are what
    they were before the scale-up."""
    fleet = _fleet(replicas=2, autoscaler_enabled=True)
    try:
        gc.collect()
        torch.cuda.synchronize()
        bytes_before = torch.cuda.memory_stats()["requested_bytes.all.current"]
        assert fleet.autoscaler.force(3)["steps"] == ["up"]
        fleet.predict_proba(_rows(card_pack[0], 300, 17))
        assert fleet.autoscaler.force(2)["steps"] == ["down"]
        for t in threading.enumerate():
            if t.name.startswith("replica-retire-"):
                t.join(timeout=30)
        gc.collect()
        torch.cuda.synchronize()
        assert torch.cuda.memory_stats()["requested_bytes.all.current"] == bytes_before
    finally:
        fleet.close()


@pytest.mark.cuda
def test_retune_wide_shap_buckets_match_plain_on_card(card_pack, fresh_programs):
    """After the busy retune (5 ms, 256 rows) queued rows coalesce into the
    128- and 256-row SHAP buckets, which are never warmed: each is one
    kernel launch, its margins the plain version's bit for bit, prob within
    1e-6 and SHAP within 1e-5."""
    fleet = _fleet(replicas=2, autoscaler_enabled=True)
    try:
        fleet.autoscaler._retune(busy=True, summary={"actions": []})
        rep = fleet.replicas[0]
        assert (rep.batcher._max_wait_s, rep.batcher._max_rows) == (0.005, 256)
        assert max(rep._model.warm_buckets["shap"]) == 64
        seen = []
        shap_fn = rep._model.shap_fn
        rep._model.shap_fn = lambda X: seen.append((X.clone(), out := shap_fn(X))) or out
        torch.cuda.synchronize()
        fresh_programs.reset()
        for n in (100, 200):
            answers = []
            with rep.batcher.pause():
                threads = [threading.Thread(
                    target=lambda i=i: answers.append(rep.predict_single(_predict_payload(900 + i))))
                    for i in range(n)]
                for t in threads:
                    t.start()
                while rep.batcher.queue_depth() < n:
                    time.sleep(0.01)
            for t in threads:
                t.join(timeout=60)
            assert len(answers) == n and all(a["shap_values"] is not None for a in answers)
        rep._model.shap_fn = shap_fn
        torch.cuda.synchronize()
        table = {r["name"]: r["dispatches"] for r in fresh_programs.table()}
        assert table == {"score_forest/f32/128/shap": 1, "score_forest/f32/256/shap": 1}
        assert [X.shape[0] for X, _ in seen] == [128, 256]
        for X, (margin, prob, phis, base) in seen:
            ref = fused_score_reference(card_pack[1], X.cpu(), n_features=card_pack[2])
            assert torch.equal(margin.cpu(), ref[0])
            assert float((prob.cpu() - ref[1]).abs().max()) <= TOL_PROB
            assert float((phis.cpu() - ref[2]).abs().max()) <= TOL_SHAP
    finally:
        fleet.close()


@pytest.mark.cuda
def test_sampled_fleet_waits_on_no_event_but_the_pools_oldest_on_card(card_pack, fresh_programs,
                                                                     monkeypatch):
    """Four replicas under 16 clients while the fleet's history sampler
    renders every registry each 20 ms (resolving the program table's event
    pairs from its own thread): no device or stream synchronisation, and
    event waits only beyond the pool's bound."""
    fleet = _fleet(history_interval_s=0.02, history_tiers=((0.05, 400), (1.0, 60)))
    try:
        torch.cuda.synchronize()
        fresh_programs.reset()
        calls = {"device": 0, "stream": 0, "event": 0}
        real = {"device": torch.cuda.synchronize, "stream": torch.cuda.Stream.synchronize,
                "event": torch.cuda.Event.synchronize}

        def count(kind):
            def wrapped(*args, **kwargs):
                calls[kind] += 1
                return real[kind](*args, **kwargs)

            return wrapped

        monkeypatch.setattr(torch.cuda, "synchronize", count("device"))
        monkeypatch.setattr(torch.cuda.Stream, "synchronize", count("stream"))
        monkeypatch.setattr(torch.cuda.Event, "synchronize", count("event"))
        before = fused_score.launches
        fleet.start_history()
        answers = []

        def client(seed: int) -> None:
            for i in range(8):
                answers.append(fleet.predict_single(_predict_payload(seed * 100 + i)))

        threads = [threading.Thread(target=client, args=(s,)) for s in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        fleet.history.stop()
        launched = fused_score.launches - before
        assert len(answers) == 128 and launched > 0
        assert calls["device"] == calls["stream"] == 0
        assert calls["event"] <= max(0, launched - EVENT_POOL)
        monkeypatch.undo()
        assert fleet.history.sample_errors == 0
        names = fleet.history.series_names()
        assert any(n.startswith("cobalt_program_dispatches_total:rate|program=score_forest/") for n in names)
        assert "cobalt_replica_routed_total:rate|replica=3" in names
    finally:
        fleet.close()


def _program_seconds(reg: ProgramRegistry, name: str) -> tuple[int, float]:
    row = next((r for r in reg.table() if r["name"] == name), None)
    return (0, 0.0) if row is None else (row["dispatches"], row["dispatch_seconds"])


@pytest.mark.cuda
def test_replicas_launch_on_their_own_streams_on_card(card_pack, fresh_programs):
    """Each card replica launches on its own CUDA stream (neither the other's
    nor the default one). While replica 1 floods the card with 1024-row
    launches from two threads, replica 0's single 64-row SHAP launch reads
    on its program at most 2x its seconds per launch on the idle card (the
    median of 5 such single launches), not the flood's; every launch's
    margins equal, bit for bit, those of the same rows launched alone."""
    fleet = _fleet(replicas=2)
    try:
        replicas = fleet.replicas
        streams = [r.stream.cuda_stream for r in replicas]
        assert len({*streams, torch.cuda.default_stream().cuda_stream}) == 3
        seen: list[list] = [[], []]

        def recording(i, fn):
            def wrapped(X):
                out = fn(X)
                seen[i].append((torch.cuda.current_stream().cuda_stream, X.shape[0], out[0].clone()))
                return out
            return wrapped

        for i, r in enumerate(replicas):
            r._model.margin_fn = recording(i, r._model.margin_fn)
            r._model.shap_fn = recording(i, r._model.shap_fn)
        pack, _, F = card_pack
        Xa, Xf = _rows(pack, 64, 21), _rows(pack, 1024, 22)
        alone = {n: fused_score(pack, torch.from_numpy(X).cuda(), n_features=F, with_shap=False)[0].cpu()
                 for n, X in ((64, Xa), (1024, Xf))}
        for _ in range(3):
            replicas[0]._model.score(Xa, with_shap=True)  # warm
        torch.cuda.synchronize()
        fresh_programs.reset()
        name = "score_forest/f32/64/shap"
        for _ in range(20):
            replicas[0]._model.score(Xa, with_shap=True)
        n_idle, s_idle = _program_seconds(fresh_programs, name)
        assert n_idle == 20
        idle = s_idle / n_idle
        stop = threading.Event()
        flood_calls = [0, 0]

        def flood(j: int) -> None:
            while not stop.is_set():
                replicas[1]._model.score(Xf, with_shap=False)
                flood_calls[j] += 1

        under_flood = []
        threads = [threading.Thread(target=flood, args=(j,)) for j in range(2)]
        for t in threads:
            t.start()
        try:
            for _ in range(5):
                time.sleep(0.1)
                before = _program_seconds(fresh_programs, name)
                replicas[0]._model.score(Xa, with_shap=True)
                after = _program_seconds(fresh_programs, name)
                assert after[0] - before[0] == 1
                under_flood.append(after[1] - before[1])
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=60)
        torch.cuda.synchronize()
        flood_n, flood_s = _program_seconds(fresh_programs, "score_forest/f32/1024/margin")
        assert min(flood_calls) > 0 and flood_n == sum(flood_calls)
        median = float(np.median(under_flood))
        print(f"replica 0 64-row SHAP: idle {idle * 1e3:.6f} ms, under the flood "
              f"{[round(t * 1e3, 6) for t in under_flood]} ms; a flood launch "
              f"{flood_s / flood_n * 1e3:.6f} ms x {flood_n}")
        assert median <= 2.0 * idle, (
            f"replica 0's 64-row SHAP launch read {median * 1e3:.4f} ms under the flood "
            f"({[round(s * 1e3, 4) for s in under_flood]}), {idle * 1e3:.4f} ms idle; "
            f"a flood launch {flood_s / flood_n * 1e3:.4f} ms")
        for i in range(2):
            assert seen[i] and {s for s, _, _ in seen[i]} == {streams[i]}
            for _, n, margin in seen[i]:
                assert torch.equal(margin.cpu(), alone[n])
        assert [n for _, n, _ in seen[0]] == [64] * 28
        assert [n for _, n, _ in seen[1]] == [1024] * sum(flood_calls)
    finally:
        fleet.close()


def _challengers(F: int, vocab: tuple[int, ...]) -> dict:
    from cobalt_smart_lender_ai_tpu_torch.models.ft_transformer import FTTransformer
    from cobalt_smart_lender_ai_tpu_torch.models.nn import MLP, seeded_generator
    from cobalt_smart_lender_ai_tpu_torch.models.tabnet import TabNet

    return {
        "mlp": MLP(F, (32, 16), generator=seeded_generator(1)),
        "ft_transformer": FTTransformer(F, vocab, d_token=16, n_blocks=2, n_heads=4, dropout=0.0,
                                        generator=seeded_generator(2)),
        "tabnet": TabNet(F, n_steps=3, width=8, generator=seeded_generator(3)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["mlp", "ft_transformer", "tabnet"])
def test_challenger_matches_the_cpu_on_card(card, family):
    """A challenger with one set of weights gives the CPU's logits on the
    card (within 1e-4), and 3 epochs of full-batch training from them give
    the CPU's losses (within 1e-5 relative) and weights (within 1e-4, the
    attentive layers within lr per update)."""
    import copy

    from cobalt_smart_lender_ai_tpu_torch.models.train_loop import TrainSettings, fit_binary

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(5)
    F, vocab, N = 12, (5, 7), 512
    Xn = rng.normal(size=(N, F)).astype(np.float32)
    Xc = np.stack([rng.integers(0, v, N) for v in vocab], axis=1)
    y = (Xn[:, 0] + 0.5 * rng.normal(size=N) > 0).astype(np.float32)
    cpu_model = _challengers(F, vocab)[family]
    card_model = copy.deepcopy(cpu_model).to(card)

    def batch(dev):
        xn = torch.from_numpy(Xn).to(dev)
        return (xn, torch.from_numpy(Xc).to(dev)) if family == "ft_transformer" else xn

    def apply(model):
        if family == "ft_transformer":
            return lambda b, gen: model(*b, gen)
        if family == "tabnet":
            return lambda b, gen: (lambda o: (o[0], 1e-3 * o[1]))(model(b))
        return lambda b, gen: model(b)

    with torch.no_grad():
        got = apply(card_model)(batch(card), None)
        want = apply(cpu_model)(batch("cpu"), None)
    got, want = (g[0] if isinstance(g, tuple) else g for g in (got, want))
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    settings = TrainSettings(batch_size=N, epochs=3, learning_rate=1e-2, l2=1e-4)
    hist = {}
    for dev, model in (("cpu", cpu_model), (card, card_model)):
        hist[str(dev)] = fit_binary(model, batch(dev), torch.from_numpy(y).to(dev), settings,
                                    apply_fn=apply(model))
    np.testing.assert_allclose(hist[str(card)]["loss"], hist["cpu"]["loss"], rtol=1e-5)
    for (k, a), b in zip(card_model.state_dict().items(), cpu_model.state_dict().values()):
        # The attentive layers' near-zero or support-flipping gradients
        # (FT's key bias, TabNet's attn.*) become Adam steps of up to lr.
        attentive = k.endswith("attn.key.bias") or (family == "tabnet" and k.startswith("attn."))
        tol = settings.learning_rate * 3 if attentive else 1e-4
        assert float((a.cpu() - b).abs().max()) <= tol, k


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", *QUANTIZED])
@pytest.mark.parametrize("rows", [1, 64, 2048])
def test_shap_phis_are_the_same_bits_on_every_launch_on_card(card_pack, card_quantized_packs,
                                                              rows, precision):
    """Five SHAP launches over the same rows give the same phis bit for bit
    (a tree's contributions are summed in integers, so the order in which
    the warps' atomics land does not matter)."""
    pack, _, F = card_pack
    if precision != "f32":
        pack = card_quantized_packs[precision][0]
    X = torch.from_numpy(_rows(pack, rows, seed=rows + 7)).cuda()
    first = fused_score(pack, X, n_features=F, with_shap=True)
    for _ in range(4):
        again = fused_score(pack, X, n_features=F, with_shap=True)
        assert torch.equal(again[0], first[0])
        assert torch.equal(again[2], first[2])


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [2048, 4096])
def test_portfolio_shap_buckets_match_plain_on_card(card_pack, rows):
    """The portfolio's 2048-row and bulk SHAP's 4096-row SHAP launches: the
    plain version's margins bit for bit (on the card and on the CPU), prob
    within 1e-6, phis within 1e-5, additivity within 1e-4; and the SHAP
    launch's margins equal the margin-only launch's bit for bit (the engine
    takes its scores from the SHAP launch's margins)."""
    pack, cpu_pack, F = card_pack
    Xn = _rows(pack, rows, seed=rows + 1)
    _assert_kernel_matches_plain(pack, cpu_pack, Xn, with_shap=True)
    X = torch.from_numpy(Xn).cuda()
    shap_margin = fused_score(pack, X, n_features=F, with_shap=True)[0]
    assert torch.equal(shap_margin, fused_score(pack, X, n_features=F, with_shap=False)[0])


@pytest.mark.cuda
def test_portfolio_sweep_on_card_is_one_shap_launch_per_chunk(card_pack, fresh_programs, tmp_path):
    """A sweep of the committed model on the card: one SHAP launch per
    chunk on ``score_forest/f32/2048/shap``, scores bitwise the CPU engine's
    margin-only sweep (the same margins, the same host sigmoid), each
    chunk's ``phi_sum`` within 1e-5 per row of the plain version's on the
    card; killed after 2 chunks and resumed, every chunk's arrays the
    uninterrupted run's bit for bit."""
    from cobalt_smart_lender_ai_tpu_torch.scenario import (
        PortfolioInterrupted,
        PortfolioScorer,
        ScenarioGrid,
        feature_delta,
    )

    pack, _, _ = card_pack
    store = ObjectStore(str(tmp_path))
    art = GBDTArtifact.load(ObjectStore(str(ROOT / "artifacts")), "models/gbdt/model_tree", "cuda")
    X = _rows(pack, 5000, seed=29)
    grid = ScenarioGrid([feature_delta("installment", [25.0, 100.0])])

    def chunks(report):
        prefix = f"scenario_runs/{report['run_id']}/chunks/"
        return {k[len(prefix):]: store.load_arrays(k) for k in sorted(store.list(prefix))
                if k.endswith(".npz")}

    before = fused_score.launches
    card = PortfolioScorer(art, store, device="cuda").run(X, grid, run_id="card")
    torch.cuda.synchronize()
    assert fused_score.launches - before == 3 * 3
    table = {r["name"]: r["dispatches"] for r in fresh_programs.table()}
    assert table == {"score_forest/f32/2048/shap": 9}
    cpu_art = GBDTArtifact.load(ObjectStore(str(ROOT / "artifacts")), "models/gbdt/model_tree", "cpu")
    cpu = PortfolioScorer(cpu_art, store, device="cpu", compute_shap=False).run(X, grid, run_id="cpu")
    got, want = chunks(card), chunks(cpu)
    assert list(got) == list(want)
    for key in got:
        assert np.array_equal(got[key]["scores"], want[key]["scores"]), key
    for si, scenario in enumerate([None, *grid.expand()]):
        for ci in range(3):
            rows = X[ci * 2048:(ci + 1) * 2048]
            rows = rows if scenario is None else scenario.apply(rows, art.feature_names)
            phis = fused_score_reference(pack, torch.from_numpy(rows).cuda(), n_features=pack.n_features)[2]
            want_sum = phis.double().sum(0).cpu().numpy()
            assert np.abs(got[f"s{si:03d}_c{ci:05d}.npz"]["phi_sum"] - want_sum).max() <= TOL_SHAP * len(rows)
    with pytest.raises(PortfolioInterrupted):
        PortfolioScorer(art, store, device="cuda").run(X, grid, run_id="kill", fail_after_chunks=2)
    resumed = PortfolioScorer(art, store, device="cuda").run(X, grid, run_id="kill", resume=True)
    assert resumed["resume"]["chunks_resumed"] == 2
    again = chunks(resumed)
    for key in got:
        for name in ("scores", "phi_sum", "base"):
            assert np.array_equal(got[key][name], again[key][name]), (key, name)


@pytest.mark.cuda
def test_shap_bulk_on_card_matches_plain(card_pack, fresh_programs):
    """`ScorerService.shap_bulk` on the card: one SHAP launch per chunk (a
    4096-row bucket and the tail's 1024), each chunk's phis within 1e-5 of
    the plain version's on the same card rows."""
    pack, _, F = card_pack
    service = ScorerService.from_store(
        ObjectStore(str(ROOT / "artifacts")), ServeConfig(microbatch_enabled=False), device="cuda")
    try:
        X = _rows(pack, 5000, seed=31)
        torch.cuda.synchronize()
        fresh_programs.reset()
        before = fused_score.launches
        phis, base = service.shap_bulk(X)
        torch.cuda.synchronize()
        assert fused_score.launches - before == 2
        table = {r["name"]: r["dispatches"] for r in fresh_programs.table()}
        assert table == {"score_forest/f32/4096/shap": 1, "score_forest/f32/1024/shap": 1}
        model_pack = service._model.pack
        for lo, hi in ((0, 4096), (4096, 5000)):
            ref = fused_score_reference(model_pack, torch.from_numpy(X[lo:hi]).cuda(), n_features=F)
            assert float(np.abs(phis[lo:hi] - ref[2].cpu().numpy()).max()) <= TOL_SHAP
            assert abs(base - float(ref[3])) <= TOL_SHAP
    finally:
        service.close()


# -- the mesh: the card named several times, each shard on its own stream ----


def _nan_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-equal, NaN where the other is NaN."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("J", [1, 3])
def test_sharded_histogram_is_one_launch_on_card(card, n_shards, J):
    """The sharded entry over 1, 2 and 4 shards of the card gives the bits
    of one `gradient_histogram_jobs` launch over all rows, a NaN in the
    last shard's rows of one job included, one accumulate launch a shard."""
    N, K, B = 50_001, 64, 255
    bins, node, g, h, w = _jobs_inputs(40 + J, J, N, 20, B, K, np.uint8)
    g[J - 1, N - 3] = np.nan
    h[0, N - 7] = np.inf
    t = [torch.from_numpy(a).to(card) for a in (bins, node, g, h, w)]
    one = torch.stack(gradient_histogram_jobs(*t, n_nodes=K, n_bins=B))
    dp = make_mesh(MeshConfig(), devices=[card] * n_shards).row_shards(0, N)
    parts = [(dp.split(t[0])[s], *(x.narrow(1, a, b - a).contiguous() for x in t[1:]))
             for s, (a, b) in enumerate(dp.bounds)]
    before = histogram_accumulate.launches
    got = torch.stack(gradient_histogram_sharded(parts, n_nodes=K, n_bins=B, n_rows=N, run=dp.run))
    torch.cuda.synchronize()
    assert histogram_accumulate.launches == before + n_shards
    assert bool(torch.isnan(one).any())
    assert _nan_equal(got, one)


@pytest.mark.cuda
def test_dp_fit_first_tree_is_the_direct_fit_on_card(card):
    """fit_binned_dp over the card named four times: the first tree's
    splits equal the single-device direct fit's (exact histograms, the
    same column sample), the margins within 1e-4."""
    rng = np.random.default_rng(19)
    N, F, B = 40_000, 10, 64
    bins = torch.from_numpy(rng.integers(0, B, (N, F)).astype(np.uint8)).to(card)
    y = torch.from_numpy((rng.random(N) < 0.3).astype(np.float32)).to(card)
    hp = GBDTHyperparams(learning_rate=0.3, gamma=0.0, reg_lambda=1.0, min_child_weight=1.0,
                         scale_pos_weight=2.0, subsample=1.0, colsample_bytree=0.8,
                         n_estimators=6, max_depth=5)
    kw = dict(n_trees_cap=6, depth_cap=5, n_bins=B)
    mesh = make_mesh(MeshConfig(), devices=[card] * 4)
    dp_forest = fit_binned_dp(mesh, bins, y, None, None, hp, 7, **kw)
    one = fit_binned_dp(make_mesh(MeshConfig(), devices=[card]), bins, y, None, None, hp, 7,
                        hist_subtract=False, **kw)
    for f in ("feature", "thr_bin", "missing_left"):
        assert torch.equal(getattr(dp_forest, f)[0], getattr(one, f)[0]), f
    diff = predict_margin(dp_forest, bins, use_binned=True) - predict_margin(one, bins, use_binned=True)
    assert float(diff.abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", *QUANTIZED])
def test_mesh_partitioner_is_the_single_device_on_card(card_pack, precision):
    """`MeshPartitioner` over the card named four times (each shard on its
    own stream): margins, prob, phis and base bit for bit
    `SingleDevicePartitioner`'s, one launch a shard."""
    pack, _, F = card_pack
    if precision != "f32":
        art = GBDTArtifact.load(ObjectStore(str(ROOT / "artifacts")), "models/gbdt/model_tree", "cuda")
        pack = pack_forest(art.forest, F, precision)
    rows = 4 * 512
    X = torch.from_numpy(_rows(pack, rows, seed=23)).cuda()
    want = SingleDevicePartitioner("cuda").compile_fused(pack, F, rows)(X)
    before = fused_score.launches
    got = MeshPartitioner([pack.device] * 4).compile_fused(pack, F, rows)(X)
    torch.cuda.synchronize()
    assert fused_score.launches == before + 4
    for k in range(3):
        assert torch.equal(got[k], want[k]), k
    assert float(got[3]) == float(want[3])


_BUILD_PROBE = """
import json, sys
from concurrent.futures import ThreadPoolExecutor
from cobalt_smart_lender_ai_tpu_torch import native
from cobalt_smart_lender_ai_tpu_torch.compilecache import bootstrap_compile_cache, compile_stats
from cobalt_smart_lender_ai_tpu_torch.config import CompileCacheConfig
from cobalt_smart_lender_ai_tpu_torch.ops import _build
cache = bootstrap_compile_cache(CompileCacheConfig(cache_dir=sys.argv[1]))
with ThreadPoolExecutor(3) as pool:
    reader = pool.submit(native._build)
    list(pool.map(_build.load, ["score_forest", "gradient_histogram"]))
    reader.result()
print(json.dumps({"cache": cache, **compile_stats()}))
"""


@pytest.mark.cuda
def test_second_process_loads_the_kernels_from_the_build_cache_on_card(card, tmp_path):
    """Two processes over one cache directory: the first compiles the two
    nvcc libraries and the g++ reader (3 misses, 3 builds), the second
    finds all three (3 hits, nothing built, their build seconds saved)."""
    import json
    import subprocess
    import sys

    def probe() -> dict:
        proc = subprocess.run([sys.executable, "-c", _BUILD_PROBE, str(tmp_path / "cache")], cwd=ROOT,
                              capture_output=True, text=True, timeout=900)
        assert proc.returncode == 0, proc.stderr
        return json.loads(proc.stdout.strip().splitlines()[-1])

    first, second = probe(), probe()
    assert first["cache"] == second["cache"] == str(tmp_path / "cache")
    assert (first["cache_misses"], first["backend_compiles"], first["cache_hits"]) == (3, 3, 0)
    assert (second["cache_misses"], second["backend_compiles"], second["cache_hits"]) == (0, 0, 3)
    assert second["cache_saved_seconds"] == pytest.approx(first["backend_compile_seconds"])
    assert second["backend_compile_seconds"] == 0.0


@pytest.mark.cuda
def test_profile_trace_records_the_shap_kernel_on_card(card_pack, tmp_path):
    """`debug.profile_trace` on the card records CUDA activity: after 8
    warm-up calls (a session loses its first launches' records), 16 SHAP
    calls at 64 rows leave device records of ``shap_kernel<7>`` and
    ``score_finalize_kernel`` in the written trace."""
    import glob
    import json

    from cobalt_smart_lender_ai_tpu_torch.debug import profile_trace

    pack, _, F = card_pack
    X = torch.from_numpy(_rows(pack, 64, seed=31)).cuda()
    for _ in range(8):
        fused_score(pack, X, n_features=F, with_shap=True)
    torch.cuda.synchronize()
    with profile_trace(str(tmp_path / "trace")):
        for _ in range(16):
            fused_score(pack, X, n_features=F, with_shap=True)
        torch.cuda.synchronize()
    (path,) = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    events = json.loads(Path(path).read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert any("shap_kernel<7>" in k for k in kernels), sorted(set(kernels))
    assert any("score_finalize_kernel" in k for k in kernels), sorted(set(kernels))


@pytest.mark.cuda
def test_train_artifact_on_card_loads_and_serves(card, tmp_path):
    """``tools.train_artifact`` at 20,000 rows on the card: one histogram
    launch per tree level (300 x 7), an artifact the card service restores
    and serves, its margins those of the plain scorer on the CPU."""
    from cobalt_smart_lender_ai_tpu_torch.tools import train_artifact

    before = gradient_histogram_channels.launches
    run = train_artifact.main(["--rows", "20000", "--out", str(tmp_path / "lake"), "--device", "cuda"])
    assert gradient_histogram_channels.launches - before == 300 * 7
    assert 0.5 < run["test_auc"] <= 1.0
    store = ObjectStore(str(tmp_path / "lake"))
    service = ScorerService.from_store(store, ServeConfig(), device="cuda")
    cpu = ScorerService.from_store(store, ServeConfig(microbatch_enabled=False), device="cpu")
    try:
        payload = {n: 1 if n in schema.SERVING_INT_FEATURES else 0.5 for n in schema.SERVING_FEATURES}
        got, want = service.predict_single(payload), cpu.predict_single(payload)
        assert abs(got["prob_default"] - want["prob_default"]) <= TOL_PROB
        assert np.allclose(got["shap_values"], want["shap_values"], atol=TOL_SHAP)
    finally:
        service.close()
        cpu.close()


@pytest.mark.cuda
def test_profile_trace_keeps_every_launch_on_card(card_pack, tmp_path):
    """`debug.profile_trace` opens its card session with spin kernels and a
    synchronize, so each of 20 sessions of 24 SHAP launches at 64 rows
    keeps 24 records of ``shap_kernel<7>`` and 24 of
    ``score_finalize_kernel`` (the tracer drops a burst of first records
    in some sessions only)."""
    import glob
    import json

    from cobalt_smart_lender_ai_tpu_torch.debug import profile_trace

    pack, _, F = card_pack
    X = torch.from_numpy(_rows(pack, 64, seed=33)).cuda()
    fused_score(pack, X, n_features=F, with_shap=True)
    torch.cuda.synchronize()
    kept = []
    for i in range(20):
        with profile_trace(str(tmp_path / f"trace{i}")):
            for _ in range(24):
                fused_score(pack, X, n_features=F, with_shap=True)
            torch.cuda.synchronize()
        (path,) = glob.glob(str(tmp_path / f"trace{i}" / "*.pt.trace.json"))
        events = json.loads(Path(path).read_text())["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        kept.append((sum("shap_kernel<7>" in k for k in kernels),
                     sum("score_finalize_kernel" in k for k in kernels)))
    assert kept == [(24, 24)] * 20, kept


@pytest.mark.cuda
def test_tree_explainer_on_card_matches_plain(card_pack):
    """`explain.TreeExplainer` over the committed model on the card: one
    SHAP launch a chunk (1,000 rows at 256: 4), its phis within 1e-5 of the
    same facade's on the CPU (the plain version), its base value the CPU's
    within 1e-6, and ``expected_value + Σ phi`` within 1e-4 of the margin."""
    from cobalt_smart_lender_ai_tpu_torch.explain import TreeExplainer

    pack, _, F = card_pack
    art = GBDTArtifact.load(ObjectStore(str(ROOT / "artifacts")), "models/gbdt/model_tree", "cuda")
    models = {}
    for device in ("cuda", "cpu"):
        models[device] = GBDTClassifier(device=device)
        models[device].forest = art.forest.to(device)
        models[device].n_features_ = F
    Xn = _rows(pack, 1000, seed=35)
    before = fused_score.launches
    card = TreeExplainer(models["cuda"])
    phis = card.shap_values(torch.from_numpy(Xn).cuda(), chunk_size=256)
    assert fused_score.launches - before == 4
    cpu = TreeExplainer(models["cpu"])
    want = cpu.shap_values(Xn, chunk_size=256)
    assert phis.shape == (1000, F)
    np.testing.assert_allclose(phis, want, rtol=0, atol=TOL_SHAP)
    assert abs(card.expected_value - cpu.expected_value) <= 1e-6
    margin = models["cpu"].predict_margin(Xn).numpy()
    np.testing.assert_allclose(card.expected_value + phis.astype(np.float64).sum(axis=1), margin,
                               rtol=0, atol=1e-4)
