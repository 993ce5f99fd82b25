"""The search's job axis against the JAX package's, on the CPU.

The reference runs a search bucket as one program: every (candidate, fold)
job advances together under ``jax.vmap`` (``parallel/tune.py``'s
``_make_cv_runner``), and the histogram of a level is one joint op for all
jobs (``ops/histogram.py``'s ``_hist_matmul_jobs``, through the vmap rule of
``_channels_matmul_vmappable``). The port's counterparts:

- `gradient_histogram_jobs_reference`, the plain J-job histogram (what
  `gradient_histogram_jobs` runs on CPU tensors): bit for bit J single plain
  calls; per job within 1e-5 of the largest |value| of the channel of the
  JAX package's ``_hist_segsum`` (the tolerance of
  ``test_torch_histogram.py``; the cover exact); bit for bit the JAX
  package's ``_hist_matmul_jobs`` on small-integer g, h and w (exact in
  bf16, so its cast drops out), its ``(F, B, J, 3, K)`` read as three
  ``(J, K, F, B)``;
- `fit_binned_jobs`, the batched level loop: each job's forest and margin
  bit for bit those of its own `fit_binned_resumable`, for J = 1, 3 and 7;
- `cross_validate_gbdt`, which runs a bucket's jobs through one
  `fit_binned_jobs` call per chunk: every job's AUC within 1e-4 of the JAX
  package's ``cross_validate_gbdt`` on a 1-device mesh (candidates that
  draw nothing at random, direct histograms). Not 1e-6: the port's plain
  histogram rounds float64 sums once, the reference's segment sum adds in
  float32, and over 10 trees a near-tie between two thresholds can go
  either way (1.08e-5 on one job of nine here; the reference's vmapped
  program itself equals its unbatched fits bit for bit). 1e-4 is
  ``chip_smoke.py``'s tolerance for the same drift between the card's
  sums and the CPU's;
- the runner's accounting: the reference's ``cobalt_search_*`` families and
  ``search.cv_runner[...]`` program rows, and a run ledger whose program
  rows hold each second of the search once.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cobalt_smart_lender_ai_tpu.config import GBDTConfig as JaxGBDTConfig
from cobalt_smart_lender_ai_tpu.config import MeshConfig as JaxMeshConfig
from cobalt_smart_lender_ai_tpu.ops.histogram import _hist_matmul_jobs, _hist_segsum
from cobalt_smart_lender_ai_tpu.parallel import tune as jax_tune
from cobalt_smart_lender_ai_tpu.parallel.mesh import make_mesh
from cobalt_smart_lender_ai_tpu.telemetry import metrics as jax_metrics
from cobalt_smart_lender_ai_tpu_torch.config import GBDTConfig, TuneConfig
from cobalt_smart_lender_ai_tpu_torch.models.gbdt import (
    GBDTHyperparams,
    fit_binned_jobs,
    fit_binned_resumable,
)
from cobalt_smart_lender_ai_tpu_torch.ops.binning import compute_bin_edges, transform
from cobalt_smart_lender_ai_tpu_torch.ops.histogram import (
    gradient_histogram_jobs,
    gradient_histogram_jobs_reference,
    gradient_histogram_reference,
    histogram_cost,
)
from cobalt_smart_lender_ai_tpu_torch.parallel import tune
from cobalt_smart_lender_ai_tpu_torch.telemetry import metrics as port_metrics
from cobalt_smart_lender_ai_tpu_torch.telemetry.programs import (
    ProgramRegistry,
    set_default_program_registry,
)
from cobalt_smart_lender_ai_tpu_torch.telemetry.runledger import RunLedger

TOL = 1e-5
#: Port against reference CV scores: histogram sums rounded otherwise.
CV_AUC_TOL = 1e-4
FOREST_FIELDS = ("feature", "thr_bin", "thr_float", "missing_left", "gain", "cover", "leaf_value")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _job_inputs(J, N, F, B, K, seed, *, small_ints=False):
    """Seeded level inputs of J jobs over one bins matrix, a third of each
    job's rows at weight 0 (its fold), and a few rows outside the nodes."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, (N, F)).astype(np.uint8 if B <= 256 else np.int32)
    node = rng.integers(0, K, (J, N)).astype(np.int32)
    node[rng.random((J, N)) < 0.02] = -1
    node[rng.random((J, N)) < 0.02] = K
    if small_ints:
        g = rng.integers(-4, 5, (J, N)).astype(np.float32)
        h = rng.integers(0, 4, (J, N)).astype(np.float32)
    else:
        g = (rng.normal(size=(J, N)) * rng.uniform(0.5, 4.0, (J, 1))).astype(np.float32)
        h = (np.abs(g) * 0.25 + 0.01).astype(np.float32)
    w = (rng.random((J, N)) < 0.9).astype(np.float32)
    fold = rng.random((J, N)) < 1 / 3
    g[fold], h[fold], w[fold] = 0.0, 0.0, 0.0
    return bins, node, g, h, w


HIST_CASES = [
    (1, 1200, 6, 16, 4),
    (3, 2000, 5, 32, 1),
    (3, 1500, 20, 255, 8),
    (7, 900, 4, 64, 16),
]


@pytest.mark.parametrize("J,N,F,B,K", HIST_CASES)
def test_plain_jobs_histogram_is_single_calls_bit_for_bit(J, N, F, B, K):
    bins, node, g, h, w = (torch.from_numpy(a) for a in _job_inputs(J, N, F, B, K, J + N))
    got = gradient_histogram_jobs_reference(bins, node, g, h, w, n_nodes=K, n_bins=B)
    assert got.shape == (3, J, K, F, B)
    for j in range(J):
        inside = (node[j] >= 0) & (node[j] < K)
        # The single plain call on the job's rows inside the nodes.
        single = gradient_histogram_reference(
            bins[inside], node[j][inside], g[j][inside], h[j][inside], w[j][inside],
            n_nodes=K, n_bins=B,
        )
        assert torch.equal(got[:, j], single), j
    hg, hh, hw = gradient_histogram_jobs(bins, node, g, h, w, n_nodes=K, n_bins=B)
    assert torch.equal(torch.stack([hg, hh, hw]), got)


@pytest.mark.parametrize("J,N,F,B,K", HIST_CASES)
def test_plain_jobs_histogram_matches_jax_segsum_per_job(J, N, F, B, K):
    arrays = _job_inputs(J, N, F, B, K, 2 * J + N)
    bins, node, g, h, w = arrays
    got = gradient_histogram_jobs_reference(*(torch.from_numpy(a) for a in arrays), n_nodes=K, n_bins=B)
    for j in range(J):
        inside = (node[j] >= 0) & (node[j] < K)
        ref = np.asarray(_hist_segsum(
            jnp.asarray(bins[inside]), jnp.asarray(node[j][inside]), jnp.asarray(g[j][inside]),
            jnp.asarray(h[j][inside]), jnp.asarray(w[j][inside]), K, B,
        ))  # (K, F, B, 3)
        np.testing.assert_array_equal(got[2, j].numpy(), ref[..., 2])
        for c in (0, 1):
            scale = np.abs(ref[..., c]).max()
            np.testing.assert_allclose(got[c, j].numpy(), ref[..., c], rtol=0, atol=TOL * scale)


@pytest.mark.parametrize("J,N,F,B,K", HIST_CASES)
def test_plain_jobs_histogram_is_jax_hist_matmul_jobs_on_small_integers(J, N, F, B, K):
    arrays = _job_inputs(J, N, F, B, K, 3 * J + N, small_ints=True)
    got = gradient_histogram_jobs_reference(*(torch.from_numpy(a) for a in arrays), n_nodes=K, n_bins=B)
    acc = np.asarray(_hist_matmul_jobs(*(jnp.asarray(a) for a in arrays), K, B, 512))
    assert acc.shape == (F, B, J, 3, K)
    for c in range(3):
        np.testing.assert_array_equal(got[c].numpy(), acc[:, :, :, c, :].transpose(2, 3, 0, 1))


def test_jobs_cost_counts_every_jobs_rows():
    N, F, K, B = 1000, 20, 8, 255
    one = histogram_cost(N, F, K, B, 1)
    three = histogram_cost(N, F, K, B, 1, n_jobs=3)
    # Every job's node, g, h, w and output; the shared bins once.
    assert three == (3 * one[0], 3 * one[1] - 2 * N * F)
    assert histogram_cost(N, F, K, B, 1, active_rows=700, n_jobs=3, bin_rows=400) == (
        3 * 700 * F, 16 * 3 * N + 400 * F + 3 * 3 * K * F * B * 4)
    assert histogram_cost(N, F, K, B, 1, active_rows=700) == histogram_cost(
        N, F, K, B, 1, active_rows=700, bin_rows=700)
    with pytest.raises(ValueError, match="bin_rows"):
        histogram_cost(N, F, K, B, 1, active_rows=700, n_jobs=3)


def _fit_inputs(J, seed):
    """Shared bins and labels, and J CV-like jobs: their own fold at weight
    0, carried margins and hyperparameters (learning rate, row and column
    samples, gamma, n_estimators and max_depth differ)."""
    rng = np.random.default_rng(seed)
    N, F, B = 1500, 7, 32
    bins = torch.from_numpy(rng.integers(0, B, (N, F)).astype(np.uint8))
    y = torch.from_numpy((rng.random(N) < 0.3).astype(np.float32))
    fm = torch.ones(F, dtype=torch.bool)
    fm[4] = False
    sw = torch.from_numpy((rng.random((J, N)) >= 1 / 3).astype(np.float32))
    init = torch.from_numpy(rng.normal(size=(J, N)).astype(np.float32))
    hps = [
        GBDTHyperparams(
            learning_rate=float(rng.choice([0.05, 0.1, 0.3])), gamma=float(rng.choice([0.0, 0.5, 1.0])),
            reg_lambda=1.0, min_child_weight=float(rng.choice([1.0, 3.0])), scale_pos_weight=2.5,
            subsample=float(rng.choice([0.6, 0.8, 1.0])),
            colsample_bytree=float(rng.choice([0.5, 0.8, 1.0])),
            n_estimators=int(rng.choice([4, 6, 9])), max_depth=int(rng.choice([3, 5])),
        )
        for _ in range(J)
    ]
    seeds = [int(s) for s in rng.integers(0, 2**31, J)]
    return bins, y, sw, fm, hps, seeds, init, B


@pytest.mark.parametrize("subtract", [True, False], ids=["subtract", "direct"])
@pytest.mark.parametrize("depth", [3, 5])
@pytest.mark.parametrize("J", [1, 3, 7])
def test_fit_binned_jobs_is_per_job_fits_bit_for_bit(J, depth, subtract):
    bins, y, sw, fm, hps, seeds, init, B = _fit_inputs(J, 10 * J + depth)
    hps = [dataclasses.replace(h, max_depth=min(h.max_depth, depth)) for h in hps]
    kw = dict(n_trees_cap=6, depth_cap=depth, n_bins=B, tree_offset=3, hist_subtract=subtract)
    forests, margins = fit_binned_jobs(bins, y, sw, fm, hps, seeds, init_margin=init, **kw)
    assert margins.shape == (J, bins.shape[0]) and len(forests) == J
    assert not torch.equal(margins, init)  # the jobs trained
    for j in range(J):
        forest, margin = fit_binned_resumable(bins, y, sw[j], fm, hps[j], seeds[j],
                                              init_margin=init[j], **kw)
        assert torch.equal(margin, margins[j]), j
        for f in FOREST_FIELDS:
            assert torch.equal(getattr(forest, f), getattr(forests[j], f)), (j, f)
        # Trees past the job's n_estimators are inert.
        inert = 3 + np.arange(6) >= hps[j].n_estimators
        assert not forests[j].leaf_value[torch.from_numpy(inert)].any()


def test_fit_binned_jobs_from_zero_margins_and_one_launch_per_level(monkeypatch):
    """Without ``init_margin`` the jobs start at 0, as a fit does; the level
    op is called once per level for all jobs."""
    bins, y, sw, fm, hps, seeds, _, B = _fit_inputs(3, 99)
    hps = [dataclasses.replace(h, max_depth=3) for h in hps]
    calls = []

    def counting(*args, **kw):
        calls.append(args[1].shape)
        return gradient_histogram_jobs(*args, **kw)

    forests, margins = fit_binned_jobs(bins, y, sw, fm, hps, seeds, n_trees_cap=2, depth_cap=3,
                                       n_bins=B, histogram=counting)
    assert calls == [(3, bins.shape[0])] * (2 * 3)
    for j in range(3):
        forest, margin = fit_binned_resumable(bins, y, sw[j], fm, hps[j], seeds[j], n_trees_cap=2,
                                              depth_cap=3, n_bins=B)
        assert torch.equal(margin, margins[j])
        assert torch.equal(forest.leaf_value, forests[j].leaf_value)


def test_fit_binned_jobs_refuses_mismatched_jobs():
    bins, y, sw, fm, hps, seeds, _, B = _fit_inputs(3, 5)
    with pytest.raises(ValueError, match="seeds"):
        fit_binned_jobs(bins, y, sw, fm, hps, seeds[:2], n_trees_cap=1, depth_cap=5, n_bins=B)
    with pytest.raises(ValueError, match="sample_weight"):
        fit_binned_jobs(bins, y, sw[:2], fm, hps, seeds, n_trees_cap=1, depth_cap=5, n_bins=B)


@pytest.fixture(scope="module")
def cv_data():
    """(bins, y, val) : 2000 rows x 6 columns binned at 32, NaN cells, 3
    stratified folds."""
    rng = np.random.default_rng(8)
    N, F = 2000, 6
    X = rng.normal(size=(N, F)).astype(np.float32)
    logit = 1.2 * X[:, 0] - 0.9 * X[:, 1] + 0.5 * X[:, 2] * X[:, 3] - 1.2
    y = (rng.random(N) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    Xt = torch.from_numpy(X)
    bins = transform(compute_bin_edges(Xt, n_bins=32), Xt)
    return bins, torch.from_numpy(y), tune.stratified_kfold_masks(y, 3, 22)


#: One bucket (depth 3, 10 trees) of candidates that draw nothing at random.
BUCKET = [
    {"learning_rate": 0.1},
    {"learning_rate": 0.3, "gamma": 1.0},
    {"learning_rate": 0.2, "min_child_weight": 4.0, "reg_lambda": 2.0},
]


def test_cross_validate_matches_jax_cross_validate(cv_data):
    bins, y, val = cv_data
    base = GBDTConfig(n_estimators=10, max_depth=3, n_bins=32, scale_pos_weight=2.0)
    hps = [GBDTHyperparams.from_config(base.replace(**c)) for c in BUCKET]
    got = tune.cross_validate_gbdt(bins, y, hps, torch.from_numpy(val), 22, n_bins=32,
                                   hist_subtract=False, chunk_trees=4)
    jbase = JaxGBDTConfig(n_estimators=10, max_depth=3, n_bins=32, scale_pos_weight=2.0)
    stacked, n_trees, depth = jax_tune.stack_candidates(BUCKET, jbase)
    mesh = make_mesh(JaxMeshConfig(hp=1, dp=1), devices=jax.devices()[:1])
    ref = np.asarray(jax_tune.cross_validate_gbdt(
        mesh, jnp.asarray(bins.numpy()), jnp.asarray(y.numpy()), stacked, jnp.asarray(val),
        jax.random.PRNGKey(22), n_trees_cap=n_trees, depth_cap=depth, n_bins=32,
        hist_subtract=False,
    ))
    assert got.shape == ref.shape == (3, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=CV_AUC_TOL)


@pytest.fixture
def fresh_registries(monkeypatch):
    """A program registry and a metrics registry of the test's own."""
    programs = ProgramRegistry()
    prev = set_default_program_registry(programs)
    metrics = port_metrics.MetricsRegistry()
    monkeypatch.setattr(port_metrics, "_default_registry", metrics)
    yield programs, metrics
    set_default_program_registry(prev)


def test_search_families_are_the_references(fresh_registries, monkeypatch):
    monkeypatch.setattr(jax_metrics, "_default_registry", jax_metrics.MetricsRegistry())
    port = tune._search_metrics()
    ref = jax_tune._search_metrics()
    assert set(port) == set(ref)
    for key in ref:
        assert (port[key].name, port[key].help, port[key].labelnames, port[key].kind) == (
            ref[key].name, ref[key].help, ref[key].labelnames, ref[key].kind)


def _samples(metrics, family: str) -> list[tuple[dict, float]]:
    return [(s["labels"], s["value"]) for s in metrics.snapshot()[family]["samples"]]


def test_exhaustive_runner_rows_and_counters(fresh_registries, cv_data):
    programs, metrics = fresh_registries
    bins, y, val = cv_data
    base = GBDTConfig(n_estimators=10, max_depth=3, n_bins=32)
    hps = [GBDTHyperparams.from_config(base.replace(**c)) for c in BUCKET]
    tune.cross_validate_gbdt(bins, y, hps, torch.from_numpy(val), 22, n_bins=32, chunk_trees=4)
    rows = {r["name"]: r for r in programs.table()}
    runner = rows["search.cv_runner[mode=exhaustive,depth=3,chunk=4,bins=32]"]
    assert runner["kind"] == "search" and runner["dispatches"] == 3  # chunks of 4, 4 and 2 trees
    assert runner["mode"] == "exhaustive" and runner["chunk_trees"] == 4 and runner["device"] == "cpu"
    # One plain histogram call per level for the bucket's 9 jobs together.
    hist = rows["gradient_histogram_plain/J9xF6xB32"]
    assert hist["dispatches"] == 10 * 3 and hist["rows"] == 9 * bins.shape[0] * 10 * 3
    ((labels, wall),) = _samples(metrics, "cobalt_search_dispatch_seconds")
    assert labels == {"mode": "exhaustive"} and wall > 0
    # Each second once: the runner's row holds the loop's seconds outside
    # the histogram calls, which their own row holds.
    assert runner["dispatch_seconds"] + hist["dispatch_seconds"] == pytest.approx(wall, abs=2e-6)
    assert 0 < runner["dispatch_seconds"] < wall


def test_halving_rows_counters_and_ledger_attribute_each_second_once(fresh_registries, cv_data):
    programs, metrics = fresh_registries
    bins, y, val = cv_data
    cands = [
        {"n_estimators": 24, "max_depth": 3, "learning_rate": lr} for lr in (0.05, 0.1, 0.2, 0.3)
    ] + [{"n_estimators": 24, "max_depth": 4, "learning_rate": 0.1}]
    tune_cfg = TuneConfig(n_iter=5, cv_folds=3, chunk_trees=6)
    base = GBDTConfig(n_bins=32)
    ledger = RunLedger("search")
    split, report = tune.successive_halving_search(
        bins, y, cands, base, tune_cfg, torch.from_numpy(val), 3)
    assert report["pruned_candidates"] > 0
    assert _samples(metrics, "cobalt_search_rungs_total") == [({}, len(report["budgets"]))]
    assert _samples(metrics, "cobalt_search_pruned_candidates_total") == [
        ({}, report["pruned_candidates"])]
    assert [lab for lab, _ in _samples(metrics, "cobalt_search_dispatch_seconds")] == [{"mode": "halving"}]
    rows = {r["name"]: r for r in programs.table()}
    runners = [r for n, r in rows.items() if n.startswith("search.cv_runner[mode=halving,")]
    assert {r["name"] for r in runners} == {
        "search.cv_runner[mode=halving,depth=3,chunk=6,bins=32]",
        "search.cv_runner[mode=halving,depth=4,chunk=6,bins=32]",
    }
    assert sum(r["dispatches"] for r in runners) == report["dispatches"]
    assert all(r["dispatch_seconds"] > 0 for r in runners)
    doc = ledger.finalize(registry=metrics)
    att = doc["dispatch_attribution"]
    # The search's counter is the measured seconds; the program rows (the
    # runners' and the histogram's) add up to it, each second once.
    assert att["measured_seconds"] > 0
    assert att["attributed_seconds"] == pytest.approx(att["measured_seconds"], abs=1e-5)
    assert att["ratio"] == pytest.approx(1.0, abs=2e-4)
    hist = sum(r["dispatch_seconds"] for n, r in rows.items() if n.startswith("gradient_histogram"))
    assert 0 < hist < att["measured_seconds"]


def test_fit_timing_needs_the_card_and_seeds_its_rows(monkeypatch):
    from cobalt_smart_lender_ai_tpu_torch.tools import fit_timing

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        fit_timing.main(["--rows", "100"])
    X, y = fit_timing._rows(2000, 10, 3)
    X2, y2 = fit_timing._rows(2000, 10, 3)
    np.testing.assert_array_equal(X, X2)
    np.testing.assert_array_equal(y, y2)
    assert X.shape == (2000, 10) and set(np.unique(y)) == {0.0, 1.0}
    missing = np.isnan(X).mean(axis=0)
    assert (missing[1:5] == 0).all() and 0.07 < missing[0] < 0.13 and 0.07 < missing[5] < 0.13
