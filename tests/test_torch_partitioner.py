"""Mesh-sharded bulk scoring in the port: `parallel.partitioner` and its
service, engine and ingest integration, mirroring the JAX package's
``tests/test_partitioner.py``.

The mesh names the CPU eight times (`device.mesh_devices`, the seam that
``chip_smoke.py`` points at the one card), as ``tests/conftest.py`` gives
the JAX package eight virtual devices. Tolerances: margins and SHAP
contributions from a 4-shard mesh equal the single device's bit for bit
(``np.array_equal``): each row's result depends only on that row, and the
port's SHAP sums are deterministic (the reference's mesh SHAP is not, fault
R2); the port's SHAP against the JAX package's single-device service within
``TOL_SHAP``. Probabilities are the kernel's: bit for bit on the card
(``tests/test_torch_cuda.py``), within ``TOL_PROB`` here, where the plain
version's ``torch.sigmoid`` takes its vectorized or its scalar path by a
row's place in the batch, and a shard's batch is a quarter of the chunk. Beside parity: the padding protocol (N not
divisible by the shard count, N smaller than the mesh), shard-count
resolution, partition rules, the deadline between dispatches, ``/readyz``;
the portfolio engine at ``shards=4`` killed and resumed at ``shards=1``
gives an uninterrupted run's chunks bit for bit; and the device ingest at
four shards gives the one-device tables bit for bit.
"""

from __future__ import annotations

from datetime import datetime

import numpy as np
import pytest
import torch

from cobalt_smart_lender_ai_tpu.config import ServeConfig as JaxServeConfig
from cobalt_smart_lender_ai_tpu.io import ObjectStore as JaxStore
from cobalt_smart_lender_ai_tpu.serve.service import ScorerService as JaxScorerService
from cobalt_smart_lender_ai_tpu_torch import device as torch_device
from cobalt_smart_lender_ai_tpu_torch.config import ServeConfig
from cobalt_smart_lender_ai_tpu_torch.data.device_pipeline import run_device_ingest, tokenize_raw_frame
from cobalt_smart_lender_ai_tpu_torch.data.synthetic import synthetic_lendingclub_frame
from cobalt_smart_lender_ai_tpu_torch.io import GBDTArtifact, ObjectStore
from cobalt_smart_lender_ai_tpu_torch.parallel.partitioner import (
    DEFAULT_RULES,
    MeshPartitioner,
    SingleDevicePartitioner,
    make_partitioner,
    match_partition_rule,
)
from cobalt_smart_lender_ai_tpu_torch.reliability.deadline import Deadline
from cobalt_smart_lender_ai_tpu_torch.reliability.errors import DeadlineExceeded
from cobalt_smart_lender_ai_tpu_torch.scenario import (
    PortfolioInterrupted,
    PortfolioScorer,
    ScenarioGrid,
    feature_delta,
)
from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService

SHARDS = 4
VISIBLE = 8
CPU = torch.device("cpu")
KEY = "models/gbdt/model_tree"
TOL_SHAP = 1e-5
TOL_PROB = 1e-7


@pytest.fixture(scope="module")
def eight_cpus():
    """The CPU named eight times as the visible devices of a mesh."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch_device, "mesh_devices", lambda device="cuda": [CPU] * VISIBLE)
        yield


def _cfg(**kw) -> ServeConfig:
    """Bulk-only service: no micro-batcher, no score cache; small chunks so
    1000 rows take several dispatches."""
    kw.setdefault("max_batch_rows", 64)
    return ServeConfig(microbatch_enabled=False, score_cache_size=0, **kw)


@pytest.fixture(scope="module")
def single_svc(serving_artifact):
    store, _ = serving_artifact
    svc = ScorerService.from_store(ObjectStore(store.uri), _cfg(bulk_shards=1), device="cpu")
    yield svc
    svc.close()


@pytest.fixture(scope="module")
def mesh_svc(serving_artifact, eight_cpus):
    store, _ = serving_artifact
    svc = ScorerService.from_store(ObjectStore(store.uri), _cfg(bulk_shards=SHARDS), device="cpu")
    yield svc
    svc.close()


# -- bit-exact parity ------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 3, 4, 37, 256, 1000])
def test_mesh_margins_bit_identical_to_single(single_svc, mesh_svc, serving_artifact, n):
    _, X = serving_artifact
    assert mesh_svc._model.bulk_part.n_shards == SHARDS
    m1 = single_svc._model.predict_margin_bulk(X[:n])
    assert m1.shape == (n,)
    assert np.array_equal(m1, mesh_svc._model.predict_margin_bulk(X[:n]))
    p1, p4 = single_svc.predict_proba(X[:n]), mesh_svc.predict_proba(X[:n])
    assert float(np.abs(p1 - p4).max()) <= TOL_PROB


@pytest.mark.parametrize("n", [1, 5, 64])
def test_mesh_shap_bit_identical_to_single(single_svc, mesh_svc, serving_artifact, n):
    store, X = serving_artifact
    phis1, base1 = single_svc.shap_bulk(X[:n])
    phis4, base4 = mesh_svc.shap_bulk(X[:n])
    assert phis1.shape == (n, single_svc._model.n_features)
    assert np.array_equal(phis1, phis4)
    assert base1 == base4
    jax_svc = JaxScorerService.from_store(
        JaxStore(store.uri),
        JaxServeConfig(prewarm_all_buckets=False, precompile_batch_buckets=(), score_cache_size=0,
                       microbatch_enabled=False, history_enabled=False),
    )
    try:
        want, want_base = jax_svc.shap_bulk(X[:n])
    finally:
        jax_svc.close()
    assert float(np.abs(phis4 - np.asarray(want)).max()) <= TOL_SHAP
    assert abs(base4 - float(want_base)) <= TOL_SHAP


def test_partitioner_level_parity(serving_artifact):
    """The same one layer down: 8 rows over a 4-way mesh, 2 a shard."""
    store, X = serving_artifact
    art = GBDTArtifact.load(ObjectStore(store.uri), KEY, "cpu")
    nf = len(art.feature_names)
    X8 = np.ascontiguousarray(X[:8, :nf], dtype=np.float32)
    single = SingleDevicePartitioner(CPU)
    mesh = MeshPartitioner([CPU] * SHARDS)
    assert torch.equal(single.compile_margin(art.forest, nf, 8)(X8), mesh.compile_margin(art.forest, nf, 8)(X8))
    phis1, base1 = single.compile_shap(art.forest, nf, 8)(X8)
    phis4, base4 = mesh.compile_shap(art.forest, nf, 8)(X8)
    assert torch.equal(phis1, phis4)
    assert float(base1) == float(base4)


# -- the padding protocol --------------------------------------------------------------


def test_chunker_pads_to_shard_multiple(mesh_svc, serving_artifact):
    """37 rows over 4 shards: ceil(37/4) = 10 rows a shard -> bucket 16 ->
    64 padded rows, n = 37 sliced back."""
    _, X = serving_artifact
    chunks = list(mesh_svc._model._bulk_chunks(np.asarray(X[:37], np.float32), None))
    assert len(chunks) == 1
    start, n, bucket, padded = chunks[0]
    assert (start, n) == (0, 37)
    assert bucket == 16
    assert padded.shape[0] == bucket * SHARDS
    assert np.all(padded[37:] == 0.0)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_fewer_rows_than_devices(mesh_svc, serving_artifact, n):
    _, X = serving_artifact
    [(start, got_n, bucket, padded)] = mesh_svc._model._bulk_chunks(np.asarray(X[:n], np.float32), None)
    assert (start, got_n, bucket) == (0, n, 1)
    assert padded.shape[0] == SHARDS
    model = mesh_svc._model
    assert np.array_equal(model.predict_margin_bulk(X[:n]), model.predict_margin_bulk(X[:8])[:n])


def test_mesh_rejects_undivisible_rows():
    mesh = MeshPartitioner([CPU] * SHARDS)
    with pytest.raises(ValueError, match="pad to shard_multiple"):
        mesh.compile_margin(None, 20, 10)
    assert mesh.shard_multiple == SHARDS


# -- the deadline between dispatches ------------------------------------------------------


class _ManualClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self) -> float:
        return self.now


def test_deadline_checked_between_sharded_dispatches(mesh_svc, serving_artifact):
    """The budget burnt during dispatch 2 of 3: the third chunk raises
    before launching, naming the row it stopped at."""
    _, X = serving_artifact
    clk = _ManualClock()
    dl = Deadline(1.0, clock=clk)
    step = mesh_svc.config.max_batch_rows * SHARDS

    def burn(rows, seconds):
        clk.now += 0.6

    with pytest.raises(DeadlineExceeded) as ei:
        mesh_svc._model.predict_margin_bulk(np.asarray(X[: step * 2 + 100], np.float32), dl, burn)
    assert f"bulk scoring, row {step * 2}/" in str(ei.value)


# -- shard-count resolution and rules ------------------------------------------------------


def test_make_partitioner_resolution(eight_cpus):
    assert isinstance(make_partitioner(0, device=CPU), SingleDevicePartitioner)
    assert isinstance(make_partitioner(1, device=CPU), SingleDevicePartitioner)
    every = make_partitioner(-1, device=CPU)
    assert isinstance(every, MeshPartitioner) and every.n_shards == VISIBLE
    assert make_partitioner(3, device=CPU).n_shards == 3
    assert make_partitioner(10 * VISIBLE, device=CPU).n_shards == VISIBLE
    assert make_partitioner(4, device=CPU, devices=[CPU]).n_shards == 1


def test_match_partition_rule():
    assert match_partition_rule(DEFAULT_RULES, "rows", "dp") == ("dp", None)
    assert match_partition_rule(DEFAULT_RULES, "X", "dp") == ("dp", None)
    assert match_partition_rule(DEFAULT_RULES, "forest", "dp") == ()
    with pytest.raises(ValueError, match="no partition rule"):
        match_partition_rule((), "rows", "dp")


def test_describe_shapes(mesh_svc, single_svc):
    assert mesh_svc._model.bulk_part.describe() == {
        "shards": SHARDS, "mesh": {"dp": SHARDS}, "devices": ["cpu"] * SHARDS}
    # The port's single-device partitioner is pinned to the service's device.
    assert single_svc._model.bulk_part.describe() == {"shards": 1, "mesh": None, "devices": ["cpu"]}


def test_readyz_reports_mesh_shape(mesh_svc, serving_artifact):
    _, X = serving_artifact
    mesh_svc.predict_proba(X[:8])
    ok, payload = mesh_svc.ready()
    assert ok
    bulk = payload["bulk"]
    assert bulk["shards"] == SHARDS and bulk["mesh"] == {"dp": SHARDS}
    assert bulk["compiled_buckets"]
    assert "cobalt_bulk_shards 4" in mesh_svc.registry.render().splitlines()


# -- the portfolio engine and the device ingest on a mesh -------------------------------


def _chunks(store: ObjectStore, report: dict) -> dict:
    """Every chunk's arrays of a finished run, by key suffix."""
    prefix = report["keys"]["report"][: -len("report.json")] + "chunks/"
    return {k[len(prefix):]: store.load_arrays(k) for k in sorted(store.list(prefix))
            if k.endswith(".npz")}


def test_engine_on_four_shards_resumes_on_one_to_the_same_bits(serving_artifact, tmp_path, eight_cpus):
    """A sweep at ``shards=4`` killed after 3 chunks and resumed at
    ``shards=1`` (the shard count is not in the fingerprint) gives an
    uninterrupted one-device run's chunk arrays bit for bit."""
    store_j, X = serving_artifact
    art = GBDTArtifact.load(ObjectStore(store_j.uri), KEY, "cpu")
    book = np.ascontiguousarray(X[:700], np.float32)
    grid = ScenarioGrid([feature_delta("installment", [0.5])])
    store = ObjectStore(str(tmp_path / "lake"))
    kw = dict(chunk_rows=100, device="cpu")
    whole = PortfolioScorer(art, store, shards=1, **kw).run(book, grid, run_id="whole")
    four = PortfolioScorer(art, store, shards=SHARDS, **kw)
    assert four.describe()["mesh"] == {"dp": SHARDS} and four.padded_rows == 128
    with pytest.raises(PortfolioInterrupted):
        four.run(book, grid, run_id="cut", fail_after_chunks=3)
    resumed = PortfolioScorer(art, store, shards=1, **kw).run(book, grid, run_id="cut", resume=True)
    assert resumed["resume"]["chunks_resumed"] == 3
    a, b = _chunks(store, whole), _chunks(store, resumed)
    assert list(a) == list(b) and len(a) == 14
    for k in a:
        assert a[k].keys() == b[k].keys()
        for name in a[k]:
            assert np.array_equal(a[k][name], b[k][name]), (k, name)


def test_ingest_shards_give_the_same_tables(eight_cpus):
    tok = tokenize_raw_frame(synthetic_lendingclub_frame(3000, seed=4), today=datetime(2026, 8, 1))
    one = run_device_ingest(tok, device="cpu")
    four = run_device_ingest(tok, device="cpu", partitioner=make_partitioner(
        SHARDS, device=CPU))
    for a, b in ((one.tree.X, four.tree.X), (one.nn.X, four.nn.X), (one.tree.y, four.tree.y)):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
    assert torch.equal(one.bins, four.bins) and torch.equal(one.bin_spec.edges, four.bin_spec.edges)
    assert one.tree.feature_names == four.tree.feature_names
    assert one.nn.feature_names == four.nn.feature_names
    assert one.plan == four.plan


def test_cli_flags_take_shard_counts(serving_artifact, eight_cpus):
    """``--bulk-shards`` reaches the service's bulk partitioner and
    ``--ingest-shards`` the pipeline CLI's arguments, as the reference's."""
    from cobalt_smart_lender_ai_tpu_torch import pipeline
    from cobalt_smart_lender_ai_tpu_torch.serve import __main__ as serve_cli

    assert pipeline.parse_args(["--ingest-shards", "-1"]).ingest_shards == -1
    assert pipeline.parse_args([]).ingest_shards == 1
    store, _ = serving_artifact
    args = serve_cli.parse_args(["--store", store.uri, "--device", "cpu", "--bulk-shards", "3",
                                 "--no-microbatch"])
    service = serve_cli.build_service(args)
    try:
        assert service.config.bulk_shards == 3
        assert service._model.bulk_part.describe()["mesh"] == {"dp": 3}
    finally:
        service.close()
