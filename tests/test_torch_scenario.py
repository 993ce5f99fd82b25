"""The port's portfolio stress path against the JAX package's.

The same small forest (8 trees of depth 4 on the 20 serving features,
trained and saved by the JAX package) is scored by the port's
`PortfolioScorer` on the CPU (the kernel's plain version) and by the
reference's (``shards=1``), on the same seeded 1,000-row portfolio in
chunks of 128 rows under a 2x2 grid:

- the grid DSL (`expand` order, ids, `to_json`) and `Scenario.apply` (bit
  for bit) equal the reference's, and so does every reducer of
  ``scenario/report.py`` on the same arrays;
- the engines' chunk scores are equal (``np.array_equal``: margins bitwise,
  the same numpy sigmoid), ``phi_sum`` within ``TOL_SHAP`` x chunk rows,
  and the report's ``delta``, ``migration``, ``band_counts`` and ``drift``
  blocks equal, ``shap_top`` the same features with values to tolerance;
- in the port: a run killed after 3 chunks and resumed gives every chunk's
  arrays of an uninterrupted run; a changed grid or portfolio, or a
  tampered chunk, restarts from 0; ``deadline=None`` never aborts, an
  explicit `Deadline` raises and leaves a resumable checkpoint;
  `from_registry` carries the published version's ``feature_sketch`` and
  flags an OOD stress point; ``shards`` resolves as the reference's:
  clamped to the visible devices (one CPU: one shard; the CPU named four
  times through `device.mesh_devices`: a mesh), `describe()` reporting
  the mesh;
- ``tools.score_portfolio`` on the CPU: exit 0, exit 3 with
  ``--fail-after-chunks``, then ``--resume`` with the same scores; and
  ``--shards 4`` clamped, or on a four-entry mesh the one device's scores;
- bulk SHAP: `ScorerService.shap_bulk` and `ReplicaSet.shap_bulk` against
  the JAX service's (phis within ``TOL_SHAP``), ``None`` while degraded.
"""

from __future__ import annotations

import hashlib
import json
import time

import numpy as np
import pytest
import torch

import cobalt_smart_lender_ai_tpu.scenario as jax_scn
from cobalt_smart_lender_ai_tpu.config import ServeConfig as JaxServeConfig
from cobalt_smart_lender_ai_tpu.data import schema as jax_schema
from cobalt_smart_lender_ai_tpu.io import GBDTArtifact as JaxArtifact
from cobalt_smart_lender_ai_tpu.io import ObjectStore as JaxStore
from cobalt_smart_lender_ai_tpu.models.gbdt import GBDTClassifier as JaxClassifier
from cobalt_smart_lender_ai_tpu.serve.replicas import ReplicaSet as JaxReplicaSet
from cobalt_smart_lender_ai_tpu.serve.service import ScorerService as JaxScorerService
from cobalt_smart_lender_ai_tpu.telemetry.drift import FeatureSketch as JaxSketch
import cobalt_smart_lender_ai_tpu_torch.scenario as scn
from cobalt_smart_lender_ai_tpu_torch import device as torch_device
from cobalt_smart_lender_ai_tpu_torch.config import ServeConfig
from cobalt_smart_lender_ai_tpu_torch.data import schema
from cobalt_smart_lender_ai_tpu_torch.io import GBDTArtifact, ModelRegistry, ObjectStore
from cobalt_smart_lender_ai_tpu_torch.ops.score import fused_score
from cobalt_smart_lender_ai_tpu_torch.reliability.deadline import Deadline
from cobalt_smart_lender_ai_tpu_torch.reliability.errors import DeadlineExceeded
from cobalt_smart_lender_ai_tpu_torch.serve.replicas import ReplicaSet
from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService
from cobalt_smart_lender_ai_tpu_torch.telemetry import default_tracer
from cobalt_smart_lender_ai_tpu_torch.telemetry.drift import FeatureSketch
from cobalt_smart_lender_ai_tpu_torch.tools import score_portfolio

KEY = "models/gbdt/model_tree"
ROWS = 1000
CHUNK = 128
TOL_SHAP = 1e-5
F = len(schema.SERVING_FEATURES)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _book(n: int, seed: int) -> np.ndarray:
    """(n, 20) float32 rows: normal numerics, 0/1 indicator columns, ~5% NaN."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    X[:, 12:] = rng.integers(0, 2, size=(n, F - 12))
    X[rng.random(X.shape) < 0.05] = np.nan
    return X


@pytest.fixture(scope="module")
def store_root(tmp_path_factory):
    """A small forest trained by the JAX package, saved by its artifact
    writer; both engines restore it."""
    rng = np.random.default_rng(7)
    X = _book(1500, 5)
    Xf = np.nan_to_num(X)
    y = Xf[:, 0] - 0.6 * Xf[:, 2] + 0.4 * Xf[:, 13] + 0.3 * rng.normal(size=len(X)) > 0
    model = JaxClassifier(n_estimators=8, max_depth=4, n_bins=32)
    model.fit(X, y.astype(np.int32))
    root = tmp_path_factory.mktemp("torch_scenario") / "lake"
    JaxArtifact(
        forest=model.forest, bin_spec=model.bin_spec, feature_names=tuple(jax_schema.SERVING_FEATURES)
    ).save(JaxStore(str(root)), KEY)
    return str(root)


@pytest.fixture(scope="module")
def portfolio() -> np.ndarray:
    return _book(ROWS, 11)


@pytest.fixture(scope="module")
def artifact(store_root):
    return GBDTArtifact.load(ObjectStore(store_root), KEY, "cpu")


def _grid(pkg):
    return pkg.ScenarioGrid(
        [pkg.feature_delta("installment", [0.5, 1.0]), pkg.feature_multiplier("loan_amnt", [0.9, 1.5])]
    )


def _scorer(artifact, store, **kw) -> scn.PortfolioScorer:
    return scn.PortfolioScorer(artifact, store, chunk_rows=CHUNK, device="cpu", **kw)


def _chunks(store, report) -> dict[str, dict]:
    """Every chunk's arrays of a finished run, by key suffix."""
    prefix = report["keys"]["report"][: -len("report.json")] + "chunks/"
    return {k[len(prefix):]: store.load_arrays(k) for k in sorted(store.list(prefix))
            if k.endswith(".npz")}


# -- the grid DSL and the reducers against the reference ---------------------------


GRIDS = {
    "rate_shock_x_haircut": lambda p: p.ScenarioGrid(
        [p.feature_delta("installment", [25, 50, 100]), p.feature_multiplier("loan_amnt", [0.9])]),
    "three_axes": lambda p: p.ScenarioGrid(
        [p.feature_delta("installment", [-2.5, 0.1]), p.feature_set("term", [36, 60]),
         p.feature_multiplier("loan_amnt", [1 / 3, 1e-7, 1e6])], name="stress"),
    "empty": lambda p: p.ScenarioGrid([]),
}


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_grid_expansion_ids_and_json_equal_the_references(name):
    ours, ref = GRIDS[name](scn), GRIDS[name](jax_scn)
    assert len(ours) == len(ref)
    assert [s.scenario_id for s in ours.expand()] == [s.scenario_id for s in ref.expand()]
    assert [s.to_json() for s in ours.expand()] == [s.to_json() for s in ref.expand()]
    assert [s.features for s in ours.expand()] == [s.features for s in ref.expand()]
    assert ours.to_json() == ref.to_json() and ours.to_json_str() == ref.to_json_str()
    clone = scn.ScenarioGrid.from_json(json.loads(ref.to_json_str()))
    assert clone.to_json() == ref.to_json() and clone.name == ref.name


def test_scenario_apply_is_bitwise_the_references():
    names = list(schema.SERVING_FEATURES)
    X = _book(500, 3) * np.float32(1234.5)
    ours = GRIDS["three_axes"](scn).expand() + GRIDS["rate_shock_x_haircut"](scn).expand()
    refs = GRIDS["three_axes"](jax_scn).expand() + GRIDS["rate_shock_x_haircut"](jax_scn).expand()
    for s, r in zip(ours, refs):
        got, want = s.apply(X, names), r.apply(X, names)
        assert got.dtype == np.float32
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), s.scenario_id
    assert np.array_equal(scn.BASELINE.apply(X, names).view(np.uint32), X.view(np.uint32))
    with pytest.raises(KeyError, match="unknown"):
        scn.Scenario("bad", ours[0].perturbations).apply(X[:, :2], ["loan_amnt", "x"])


def _sketches(X: np.ndarray, names):
    return FeatureSketch.from_data(X, names, bins=10), JaxSketch.from_data(X, names, bins=10)


@pytest.mark.parametrize("bands", [scn.DEFAULT_PD_BANDS, (0.05, 0.5), (0.001, 0.01, 0.1, 0.3, 0.6, 0.9)])
def test_reducers_equal_the_references(bands):
    rng = np.random.default_rng(17)
    base = rng.beta(1, 6, size=3000).astype(np.float32)
    stressed = np.clip(base + rng.normal(0.02, 0.05, size=3000), 0, 1).astype(np.float32)
    stressed[:20] = base[:20]
    assert scn.pd_band_index(base, bands).tolist() == jax_scn.pd_band_index(base, bands).tolist()
    assert scn.band_labels(bands) == jax_scn.band_labels(bands)
    assert scn.delta_stats(base, stressed) == jax_scn.delta_stats(base, stressed)
    assert scn.band_migration(base, stressed, bands) == jax_scn.band_migration(base, stressed, bands)
    names = [f"f{j}" for j in range(12)]
    phi_b = rng.normal(size=12)
    phi_s = phi_b + rng.normal(size=12) * (np.arange(12) % 3 > 0)
    phi_s[5], phi_b[5] = 0.0, 0.0
    for k in (3, 8, 20):
        assert scn.shap_top_movers(phi_s, phi_b, names, top_k=k) == jax_scn.shap_top_movers(
            phi_s, phi_b, names, top_k=k)
    X = rng.normal(size=(2000, 3)).astype(np.float32)
    X[rng.random(X.shape) < 0.03] = np.nan
    cols = ["installment", "loan_amnt", "term"]
    ours, ref = _sketches(X, cols)
    for shift in (0.0, 0.3, 50.0):
        Xs = X.copy()
        Xs[:, 0] += shift
        for alert in (0.1, 0.25):
            assert scn.scenario_drift(ours, Xs, cols, ["installment", "nope"], alert=alert) == \
                jax_scn.scenario_drift(ref, Xs, cols, ["installment", "nope"], alert=alert)


def test_write_report_lands_where_the_references_does(tmp_path):
    ours, ref = ObjectStore(str(tmp_path / "a")), JaxStore(str(tmp_path / "b"))
    doc = {"run_id": "r", "x": [1, 2.5]}
    assert scn.write_report(ours, "runs/r/", doc) == jax_scn.write_report(ref, "runs/r/", doc)
    assert ours.get_bytes("runs/r/report.json") == ref.get_bytes("runs/r/report.json")


# -- the engine against the JAX engine -----------------------------------------------


@pytest.fixture(scope="module")
def engine_pair(store_root, artifact, portfolio, tmp_path_factory):
    """(port report, port store, JAX report, JAX store) of one SHAP sweep of
    the portfolio under the 2x2 grid, each engine with its package's
    training sketch of the portfolio."""
    names = list(schema.SERVING_FEATURES)
    ours_sketch, ref_sketch = _sketches(portfolio, names)
    ours_store = ObjectStore(str(tmp_path_factory.mktemp("ours")))
    ours = _scorer(artifact, ours_store, training_sketch=ours_sketch).run(
        portfolio, _grid(scn), run_id="pair")
    ref_store = JaxStore(str(tmp_path_factory.mktemp("ref")))
    ref_art = JaxArtifact.load(JaxStore(store_root), KEY)
    ref = jax_scn.PortfolioScorer(ref_art, ref_store, shards=1, chunk_rows=CHUNK,
                                  training_sketch=ref_sketch).run(portfolio, _grid(jax_scn), run_id="pair")
    return ours, ours_store, ref, ref_store


def test_engine_scores_equal_the_jax_engines(engine_pair):
    ours, ours_store, ref, ref_store = engine_pair
    got, want = _chunks(ours_store, ours), _chunks(ref_store, ref)
    assert list(got) == list(want) and len(got) == 5 * 8
    for key in want:
        a, b = got[key], want[key]
        assert set(a) == set(b) == {"scores", "n", "phi_sum", "base"}
        assert a["scores"].dtype == b["scores"].dtype == np.float32
        assert np.array_equal(a["scores"], b["scores"]), key
        assert int(a["n"]) == int(b["n"])
        assert a["phi_sum"].dtype == np.float64
        assert np.abs(a["phi_sum"] - b["phi_sum"]).max() <= TOL_SHAP * int(a["n"]), key
        assert abs(float(a["base"]) - float(b["base"])) <= TOL_SHAP
    for sid, key in want_scores(ref).items():
        assert np.array_equal(ours_store.load_array(ours["keys"]["scores"][sid]), ref_store.load_array(key))


def want_scores(report) -> dict:
    return report["keys"]["scores"]


def test_engine_report_blocks_equal_the_jax_engines(engine_pair):
    ours, _, ref, _ = engine_pair
    assert ours["baseline"]["band_counts"] == ref["baseline"]["band_counts"]
    assert ours["baseline"]["mean_pd"] == ref["baseline"]["mean_pd"]
    assert ours["baseline"]["p95_pd"] == ref["baseline"]["p95_pd"]
    for name, v in ref["baseline"]["mean_phi"].items():
        assert ours["baseline"]["mean_phi"][name] == pytest.approx(v, abs=TOL_SHAP)
    assert [b["id"] for b in ours["scenarios"]] == [b["id"] for b in ref["scenarios"]]
    for a, b in zip(ours["scenarios"], ref["scenarios"]):
        for key in ("index", "perturbations", "mean_pd", "delta", "migration", "drift"):
            assert a[key] == b[key], (a["id"], key)
        assert [m["feature"] for m in a["shap_top"]] == [m["feature"] for m in b["shap_top"]]
        for m, n in zip(a["shap_top"], b["shap_top"]):
            for key in ("mean_phi", "baseline_mean_phi", "shift"):
                assert m[key] == pytest.approx(n[key], abs=TOL_SHAP)
    assert any(b["migration"]["downgraded"] for b in ref["scenarios"])
    for key in ("chunk_rows", "padded_rows", "n_chunks", "pd_bands", "grid", "resume", "portfolio"):
        assert ours[key] == ref[key], key
    assert ours["partitioner"] == {"shards": 1, "mesh": None, "devices": ["cpu"]}
    assert ref["partitioner"]["shards"] == 1 and ref["partitioner"]["mesh"] is None
    assert set(ours) == set(ref)
    assert set(ours["stages"]) == set(ref["stages"]) == {"compile", "score", "reduce", "write"}
    assert ours["model"]["channel"] == "direct"


# -- kill and resume in the port ------------------------------------------------------


def test_kill_after_three_chunks_then_resume_equals_an_uninterrupted_run(artifact, portfolio, tmp_path):
    store = ObjectStore(str(tmp_path))
    grid = _grid(scn)
    ref = _scorer(artifact, store).run(portfolio, grid, run_id="ref")
    killed = _scorer(artifact, store)
    with pytest.raises(scn.PortfolioInterrupted) as exc:
        killed.run(portfolio, grid, run_id="kill", fail_after_chunks=3)
    assert (exc.value.items_done, exc.value.items_total) == (3, 40)
    progress = killed._ckpt.progress("portfolio/kill")
    assert progress["items_done"] == 3 and progress["chunk"] == 2
    resumed = _scorer(artifact, store).run(portfolio, grid, run_id="kill", resume=True)
    assert resumed["resume"] == {"chunks_total": 40, "chunks_resumed": 3, "chunks_scored": 37}
    a, b = _chunks(store, ref), _chunks(store, resumed)
    assert list(a) == list(b)
    for key in a:
        for name in ("scores", "phi_sum", "base", "n"):
            assert np.array_equal(a[key][name], b[key][name]), (key, name)
    for sid, key in ref["keys"]["scores"].items():
        assert np.array_equal(store.load_array(key), store.load_array(resumed["keys"]["scores"][sid]))
    # A finished run resumes as a pure reduce.
    again = _scorer(artifact, store).run(portfolio, grid, run_id="kill", resume=True)
    assert again["resume"]["chunks_resumed"] == 40 and again["resume"]["chunks_scored"] == 0


def _killed(artifact, store, X, grid, run_id: str, k: int = 3):
    with pytest.raises(scn.PortfolioInterrupted):
        _scorer(artifact, store).run(X, grid, run_id=run_id, fail_after_chunks=k)


def test_changed_grid_or_portfolio_restarts_from_zero(artifact, portfolio, tmp_path):
    store = ObjectStore(str(tmp_path))
    _killed(artifact, store, portfolio, _grid(scn), "g")
    other = scn.ScenarioGrid([scn.feature_delta("installment", [0.5, 2.0])])
    assert _scorer(artifact, store).run(portfolio, other, run_id="g", resume=True)[
        "resume"]["chunks_resumed"] == 0
    _killed(artifact, store, portfolio, _grid(scn), "p")
    changed = portfolio.copy()
    changed[500, 3] += 1.0
    assert _scorer(artifact, store).run(changed, _grid(scn), run_id="p", resume=True)[
        "resume"]["chunks_resumed"] == 0
    _killed(artifact, store, portfolio, _grid(scn), "s")
    assert _scorer(artifact, store, compute_shap=False).run(portfolio, _grid(scn), run_id="s", resume=True)[
        "resume"]["chunks_resumed"] == 0


def test_a_tampered_chunk_restarts_from_zero(artifact, portfolio, tmp_path):
    store = ObjectStore(str(tmp_path))
    _killed(artifact, store, portfolio, _grid(scn), "t")
    key = "scenario_runs/t/chunks/s000_c00001.npz"
    data = bytearray(store.get_bytes(key))
    data[-40] ^= 0xFF
    store.put_bytes(key, bytes(data))
    resumed = _scorer(artifact, store).run(portfolio, _grid(scn), run_id="t", resume=True)
    assert resumed["resume"]["chunks_resumed"] == 0 and resumed["resume"]["chunks_scored"] == 40
    # Intact chunks resume; and a resume scored by the other kernel would not.
    _killed(artifact, store, portfolio, _grid(scn), "u")
    scorer = _scorer(artifact, store)
    fp = scorer._fingerprint(hashlib.md5(portfolio.tobytes()).hexdigest(), ROWS, _grid(scn).to_json())
    keys = [scorer._chunk_key("scenario_runs/u/", si, ci) for si in range(5) for ci in range(8)]
    assert scorer._verified_resume_point("portfolio/u", fp, keys) == 3
    scorer.kernel = "score_forest"
    fp_card = scorer._fingerprint(hashlib.md5(portfolio.tobytes()).hexdigest(), ROWS, _grid(scn).to_json())
    assert fp_card != fp and scorer._verified_resume_point("portfolio/u", fp_card, keys) == 0


def test_a_direct_artifacts_fingerprint_survives_a_clock_jump(artifact, tmp_path, monkeypatch):
    """An ``.npz`` written later carries other zip timestamps: the resume
    fingerprint of an artifact given directly hashes its forest, not a
    re-serialization, so a resume after the clock moved still matches."""
    a = _scorer(artifact, ObjectStore(str(tmp_path)))
    before = a._model_md5()
    real = time.time
    monkeypatch.setattr(time, "time", lambda: real() + 3600.0)
    b = _scorer(artifact, ObjectStore(str(tmp_path)))
    assert b._model_md5() == before
    assert len(before) == 32


# -- deadlines ---------------------------------------------------------------------


class _TickClock:
    """Each read advances 30 fake seconds: a multi-minute-shaped run."""

    def __init__(self, step: float = 30.0):
        self.now = 0.0
        self.step = step

    def __call__(self) -> float:
        self.now += self.step
        return self.now


def test_deadline_none_never_aborts_a_long_run(artifact, portfolio, tmp_path):
    clock = _TickClock(3600.0)
    scorer = _scorer(artifact, ObjectStore(str(tmp_path)), compute_shap=False, clock=clock)
    report = scorer.run(portfolio, None, run_id="slow")
    assert clock.now > 8 * 3600.0
    assert report["resume"]["chunks_scored"] == 8
    assert report["baseline"]["mean_pd"] > 0.0


def test_an_explicit_deadline_raises_and_leaves_a_resumable_checkpoint(artifact, portfolio, tmp_path):
    store = ObjectStore(str(tmp_path))
    clock = _TickClock(30.0)
    scorer = _scorer(artifact, store, compute_shap=False, clock=clock)
    with pytest.raises(DeadlineExceeded):
        scorer.run(portfolio, None, run_id="budget", deadline=Deadline(400.0, clock=clock))
    done = scorer._ckpt.progress("portfolio/budget")["items_done"]
    assert 0 < done < 8
    resumed = scorer.run(portfolio, None, run_id="budget", resume=True)
    assert resumed["resume"]["chunks_resumed"] == done
    ref = _scorer(artifact, store, compute_shap=False).run(portfolio, None, run_id="budget-ref")
    assert np.array_equal(store.load_array(resumed["keys"]["scores"]["baseline"]),
                          store.load_array(ref["keys"]["scores"]["baseline"]))


# -- the registry, shards, the ledger --------------------------------------------------


def _publish(store: ObjectStore, artifact, X: np.ndarray):
    sketch = FeatureSketch.from_data(X, schema.SERVING_FEATURES, bins=10)
    return ModelRegistry(store).publish(
        "gbdt", artifact, channel="latest",
        provenance={"feature_sketch": sketch.to_json(), "config_hash": "c0ffee",
                    "dataset_md5": "d" * 32},
    )


def test_from_registry_carries_the_sketch_and_flags_an_ood_stress_point(store_root, portfolio, tmp_path):
    store = ObjectStore(str(tmp_path))
    art = GBDTArtifact.load(ObjectStore(store_root), KEY, "cpu")
    mv = _publish(store, art, portfolio)
    scorer = scn.PortfolioScorer.from_registry(store, chunk_rows=CHUNK, device="cpu", compute_shap=False)
    assert scorer.training_sketch is not None
    grid = scn.ScenarioGrid([scn.feature_delta("installment", [0.0, 1e6])])
    report = scorer.run(portfolio, grid, run_id="ood")
    assert report["model"] == {"name": "gbdt", "version": 1, "channel": "latest", "key": mv.key,
                               "md5": mv.md5, "kind": "GBDTArtifact", "config_hash": "c0ffee",
                               "dataset_md5": "d" * 32}
    benign, extreme = report["scenarios"]
    assert not benign["drift"]["ood"] and benign["drift"]["psi"]["installment"] == 0.0
    assert extreme["drift"]["ood_features"] == ["installment"] and extreme["drift"]["ood"]
    assert "drift_note" not in report
    with pytest.raises(LookupError, match="canary"):
        scn.PortfolioScorer.from_registry(store, channel="canary", device="cpu")


@pytest.mark.parametrize("shards", [0, 1, -1])
def test_one_device_shards_are_accepted(artifact, tmp_path, shards):
    scorer = _scorer(artifact, ObjectStore(str(tmp_path)), shards=shards)
    assert scorer.describe()["shards"] == 1 and scorer.padded_rows == CHUNK


@pytest.mark.parametrize("shards", [2, 4, -2])
def test_a_mesh_is_refused_as_not_ported(artifact, tmp_path, shards, monkeypatch):
    """A mesh is no longer refused: ``shards`` is clamped to the visible
    devices, as the reference clamps it (one CPU: one shard; -2 is one
    device), and `describe()` reports the mesh it got."""
    assert _scorer(artifact, ObjectStore(str(tmp_path)), shards=shards).describe() == {
        "shards": 1, "mesh": None, "devices": ["cpu"]}
    monkeypatch.setattr(torch_device, "mesh_devices", lambda device="cuda": [torch.device("cpu")] * 3)
    scorer = _scorer(artifact, ObjectStore(str(tmp_path)), shards=shards)
    n = {2: 2, 4: 3, -2: 1}[shards]
    assert scorer.describe()["shards"] == n
    assert scorer.describe()["mesh"] == (None if n == 1 else {"dp": n})
    assert scorer.padded_rows == (1 << (-(-CHUNK // n) - 1).bit_length()) * n


def test_padded_rows_are_the_power_of_two_cover(artifact, tmp_path):
    for chunk, padded in ((1, 1), (100, 128), (2048, 2048), (2049, 4096)):
        assert scn.PortfolioScorer(artifact, ObjectStore(str(tmp_path)), chunk_rows=chunk,
                                   device="cpu").padded_rows == padded


def test_one_launch_per_chunk_counted_as_its_kind(artifact, portfolio, tmp_path):
    from cobalt_smart_lender_ai_tpu_torch.telemetry import default_program_registry, default_registry

    store = ObjectStore(str(tmp_path))
    fam = default_registry().counter("cobalt_portfolio_dispatches_total", "", ("kind",))
    progs = default_program_registry()

    def dispatches(name):
        return next((r["dispatches"] for r in progs.table() if r["name"] == name), 0)

    for shap, kind in ((True, "shap"), (False, "margin")):
        name = f"score_forest_plain/f32/{CHUNK}/{kind}"  # the plain version's program
        before = (fam.labels(kind).value, dispatches(name))
        _scorer(artifact, store, compute_shap=shap).run(portfolio[:300], _grid(scn), run_id=kind)
        assert fam.labels(kind).value - before[0] == 5 * 3
        assert dispatches(name) - before[1] == 5 * 3


def test_report_and_ledger_round_trip(artifact, portfolio, tmp_path):
    from cobalt_smart_lender_ai_tpu_torch.telemetry import RunLedger, load_ledger

    store = ObjectStore(str(tmp_path / "lake"))
    ledger = RunLedger("portfolio", meta={"run_id": "led"})
    report = _scorer(artifact, store).run(portfolio[:256], scn.ScenarioGrid(
        [scn.feature_delta("installment", [25.0])]), run_id="led", ledger=ledger)
    stored = store.get_json(report["keys"]["report"])
    assert stored["run_id"] == "led" and stored["fingerprint"] == report["fingerprint"]
    assert stored["resume"] == report["resume"] and "stages" not in stored
    ledger.write(str(tmp_path / "ledger.json"))
    loaded = load_ledger(str(tmp_path / "ledger.json"))
    assert set(loaded["stages"]) >= {"compile", "score", "reduce", "write"}
    assert loaded["scenario_report"]["run_id"] == "led"
    assert loaded["scenario_report"]["scenarios"][0]["id"] == "installment+25"
    assert "cobalt_portfolio_dispatch_seconds" in loaded["metrics"]
    assert loaded["dispatch_attribution"]["ratio"] is not None
    assert any(p["name"] == f"score_forest_plain/f32/{CHUNK}/shap" for p in loaded["programs"])
    spans = [s["name"] for s in default_tracer().export()]
    assert "portfolio.scenario" in spans and "portfolio.reduce" in spans


def test_load_portfolio_reads_what_save_frame_wrote(tmp_path):
    from cobalt_smart_lender_ai_tpu_torch.data.frame import RawFrame

    store = ObjectStore(str(tmp_path))
    X = _book(300, 2) * np.float32(1e4)
    names = list(schema.SERVING_FEATURES)
    store.save_frame("book.csv", RawFrame({n: X[:, j] for j, n in enumerate(names) if n != "term"}))
    got, meta = scn.load_portfolio(store, "book.csv", names)
    keep = [j for j, n in enumerate(names) if n != "term"]
    assert np.array_equal(got[:, keep], X[:, keep], equal_nan=True)
    assert np.isnan(got[:, names.index("term")]).all()
    assert meta["missing_features"] == ["term"] and meta["rows"] == 300
    assert meta["md5"] == hashlib.md5(store.get_bytes("book.csv")).hexdigest()


# -- the CLI on the CPU ----------------------------------------------------------------


def test_score_portfolio_cli_kill_and_resume_on_the_cpu(store_root, tmp_path, capsys):
    lake = tmp_path / "lake"
    store = ObjectStore(str(lake))
    mv = _publish(store, GBDTArtifact.load(ObjectStore(store_root), KEY, "cpu"), _book(400, 1))
    grid = tmp_path / "grid.json"
    grid.write_text(_grid(scn).to_json_str())
    common = ["--store", str(lake), "--device", "cpu", "--synthetic-portfolio", "2000",
              "--scenarios", str(grid), "--chunk-rows", "256"]
    assert score_portfolio.main([*common, "--run-id", "whole"]) == 0
    whole = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert whole["scenarios"] == 4 and whole["chunks_resumed"] == 0 and whole["shards"] == 1
    n_rows = whole["rows"]
    assert 1500 < n_rows <= 2000
    chunks = 5 * -(-n_rows // 256)
    assert whole["chunks_scored"] == chunks
    assert score_portfolio.main([*common, "--run-id", "cut", "--fail-after-chunks", "4"]) == 3
    cut = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cut == {"run_id": "cut", "interrupted": True, "items_done": 4, "items_total": chunks,
                   "resume_with": "--resume"}
    ledger = tmp_path / "ledger.json"
    assert score_portfolio.main([*common, "--run-id", "cut", "--resume",
                                 "--ledger-out", str(ledger)]) == 0
    resumed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert resumed["chunks_resumed"] == 4 and resumed["chunks_scored"] == chunks - 4
    a = store.get_json(f"scenario_runs/whole/report.json")["keys"]["scores"]
    b = store.get_json(f"scenario_runs/cut/report.json")["keys"]["scores"]
    assert list(a) == list(b)
    for sid in a:
        assert np.array_equal(store.load_array(a[sid]), store.load_array(b[sid]))
    doc = json.loads(ledger.read_text())
    assert doc["kind"] == "portfolio" and doc["meta"]["device"] == "cpu"
    assert doc["scenario_report"]["resume"]["chunks_resumed"] == 4
    # --model-key: the stored bytes' md5 pins the model, so it resumes too.
    assert score_portfolio.main([*common, "--run-id", "direct", "--model-key",
                                 mv.key, "--fail-after-chunks", "2"]) == 3
    capsys.readouterr()
    assert score_portfolio.main([*common, "--run-id", "direct", "--model-key",
                                 mv.key, "--resume"]) == 0
    direct = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert direct["chunks_resumed"] == 2 and direct["ood_scenarios"] == []


def test_score_portfolio_cli_refuses_a_mesh(store_root, tmp_path, capsys, monkeypatch):
    """``--shards 4`` is no longer refused: on one CPU it is clamped to one
    shard, and with the CPU named four times (`device.mesh_devices`) the
    run is a four-shard mesh whose scores are the one-device run's, bit
    for bit."""
    assert score_portfolio.parse_args([]).device == "cuda"
    lake = tmp_path / "lake"
    store = ObjectStore(str(lake))
    _publish(store, GBDTArtifact.load(ObjectStore(store_root), KEY, "cpu"), _book(400, 1))
    common = ["--store", str(lake), "--device", "cpu", "--synthetic-portfolio", "600",
              "--chunk-rows", "128", "--no-shap"]
    assert score_portfolio.main([*common, "--run-id", "one", "--shards", "4"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["shards"] == 1
    monkeypatch.setattr(torch_device, "mesh_devices", lambda device="cuda": [torch.device("cpu")] * 4)
    assert score_portfolio.main([*common, "--run-id", "mesh", "--shards", "4"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["shards"] == 4
    a = store.get_json("scenario_runs/one/report.json")["keys"]["scores"]
    b = store.get_json("scenario_runs/mesh/report.json")["keys"]["scores"]
    for sid in a:
        assert np.array_equal(store.load_array(a[sid]), store.load_array(b[sid]))


# -- bulk SHAP on the service and the fleet -------------------------------------------


def _jax_service(root: str, **kw):
    cfg = JaxServeConfig(prewarm_all_buckets=False, precompile_batch_buckets=(), score_cache_size=0,
                         microbatch_enabled=False, history_enabled=False, **kw)
    return JaxScorerService.from_store(JaxStore(root), cfg)


@pytest.fixture(scope="module")
def bulk_rows(portfolio) -> np.ndarray:
    return portfolio[:150]


def test_service_shap_bulk_matches_the_jax_service(store_root, bulk_rows):
    port = ScorerService.from_store(ObjectStore(store_root), ServeConfig(
        max_batch_rows=64, microbatch_enabled=False, score_cache_size=0), device="cpu")
    ref = _jax_service(store_root, max_batch_rows=64)
    try:
        bulk = port.registry.counter("cobalt_bulk_dispatches_total", "")
        before = bulk.value
        launches = fused_score.launches
        phis, base = port.shap_bulk(bulk_rows)
        want, want_base = ref.shap_bulk(bulk_rows)
        assert phis.shape == want.shape == (150, F) and phis.dtype == np.float32
        assert np.abs(phis - want).max() <= TOL_SHAP
        assert abs(base - want_base) <= TOL_SHAP
        assert bulk.value - before == 3  # 64 + 64 + 22 rows (a 32-row bucket)
        assert fused_score.launches == launches  # the plain version on the CPU
        assert any(s["name"] == "serve.bulk_shap" and s["attrs"].get("rows") == 150
                   for s in default_tracer().export())
        # Chunked equals one plain call over all the rows, and the probabilities agree.
        prob = port.predict_proba(bulk_rows)
        margins = np.log(prob / (1 - prob))
        assert np.abs(base + phis.sum(1) - margins).max() <= 1e-4
        port._model.shap_fn = None
        ref._model.shap_fn = None
        assert port.shap_bulk(bulk_rows) is None and ref.shap_bulk(bulk_rows) is None
    finally:
        port.close()
        ref.close()


def test_fleet_shap_bulk_matches_the_jax_fleet(store_root, bulk_rows):
    kw = dict(replicas=2, microbatch_enabled=False, score_cache_size=0,
              supervisor_probe_interval_s=3600.0)
    port = ReplicaSet.from_store(ObjectStore(store_root), ServeConfig(**kw), device="cpu")
    ref = JaxReplicaSet.from_store(JaxStore(store_root), JaxServeConfig(
        **kw, precompile_batch_buckets=(), prewarm_all_buckets=False, history_enabled=False))
    try:
        for _ in range(2):  # routed to each replica in turn
            phis, base = port.shap_bulk(bulk_rows)
            want, want_base = ref.shap_bulk(bulk_rows)
            assert np.abs(phis - want).max() <= TOL_SHAP and abs(base - want_base) <= TOL_SHAP
        routed = [int(port._m_routed.labels(replica=str(i)).value) for i in range(2)]
        assert sum(routed) == 2
    finally:
        port.close()
        ref.close()
