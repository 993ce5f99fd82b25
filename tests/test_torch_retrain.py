"""The port's retrain driver (`tools.retrain`) against the reference's
``tools/retrain.py`` (``train_mlp=False``), on the CPU at a small size
(3,000 loans, 20 trees of depth 3).

Equal: the report's and the provenance's keys, the config hash, the
degraded flag, the version record's layout, the scale_pos_weight and the
sketch's bin counts. The training matrices match within ``LOG_RTOL``: some
serving features come out of log1p, whose last bits differ between torch
and XLA, so the two ``dataset_md5`` strings differ, and each package's md5
is the md5 of its own matrix (checked here for the port). The sketch's edges
match within ``LOG_RTOL`` too. The forests are held as
``tests/test_torch_fit.py`` holds fits: split features and covers equal,
every training row in the same leaf of every tree, gains and leaf values
within rtol 1e-5 plus 1e-5 of the forest's largest |value|, margins within
1e-5. ``--degrade`` shuffles the labels with the reference's permutation.
By default (``train_mlp=True``, as the reference's) a retrain also trains
the MLP challenger and publishes it as ``gbdt_mlp`` to ``canary``: the same
report keys and registry record as the reference's, an `MLPArtifact` the
JAX package reads, scoring as the port's MLP does; the CLI does so too,
and ``--no-mlp`` skips it. The CLI defaults to ``cuda`` and raises without
it.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest
import torch

from cobalt_smart_lender_ai_tpu.io import GBDTArtifact as JaxArtifact
from cobalt_smart_lender_ai_tpu.io import ObjectStore as JaxStore
from cobalt_smart_lender_ai_tpu.io.model_registry import ModelRegistry as JaxRegistry
from cobalt_smart_lender_ai_tpu_torch.convert import forest_from_numpy
from cobalt_smart_lender_ai_tpu_torch.data import (
    clean_raw_frame,
    engineer_features,
    prepare_cleaned_frame,
    schema,
    synthetic_lendingclub_frame,
    train_test_split_hashed,
)
from cobalt_smart_lender_ai_tpu_torch.data.features import drop_training_leakage
from cobalt_smart_lender_ai_tpu_torch.io import GBDTArtifact, ModelRegistry, ObjectStore
from cobalt_smart_lender_ai_tpu_torch.models import gbdt
from cobalt_smart_lender_ai_tpu_torch.ops.binning import transform
from cobalt_smart_lender_ai_tpu_torch.telemetry import FeatureSketch
from cobalt_smart_lender_ai_tpu_torch.tools import retrain
from tools.retrain import retrain_candidate as jax_retrain_candidate

LOG_RTOL = 3e-7
RTOL = 1e-5
SIZE = dict(rows=3000, n_estimators=20, max_depth=3, train_mlp=False)
FIELDS = ("feature", "thr_bin", "thr_float", "missing_left", "gain", "cover", "leaf_value")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_matrix(rows: int, seed: int) -> np.ndarray:
    from cobalt_smart_lender_ai_tpu.data import clean_raw_frame as j_clean
    from cobalt_smart_lender_ai_tpu.data import engineer_features as j_engineer
    from cobalt_smart_lender_ai_tpu.data import prepare_cleaned_frame as j_prepare
    from cobalt_smart_lender_ai_tpu.data import synthetic_lendingclub_frame as j_synthetic
    from cobalt_smart_lender_ai_tpu.data import train_test_split_hashed as j_split
    from cobalt_smart_lender_ai_tpu.data.features import drop_training_leakage as j_drop

    cleaned, _ = j_clean(j_synthetic(n_rows=rows, seed=seed))
    tree, _, _ = j_engineer(j_prepare(cleaned))
    ff = j_drop(tree).select(schema.SERVING_FEATURES)
    return np.asarray(j_split(ff.X, ff.y)[0])


def _port_matrix(rows: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    cleaned, _ = clean_raw_frame(synthetic_lendingclub_frame(n_rows=rows, seed=seed))
    tree, _, _ = engineer_features(prepare_cleaned_frame(cleaned), device="cpu")
    ff = drop_training_leakage(tree).select(schema.SERVING_FEATURES)
    X, _, y, _ = train_test_split_hashed(ff.X, ff.y)
    return X.numpy(), y.numpy()


@pytest.fixture(scope="module", params=[False, True], ids=["candidate", "degraded"])
def retrains(request, tmp_path_factory):
    degrade = request.param
    root = tmp_path_factory.mktemp("torch_retrain")
    port = retrain.retrain_candidate(ObjectStore(str(root / "port")), seed=5, degrade=degrade,
                                     bootstrap=True, device="cpu", **SIZE)
    ref = jax_retrain_candidate(JaxStore(str(root / "jax")), seed=5, degrade=degrade,
                                bootstrap=True, **SIZE)
    return {"degrade": degrade, "root": root, "port": port, "jax": ref,
            "port_record": ModelRegistry(ObjectStore(str(root / "port"))).record("gbdt", 1),
            "jax_record": JaxRegistry(JaxStore(str(root / "jax"))).record("gbdt", 1)}


def test_reports_and_provenance_are_the_references(retrains):
    port, ref = retrains["port"], retrains["jax"]
    assert port.keys() == ref.keys()
    for key in ("model", "version", "key", "channel", "parent_version", "bootstrapped"):
        assert port[key] == ref[key], key
    assert abs(port["test_auc"] - ref["test_auc"]) <= 2e-4
    pr, jr = retrains["port_record"], retrains["jax_record"]
    assert pr.to_json().keys() == jr.to_json().keys()
    assert (pr.name, pr.version, pr.key, pr.kind, pr.parent_version) == (
        jr.name, jr.version, jr.key, jr.kind, jr.parent_version)
    assert pr.provenance.keys() == jr.provenance.keys()
    for key in ("dataset", "config_hash", "degraded"):
        assert pr.provenance[key] == jr.provenance[key], key
    assert pr.provenance["degraded"] is retrains["degrade"]
    assert pr.metrics["train_rows"] == jr.metrics["train_rows"]
    port_art = GBDTArtifact.load(ObjectStore(str(retrains["root"] / "port")), pr.key, "cpu")
    jax_art = JaxArtifact.load(JaxStore(str(retrains["root"] / "jax")), jr.key)
    assert port_art.config == jax_art.config  # scale_pos_weight included, bit for bit


def test_matrix_and_sketch_match_within_log_rtol(retrains):
    X, y = _port_matrix(3000, seed=5)
    if retrains["degrade"]:
        y = np.random.default_rng(5).permutation(y)
    md5 = hashlib.md5(np.ascontiguousarray(X, np.float32).tobytes()
                      + np.ascontiguousarray(y, np.float32).tobytes()).hexdigest()
    assert retrains["port"]["dataset_md5"] == md5  # the md5 of the port's own matrix
    J = _jax_matrix(3000, seed=5)
    assert X.shape == J.shape
    both_nan = np.isnan(X) & np.isnan(J)
    assert (np.isclose(X, J, rtol=LOG_RTOL, atol=0.0) | both_nan).all()
    ps = FeatureSketch.from_json(retrains["port_record"].provenance["feature_sketch"])
    js = retrains["jax_record"].provenance["feature_sketch"]
    assert ps.feature_names == js["feature_names"] == list(schema.SERVING_FEATURES)
    np.testing.assert_array_equal(ps.counts, np.asarray(js["counts"]))
    for pe, je in zip(ps.edges, js["edges"]):
        np.testing.assert_allclose(pe, je, rtol=LOG_RTOL, atol=0.0)


def test_forest_is_held_as_fits_are(retrains):
    pr, jr = retrains["port_record"], retrains["jax_record"]
    port = GBDTArtifact.load(ObjectStore(str(retrains["root"] / "port")), pr.key, "cpu")
    ref = JaxArtifact.load(JaxStore(str(retrains["root"] / "jax")), jr.key)
    depth = SIZE["max_depth"]
    jforest = forest_from_numpy({f: np.asarray(getattr(ref.forest, f)) for f in FIELDS}, depth)
    tf = port.forest
    for f in ("feature", "cover"):
        np.testing.assert_array_equal(getattr(tf, f).numpy(), getattr(jforest, f).numpy(), err_msg=f)
    X, _ = _port_matrix(3000, seed=5)
    Xt = torch.from_numpy(X)
    from cobalt_smart_lender_ai_tpu_torch.ops.binning import BinSpec

    bins = transform(BinSpec(edges=torch.from_numpy(port.bin_edges)), Xt)
    landed = [gbdt.landed_leaves(f.feature, f.thr_bin, f.missing_left, depth, bins, binned=True)
              for f in (jforest, tf)]
    assert torch.equal(landed[0], landed[1])
    for f in ("gain", "leaf_value"):
        ref_v = getattr(jforest, f).numpy()
        np.testing.assert_allclose(getattr(tf, f).numpy(), ref_v, rtol=RTOL,
                                   atol=RTOL * np.abs(ref_v).max(), err_msg=f)
    np.testing.assert_allclose(gbdt.predict_margin(tf, Xt).numpy(),
                               gbdt.predict_margin(jforest, Xt).numpy(), rtol=0, atol=1e-5)


MINI_MLP = dict(rows=1200, n_estimators=8, max_depth=3, mlp_epochs=2, bootstrap=True)


def test_default_retrain_publishes_the_mlp_challenger(tmp_path):
    """As the reference's ``tests/test_canary.py`` checks it: the challenger
    under its own name in ``canary`` with kind `MLPArtifact`, beside the
    champion bootstrapped into ``latest``; the report and the record as the
    reference's."""
    from cobalt_smart_lender_ai_tpu.io import MLPArtifact as JaxMLPArtifact
    from cobalt_smart_lender_ai_tpu.models.nn import MLP as JaxMLP
    from cobalt_smart_lender_ai_tpu_torch.io import MLPArtifact
    from cobalt_smart_lender_ai_tpu_torch.models.nn import MLP, MinMaxStats

    port = retrain.retrain_candidate(ObjectStore(str(tmp_path / "port")), seed=5, device="cpu", **MINI_MLP)
    ref = jax_retrain_candidate(JaxStore(str(tmp_path / "jax")), seed=5, **MINI_MLP)
    assert port.keys() == ref.keys() and port["challenger"].keys() == ref["challenger"].keys()
    for key in ("model", "version", "key"):
        assert port["challenger"][key] == ref["challenger"][key] == {
            "model": "gbdt_mlp", "version": 1, "key": "models/gbdt_mlp/v1"}[key]
    assert 0.5 < port["challenger"]["test_auc"] <= 1.0
    assert port["bootstrapped"] and port["channel"] == "latest"
    reg = ModelRegistry(ObjectStore(str(tmp_path / "port")))
    jreg = JaxRegistry(JaxStore(str(tmp_path / "jax")))
    assert reg.channel("gbdt", "latest")["version"] == 1 and reg.channel("gbdt", "canary") is None
    assert reg.channel("gbdt_mlp", "canary")["version"] == 1
    assert reg.channel("gbdt_mlp", "latest") is None
    record, jrecord = reg.record("gbdt_mlp", 1), jreg.record("gbdt_mlp", 1)
    assert record.kind == jrecord.kind == "MLPArtifact" and reg.verify("gbdt_mlp", 1)
    assert record.to_json().keys() == jrecord.to_json().keys()
    assert record.provenance == reg.record("gbdt", 1).provenance  # the champion's data
    assert record.metrics == {"test_auc": port["challenger"]["test_auc"]}
    art = MLPArtifact.load(ObjectStore(str(tmp_path / "port")), record.key, device="cpu")
    assert art.hidden_sizes == (32, 16) and art.feature_names == tuple(schema.SERVING_FEATURES)
    assert art.config == {"learning_rate": 0.01, "epochs": 2, "seed": 5}
    # The reference reads it, and scores as the port's MLP on the same rows.
    jart = JaxMLPArtifact.from_bytes(ObjectStore(str(tmp_path / "port")).get_bytes(record.key + ".npz"))
    X, _ = _port_matrix(1200, seed=5)
    module = MLP(len(schema.SERVING_FEATURES), (32, 16))
    module.load_state_dict(art.state_dict)
    Xs = MinMaxStats(torch.from_numpy(art.scaler_low), torch.from_numpy(art.scaler_range))(
        torch.from_numpy(X))
    with torch.no_grad():
        want = module(Xs).numpy()
    got = np.asarray(JaxMLP(hidden=(32, 16)).apply(jart.params, Xs.numpy()))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_cli_trains_the_challenger_unless_no_mlp(tmp_path, capsys):
    args = ["--store", str(tmp_path), "--rows", "1200", "--n-estimators", "4", "--max-depth", "2",
            "--device", "cpu"]
    first = retrain.main(args + ["--bootstrap"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == first
    assert first["challenger"]["model"] == "gbdt_mlp" and first["challenger"]["version"] == 1
    second = retrain.main(args + ["--seed", "18", "--no-mlp"])
    assert "challenger" not in second and second["version"] == 2
    reg = ModelRegistry(ObjectStore(str(tmp_path)))
    assert reg.channel("gbdt_mlp", "canary")["version"] == 1  # --no-mlp published none
    assert reg.record("gbdt_mlp", 1).kind == "MLPArtifact"
    assert retrain.parse_args([]).no_mlp is False


def test_cli_defaults_to_cuda_and_raises_without_it(tmp_path, monkeypatch):
    assert retrain.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        retrain.main(["--store", str(tmp_path), "--no-mlp", "--rows", "100"])
    with pytest.raises(RuntimeError, match="cuda"):
        retrain.retrain_candidate(ObjectStore(str(tmp_path)), rows=100, train_mlp=False)


def test_cli_publishes_on_the_cpu_when_asked(tmp_path, capsys):
    args = ["--store", str(tmp_path), "--rows", "1500", "--n-estimators", "4", "--max-depth", "2",
            "--no-mlp", "--device", "cpu"]
    first = retrain.main(args + ["--bootstrap", "--ledger-out", str(tmp_path / "run.json")])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == first
    assert first["channel"] == "latest" and first["bootstrapped"]
    second = retrain.main(args + ["--seed", "18", "--bootstrap"])
    assert second["channel"] == "canary" and second["version"] == 2 and second["parent_version"] == 1
    reg = ModelRegistry(ObjectStore(str(tmp_path)))
    assert reg.channel("gbdt", "latest")["version"] == 1 and reg.channel("gbdt", "canary")["version"] == 2
    assert reg.verify("gbdt", 1) and reg.verify("gbdt", 2)
    ledger = json.loads((tmp_path / "run.json").read_text())
    assert ledger["kind"] == "retrain" and ledger["retrain_report"] == first
