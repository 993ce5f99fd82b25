"""The port's ``tools.train_artifact`` against the reference's preparation.

`train_artifact` runs on the CPU at 3000 rows with ``today`` pinned, and the
CLI saves that run into a temporary store; the JAX package's preparation (as the reference's
``tools/train_artifact.py`` does it: the host cleaning path, the leakage
drop, the 20 serving features, the hashed split) runs with the same
``today``. The training rows and every column's bin edges are the JAX
package's bit for bit, but for the six columns log1p derives (within
``LOG_RTOL``: torch's and XLA's float32 log1p differ by an ulp); the
header's ``config`` and ``metrics`` keys are the committed artifact's; the JAX package's `GBDTArtifact.load` reads the
port's file, and its `predict_margin` on seeded rows equals the port's bit
for bit. The tool refuses ``cuda`` without a card.
"""

from __future__ import annotations

import json
from datetime import datetime
from pathlib import Path

import numpy as np
import pytest
import torch

from cobalt_smart_lender_ai_tpu_torch.data import schema
from cobalt_smart_lender_ai_tpu_torch.io import GBDTArtifact, ObjectStore
from cobalt_smart_lender_ai_tpu_torch.models.gbdt import predict_margin
from cobalt_smart_lender_ai_tpu_torch.tools import train_artifact

ROOT = Path(__file__).resolve().parent.parent
ROWS, SEED = 3000, 11
TODAY = datetime(2026, 8, 1)
KEY = "models/gbdt/model_tree"
#: The serving columns log1p derives, and their tolerance against XLA's.
LOG_SERVING = tuple(n for n in schema.SERVING_FEATURES if n in schema.LOG_COLS)
LOG_RTOL = 3e-7


def _jax_training_rows(rows: int, seed: int, today: datetime) -> np.ndarray:
    from cobalt_smart_lender_ai_tpu.data import (
        clean_raw_frame,
        engineer_features,
        prepare_cleaned_frame,
        schema,
        synthetic_lendingclub_frame,
        train_test_split_hashed,
    )
    from cobalt_smart_lender_ai_tpu.data.features import drop_training_leakage

    raw = synthetic_lendingclub_frame(n_rows=rows, seed=seed)
    cleaned, _ = clean_raw_frame(raw)
    tree_ff, _, _ = engineer_features(prepare_cleaned_frame(cleaned, today=today))
    ff = drop_training_leakage(tree_ff).select(schema.SERVING_FEATURES)
    X_train, _, _, _ = train_test_split_hashed(ff.X, ff.y)
    return np.asarray(X_train)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The date-pinned run, saved and reported by `main` (which takes the
    date of the day; its fit is the pinned one, so the tool fits once)."""
    out = tmp_path_factory.mktemp("train_artifact") / "lake"
    pinned = train_artifact.train_artifact(ROWS, SEED, device="cpu", today=TODAY)
    calls = []

    def fit(rows, seed, *, device):
        calls.append((rows, seed, device))
        return pinned

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_artifact, "train_artifact", fit)
        run = train_artifact.main(["--rows", str(ROWS), "--seed", str(SEED), "--out", str(out),
                                   "--device", "cpu"])
    assert calls == [(ROWS, SEED, "cpu")] and run is pinned
    return out, run


def _header(path: Path) -> dict:
    return json.loads(bytes(np.load(path)["__header__"]).decode())


def test_training_rows_and_bin_edges_are_the_references(trained):
    """Bit for bit, but for the columns log1p derives: torch's and XLA's
    float32 log1p differ by an ulp, so those are held to ``LOG_RTOL`` (the
    port's rule since its device ingest; ``ROADMAP.md``, traps)."""
    from cobalt_smart_lender_ai_tpu.ops.binning import compute_bin_edges

    out, run = trained
    X_ref = _jax_training_rows(ROWS, SEED, TODAY).astype(np.float32)
    header = _header(out / f"{KEY}.npz")
    assert header["metrics"]["train_rows"] == X_ref.shape[0] == run["artifact"].metrics["train_rows"]
    X_port = train_artifact.prepare_training_rows(ROWS, SEED, "cpu", TODAY)[0].numpy()
    want = np.asarray(compute_bin_edges(X_ref, n_bins=255).edges)
    got = np.load(out / f"{KEY}.npz")["bin_edges"]
    assert X_port.shape == X_ref.shape and got.shape == want.shape == (20, 253)
    for col, name in enumerate(schema.SERVING_FEATURES):
        if name in LOG_SERVING:
            np.testing.assert_allclose(X_port[:, col], X_ref[:, col], rtol=LOG_RTOL, atol=0)
            np.testing.assert_allclose(got[col], want[col], rtol=LOG_RTOL, atol=0)
        else:
            assert X_port[:, col].tobytes() == X_ref[:, col].tobytes(), name
            assert got[col].tobytes() == want[col].tobytes(), name
    assert len(LOG_SERVING) == 6  # 14 of the 20 columns bit for bit


def test_header_keys_are_the_committed_artifacts(trained):
    out, run = trained
    header, committed = _header(out / f"{KEY}.npz"), _header(ROOT / "artifacts" / f"{KEY}.npz")
    assert list(header["config"]) == list(committed["config"])
    assert list(header["metrics"]) == list(committed["metrics"])
    assert set(header) == set(committed)
    assert {k: header["config"][k] for k in ("n_estimators", "max_depth", "learning_rate", "subsample",
                                             "colsample_bytree", "n_bins", "seed")} == {
        k: committed["config"][k] for k in ("n_estimators", "max_depth", "learning_rate", "subsample",
                                            "colsample_bytree", "n_bins", "seed")}
    assert header["metrics"]["data"] == f"synthetic_lendingclub_frame(rows={ROWS}, seed={SEED})"
    assert header["library_version"] == committed["library_version"]
    assert json.loads((out / f"{KEY}.features.json").read_text()) == json.loads(
        (ROOT / "artifacts" / f"{KEY}.features.json").read_text())
    line = run["line"]
    assert line == {"artifact": f"{out}/{KEY}", "test_auc": round(run["test_auc"], 4),
                    "wall_s": round(run["wall_s"], 1)}
    assert 0.5 < run["test_auc"] <= 1.0


def test_the_jax_package_reads_the_artifact_and_scores_it_alike(trained):
    import jax.numpy as jnp

    from cobalt_smart_lender_ai_tpu.io import GBDTArtifact as JaxArtifact
    from cobalt_smart_lender_ai_tpu.io import ObjectStore as JaxStore
    from cobalt_smart_lender_ai_tpu.models.gbdt import predict_margin as jax_margin

    out, _ = trained
    ref = JaxArtifact.load(JaxStore(str(out)), KEY)
    port = GBDTArtifact.load(ObjectStore(str(out)), KEY, device="cpu")
    assert ref.feature_names == port.feature_names and ref.forest.n_trees == 300
    rng = np.random.default_rng(7)
    edges = np.load(out / f"{KEY}.npz")["bin_edges"]
    X = np.stack([rng.choice(np.unique(edges[f][np.isfinite(edges[f])]), 512) for f in range(20)], axis=1)
    X = (X + rng.normal(scale=1e-3, size=X.shape)).astype(np.float32)
    X[rng.random(X.shape) < 0.1] = np.nan
    want = np.asarray(jax_margin(ref.forest, jnp.asarray(X)))
    got = predict_margin(port.forest, torch.from_numpy(X)).numpy()
    assert got.tobytes() == want.tobytes()


def test_refuses_cuda_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert train_artifact.parse_args([]).device == "cuda"
    assert train_artifact.parse_args([]).out == "artifacts"
    with pytest.raises(RuntimeError, match="cuda"):
        train_artifact.main(["--rows", "500", "--out", str(tmp_path)])
    assert not any(tmp_path.iterdir())
