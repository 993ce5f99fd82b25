"""The port's ``tools.parity`` against the reference's ``tools/parity.py``.

- `build_matrices` at 2,000 loans equals the reference tool's: the labels,
  the scale_pos_weight and the feature names exactly; every column bit for
  bit but for the columns log1p derives, held to ``LOG_RTOL`` (torch's and
  XLA's float32 log1p differ by an ulp), and ``earliest_cr_line_days``,
  which counts days before the moment of the run (``PERF.md`` §7) and is
  held to ``DATE_ATOL`` days.
- `run_ours` at that size, shrunk the same way on both sides by
  monkeypatching the configs the tools read (a 4-tree depth-2 selector
  dropping 42 features a refit, a 3 x 3 search of candidates that draw
  nothing at random, 32 bins) and the reference's mesh to one device (the
  port runs on one): the same selected features and best parameters, the
  CV AUC within ``SEARCH_TOL`` (`tests/test_torch_tune.py`'s tolerance of
  searches), and the held-out AUC within it too.
- `run_oracle` on 800 training rows and 22 of the columns, with a small HGB
  space on both sides: the reference's record exactly, but for its seconds.
  Marked ``slow``: its 2 x 63 scikit-learn fits take about a minute.
- `merge` and the CLI's ``merge`` give the reference's output on the
  committed records and refuse sides of another ``n_rows``.
- With scikit-learn hidden, as on the card's machine, ``oracle`` and
  ``both`` exit non-zero saying why.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import parity as ref_parity  # noqa: E402  (the reference's tool)

import cobalt_smart_lender_ai_tpu.config as jax_config  # noqa: E402
import cobalt_smart_lender_ai_tpu.models.gbdt  # noqa: E402,F401
import cobalt_smart_lender_ai_tpu.ops.metrics  # noqa: E402,F401
import cobalt_smart_lender_ai_tpu.parallel.mesh as jax_mesh  # noqa: E402
import cobalt_smart_lender_ai_tpu.parallel.rfe  # noqa: E402,F401
import cobalt_smart_lender_ai_tpu.parallel.tune  # noqa: E402,F401
import cobalt_smart_lender_ai_tpu_torch.config as port_config  # noqa: E402
import cobalt_smart_lender_ai_tpu_torch.parallel.rfe  # noqa: E402,F401
import cobalt_smart_lender_ai_tpu_torch.parallel.tune  # noqa: E402,F401
from cobalt_smart_lender_ai_tpu_torch.data import schema  # noqa: E402
from cobalt_smart_lender_ai_tpu_torch.tools import parity  # noqa: E402

ROWS, SEED = 2000, 11
LOG_RTOL = 3e-7
DATE_COLUMN = "earliest_cr_line_days"
DATE_ATOL = 1.0
SEARCH_TOL = 0.005

#: Candidates that draw nothing at random, over two (depth, trees) buckets.
SPACE = {
    "n_estimators": (4, 8),
    "max_depth": (2, 3),
    "learning_rate": (0.1, 0.3),
    "subsample": (1.0,),
    "colsample_bytree": (1.0,),
    "gamma": (0.0, 1.0),
}
RFE = dict(step=42, n_estimators=4, max_depth=2)
TUNE = dict(n_iter=3, param_space=SPACE)
ORACLE_ROWS, ORACLE_COLUMNS = 800, 22
HGB_SPACE = {
    "max_iter": [4, 8],
    "max_depth": [2, 3],
    "learning_rate": [0.1, 0.3],
    "max_features": [0.5, 1.0],
    "l2_regularization": [0.0, 1.0],
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def matrices():
    return parity.build_matrices(ROWS, SEED, "cpu"), ref_parity.build_matrices(ROWS, SEED)


def test_build_matrices_are_the_references(matrices):
    ours, ref = matrices
    names = ours["feature_names"]
    assert names == ref["feature_names"] and len(names) == 104
    assert ours["spw"] == ref["spw"]
    for k in ("y_train", "y_test"):
        assert ours[k].dtype == np.float32
        assert ours[k].tobytes() == np.asarray(ref[k]).tobytes(), k
    for k in ("X_train", "X_test"):
        got, want = ours[k], np.asarray(ref[k])
        assert isinstance(got, np.ndarray) and got.dtype == np.float32 and got.shape == want.shape
        for j, name in enumerate(names):
            if name == DATE_COLUMN:
                np.testing.assert_allclose(got[:, j], want[:, j], rtol=0, atol=DATE_ATOL)
            elif name in schema.LOG_COLS:
                np.testing.assert_allclose(got[:, j], want[:, j], rtol=LOG_RTOL, atol=0)
            else:
                assert got[:, j].tobytes() == want[:, j].tobytes(), (k, name)


@pytest.fixture
def shrunk(monkeypatch):
    """The configs both tools read, shrunk alike; the reference's mesh on
    one of its eight virtual devices."""
    port = (port_config.RFEConfig, port_config.TuneConfig, port_config.GBDTConfig)
    ref = (jax_config.RFEConfig, jax_config.TuneConfig, jax_config.GBDTConfig, jax_mesh.make_mesh)
    for module, (rfe, tune, gbdt), rfe_kw in (
        (port_config, port, RFE), (jax_config, ref[:3], dict(RFE, steps_per_dispatch=0)),
    ):
        monkeypatch.setattr(module, "RFEConfig", lambda cls=rfe, d=rfe_kw, **kw: cls(**{**d, **kw}))
        monkeypatch.setattr(module, "TuneConfig", lambda cls=tune, **kw: cls(**{**TUNE, **kw}))
        monkeypatch.setattr(module, "GBDTConfig", lambda cls=gbdt, **kw: cls(**{"n_bins": 32, **kw}))
    monkeypatch.setattr(jax_mesh, "make_mesh", lambda cfg=None: ref[3](cfg, devices=jax.devices()[:1]))


def test_run_ours_selects_and_tunes_as_the_references(matrices, shrunk):
    ours_mats, ref_mats = matrices
    got = parity.run_ours(ours_mats, device="cpu")
    want = ref_parity.run_ours(ref_mats)
    assert set(got) == set(want)
    assert got["side"] == "ours" and got["backend"] == "cpu"
    assert got["scheduler"] == want["scheduler"] == "exhaustive" and got["halving"] is None
    assert got["selected_features"] == want["selected_features"]
    assert len(got["selected_features"]) == 20
    assert got["best_params"] == want["best_params"]
    assert abs(got["cv_auc"] - want["cv_auc"]) <= SEARCH_TOL
    assert abs(got["test_auc"] - want["test_auc"]) <= SEARCH_TOL
    assert set(got["seconds"]) == {"rfe", "search", "total"}


@pytest.mark.slow  # 63 scikit-learn fits a side take ~30 s on a shared CPU
def test_run_oracle_is_the_references(matrices, monkeypatch):
    ours_mats, ref_mats = matrices
    monkeypatch.setattr(parity, "HGB_SPACE", HGB_SPACE)
    monkeypatch.setattr(ref_parity, "HGB_SPACE", HGB_SPACE)
    cut = lambda m: {**m, "X_train": np.asarray(m["X_train"])[:ORACLE_ROWS, :ORACLE_COLUMNS],  # noqa: E731
                     "y_train": np.asarray(m["y_train"])[:ORACLE_ROWS],
                     "X_test": np.asarray(m["X_test"])[:, :ORACLE_COLUMNS],
                     "feature_names": m["feature_names"][:ORACLE_COLUMNS]}
    with threadpool_limits(1):  # the suite shares its cores with other workers
        got = parity.run_oracle(cut(ours_mats))
        want = ref_parity.run_oracle(cut(ref_mats))
    got.pop("seconds"), want.pop("seconds")
    assert got == want
    assert len(got["selected_features"]) == 20


RECORDS = (ROOT / "PARITY_ours.json", ROOT / "PARITY_oracle.json")


def test_merge_is_the_references(tmp_path, capsys):
    ours, oracle = (json.loads(p.read_text()) for p in RECORDS)
    meta = {"n_rows": 130_000, "seed": 11}
    assert parity.merge(ours, oracle, **meta) == ref_parity.merge(ours, oracle, **meta)
    assert parity.PARITY_MARGIN == ref_parity.PARITY_MARGIN == 0.005
    args = ["merge", *map(str, RECORDS), "--out", str(tmp_path / "port.json")]
    got = parity.main(args)
    want = ref_parity.main(["merge", *map(str, RECORDS), "--out", str(tmp_path / "ref.json")])
    assert got == want and got["parity_ok"]
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
        (tmp_path / "ref.json").read_text())
    other = dict(oracle, n_rows=260_000)
    (tmp_path / "other.json").write_text(json.dumps(other))
    for tool in (parity, ref_parity):
        with pytest.raises(SystemExit, match="disagree on n_rows"):
            tool.main(["merge", str(RECORDS[0]), str(tmp_path / "other.json")])
        with pytest.raises(SystemExit, match="one 'ours' and one 'oracle'"):
            tool.main(["merge", str(RECORDS[0]), str(RECORDS[0])])


def test_merge_with_the_committed_oracle_writes_ledger_and_trace(tmp_path):
    ledger, trace = tmp_path / "ledger.json", tmp_path / "trace.json"
    ours = dict(json.loads(RECORDS[0].read_text()), backend="NVIDIA H100 80GB HBM3")
    (tmp_path / "ours.json").write_text(json.dumps(ours))
    out = parity.main(["merge", str(tmp_path / "ours.json"), str(RECORDS[1]),
                       "--ledger-out", str(ledger), "--trace-out", str(trace)])
    doc = json.loads(ledger.read_text())
    assert doc["kind"] == "parity" and doc["parity"] == out
    assert set(doc["stages"]) == {"ours.rfe", "ours.search", "oracle.rfe", "oracle.search"}
    assert "traceEvents" in json.loads(trace.read_text())


@pytest.mark.parametrize("side", ["oracle", "both"])
def test_oracle_side_without_sklearn_exits_nonzero(side, monkeypatch):
    monkeypatch.setitem(sys.modules, "sklearn", None)
    with pytest.raises(SystemExit) as exc:
        parity.main([side, "--rows", "200", "--device", "cpu"])
    assert exc.value.code not in (0, None)
    assert "scikit-learn" in str(exc.value.code)
