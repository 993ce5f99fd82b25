"""The port's ``tools.bench_models`` against the reference's
``tools/bench_models.py``, on the CPU.

The reference's families retrain and recompile five times each, about two
minutes even at a toy size on the CPU, so the record is held to the reference's
in two parts, and the port's families run for real:

- `bench_family`, the harness's method, on one seeded stand-in model (its
  fit records the epochs asked and its probabilities are a fixed function
  of the rows): the same keys, rows, epochs run and held-out AUC as the
  reference's.
- `main` on 1,500 loans, each side's `bench_family` replaced by a recorder:
  the same nn frame (training rows, features), the same short and long
  epochs per family, the same model family built at each, and the record's
  key tree and trend metric names (none: the record has no ``bench`` key,
  as the reference's ``MODELS_BENCH.json``) the reference's, but for
  ``card``.
- The port's `main` for real at 2 and 3 epochs, the FT-Transformer narrowed
  (one block of 8-wide tokens, one head): each family trains the epochs
  asked and scores a finite held-out AUC.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
from _bench_records import (  # noqa: F401  (one_torch_thread is an autouse fixture)
    assert_same_record_shape,
    load_reference,
    one_torch_thread,
)

import cobalt_smart_lender_ai_tpu_torch.config as port_config
import cobalt_smart_lender_ai_tpu_torch.models.ft_transformer  # noqa: F401
from cobalt_smart_lender_ai_tpu_torch.tools import bench_models as port

ref = load_reference("ref_bench_models", "tools/bench_models.py")

ROWS, SHORT, LONG = 1500, 2, 3
FAMILIES = ("mlp", "ft_transformer", "tabnet")


class StandIn:
    """A model whose fit records its epochs and whose P(default) is a fixed
    function of the first feature."""

    def __init__(self, epochs: int):
        self.epochs = epochs

    def fit(self, X, y):
        self.history = {"loss": [0.0] * self.epochs}
        return self

    def predict_proba(self, X):
        p1 = 1.0 / (1.0 + np.exp(-np.asarray(X, np.float64)[:, 0]))
        return np.stack([1.0 - p1, p1], axis=1)


class TorchStandIn(StandIn):
    def predict_proba(self, X):
        import torch

        return torch.from_numpy(super().predict_proba(X).astype(np.float32))


def test_bench_family_is_the_references():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(500, 4)).astype(np.float32)
    y = (X[:, 0] + rng.normal(size=500) > 0).astype(np.int32)
    want = ref.bench_family(StandIn, (X[:400], y[:400]), (X[400:],), y[400:], short=2, long=3)
    got = port.bench_family(TorchStandIn, (X[:400], y[:400]), (X[400:],), y[400:], short=2, long=3)
    assert list(got) == list(want)
    for key in ("rows", "epochs_run"):
        assert got[key] == want[key]
    assert got["test_auc"] == pytest.approx(want["test_auc"], abs=1e-4)
    assert port.NOISE_FLOOR_S == 5.0


def _recorder(calls: dict, name: str):
    def bench_family(make_model, fit_args, test_args, y_test, short, long):
        models = [make_model(e) for e in (short, long)]
        calls.setdefault(name, []).append(
            ([type(m).__name__ for m in models], short, long, int(np.asarray(fit_args[-1]).shape[0])))
        return {"rows": int(np.asarray(fit_args[-1]).shape[0]), "steady_rows_per_sec": 0,
                "throughput_measurement": "recorded", "test_auc": 0.0}

    return bench_family


def test_main_record_is_the_references(tmp_path):
    calls: dict = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref, "bench_family", _recorder(calls, "ref"))
        mp.setattr(port, "bench_family", _recorder(calls, "port"))
        ref_rec = ref.main(["--rows", str(ROWS)])
        port_rec = port.main(["--rows", str(ROWS), "--device", "cpu", "--out", str(tmp_path / "port.json")])
    assert calls["port"] == calls["ref"] and len(calls["port"]) == 3
    assert (port_rec["train_rows"], port_rec["features"]) == (ref_rec["train_rows"], ref_rec["features"])
    assert port_rec["backend"] == "cpu"
    assert_same_record_shape(ref_rec, port_rec)


def test_port_families_train_on_the_cpu(tmp_path):
    def narrow(**kw):
        return dataclasses.replace(real_ft(**kw), d_token=8, n_blocks=1, n_heads=1)

    def epochs(*args, short, long, _real=port.bench_family):
        return _real(*args, short=SHORT, long=LONG)

    real_ft = port_config.FTTransformerConfig
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_config, "FTTransformerConfig", narrow)
        mp.setattr(port, "bench_family", epochs)
        record = port.main(["--rows", str(ROWS), "--device", "cpu", "--out", str(tmp_path / "port.json")])
    assert json.loads((tmp_path / "port.json").read_text()) == record
    for family in FAMILIES:
        row = record[family]
        assert row["epochs_run"] == [SHORT, LONG]
        assert 0.0 <= row["test_auc"] <= 1.0 and row["steady_rows_per_sec"] > 0
