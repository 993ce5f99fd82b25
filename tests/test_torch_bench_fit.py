"""The port's ``tools.bench`` against the reference's ``bench.py``, on the CPU.

- The single fit's inputs, bit for bit: the rows the reference bins (its
  planted logit, 2% NaN), its labels and its 80/20 split weights, as the
  reference's ``main`` hands them to its fit, against
  `planted_logit_rows`.
- The single fit at 20,000 rows with ``N_TREES`` cut to 20 (chunks of 10) on
  both sides: the held-out AUC within 1e-6 of the JAX package's (depth 3:
  shallow trees keep the sigmoid's near-ties away), and the record's key
  tree and trend metric name the reference's, but for the port's ``card``
  block and the reference's three keys taken on or for a TPU:
  ``vs_baseline``, ``protocol`` and ``tuned_test_auc``. The run ledger's
  stages are the reference's too.
- ``--protocol`` on 1,500 loans, with `PipelineConfig` shrunk alike on both
  sides (one RFE refit of 2 trees, a 2 x 2 search of shallow candidates):
  the record's key tree, its stage names and its trend metric name are the
  reference's, but for ``card`` and ``vs_baseline``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import sys

import numpy as np
import pytest
from _bench_records import (  # noqa: F401  (one_torch_thread is an autouse fixture)
    assert_same_record_shape,
    load_reference,
    one_torch_thread,
)

import cobalt_smart_lender_ai_tpu.config as jax_config
import cobalt_smart_lender_ai_tpu.models.gbdt as jax_gbdt
import cobalt_smart_lender_ai_tpu.ops.binning as jax_binning
import cobalt_smart_lender_ai_tpu.ops.metrics as jax_metrics
import cobalt_smart_lender_ai_tpu.pipeline  # noqa: F401  (imported before its config is patched)
import cobalt_smart_lender_ai_tpu_torch.config as port_config
import cobalt_smart_lender_ai_tpu_torch.ops.metrics as port_metrics
import cobalt_smart_lender_ai_tpu_torch.pipeline  # noqa: F401
from cobalt_smart_lender_ai_tpu_torch.tools import bench as port

ref = load_reference("ref_bench", "bench.py")

ROWS, TREES, CHUNK = 20_000, 20, 10
AUC_TOL = 1e-6
TPU_KEYS = ("vs_baseline", "protocol", "tuned_test_auc")


@pytest.fixture(scope="module")
def single_fits(tmp_path_factory):
    """Both single fits at ``ROWS`` x ``TREES``: the reference's captured
    inputs and AUC, both records and both ledgers."""
    tmp = tmp_path_factory.mktemp("bench_fit")
    seen: dict = {"auc": [], "port_auc": []}

    def ref_edges(X, *a, _real=jax_binning.compute_bin_edges, **kw):
        seen["X"] = np.asarray(X)
        return _real(X, *a, **kw)

    def ref_fit(bins, y, w, *a, _real=jax_gbdt.fit_binned_chunked, **kw):
        seen["y"], seen["train_w"] = np.asarray(y), np.asarray(w)
        return _real(bins, y, w, *a, **kw)

    def ref_auc(*a, _real=jax_metrics.roc_auc, **kw):
        out = _real(*a, **kw)
        seen["auc"].append(float(out))
        return out

    def port_auc(*a, _real=port_metrics.roc_auc, **kw):
        out = _real(*a, **kw)
        seen["port_auc"].append(float(out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        for module in (ref, port):
            mp.setattr(module, "N_TREES", TREES)
            mp.setattr(module, "CHUNK_TREES", CHUNK)
        mp.setattr(jax_binning, "compute_bin_edges", ref_edges)
        mp.setattr(jax_gbdt, "fit_binned_chunked", ref_fit)
        mp.setattr(jax_metrics, "roc_auc", ref_auc)
        mp.setattr(port_metrics, "roc_auc", port_auc)
        mp.setattr(sys, "argv", ["bench.py", "--rows", str(ROWS), "--ledger-out", str(tmp / "ref_ledger.json")])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ref.main()  # reads sys.argv and prints its record
        seen["ref"] = json.loads(buf.getvalue().strip().splitlines()[-1])
        seen["port"] = port.main(["--rows", str(ROWS), "--device", "cpu", "--out", str(tmp / "port.json"),
                                  "--ledger-out", str(tmp / "port_ledger.json")])
    seen["ledgers"] = [json.loads((tmp / f"{side}_ledger.json").read_text()) for side in ("ref", "port")]
    assert json.loads((tmp / "port.json").read_text()) == json.loads(json.dumps(seen["port"]))
    return seen


def test_planted_logit_rows_are_the_references(single_fits):
    X, y, test = port.planted_logit_rows(ROWS)
    assert X.dtype == np.float32 and y.dtype == np.int32 and test.dtype == bool
    assert X.tobytes() == single_fits["X"].tobytes()
    assert y.tobytes() == single_fits["y"].tobytes()
    assert (~test).astype(np.float32).tobytes() == single_fits["train_w"].tobytes()
    assert test.sum() == ROWS // 5


def test_single_fit_auc_is_the_references(single_fits):
    ref_warm, ref_timed = single_fits["auc"]
    port_warm, port_timed = single_fits["port_auc"]
    assert abs(port_timed - ref_timed) <= AUC_TOL
    assert abs(port_warm - ref_warm) <= AUC_TOL
    assert 0.7 < port_timed < 0.95
    assert f"held-out AUC {port_timed:.3f}" in single_fits["port"]["unit"]


def test_single_fit_record_is_the_references_without_its_tpu_keys(single_fits):
    ref_rec, port_rec = single_fits["ref"], dict(single_fits["port"])
    assert not set(TPU_KEYS) & set(port_rec)
    assert port_rec["metric"] == ref_rec["metric"] == "full_table_e2e_rows_per_sec_per_chip"
    ref_rec = {k: v for k, v in ref_rec.items() if k != "telemetry"}
    port_rec = {k: v for k, v in port_rec.items() if k != "telemetry"}
    assert_same_record_shape(ref_rec, port_rec, ref_only=TPU_KEYS)
    assert set(single_fits["port"]["telemetry"]) == set(single_fits["ref"]["telemetry"])
    ref_ledger, port_ledger = single_fits["ledgers"]
    assert list(port_ledger["stages"]) == list(ref_ledger["stages"]) == ["full_table_fit"]
    assert set(port_ledger["headline"]) == set(ref_ledger["headline"]) - set(TPU_KEYS) | {"card"}


SPACE = {"n_estimators": (4, 6), "max_depth": (2,), "learning_rate": (0.1, 0.3)}


def _shrunk(real):
    """`PipelineConfig` as the harness builds it, with a small RFE and
    search (rows and width not cut)."""

    def make(**kw):
        cfg = real(**kw)
        return dataclasses.replace(
            cfg,
            gbdt=cfg.gbdt.replace(n_bins=32),
            rfe=dataclasses.replace(cfg.rfe, step=84, n_estimators=2, max_depth=2),
            tune=dataclasses.replace(cfg.tune, n_iter=2, cv_folds=2, param_space=SPACE),
        )

    return make


def test_protocol_record_is_the_references(monkeypatch, tmp_path):
    monkeypatch.setattr(jax_config, "PipelineConfig", _shrunk(jax_config.PipelineConfig))
    monkeypatch.setattr(port_config, "PipelineConfig", _shrunk(port_config.PipelineConfig))
    ref_rec = ref.run_protocol(1500)
    port_rec = port.run_protocol(1500, device="cpu")
    port_rec["card"] = {"name": None, "power_limit": None}
    assert port_rec["metric"] == ref_rec["metric"] == "full_protocol_rows_per_sec_per_chip"
    assert list(port_rec["seconds_stage"]) == list(ref_rec["seconds_stage"])
    assert set(port_rec["best_params"]) == set(ref_rec["best_params"])
    assert 0.5 < port_rec["test_auc"] <= 1.0
    ref_rec = {k: v for k, v in ref_rec.items() if k not in ("telemetry", "seconds_stage")}
    port_rec = {k: v for k, v in port_rec.items() if k not in ("telemetry", "seconds_stage")}
    assert_same_record_shape(ref_rec, port_rec, ref_only=("vs_baseline",))
