"""The port's ``tools.bench_kernels`` against the reference's
``tools/bench_kernels.py``, on the CPU.

- The seeded rows and labels, bit for bit: `kernel_rows` against what the
  reference's `run_kernel_bench` fits its forest on.
- The record at bucket 16, one repeat, f32/bf16/int8: its ``bench`` value,
  key tree and trend metric names are the reference's, but for ``card``.
- Quality: on the JAX-trained forest carried across by `convert.py`
  (`forest_from_numpy`), the port's bf16 and int8 quantization reports
  are within `PRECISION_TOLERANCES` and equal the reference record's.
- The ``--check`` gate gives the reference's verdict on the same records.
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

import cobalt_smart_lender_ai_tpu.models.gbdt as jax_gbdt
import cobalt_smart_lender_ai_tpu.ops.score_pallas  # noqa: F401
import cobalt_smart_lender_ai_tpu.parallel.partitioner  # noqa: F401
from cobalt_smart_lender_ai_tpu_torch.convert import forest_from_numpy
from cobalt_smart_lender_ai_tpu_torch.ops.score import PRECISION_TOLERANCES
from cobalt_smart_lender_ai_tpu_torch.tools import bench_kernels as port

ref = load_reference("ref_bench_kernels", "tools/bench_kernels.py")

PRECISIONS = ["f32", "bf16", "int8"]
QUANT_FIELDS = ("mean_abs_margin_delta", "max_abs_margin_delta", "mean_abs_prob_delta")


@pytest.fixture(scope="module")
def reference_run():
    """The reference's record at bucket 16, with the rows and labels its
    forest was fitted on and that fitted forest."""
    seen: dict = {}
    real_fit = jax_gbdt.GBDTClassifier.fit

    def fit(self, X, y, *a, **kw):
        seen["X"], seen["y"] = np.array(X), np.array(y)
        seen["model"] = real_fit(self, X, y, *a, **kw)
        return seen["model"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_gbdt.GBDTClassifier, "fit", fit)
        seen["record"] = ref.run_kernel_bench([16], repeats=1, precisions=PRECISIONS)
    return seen


def test_kernel_rows_are_the_references(reference_run):
    X, y = port.kernel_rows()
    assert X.dtype == np.float32 and y.dtype == np.int32
    assert X.tobytes() == reference_run["X"].tobytes()
    assert y.tobytes() == reference_run["y"].tobytes()


def test_record_shape_and_quantization_are_the_references(reference_run):
    jax_forest = reference_run["model"].forest
    arrays = {f.name: np.asarray(getattr(jax_forest, f.name))
              for f in dataclasses.fields(jax_forest) if f.name != "depth"}
    forest = forest_from_numpy(arrays, jax_forest.depth)
    record = port.run_kernel_bench([16], repeats=1, precisions=PRECISIONS, device="cpu", forest=forest)
    record["card"] = {"name": None, "power_limit": None}
    want = reference_run["record"]
    assert record["interpret_mode"] is False and record["platform"] == "cpu"
    assert_same_record_shape(want, record)
    for precision in ("bf16", "int8"):
        got, theirs = record["results"][precision]["quantization"], want["results"][precision]["quantization"]
        assert got["within_tolerance"] and got["probe_rows"] == theirs["probe_rows"]
        for field in QUANT_FIELDS:
            assert got[field] <= PRECISION_TOLERANCES[precision][field]
            assert got[field] == pytest.approx(theirs[field], rel=0, abs=1e-6)


def _record(fused_s: float, ref_s: float) -> dict:
    return {"results": {"f32": {"16": {"fused": {"dispatch_seconds": fused_s},
                                       "reference": {"dispatch_seconds": ref_s}},
                                "64": {"fused": {"dispatch_seconds": 0.001}}}}}


@pytest.mark.parametrize("fused_s,ref_s,slack", [(0.001, 0.002, 1.0), (0.003, 0.002, 1.0),
                                                 (0.003, 0.002, 1.6), (0.002, 0.002, 1.0)])
def test_check_gate_is_the_references(tmp_path, fused_s, ref_s, slack):
    record = _record(fused_s, ref_s)
    path = tmp_path / "record.json"
    path.write_text(json.dumps(record))
    want = ref.check_record(record, slack=slack)
    assert port.check_record(record, slack=slack) == want
    assert port.main(["--check", str(path), "--slack", str(slack)]) == want
