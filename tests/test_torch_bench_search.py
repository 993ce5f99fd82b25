"""The port's ``tools.bench_search`` against the reference's
``tools/bench_search.py``, on the CPU.

Both run ``--smoke --mini-grid --mode both`` (the reference's short profile
and its miniature 6 x 2 grid: each scheduler twice, cold and warm) on 1,000
loans of seed 5, each with its own build or compile cache in a temporary
directory, the reference's mesh on one of its virtual devices (the port
runs on one device). Both searches read the reference tool's matrices,
built once (`tests/test_torch_parity.py` holds the port's `build_matrices`
to them), so the two see the same bits.

- The record's ``bench`` value, key tree and trend metric names are the
  reference's, but for ``card``.
- Quality, to `tests/test_torch_halving.py`'s tolerances. The reference's
  vmapped CV runner casts g and h to bf16 in its histogram
  (``cobalt_smart_lender_ai_tpu/ops/histogram.py:199-201``), so its scores
  carry that error (thousandths of AUC at depth 3); the port's are exact
  (held within 1e-6 of unbatched JAX fits by `tests/test_torch_tune.py` and
  `tests/test_torch_halving.py`). Per scheduler: every candidate's mean CV
  AUC, the winner's among them, within ``MARGIN`` of the reference's, and,
  wherever the best two candidates' means differ by more than ``MARGIN``,
  the same winner; the halving report (rungs, survivors,
  pruned count) equal wherever each rung's kept and pruned candidates
  differ by more than ``MARGIN``.
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest
from _bench_records import (  # noqa: F401  (one_torch_thread is an autouse fixture)
    assert_same_record_shape,
    load_reference,
    one_torch_thread,
)

import cobalt_smart_lender_ai_tpu.parallel.mesh as jax_mesh
import cobalt_smart_lender_ai_tpu.parallel.tune  # noqa: F401
import cobalt_smart_lender_ai_tpu_torch.parallel.tune  # noqa: F401
from cobalt_smart_lender_ai_tpu_torch.tools import bench_search as port
from cobalt_smart_lender_ai_tpu_torch.tools import parity as port_parity

ref = load_reference("ref_bench_search", "tools/bench_search.py")
import parity as ref_parity  # noqa: E402  (the reference's tool, on the path the harness put it)

MARGIN = 0.005
ARGV = ["--smoke", "--mini-grid", "--mode", "both", "--rows", "1000", "--seed", "5"]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bench_search")
    real_mesh = jax_mesh.make_mesh

    mats = ref_parity.build_matrices(1000, 5)  # the rows and seed of ``ARGV``
    port_mats = {k: v if k in ("spw", "feature_names") else np.array(v) for k, v in mats.items()}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_mesh, "make_mesh", lambda cfg=None, devices=None: real_mesh(cfg, devices=jax.devices()[:1]))
        mp.setattr(ref_parity, "build_matrices", lambda rows, seed: mats)
        mp.setattr(port_parity, "build_matrices", lambda rows, seed, device="cuda": port_mats)
        assert ref.main([*ARGV, "--cache-dir", str(tmp / "ref_cache"), "--out", str(tmp / "ref.json")]) == 0
        assert port.main([*ARGV, "--cache-dir", str(tmp / "port_cache"), "--device", "cpu",
                          "--out", str(tmp / "port.json")]) == 0
    return json.loads((tmp / "ref.json").read_text()), json.loads((tmp / "port.json").read_text())


def test_record_shape_is_the_references(records):
    ref_rec, port_rec = records
    assert port_rec["backend"] == "cpu" and port_rec["n_devices"] == 1
    assert set(port_rec["runs"]) == {"halving", "exhaustive"}
    assert "halving" in port_rec["runs"]["halving"]
    assert_same_record_shape(ref_rec, port_rec)


def _rungs_separated(run: dict) -> bool:
    """Whether, at every rung of the reference's halving report, the kept
    and the pruned candidates' scores differ by more than ``MARGIN``."""
    scores = np.asarray(run["mean_test_score"])
    survivors = set(run["halving"]["survivors"])
    pruned = [c for c in range(len(scores)) if c not in survivors]
    return not pruned or min(scores[list(survivors)]) - max(scores[pruned]) > MARGIN


@pytest.mark.parametrize("mode", ["halving", "exhaustive"])
def test_cv_aucs_and_winner_are_the_references(records, mode):
    ref_run, port_run = (rec["runs"][mode] for rec in records)
    got, want = np.asarray(port_run["mean_test_score"]), np.asarray(ref_run["mean_test_score"])
    np.testing.assert_allclose(got, want, rtol=0, atol=MARGIN)
    best_two = np.sort(want)[::-1][:2]
    if best_two[0] - best_two[1] > MARGIN:
        assert port_run["best_params"] == ref_run["best_params"]
    if mode == "halving" and _rungs_separated(ref_run):
        for key in ("rungs", "survivors", "pruned_candidates"):
            assert port_run["halving"][key] == ref_run["halving"][key], key
