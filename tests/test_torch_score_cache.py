"""The port's content-hash score cache against the JAX package's.

Both services restore the same artifact on the CPU, with the micro-batcher
off as the reference's cache tests run (each miss is one launch), and see
the same sequence of payloads. After each sequence the ``/readyz``
``score_cache`` block (size, entries, hits, misses) is equal, and every
response is the reference's within the serving tolerances (prob 1e-6, SHAP
1e-5), the other keys equal. Cases: a repeated payload (the hit is the
miss's response bit for bit), the aliased and underscored spellings and
int/float spellings of one application sharing an entry, LRU eviction at
the size bound, invalidation on reload, and size 0. With the micro-batcher
on, a hit runs no scoring call (no dispatch of the plain version on its
program), and a payload cached before a swap to another model answers with
the new model's probability after it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from cobalt_smart_lender_ai_tpu.config import ServeConfig as JaxServeConfig
from cobalt_smart_lender_ai_tpu.data import schema as jax_schema
from cobalt_smart_lender_ai_tpu.io import GBDTArtifact as JaxArtifact
from cobalt_smart_lender_ai_tpu.io import ObjectStore as JaxStore
from cobalt_smart_lender_ai_tpu.models.gbdt import GBDTClassifier as JaxClassifier
from cobalt_smart_lender_ai_tpu.serve.service import ScorerService as JaxScorerService
from cobalt_smart_lender_ai_tpu_torch.config import ServeConfig
from cobalt_smart_lender_ai_tpu_torch.io import ObjectStore
from cobalt_smart_lender_ai_tpu_torch.serve.service import ScorerService
from cobalt_smart_lender_ai_tpu_torch.telemetry import default_program_registry

TOL_PROB = 1e-6
TOL_SHAP = 1e-5
KEY = "models/gbdt/model_tree"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def store_root(tmp_path_factory):
    """A small forest trained by the JAX package on the 20 serving features
    (saved as the artifact), and a second one, all leaves zero, at
    ``models/gbdt/zero``."""
    rng = np.random.default_rng(41)
    F = len(jax_schema.SERVING_FEATURES)
    X = rng.normal(size=(1024, F)).astype(np.float32) * 5.0
    X[:, 12:] = rng.integers(0, 2, size=(1024, F - 12))
    y = X[:, 0] - 0.6 * X[:, 4] + 2.0 * X[:, 12] + rng.normal(size=1024) > 0
    model = JaxClassifier(n_estimators=10, max_depth=3, n_bins=32)
    model.fit(X, y.astype(np.int32))
    root = tmp_path_factory.mktemp("torch_score_cache") / "lake"
    art = JaxArtifact(
        forest=model.forest, bin_spec=model.bin_spec, feature_names=tuple(jax_schema.SERVING_FEATURES)
    )
    art.save(JaxStore(str(root)), KEY)
    zero = dataclasses.replace(
        art, forest=dataclasses.replace(art.forest, leaf_value=art.forest.leaf_value * 0.0)
    )
    zero.save(JaxStore(str(root)), "models/gbdt/zero")
    return str(root)


def _payload(loan_amnt: float = 9.2, aliased: bool = True, ints_as_floats: bool = False) -> dict:
    vals = {
        "loan_amnt": loan_amnt, "term": 36.0, "installment": 5.7,
        "fico_range_low": 6.55, "last_fico_range_high": 690.0,
        "open_il_12m": 1.0, "open_il_24m": 2.0, "max_bal_bc": 5000.0,
        "num_rev_accts": 2.3, "pub_rec_bankruptcies": 0.0,
        "emp_length_num": 5.0, "earliest_cr_line_days": 8.6,
        "grade_E": 0, "home_ownership_MORTGAGE": 1,
        "verification_status_Verified": 0,
        "application_type_Joint App": 0,
        "hardship_status_BROKEN": 0, "hardship_status_COMPLETE": 0,
        "hardship_status_COMPLETED": 0, "hardship_status_No Hardship": 1,
    }
    if not aliased:
        vals["application_type_Joint_App"] = vals.pop("application_type_Joint App")
        vals["hardship_status_No_Hardship"] = vals.pop("hardship_status_No Hardship")
    if ints_as_floats:
        vals = {k: float(v) if isinstance(v, int) else v for k, v in vals.items()}
        vals["max_bal_bc"] = 5000  # an int spelling of a float field
    return dict(reversed(list(vals.items()))) if ints_as_floats else vals


def _services(root: str, **kw):
    port = ScorerService.from_store(
        ObjectStore(root), ServeConfig(microbatch_enabled=False, **kw), device="cpu"
    )
    ref = JaxScorerService.from_store(
        JaxStore(root),
        JaxServeConfig(
            microbatch_enabled=False, precompile_batch_buckets=(), prewarm_all_buckets=False, **kw
        ),
    )
    return port, ref


def _assert_same_response(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    assert got["features"] == want["features"] and got["input_row"] == want["input_row"]
    assert abs(got["prob_default"] - want["prob_default"]) <= TOL_PROB
    np.testing.assert_allclose(got["shap_values"], want["shap_values"], rtol=0, atol=TOL_SHAP)
    assert abs(got["base_value"] - want["base_value"]) <= TOL_SHAP


def _run(root: str, steps: list, **kw) -> tuple[list, list, dict, dict]:
    """Each step (a payload, or ``"reload"``) on both services: (port
    answers, reference answers, port cache block, reference cache block)."""
    port, ref = _services(root, **kw)
    try:
        got, want = [], []
        for step in steps:
            if step == "reload":
                got.append(port.reload_from_store())
                want.append(ref.reload_from_store())
            else:
                got.append(port.predict_single(step))
                want.append(ref.predict_single(step))
        return got, want, port.ready()[1]["score_cache"], ref.ready()[1]["score_cache"]
    finally:
        port.close()
        ref.close()


CASES = {
    "repeat": ([_payload(), _payload()], {}, (1, 1, 1)),
    "spellings": (
        [_payload(aliased=True), _payload(aliased=False), _payload(ints_as_floats=True)],
        {},
        (2, 1, 1),
    ),
    "lru_eviction": (
        [_payload(loan_amnt=a) for a in (1.0, 2.0, 3.0, 1.0, 3.0)],
        {"score_cache_size": 2},
        (1, 4, 2),
    ),
    "reload_invalidates": ([_payload(), _payload(), "reload", _payload()], {}, (1, 2, 1)),
    "size_zero": ([_payload(), _payload()], {"score_cache_size": 0}, (0, 0, 0)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cache_counts_and_bodies_match_the_reference(store_root, case):
    steps, kw, (hits, misses, entries) = CASES[case]
    got, want, port_cache, ref_cache = _run(store_root, steps, **kw)
    assert port_cache == ref_cache
    assert (port_cache["hits"], port_cache["misses"], port_cache["entries"]) == (
        hits, misses, entries
    )
    for step, g, w in zip(steps, got, want):
        if step == "reload":
            assert g == w == {"status": "ok", "model_key": KEY, "n_features": 20}
        else:
            _assert_same_response(g, w)
    if case == "repeat":
        assert got[1] == got[0]  # the hit is the miss's response, bit for bit
    if case == "spellings":
        assert got[1]["shap_values"] == got[0]["shap_values"]


def _plain_dispatches() -> int:
    return sum(
        r["dispatches"] for r in default_program_registry().table()
        if r["name"].startswith("score_forest_plain/")
    )


def test_batched_hit_runs_no_scoring_call(store_root):
    """With the micro-batcher on, a hit scores nothing: no batch, no
    dispatch of the plain version; the miss took one batch."""
    svc = ScorerService.from_store(ObjectStore(store_root), ServeConfig(), device="cpu")
    try:
        first = svc.predict_single(_payload(loan_amnt=4.4))
        batches, dispatches = svc.batcher.batches, _plain_dispatches()
        second = svc.predict_single(_payload(loan_amnt=4.4, aliased=False))
        assert (svc.batcher.batches, _plain_dispatches()) == (batches, dispatches)
        assert second == first
        assert svc.ready()[1]["score_cache"] == {"size": 2048, "entries": 1, "hits": 1, "misses": 1}
        fams = {f.name: f for f in svc.registry.families()}
        assert fams["cobalt_score_cache_hits_total"].value == 1
        assert fams["cobalt_score_cache_entries"].value == 1
    finally:
        svc.close()


def test_cached_payload_answers_with_the_new_model_after_a_swap(store_root):
    """A payload cached under the first model answers, after a swap to the
    all-zero forest, with that forest's probability (0.5), as the
    reference's does."""
    answers = {}
    port, ref = _services(store_root)
    try:
        for side, svc in (("port", port), ("ref", ref)):
            before = [svc.predict_single(_payload()) for _ in range(2)]
            result = svc.reload_from_store(model_key="models/gbdt/zero")
            after = svc.predict_single(_payload())
            answers[side] = (before, result, after, svc.ready()[1]["score_cache"])
    finally:
        port.close()
        ref.close()
    (p_before, p_result, p_after, p_cache) = answers["port"]
    (r_before, r_result, r_after, r_cache) = answers["ref"]
    assert p_before[0]["prob_default"] != 0.5 and p_before[1] == p_before[0]
    assert p_result == r_result and p_result["status"] == "ok"
    assert p_after["prob_default"] == r_after["prob_default"] == 0.5
    _assert_same_response(p_after, r_after)
    assert p_cache == r_cache == {"size": 2048, "entries": 1, "hits": 1, "misses": 2}
