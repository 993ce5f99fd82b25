"""The port's host cleaning path against the JAX package's, on the CPU.

`clean_raw_frame` -> `prepare_cleaned_frame` -> `engineer_features`, in the
port on `RawFrame` columns (no pandas) and in the JAX package on pandas, on
the same inputs with ``today`` pinned:

- seeded synthetic LendingClub frames (the two packages' generators give
  cell-identical frames; the port also reads the reference's own pandas
  frame through `as_raw_frame`);
- a small frame of degenerate cells: the cells of
  ``tests/test_data_pipeline.py``'s parser tests (whitespace-only, empty,
  missing and malformed term / percent cells), unparseable emp_length and
  dates, unmapped and missing statuses, a residual string column with
  missing cells, duplicates that differ only in NaN cells or the sign of
  zero, a junk column over the null threshold and near-complete columns.

Held to the reference: the same `CleanReport`; cleaned and prepared tables
with the same columns in the same order, numbers bitwise (int or float as
the reference's pandas dtype), strings and missing cells alike; the same
`FeaturePlan` (medians within ``LOG_RTOL`` for log1p-derived columns, bitwise
otherwise); tree and nn matrices and labels bitwise, except log1p-derived
columns within ``LOG_RTOL`` (the port's log1p and XLA's differ in the last
bits). And the port's host path equals the port's device ingest on the CPU
(report, plan but its ``asof``, matrices).
"""

from __future__ import annotations

import dataclasses
from datetime import datetime

import numpy as np
import pandas as pd
import pytest
import torch

from cobalt_smart_lender_ai_tpu.data.clean import clean_raw_frame as jax_clean
from cobalt_smart_lender_ai_tpu.data.features import engineer_features as jax_engineer
from cobalt_smart_lender_ai_tpu.data.features import prepare_cleaned_frame as jax_prepare
from cobalt_smart_lender_ai_tpu.data.synthetic import synthetic_lendingclub_frame as jax_synthetic
from cobalt_smart_lender_ai_tpu_torch.data import schema
from cobalt_smart_lender_ai_tpu_torch.data.clean import clean_raw_frame, duplicated, isnull
from cobalt_smart_lender_ai_tpu_torch.data.device_pipeline import (
    run_device_ingest,
    tokenize_raw_frame,
)
from cobalt_smart_lender_ai_tpu_torch.data.features import engineer_features, prepare_cleaned_frame
from cobalt_smart_lender_ai_tpu_torch.data.frame import RawFrame, as_raw_frame
from cobalt_smart_lender_ai_tpu_torch.data.synthetic import synthetic_lendingclub_frame

TODAY = datetime(2026, 8, 1)
#: Relative tolerance of log1p-derived floats, the JAX package's own
#: (tests/test_device_pipeline.py): a few float32 ulps.
LOG_RTOL = 3e-7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _degenerate_frame(n: int = 240, seed: int = 3) -> pd.DataFrame:
    rng = np.random.default_rng(seed)

    def pick(values, p_missing):
        out = [values[i] for i in rng.integers(0, len(values), n)]
        return [None if m else v for v, m in zip(out, rng.random(n) < p_missing)]

    amount = rng.choice([1000.0, 0.0, -0.0, 2500.5, 1e-3], n)
    amount[rng.random(n) < 0.2] = np.nan
    inq = rng.integers(0, 4, n).astype(float)
    inq[rng.random(n) < 0.3] = np.nan
    df = pd.DataFrame(
        {
            "Unnamed: 0": np.arange(n),
            "id": np.arange(n) % 7,  # near-complete, never missing
            "term": pick([" 36 months", " 60 months", "   ", "", "36.5 months"], 0.1),
            "int_rate": pick(["13.56%", "7.00%", "  ", "", "bogus", "5%"], 0.1),
            "hardship_status": pick(["ACTIVE", "COMPLETED"], 0.5),
            "emp_length": pick(["< 1 year", "10+ years", "3 years", "n/a", ""], 0.15),
            "earliest_cr_line": pick(["Jan-2001", "Feb-2003", "bogus", "Dec-1999"], 0.15),
            "revol_util": pick(["50%", "", "12.5%", "x"], 0.15),
            "loan_status": pick(["Fully Paid", "Charged Off", "Current", "Weird", "Default"], 0.1),
            "loan_amnt": amount,
            "annual_inc": rng.choice([0.0, 52000.0, 81000.0, np.nan], n),
            "dti": rng.choice([12.5, 0.0, np.nan], n),
            "mths_since_last_delinq": rng.choice([3.0, 40.0, np.nan], n),
            "inq_last_12m": inq,
            "grade": pick(["A", "B", "C"], 0.1),
            "home_ownership": pick(["RENT", "OWN"], 0.0),
            "branch_code": pick(["north", "east", ""], 0.2),
            "junk_sparse_0": rng.choice([1.0, np.nan], n, p=[0.1, 0.9]),
        }
    )
    # Duplicates: exact copies, copies whose only differences are NaN cells
    # (NaN equals NaN) and a sign of zero, and a near-copy that differs.
    df.loc[1, "loan_amnt"] = 0.0
    dup = df.iloc[[0, 1, 2, 3, 4, 5]].copy()
    dup.loc[dup.index[1], "loan_amnt"] = -0.0
    near = df.iloc[[6]].copy()
    near["annual_inc"] = 123.0
    df = pd.concat([df, dup, near], ignore_index=True)
    # One near-complete column with a few missing cells (its rows go).
    inc = df["id"].astype(float)
    inc.iloc[[10, 20]] = np.nan
    df["funded_amnt"] = inc
    return df


def _jax_host_path(df: pd.DataFrame):
    cleaned, report = jax_clean(df.copy())
    prepared = jax_prepare(cleaned, today=TODAY)
    return cleaned, report, prepared, jax_engineer(prepared)


def _port_host_path(frame):
    cleaned, report = clean_raw_frame(frame)
    prepared = prepare_cleaned_frame(cleaned, today=TODAY)
    return cleaned, report, prepared, engineer_features(prepared, device="cpu")


@pytest.fixture(scope="module")
def synthetic_runs():
    jax = _jax_host_path(jax_synthetic(3000, 7))
    port = _port_host_path(synthetic_lendingclub_frame(3000, 7))
    return jax, port


@pytest.fixture(scope="module")
def degenerate_runs():
    df = _degenerate_frame()
    return _jax_host_path(df), _port_host_path(df)


CASES = ["synthetic", "degenerate"]


@pytest.fixture(params=CASES)
def runs(request, synthetic_runs, degenerate_runs):
    return synthetic_runs if request.param == "synthetic" else degenerate_runs


def _assert_table_equal(ref: pd.DataFrame, got: RawFrame, what: str) -> None:
    assert got.columns == [str(c) for c in ref.columns], what
    assert got.n_rows == len(ref), what
    for name in ref.columns:
        col = ref[name]
        if pd.api.types.is_numeric_dtype(col):
            want = col.to_numpy()
            have = got[name]
            assert have.dtype.kind == want.dtype.kind, f"{what}: {name} {have.dtype} vs {want.dtype}"
            a, b = want.astype(np.float64), have.astype(np.float64)
            same = (a.view(np.int64) == b.view(np.int64)) | (np.isnan(a) & np.isnan(b))
            assert same.all(), f"{what}: column {name!r} differs"
        else:
            miss = col.isna().to_numpy()
            assert got[name].dtype.kind == "U", f"{what}: {name}"
            assert np.array_equal(isnull(got, name), miss), f"{what}: {name} missing cells"
            assert np.array_equal(got[name][~miss], col[~miss].astype(str).to_numpy()), f"{what}: {name}"


def _assert_columns(names, A, B, log_cols, what):
    assert A.shape == B.shape, what
    both_nan = np.isnan(A) & np.isnan(B)
    for j, name in enumerate(names):
        if name in log_cols:
            ok = np.isclose(A[:, j], B[:, j], rtol=LOG_RTOL, atol=0.0) | both_nan[:, j]
        else:
            ok = (A[:, j] == B[:, j]) | both_nan[:, j]
        assert ok.all(), f"{what}: column {name!r} differs in {int((~ok).sum())} rows"


def test_clean_report_matches_jax(runs):
    (_, ref, _, _), (_, got, _, _) = runs
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.n_duplicates_removed > 0


def test_cleaned_table_matches_jax(runs):
    (ref, _, _, _), (got, _, _, _) = runs
    _assert_table_equal(ref, got, "cleaned")


def test_prepared_table_matches_jax(runs):
    (_, _, ref, _), (_, _, got, _) = runs
    _assert_table_equal(ref, got, "prepared")
    assert got.columns[-3:] == ["emp_length_num", "earliest_cr_line_days", schema.LABEL_COL]


def test_plan_matches_jax(runs):
    (_, _, _, (_, _, ref)), (_, _, _, (_, _, got)) = runs
    for field in ("numeric_names", "log_cols", "tree_feature_names", "nn_feature_names", "asof"):
        assert getattr(got, field) == getattr(ref, field), field
    assert got.asof is None
    assert list(got.categorical_vocab.items()) == list(ref.categorical_vocab.items())
    assert dict(got.label_vocab) == dict(ref.label_vocab)
    assert set(got.medians) == set(ref.medians)
    for k, v in ref.medians.items():
        if k in ref.log_cols:
            assert np.isclose(got.medians[k], v, rtol=LOG_RTOL, atol=0.0), k
        else:
            assert got.medians[k] == v, k


@pytest.mark.parametrize("frame", ["tree", "nn"])
def test_feature_matrices_match_jax(runs, frame):
    (_, _, _, ref_out), (_, _, _, got_out) = runs
    i = ["tree", "nn"].index(frame)
    ref, got = ref_out[i], got_out[i]
    assert got.feature_names == ref.feature_names
    log_cols = set(ref_out[2].log_cols)
    _assert_columns(ref.feature_names, np.asarray(ref.X), got.X.numpy(), log_cols, frame)
    ya, yb = np.asarray(ref.y), got.y.numpy()
    assert ((ya == yb) | (np.isnan(ya) & np.isnan(yb))).all()


def test_degenerate_cells_land_as_the_reference_puts_them(degenerate_runs):
    """Spot checks behind the column comparisons: unparseable cells are
    missing, an unmapped status keeps its row with a NaN label, the residual
    string column's missing cells are the token ``"missing"``."""
    _, (cleaned, report, prepared, (tree, _, plan)) = degenerate_runs
    assert report.dropped_null_columns == ["junk_sparse_0"]
    assert report.n_rows_dropped_near_complete >= 2
    assert cleaned["term"].dtype == np.float64 and cleaned["int_rate"].dtype == np.float64
    assert not isnull(cleaned, "hardship_status").any()
    assert np.isnan(prepared[schema.LABEL_COL]).any()
    assert "missing" in plan.label_vocab["branch_code"]
    assert tree.X.shape[0] == prepared.n_rows


def test_reads_the_references_own_pandas_frame(synthetic_runs):
    """`as_raw_frame` hands the reference's pandas frame to the port: the
    same report and tree matrix as from the port's own frame."""
    _, (_, report, _, (tree, _, _)) = synthetic_runs
    cleaned, got_report = clean_raw_frame(jax_synthetic(3000, 7))
    assert got_report == report
    got_tree, _, _ = engineer_features(prepare_cleaned_frame(cleaned, today=TODAY), device="cpu")
    assert torch.equal(got_tree.X.nan_to_num(-7.0), tree.X.nan_to_num(-7.0))


def test_host_path_equals_the_device_ingest(synthetic_runs):
    """The port's two data paths on one frame and the CPU: the same report
    and plan (the host path records no ``asof``), and the same matrices."""
    _, (_, report, _, (tree, nn, plan)) = synthetic_runs
    res = run_device_ingest(tokenize_raw_frame(synthetic_lendingclub_frame(3000, 7), today=TODAY),
                            device="cpu")
    assert res.report == report
    assert dataclasses.replace(res.plan, asof=None) == plan
    log_cols = set(plan.log_cols)
    for mine, theirs, what in ((tree, res.tree, "tree"), (nn, res.nn, "nn")):
        assert mine.feature_names == theirs.feature_names
        _assert_columns(mine.feature_names, theirs.X.numpy(), mine.X.numpy(), log_cols, what)
    assert torch.equal(tree.y.nan_to_num(-1.0), res.tree.y.nan_to_num(-1.0))


def test_duplicated_matches_pandas_on_colliding_rows():
    """pandas' ``duplicated()``: NaN equals NaN, 0.0 equals -0.0, strings by
    value with missing apart from ``""``, the first of each group kept."""
    df = pd.DataFrame(
        {
            "x": [0.0, -0.0, np.nan, np.nan, 1.0, 1.0, 2.0],
            "s": ["a", "a", None, None, "", None, "b"],
            "i": [1, 1, 2, 2, 3, 3, 4],
        }
    )
    got = duplicated(as_raw_frame(df))
    assert got.tolist() == df.duplicated().tolist() == [False, True, False, True, False, False, False]
