"""The port's data layer and device ingest against the JAX package's, on the CPU.

Inputs come from the seeded synthetic LendingClub generator at a few
thousand rows, with ``today`` pinned. Held to the reference:

- `synthetic_lendingclub_frame`: the same columns in the same order, the
  same cells (string cells equal where present, the same missing cells);
- `tokenize_raw_frame`, on the reference's own pandas frame and on the
  port's frame: bit-identical ``X``, the same kinds, vocabularies and
  missing tokens (compared as strings: the reference's pandas string
  columns hand it a float NaN where the port writes ``'nan'``);
- `run_device_ingest` (``device="cpu"``): the same `CleanReport` and
  `FeaturePlan` (medians within ``LOG_RTOL``), tree / nn matrices and labels
  bit-identical except the log1p-derived columns, which are within
  ``LOG_RTOL`` (the port's log1p and XLA's differ in the last bits), and
  bins bit-identical on every column log1p does not touch; with
  ``keep_cleaned=True`` the clean stage's decoded table equals the
  reference's (numbers bitwise, strings and missing cells alike);
- the hashed split, the stratified folds, ``_mix_u32`` on edge values, and
  `binary_classification_report`: the same rows and numbers.
"""

from __future__ import annotations

import collections
import dataclasses
from datetime import datetime

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cobalt_smart_lender_ai_tpu.data import device_pipeline as jax_dp
from cobalt_smart_lender_ai_tpu.data import split as jax_split
from cobalt_smart_lender_ai_tpu.data.synthetic import (
    synthetic_lendingclub_frame as jax_synthetic,
)
from cobalt_smart_lender_ai_tpu.ops import metrics as jax_metrics
from cobalt_smart_lender_ai_tpu_torch.data import device_pipeline, schema, split
from cobalt_smart_lender_ai_tpu_torch.data.device_pipeline import (
    run_device_ingest,
    tokenize_raw_frame,
)
from cobalt_smart_lender_ai_tpu_torch.data.features import drop_training_leakage
from cobalt_smart_lender_ai_tpu_torch.data.frame import RawFrame, row_dicts, string_column
from cobalt_smart_lender_ai_tpu_torch.data.synthetic import synthetic_lendingclub_frame
from cobalt_smart_lender_ai_tpu_torch.ops import metrics
from cobalt_smart_lender_ai_tpu_torch.ops.binning import (
    bin_edges_and_transform,
    compute_bin_edges,
    transform,
)
from cobalt_smart_lender_ai_tpu_torch.telemetry.programs import (
    ProgramRegistry,
    set_default_program_registry,
)

TODAY = datetime(2026, 8, 1)
#: Relative tolerance of log1p-derived floats, the JAX package's own
#: (tests/test_device_pipeline.py): a few float32 ulps.
LOG_RTOL = 3e-7
N_ROWS, SEED = 3000, 7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_frame():
    return jax_synthetic(N_ROWS, SEED)


@pytest.fixture(scope="module")
def port_frame():
    return synthetic_lendingclub_frame(N_ROWS, SEED)


@pytest.fixture(scope="module")
def jax_ingest(jax_frame):
    tok = jax_dp.tokenize_raw_frame(jax_frame.copy(), today=TODAY)
    return tok, jax_dp.run_device_ingest(tok)


@pytest.fixture(scope="module")
def port_ingest(port_frame):
    tok = tokenize_raw_frame(port_frame, today=TODAY)
    return tok, run_device_ingest(tok, device="cpu")


def _cells_equal(a, b, name: str) -> None:
    sa, sb = string_column(a, name), string_column(b, name)
    assert (sa is None) == (sb is None), name
    if sa is None:
        x, y = np.asarray(a[name]), np.asarray(b[name])
        assert x.dtype == y.dtype and np.array_equal(x, y, equal_nan=True), name
    else:
        assert np.array_equal(sa[1], sb[1]), f"{name}: missing cells differ"
        assert np.array_equal(sa[0][~sa[1]], sb[0][~sb[1]]), f"{name}: cells differ"


@pytest.mark.parametrize("n_rows,seed", [(N_ROWS, SEED), (501, 0)])
def test_synthetic_frame_is_cell_identical(n_rows, seed):
    ref = jax_synthetic(n_rows, seed)
    got = synthetic_lendingclub_frame(n_rows, seed)
    assert got.columns == list(ref.columns) and len(got.columns) == 146
    assert got.n_rows == len(ref)
    for name in got.columns:
        _cells_equal(ref, got, name)


def _missing_tokens(tok):
    return {k: tuple(map(str, v)) for k, v in tok.missing_token.items()}


@pytest.mark.parametrize("source", ["jax-pandas-frame", "port-frame"])
def test_tokenize_matches_jax(jax_frame, port_frame, jax_ingest, source):
    ref = jax_ingest[0]
    got = tokenize_raw_frame(jax_frame if source == "jax-pandas-frame" else port_frame, today=TODAY)
    assert got.columns == ref.columns and got.kinds == ref.kinds
    assert dict(got.vocab) == dict(ref.vocab)
    assert _missing_tokens(got) == _missing_tokens(ref)
    X = np.asarray(ref.X)
    assert got.X.dtype == np.float32 and np.array_equal(got.X.view(np.int32), X.view(np.int32))


def test_tokenize_degenerate_cells():
    """Whitespace-only or unparseable frontier cells are NaN; the hardship
    vocabulary gains the fill token exactly when the column has missing
    cells (the reference's test of the same name, through a pandas frame
    and the port's frame)."""
    df = pd.DataFrame(
        {
            "term": [" 36 months", "   ", None],
            "int_rate": ["10.0%", "", "5.5%"],
            "emp_length": ["< 1 year", "10+ years", None],
            "hardship_status": ["ACTIVE", None, None],
            "loan_amnt": [1000.0, 2000.0, 3000.0],
        }
    )
    ref = jax_dp.tokenize_raw_frame(df, today=TODAY)
    port = RawFrame(
        {c: (df[c].fillna("").to_numpy(str) if c != "loan_amnt" else df[c].to_numpy())
         for c in df.columns},
        {c: df[c].isnull().to_numpy() for c in df.columns if c != "loan_amnt"},
    )
    for frame in (df, port):
        tok = tokenize_raw_frame(frame, today=TODAY)
        assert np.array_equal(tok.X, np.asarray(ref.X), equal_nan=True)
        X = tok.X
        assert X[0, tok.columns.index("term")] == 36.0
        assert np.isnan(X[1:, tok.columns.index("term")]).all()
        emp = X[:, tok.columns.index("emp_length")]
        assert emp[0] == 0.0 and emp[1] == 10.0 and np.isnan(emp[2])
        hpos = tok.columns.index("hardship_status")
        assert tok.vocab[hpos] == ("ACTIVE", schema.HARDSHIP_FILL)


@pytest.mark.parametrize(
    "name,values",
    [
        ("purpose", ["b", "a", "b", "", "ab", "a"]),
        ("earliest_cr_line", ["Jan-2001", "Feb-2003", "Jan-2001", "Dec-1999"] * 50),
        ("purpose", ["é", "e", "z", "É", "ē"]),
        ("purpose", [None, None, None]),
    ],
    ids=["short", "dates", "unicode", "empty"],
)
def test_tokenize_vocabulary_matches_jax(name, values):
    """Sorted (code-point) vocabularies and their codes, and date parses of
    the distinct strings, as the reference tokenizes the same column."""
    df = pd.DataFrame({name: pd.Series(values, dtype=object), "loan_amnt": 1.0})
    ref = jax_dp.tokenize_raw_frame(df, today=TODAY)
    got = tokenize_raw_frame(df, today=TODAY)
    assert got.kinds == ref.kinds and dict(got.vocab) == dict(ref.vocab)
    assert np.array_equal(got.X.view(np.int32), np.asarray(ref.X).view(np.int32))


def test_clean_report_matches_jax(jax_ingest, port_ingest):
    assert dataclasses.asdict(port_ingest[1].report) == dataclasses.asdict(jax_ingest[1].report)
    assert port_ingest[1].report.n_duplicates_removed > 0


def test_plan_matches_jax(jax_ingest, port_ingest):
    ref, got = jax_ingest[1].plan, port_ingest[1].plan
    for field in ("numeric_names", "log_cols", "tree_feature_names", "nn_feature_names", "asof"):
        assert getattr(got, field) == getattr(ref, field), field
    assert list(got.categorical_vocab.items()) == list(ref.categorical_vocab.items())
    assert dict(got.label_vocab) == dict(ref.label_vocab)
    assert got.asof == TODAY.strftime("%Y-%m-%d")
    assert set(got.medians) == set(ref.medians)
    for k, v in ref.medians.items():
        if k in ref.log_cols:
            assert np.isclose(got.medians[k], v, rtol=LOG_RTOL, atol=0.0), k
        else:
            assert got.medians[k] == v, k


def _assert_columns(names, A, B, log_cols, what):
    assert A.shape == B.shape, what
    both_nan = np.isnan(A) & np.isnan(B)
    for j, name in enumerate(names):
        if name in log_cols:
            ok = np.isclose(A[:, j], B[:, j], rtol=LOG_RTOL, atol=0.0) | both_nan[:, j]
        else:
            ok = (A[:, j] == B[:, j]) | both_nan[:, j]
        assert ok.all(), f"{what}: column {name!r} differs in {int((~ok).sum())} rows"


@pytest.mark.parametrize("frame", ["tree", "nn"])
def test_feature_matrices_match_jax(jax_ingest, port_ingest, frame):
    ref, got = getattr(jax_ingest[1], frame), getattr(port_ingest[1], frame)
    assert got.feature_names == ref.feature_names
    log_cols = set(jax_ingest[1].plan.log_cols)
    _assert_columns(ref.feature_names, np.asarray(ref.X), got.X.numpy(), log_cols, frame)
    ya, yb = np.asarray(ref.y), got.y.numpy()
    assert ((ya == yb) | (np.isnan(ya) & np.isnan(yb))).all()


def test_bins_match_jax_on_the_columns_log1p_does_not_touch(jax_ingest, port_ingest):
    ref, got = jax_ingest[1], port_ingest[1]
    log_cols = set(ref.plan.log_cols)
    exact = [j for j, n in enumerate(ref.tree.feature_names) if n not in log_cols]
    assert len(exact) > 50
    A, B = np.asarray(ref.bins), got.bins.numpy()
    assert A.shape == B.shape and np.array_equal(A[:, exact], B[:, exact])
    Ea, Eb = np.asarray(ref.bin_spec.edges), got.bin_spec.edges.numpy()
    assert np.array_equal(Ea[exact], Eb[exact])
    assert got.bin_spec.n_bins == 255


def test_bin_edges_and_transform_is_the_composition(port_ingest):
    X = port_ingest[1].tree.X
    spec, bins = bin_edges_and_transform(X, n_bins=64)
    want = compute_bin_edges(X, n_bins=64)
    assert torch.equal(spec.edges, want.edges) and torch.equal(bins, transform(want, X))


def test_serving_features_survive_ingest_and_leakage_drop(port_ingest):
    ff = drop_training_leakage(port_ingest[1].tree)
    assert not set(schema.TRAIN_LEAKAGE_COLS) & set(ff.feature_names)
    assert set(schema.SERVING_FEATURES) <= set(ff.feature_names)
    sel = ff.select(schema.SERVING_FEATURES)
    assert sel.feature_names == schema.SERVING_FEATURES and sel.X.shape[1] == 20


def test_keep_cleaned_is_not_ported(port_ingest, jax_ingest):
    """``keep_cleaned=True`` is ported: the clean stage's table, decoded on
    the host, equals the reference's ``DeviceIngestResult.cleaned`` column
    for column (categories as their strings, missing where the reference's
    are NaN; every other column float64, bitwise), and the ingest's other
    outputs do not change."""
    got = run_device_ingest(port_ingest[0], device="cpu", keep_cleaned=True)
    ref = jax_dp.run_device_ingest(jax_ingest[0], keep_cleaned=True).cleaned
    assert port_ingest[1].cleaned is None
    assert got.cleaned.columns == [str(c) for c in ref.columns]
    assert got.cleaned.n_rows == len(ref) == got.report.n_rows_out
    for name in ref.columns:
        col = ref[name]
        if pd.api.types.is_numeric_dtype(col):
            assert got.cleaned[name].dtype == np.float64, name
            assert np.array_equal(got.cleaned[name], col.to_numpy(np.float64), equal_nan=True), name
        else:
            miss = col.isna().to_numpy()
            assert np.array_equal(got.cleaned.missing(name), miss), name
            assert np.array_equal(got.cleaned[name][~miss], col[~miss].astype(str).to_numpy()), name
    assert torch.equal(got.tree.X.nan_to_num(-7.0), port_ingest[1].tree.X.nan_to_num(-7.0))


def test_ingest_leaves_the_tokenized_matrix_alone(port_frame):
    tok = tokenize_raw_frame(port_frame, today=TODAY)
    before = tok.X.copy()
    run_device_ingest(tok, device="cpu")
    assert np.array_equal(tok.X, before, equal_nan=True)


def test_each_ingest_step_is_a_program_row(port_frame):
    """Each step of the ingest lands on its ``ingest.<step>`` program (the
    reference's names) once per dispatch, and
    ``cobalt_ingest_dispatch_seconds`` observes each dispatch once: twelve
    per ingest, two of them the stats step's (numeric prep, then medians)."""
    tok = tokenize_raw_frame(port_frame, today=TODAY)
    reg = ProgramRegistry()
    prev = set_default_program_registry(reg)
    observed = device_pipeline._INGEST_DISPATCH_S.count
    try:
        run_device_ingest(tok, device="cpu")
    finally:
        set_default_program_registry(prev)
    rows = reg.table(kind="ingest")
    steps = collections.Counter()
    for r in rows:
        assert r["name"].startswith("ingest.") and r["dispatch_seconds"] > 0, r
        steps[r["name"][len("ingest."):].split("[", 1)[0]] += r["dispatches"]
    assert steps == {"null_stats": 2, "row_compact": 2, "fill": 2, "dedupe": 1,
                     "vocab_census": 1, "stats": 2, "assemble": 1, "binning": 1}
    assert device_pipeline._INGEST_DISPATCH_S.count - observed == 12


def _same_cell(a, b) -> bool:
    return a == b or (a is None and b is None) or (a != a and b != b)


def test_row_dicts_are_the_raw_cells(port_frame, jax_frame):
    rows = np.array([0, 5, N_ROWS])  # the last is the duplicate of row 0
    got, ref = row_dicts(port_frame, rows), row_dicts(jax_frame, rows)
    for g, r in zip(got, ref):
        assert list(g) == list(r) == port_frame.columns
        assert all(_same_cell(g[k], r[k]) or (g[k] is None and r[k] != r[k]) for k in g)
    assert all(_same_cell(got[0][k], got[2][k]) for k in got[0])


# --- split ------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 22, 101, 2**31, 2**32 - 1, 2**32 + 5, 10**12])
def test_mix_u32_edge_values(seed):
    x = np.array([0, 1, 2, 0xFFFF, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1], dtype=np.uint32)
    want = np.asarray(jax_split._mix_u32(jnp.asarray(x), seed)).astype(np.int64)
    got = split._mix_u32(torch.from_numpy(x.astype(np.int64)), seed).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n,frac,seed", [(10_007, 0.2, 22), (4096, 0.35, 3), (100, 0.0, 22), (100, 1.0, 5)])
def test_train_test_split_matches_jax(n, frac, seed):
    rng = np.random.default_rng(n)
    X = rng.normal(size=(n, 3)).astype(np.float32)
    y = (rng.random(n) < 0.3).astype(np.float32)
    want = jax_split.train_test_split_hashed(X, y, test_fraction=frac, seed=seed)
    got = split.train_test_split_hashed(torch.from_numpy(X), torch.from_numpy(y),
                                        test_fraction=frac, seed=seed)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())
    assert np.array_equal(np.asarray(jax_split.split_mask(n, frac, seed)),
                          split.split_mask(n, frac, seed, device="cpu").numpy())


def test_keep_order_is_a_stable_partition():
    keep = torch.tensor([False, True, True, False, True])
    assert split.keep_order(keep).tolist() == [1, 2, 4, 0, 3]


@pytest.mark.parametrize("n_folds,seed", [(3, 0), (5, 42)])
def test_stratified_fold_ids_match_jax(n_folds, seed):
    y = (np.random.default_rng(seed).random(1000) < 0.21).astype(np.float32)
    assert np.array_equal(split.stratified_fold_ids(y, n_folds, seed),
                          jax_split.stratified_fold_ids(y, n_folds, seed))


# --- metrics ------------------------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_classification_report_matches_jax(weighted):
    rng = np.random.default_rng(9)
    y = (rng.random(2000) < 0.21).astype(np.float32)
    pred = ((rng.random(2000) < 0.3) ^ (y > 0)).astype(np.int32)
    w = (rng.random(2000) < 0.8).astype(np.float32) if weighted else None
    want = jax_metrics.binary_classification_report(
        jnp.asarray(y), jnp.asarray(pred), None if w is None else jnp.asarray(w))
    got = metrics.binary_classification_report(
        torch.from_numpy(y), torch.from_numpy(pred), None if w is None else torch.from_numpy(w))
    assert got == want
    cm = metrics.confusion_matrix(torch.from_numpy(y), torch.from_numpy(pred))
    assert np.array_equal(cm.numpy(), np.asarray(jax_metrics.confusion_matrix(jnp.asarray(y), jnp.asarray(pred))))


def test_residual_label_encode_matches_jax(jax_frame):
    """A string column outside the one-hot list is label-encoded in both
    frames, with its surviving vocabulary in the plan's ``label_vocab``."""
    df = jax_frame.copy()
    df["branch_code"] = np.random.default_rng(3).choice(["north", "east", "south"], len(df))
    ref_tok = jax_dp.tokenize_raw_frame(df, today=TODAY)
    ref = jax_dp.run_device_ingest(ref_tok)
    got = run_device_ingest(tokenize_raw_frame(df, today=TODAY), device="cpu")
    assert dict(got.plan.label_vocab) == dict(ref.plan.label_vocab) == {
        "branch_code": ("east", "north", "south")
    }
    assert got.tree.feature_names == ref.tree.feature_names
    j = ref.tree.feature_names.index("branch_code")
    assert np.array_equal(got.tree.X[:, j].numpy(), np.asarray(ref.tree.X)[:, j])
