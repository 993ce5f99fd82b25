"""Feature frames, the replay plan, the host path's preparation and
engineering stages, and the engineering transforms as plain torch
functions: the port's copy of the reference's ``data/features.py``.

Two outputs, as in the reference: the tree frame (log1p on the skewed
columns, one-hot categoricals with the first category dropped, NaN kept for
the NaN-aware GBDT) and the nn frame (median impute, ``<col>_NA``
indicators, ``no_income``/``dti_NA`` flags and integer category codes).

The host does the string work (`prepare_cleaned_frame`, the vocabularies);
`engineer_features` runs the numeric transforms (log1p, medians, imputation,
one-hots) on its device through the same functions the device ingest
(`data.device_pipeline`) runs, and both assemble the two frames with
`assemble_frames`, so the two paths give the same numbers.
"""

from __future__ import annotations

import dataclasses
from datetime import datetime
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from cobalt_smart_lender_ai_tpu_torch.data import schema
from cobalt_smart_lender_ai_tpu_torch.data.clean import (
    isnull,
    keep_rows,
    parse_frontier_strings,
    parse_string_column,
    select_columns,
)
from cobalt_smart_lender_ai_tpu_torch.data.frame import RawFrame, as_raw_frame
from cobalt_smart_lender_ai_tpu_torch.device import resolve_device
from cobalt_smart_lender_ai_tpu_torch.ops.binning import _nanquantile_column

__all__ = [
    "FeatureFrame",
    "FeaturePlan",
    "assemble_frames",
    "drop_training_leakage",
    "engineer_features",
    "impute_with_indicators",
    "log1p_masked",
    "nanmedians",
    "one_hot_codes",
    "prepare_cleaned_frame",
]


@dataclasses.dataclass(frozen=True)
class FeatureFrame:
    """A named feature matrix on its device."""

    feature_names: tuple[str, ...]
    X: torch.Tensor  # (N, F) float32
    y: torch.Tensor | None = None  # (N,) float32 labels

    @property
    def n_rows(self) -> int:
        return int(self.X.shape[0])

    @property
    def n_features(self) -> int:
        return int(self.X.shape[1])

    def column(self, name: str) -> torch.Tensor:
        return self.X[:, self.feature_names.index(name)]

    def select(self, names: Sequence[str]) -> "FeatureFrame":
        idx = torch.tensor([self.feature_names.index(n) for n in names], device=self.X.device)
        return FeatureFrame(tuple(names), self.X[:, idx], self.y)

    def drop(self, names: Sequence[str]) -> "FeatureFrame":
        keep = [n for n in self.feature_names if n not in set(names)]
        return self.select(keep)


@dataclasses.dataclass(frozen=True)
class FeaturePlan:
    """Everything needed to replay the engineering on new raw rows: the
    categorical vocabularies (one-hot order follows ``categorical_vocab``'s
    order), the label-encode vocabularies, the imputation medians and the
    snapshot date of the date -> age features. Saved with model artifacts."""

    numeric_names: tuple[str, ...]
    categorical_vocab: Mapping[str, tuple[str, ...]]
    label_vocab: Mapping[str, tuple[str, ...]]
    medians: Mapping[str, float]
    log_cols: tuple[str, ...]
    tree_feature_names: tuple[str, ...]
    nn_feature_names: tuple[str, ...]
    #: ISO date the ingest snapshot used for date -> age features; raw-row
    #: serving pins its "today" to it.
    asof: str | None = None


def log1p_masked(X: torch.Tensor, col_mask: torch.Tensor) -> torch.Tensor:
    """log1p on the masked columns where the value is present and positive.

    Each log1p is taken in float64 and rounded once to float32, which is
    the correctly rounded value but for a few cells in a billion. So the
    result of a cell does not depend on which code path of the device's
    elementwise loop (vectorised body or scalar tail) reached it: a raw row
    scored alone gets the bits of the same row in a batch. It stays within
    a few ulps of the reference's float32 ``log1p``."""
    out = X.clone()
    for j in torch.nonzero(col_mask.cpu()).flatten().tolist():
        col = X[:, j]
        apply = (col > 0) & ~torch.isnan(col)
        out[:, j] = torch.where(apply, torch.log1p(col.double()).to(X.dtype), col)
    return out


def one_hot_codes(codes: torch.Tensor, n_classes: int) -> torch.Tensor:
    """(N,) integer codes -> (N, n_classes - 1) float32 one-hot, class 0
    dropped (get_dummies drop_first); code -1 (missing or unseen) is an
    all-zero row."""
    classes = torch.arange(1, n_classes, device=codes.device)
    return (codes.long()[:, None] == classes[None, :]).to(torch.float32)


def impute_with_indicators(
    X: torch.Tensor, medians: torch.Tensor, need: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Median-fill NaNs; return the filled matrix and the per-column NaN
    indicators of the columns flagged in ``need`` (zero elsewhere)."""
    isnan = torch.isnan(X)
    filled = torch.where(isnan, medians[None, :], X)
    indicators = torch.where(need[None, :], isnan.to(torch.float32), 0.0)
    return filled, indicators


def nanmedians(X: torch.Tensor) -> torch.Tensor:
    """Per-column medians ignoring NaN, the reference's ``nanmedian``
    rounding (the mean of the two middle values); all-NaN columns give 0."""
    half = torch.tensor([0.5], dtype=torch.float32, device=X.device)
    med = torch.cat([_nanquantile_column(X[:, j], half) for j in range(X.shape[1])])
    return torch.where(torch.isnan(med), 0.0, med)


def assemble_frames(
    X_num: torch.Tensor,
    numeric_names: Sequence[str],
    codes: Mapping[str, torch.Tensor],
    vocab: Mapping[str, Sequence[str]],
    medians: torch.Tensor,
    need_ind: np.ndarray | None = None,
) -> tuple[torch.Tensor, torch.Tensor, list[str], list[str]]:
    """The tree and nn matrices and their column names, from the numeric
    block (log1p applied), its medians and each categorical's codes in
    ``vocab[c]`` (-1 where missing; the one-hots follow ``codes``' order).
    Tree: numerics | one-hots. nn: median-imputed numerics | ``<col>_NA``
    for each column with a NaN but ``dti`` | ``no_income`` | ``dti_NA`` |
    the codes, missing as ``len(vocab[c])``. The host path and the device
    ingest both assemble through it. ``need_ind`` (``(F,)`` bool: which
    numerics have a NaN) defaults to ``X_num``'s own; a shard of the rows
    passes the whole table's, so that every shard has the same columns."""
    numeric_names = list(numeric_names)
    tree_blocks, tree_names = [X_num], list(numeric_names)
    for c, code in codes.items():
        if len(vocab[c]) > 1:
            tree_blocks.append(one_hot_codes(code, len(vocab[c])))
            tree_names.extend(f"{c}_{v}" for v in vocab[c][1:])
    X_tree = torch.cat(tree_blocks, dim=1)

    if need_ind is None:
        need_ind = torch.isnan(X_num).any(dim=0).cpu().numpy()
    need_ind = np.array(need_ind, dtype=bool)
    dti_idx = numeric_names.index("dti") if "dti" in numeric_names else -1
    if dti_idx >= 0:
        need_ind[dti_idx] = False
    dev = X_num.device
    filled, indicators = impute_with_indicators(X_num, medians, torch.from_numpy(need_ind).to(dev))
    nn_blocks, nn_names = [filled], list(numeric_names)
    ind_cols = np.flatnonzero(need_ind)
    if ind_cols.size:
        nn_blocks.append(indicators[:, torch.from_numpy(ind_cols).to(dev)])
        nn_names.extend(f"{numeric_names[i]}_NA" for i in ind_cols)
    if "annual_inc" in numeric_names:
        inc = X_num[:, numeric_names.index("annual_inc")]
        nn_blocks.append((torch.isnan(inc) | (inc == 0)).to(torch.float32)[:, None])
        nn_names.append("no_income")
    if dti_idx >= 0:
        nn_blocks.append(torch.isnan(X_num[:, dti_idx]).to(torch.float32)[:, None])
        nn_names.append("dti_NA")
    for c, code in codes.items():
        nn_blocks.append(torch.where(code < 0, len(vocab[c]), code).to(torch.float32)[:, None])
        nn_names.append(c)
    return X_tree, torch.cat(nn_blocks, dim=1), tree_names, nn_names


def prepare_cleaned_frame(
    frame: Any,
    *,
    today: datetime | None = None,
    row_null_allowance: int = 20,
) -> RawFrame:
    """The reference's preparation of a cleaned table, on the host: drop the
    leakage and useless columns, then the rows with fewer than ``ncols -
    row_null_allowance`` present cells; ``emp_length`` -> ``emp_length_num``
    and ``earliest_cr_line`` -> ``earliest_cr_line_days`` (its age in days
    at ``today``, default now), each appended at the end; ``revol_util``
    parsed; ``loan_status`` -> the label (appended; an unmapped status is
    NaN). Each derived column is int64 when it has no missing cell, float64
    otherwise, as pandas types it. ``frame`` is a `RawFrame`, or anything
    `as_raw_frame` reads.

    A numeric ``emp_length`` or ``earliest_cr_line`` is taken as already
    derived (the device ingest's cleaned table stores them parsed; in a raw
    table such a column has no present cell), where the reference raises
    on the first and makes the second missing."""
    frame = as_raw_frame(frame)
    drop = set(schema.FE_LEAKAGE_COLS) | set(schema.FE_USELESS_COLS)
    frame = select_columns(frame, [c for c in frame if c not in drop])
    present = np.zeros(frame.n_rows, np.int64)
    for c in frame:
        present += ~isnull(frame, c)
    frame = keep_rows(frame, present >= len(frame.columns) - row_null_allowance)

    now = today or datetime.today()
    cols = {c: frame[c] for c in frame}
    miss = {c: frame.missing(c) for c in frame if frame.missing(c) is not None}

    def derive(old: str, new: str | None = None) -> None:
        col = frame[old]
        if col.dtype.kind == "U":
            col = parse_string_column(
                frame, old, lambda uniq: parse_frontier_strings(old, uniq, now)
            )
            miss.pop(old, None)
        if new is None:
            cols[old] = col
        else:
            del cols[old]
            cols[new] = _int_unless_missing(col)

    if "emp_length" in cols:
        derive("emp_length", "emp_length_num")
    if "revol_util" in cols:
        derive("revol_util")
    if "earliest_cr_line" in cols:
        derive("earliest_cr_line", "earliest_cr_line_days")
    if "loan_status" in cols:
        status = frame["loan_status"]
        if status.dtype.kind == "U":
            label = parse_string_column(
                frame, "loan_status",
                lambda uniq: np.array([schema.LOAN_STATUS_MAP.get(v, np.nan) for v in uniq.tolist()],
                                      np.float64),
            )
        else:
            label = np.full(frame.n_rows, np.nan)
        del cols["loan_status"]
        miss.pop("loan_status", None)
        cols[schema.LABEL_COL] = _int_unless_missing(label)
    return RawFrame(cols, miss)


def _int_unless_missing(col: np.ndarray) -> np.ndarray:
    """A derived column as pandas types it: int64 when no cell is missing,
    else float64 with NaN."""
    col = col.astype(np.float64)
    return col if np.isnan(col).any() else col.astype(np.int64)


def _category_codes(frame: RawFrame, name: str) -> tuple[tuple, np.ndarray]:
    """A categorical column's sorted vocabulary of present values and each
    row's code in it (-1 where missing)."""
    col, miss = frame[name], isnull(frame, name)
    cats, inv = np.unique(col[~miss], return_inverse=True)
    codes = np.full(col.shape[0], -1, np.int64)
    codes[~miss] = inv.reshape(-1)
    return tuple(cats.tolist()), codes


def engineer_features(
    frame: Any,
    *,
    one_hot_cols: Sequence[str] = schema.ONE_HOT_COLS,
    log_cols: Sequence[str] = schema.LOG_COLS,
    device: torch.device | str = "cuda",
) -> tuple[FeatureFrame, FeatureFrame, FeaturePlan]:
    """The tree and nn feature frames and the plan of a prepared table
    (`prepare_cleaned_frame`): on the host the vocabularies and the float32
    matrix, on ``device`` (``cuda`` unless the caller asks for ``cpu``) the
    log1p, one-hots, medians and imputation. A string column outside
    ``one_hot_cols`` is label-encoded in both frames (missing cells as
    ``"missing"``, as the reference's ``astype(str).fillna`` spells them).
    The plan records no ``asof`` date, as the reference's host path."""
    frame = as_raw_frame(frame)
    dev = resolve_device(device)
    y = None
    if schema.LABEL_COL in frame.columns:
        y = torch.from_numpy(frame[schema.LABEL_COL].astype(np.float32)).to(dev)
    names = [c for c in frame if c != schema.LABEL_COL]
    cat_present = [c for c in one_hot_cols if c in names]
    numeric_names = tuple(c for c in names if c not in set(cat_present))

    label_vocab: dict[str, tuple[str, ...]] = {}
    blocks = []
    for c in numeric_names:
        col = frame[c]
        if col.dtype.kind == "U":
            vocab, inv = np.unique(np.where(isnull(frame, c), "missing", col), return_inverse=True)
            label_vocab[c] = tuple(vocab.tolist())
            col = inv.reshape(-1)
        blocks.append(col.astype(np.float32))
    X_np = np.stack(blocks, axis=1) if blocks else np.zeros((frame.n_rows, 0), np.float32)
    log_mask = torch.from_numpy(np.isin(np.asarray(numeric_names, dtype=str), np.asarray(log_cols)))
    X_num = log1p_masked(torch.from_numpy(X_np).to(dev), log_mask)
    del X_np, blocks

    vocab: dict[str, tuple] = {}
    codes: dict[str, torch.Tensor] = {}
    for c in cat_present:
        vocab[c], code = _category_codes(frame, c)
        codes[c] = torch.from_numpy(code).to(dev)
    medians = nanmedians(X_num)
    X_tree, X_nn, tree_names, nn_names = assemble_frames(X_num, numeric_names, codes, vocab, medians)

    medians_np = medians.cpu().numpy()
    plan = FeaturePlan(
        numeric_names=numeric_names,
        categorical_vocab=vocab,
        label_vocab=label_vocab,
        medians={name: float(medians_np[i]) for i, name in enumerate(numeric_names)},
        log_cols=tuple(c for c in log_cols if c in numeric_names),
        tree_feature_names=tuple(tree_names),
        nn_feature_names=tuple(nn_names),
    )
    return (
        FeatureFrame(tuple(tree_names), X_tree, y),
        FeatureFrame(tuple(nn_names), X_nn, y),
        plan,
    )


def drop_training_leakage(ff: FeatureFrame) -> FeatureFrame:
    """Remove the trainer's leakage columns."""
    return ff.drop([c for c in schema.TRAIN_LEAKAGE_COLS if c in ff.feature_names])
