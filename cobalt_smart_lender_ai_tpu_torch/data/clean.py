"""The cleaning stage on the host, and the string parsers of the stringy
frontier: the port's copy of the reference's ``data/clean.py``, on
`RawFrame` columns instead of pandas.

`clean_raw_frame` applies the reference's eight rules in its order:

1. drop the index-artifact columns (``Unnamed: 0*``);
2. drop the rows missing a value in any near-complete column (a column
   with fewer than ``row_drop_null_limit`` missing cells);
3. fill ``hardship_status``'s missing cells with ``"No Hardship"``;
4. parse ``term`` (``" 36 months"`` -> 36) and ``int_rate``
   (``"13.56%"`` -> 0.1356);
5. drop the columns more than ``null_col_threshold`` percent missing;
6. drop the fixed list of unnecessary columns;
7. fill the missing-means-zero columns with 0;
8. drop duplicate rows, keeping the first (missing equals missing, and
   0.0 equals -0.0, as pandas' ``drop_duplicates`` compares them).

The device ingest (`data.device_pipeline`) replays the same rules on its
tokenized matrix; `tokenize_raw_frame` there calls the parsers defined here
once per distinct string of each frontier column. Each parser takes the
column's distinct strings, parses each once in float64, and the caller
gathers the results. A cell that does not parse (empty, whitespace-only,
malformed) is NaN, as ``pd.to_numeric(errors="coerce")`` makes it.
"""

from __future__ import annotations

import dataclasses
import re
from datetime import datetime
from typing import Any, Sequence

import numpy as np

from cobalt_smart_lender_ai_tpu_torch.data import schema
from cobalt_smart_lender_ai_tpu_torch.data.frame import RawFrame, as_raw_frame

__all__ = [
    "CleanReport",
    "clean_raw_frame",
    "date_age_days",
    "parse_emp_length",
    "parse_frontier_strings",
    "parse_percent",
    "parse_term",
]


@dataclasses.dataclass
class CleanReport:
    n_rows_in: int = 0
    n_rows_out: int = 0
    dropped_null_columns: list[str] = dataclasses.field(default_factory=list)
    dropped_fixed_columns: list[str] = dataclasses.field(default_factory=list)
    n_duplicates_removed: int = 0
    n_rows_dropped_near_complete: int = 0


def _number(s: str) -> float:
    """``float(s)``, or NaN where pandas' ``to_numeric`` would not parse
    (it takes no ``_`` digit separators)."""
    if "_" in s:
        return float("nan")
    try:
        return float(s)
    except ValueError:
        return float("nan")


def parse_percent(values: np.ndarray) -> np.ndarray:
    """'13.56%' -> 0.1356, float64; a numeric column is divided by 100."""
    if values.dtype.kind in "biuf":
        return values.astype(np.float64) / 100.0
    parsed = np.array([_number(str(v).replace("%", "").strip()) for v in values], np.float64)
    return parsed / 100.0


def parse_term(values: np.ndarray) -> np.ndarray:
    """' 36 months' -> 36.0, float64; a numeric column passes through."""
    if values.dtype.kind in "biuf":
        return values.astype(np.float64)
    return np.array(
        [_number(str(v).replace(" months", "").strip()) for v in values], np.float64
    )


def parse_emp_length(s: str) -> float:
    """The reference's emp_length transform of one string: ``"< 1 year"``
    is 0, else the first run of digits."""
    m = re.search(r"(\d+)", "0" if s == "< 1 year" else s)
    return _number(m.group(1)) if m else float("nan")


def date_age_days(s: str, today: datetime) -> float:
    """Days from a ``"%b-%Y"`` date (the 1st of its month) to ``today``,
    floored; NaN if the string is not such a date."""
    try:
        return float((today - datetime.strptime(s, "%b-%Y")).days)
    except ValueError:
        return float("nan")


def parse_frontier_strings(name: str, uniq: np.ndarray, today: datetime) -> np.ndarray:
    """The frontier parse of one column's distinct strings, float64: term,
    the percents, emp_length or a date's age in days, by the column's name."""
    if name in schema.FRONTIER_TERM_COLS:
        return parse_term(uniq)
    if name in schema.FRONTIER_PERCENT_COLS:
        return parse_percent(uniq)
    if name in schema.FRONTIER_EMP_COLS:
        return np.array([parse_emp_length(s) for s in uniq.tolist()], np.float64)
    return np.array([date_age_days(s, today) for s in uniq.tolist()], np.float64)


# --- the host path over RawFrame columns --------------------------------------------


def isnull(frame: RawFrame, name: str) -> np.ndarray:
    """The missing cells of a column: its mask (``U``), NaN (float), none
    (int, bool)."""
    col = frame[name]
    if col.dtype.kind == "U":
        mask = frame.missing(name)
        return np.zeros(col.shape[0], bool) if mask is None else mask
    if col.dtype.kind == "f":
        return np.isnan(col)
    return np.zeros(col.shape[0], bool)


def parse_string_column(frame: RawFrame, name: str, parse: Any) -> np.ndarray:
    """A ``U`` column through ``parse`` (distinct present strings -> float64
    values), gathered back to its rows; missing cells are NaN."""
    col, miss = frame[name], isnull(frame, name)
    uniq, inv = np.unique(col[~miss], return_inverse=True)
    out = np.full(col.shape[0], np.nan)
    out[~miss] = parse(uniq)[inv.reshape(-1)]
    return out


def _replace(frame: RawFrame, **columns: np.ndarray) -> RawFrame:
    """The frame with the given columns replaced in place (their missing
    masks dropped: each new column is numeric or has no missing cell)."""
    cols = {n: columns.get(n, frame[n]) for n in frame}
    miss = {n: frame.missing(n) for n in frame if n not in columns and frame.missing(n) is not None}
    return RawFrame(cols, miss)


def keep_rows(frame: RawFrame, keep: np.ndarray) -> RawFrame:
    """The frame's rows where ``keep`` is True, in order (the frame itself
    when every row is kept: no copy)."""
    return frame if keep.all() else frame.take(np.flatnonzero(keep))


def select_columns(frame: RawFrame, names: Sequence[str]) -> RawFrame:
    """The frame's columns ``names``, in that order."""
    return RawFrame(
        {n: frame[n] for n in names},
        {n: frame.missing(n) for n in names if frame.missing(n) is not None},
    )


_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)
_FOLD = np.uint64(0x100000001B3)
_MISSING_KEY = np.uint64(0x9E3779B97F4A7C15)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64's finalizer over a uint64 array (wrapping arithmetic)."""
    x = (x ^ (x >> np.uint64(30))) * _MIX1
    x = (x ^ (x >> np.uint64(27))) * _MIX2
    return x ^ (x >> np.uint64(31))


def _equality_key(frame: RawFrame, name: str) -> np.ndarray:
    """One uint64 per cell, equal for cells ``drop_duplicates`` calls equal
    (every missing cell alike, 0.0 and -0.0 alike); unequal cells may
    collide, so callers compare the colliding rows exactly."""
    col = frame[name]
    kind = col.dtype.kind
    if kind == "f":
        canon = np.where(np.isnan(col), np.nan, col + 0.0).astype(np.float64)
        return canon.view(np.uint64)
    if kind in "biu":
        return col.astype(np.int64).view(np.uint64)
    words = np.ascontiguousarray(col).view(np.uint32).reshape(col.shape[0], -1)
    h = np.zeros(col.shape[0], np.uint64)
    for k in range(words.shape[1]):
        h = (h ^ words[:, k]) * _FOLD
    return np.where(isnull(frame, name), _MISSING_KEY, h)


def _exact_codes(frame: RawFrame, name: str, rows: np.ndarray) -> np.ndarray:
    """Integer codes of a column's cells at ``rows``, equal exactly where
    ``drop_duplicates`` calls the cells equal (missing is -1)."""
    col, miss = frame[name][rows], isnull(frame, name)[rows]
    present = col[~miss]
    if present.dtype.kind == "f":
        present = present + 0.0  # -0.0 joins 0.0
    codes = np.full(rows.shape[0], -1, np.int64)
    codes[~miss] = np.unique(present, return_inverse=True)[1].reshape(-1)
    return codes


def duplicated(frame: RawFrame) -> np.ndarray:
    """pandas' ``DataFrame.duplicated()`` (keep='first'): True for each row
    equal in every column to an earlier row. Rows are hashed column by
    column; only the rows whose hash another row shares are compared
    exactly (sorted by their exact codes, stable in row order)."""
    n = frame.n_rows
    dup = np.zeros(n, bool)
    if n < 2 or not frame.columns:
        return dup
    h = np.zeros(n, np.uint64)
    for name in frame:
        h = (h ^ _equality_key(frame, name)) * _FOLD
    h = _mix64(h)
    order = np.argsort(h, kind="stable")
    hs = h[order]
    same = hs[1:] == hs[:-1]
    shared = np.zeros(n, bool)
    shared[1:] |= same
    shared[:-1] |= same
    cand = np.sort(order[shared])
    if cand.size == 0:
        return dup
    K = np.stack([_exact_codes(frame, name, cand) for name in frame], axis=1)
    srt = np.lexsort(K.T[::-1])  # stable: equal rows stay in row order
    Ks = K[srt]
    eq = (Ks[1:] == Ks[:-1]).all(axis=1)
    dup[cand[srt[1:][eq]]] = True
    return dup


def clean_raw_frame(
    frame: Any,
    *,
    null_col_threshold: float = 70.0,
    row_drop_null_limit: int = 10,
    unnecessary_cols: Sequence[str] = schema.CLEAN_UNNECESSARY_COLS,
    fill_zero_cols: Sequence[str] = schema.FILL_ZERO_COLS,
) -> tuple[RawFrame, CleanReport]:
    """The reference's cleaning rules on the host (module docstring).
    ``frame`` is a `RawFrame`, or anything `data.frame.as_raw_frame` reads.
    ``term`` comes back int64 when every cell parsed (truncated, as
    ``astype(int)`` truncates), else float64 with NaN."""
    frame = as_raw_frame(frame)
    report = CleanReport(n_rows_in=frame.n_rows)
    frame = select_columns(frame, [n for n in frame if n not in schema.UNNAMED_COLS])

    null_counts = {n: int(isnull(frame, n).sum()) for n in frame}
    near = [n for n in frame if null_counts[n] < row_drop_null_limit]
    before = frame.n_rows
    bad = np.zeros(frame.n_rows, bool)
    for n in near:
        bad |= isnull(frame, n)
    frame = keep_rows(frame, ~bad)
    report.n_rows_dropped_near_complete = before - frame.n_rows

    fixes: dict[str, np.ndarray] = {}
    if "hardship_status" in frame.columns and frame["hardship_status"].dtype.kind == "U":
        fixes["hardship_status"] = np.where(
            isnull(frame, "hardship_status"), schema.HARDSHIP_FILL, frame["hardship_status"]
        )
    if "term" in frame.columns:
        term = frame["term"]
        if term.dtype.kind == "U":
            term = parse_string_column(frame, "term", parse_term)
        nan = term.dtype.kind == "f" and bool(np.isnan(term).any())
        fixes["term"] = term.astype(np.float64 if nan else np.int64)
    if "int_rate" in frame.columns:
        col = frame["int_rate"]
        fixes["int_rate"] = (
            parse_string_column(frame, "int_rate", parse_percent) if col.dtype.kind == "U"
            else parse_percent(col)
        )
    frame = _replace(frame, **fixes)

    n = frame.n_rows
    too_null = [c for c in frame if n and isnull(frame, c).sum() / n * 100.0 > null_col_threshold]
    report.dropped_null_columns = too_null
    present_fixed = [c for c in unnecessary_cols if c in frame.columns and c not in too_null]
    report.dropped_fixed_columns = present_fixed
    gone = set(too_null) | set(present_fixed)
    frame = select_columns(frame, [c for c in frame if c not in gone])

    fills = {
        c: np.where(np.isnan(frame[c]), 0.0, frame[c])
        for c in fill_zero_cols
        if c in frame.columns and frame[c].dtype.kind == "f"
    }
    frame = _replace(frame, **fills)

    before = frame.n_rows
    frame = keep_rows(frame, ~duplicated(frame))
    report.n_duplicates_removed = before - frame.n_rows
    report.n_rows_out = frame.n_rows
    return frame, report
