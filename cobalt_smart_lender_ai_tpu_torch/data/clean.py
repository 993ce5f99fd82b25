"""The cleaning stage's report and its two string parsers, on numpy
columns: the part of the reference's ``data/clean.py`` that the device
ingest (`data.device_pipeline`) needs.

Each parser takes the column's distinct strings only, parses each once in
float64, and the tokenizer gathers the results; float64 is rounded once to
float32 when the tokenized matrix is built, as the reference's tokenizer
does. A cell that does not parse (empty, whitespace-only, malformed) is
NaN, as ``pd.to_numeric(errors="coerce")`` makes it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["CleanReport", "parse_percent", "parse_term"]


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
