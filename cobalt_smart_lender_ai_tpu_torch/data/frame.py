"""The port's raw table: an ordered mapping from column name to a 1-D numpy
array, standing in for the reference's ``pd.DataFrame`` of raw loans.

Numeric columns are float64 or int64 arrays. String columns are numpy
``U`` arrays with a boolean mask of the missing cells (whose ``U`` values
are ignored), because 34 string columns of 2.3M rows as Python ``str``
objects would be ~80M objects and several GB of host memory. Object arrays
holding ``str`` and ``None`` are accepted too.

`tokenize_raw_frame` reads a table only through `string_column` and
`column_names`, which also take any frame that iterates over its column
names and answers ``frame[name]`` with an array-like (a pandas DataFrame
among them), so the tests can hand the reference's own frames to the port.
"""

from __future__ import annotations

import math
from typing import Any, Iterator, Mapping

import numpy as np

__all__ = ["RawFrame", "as_raw_frame", "column_names", "row_dicts", "string_column"]


class RawFrame:
    """Ordered columns of equal length, plus the missing masks of the ``U``
    columns.

    >>> f = RawFrame({"a": np.array([1.0, 2.0]), "b": np.array(["x", ""])},
    ...              missing={"b": np.array([False, True])})
    >>> list(f), f.n_rows, f.missing("b").tolist()
    (['a', 'b'], 2, [False, True])
    """

    def __init__(
        self,
        columns: Mapping[str, np.ndarray],
        missing: Mapping[str, np.ndarray] | None = None,
    ):
        self._cols = {name: np.asarray(col) for name, col in columns.items()}
        lengths = {col.shape for col in self._cols.values()}
        if len(lengths) > 1 or any(len(s) != 1 for s in lengths):
            raise ValueError(f"columns must be 1-D of one length, got shapes {lengths}")
        self._missing = {name: np.asarray(m, dtype=bool) for name, m in (missing or {}).items()}
        for name, m in self._missing.items():
            if self._cols[name].dtype.kind != "U" or m.shape != self._cols[name].shape:
                raise ValueError(f"missing mask of {name!r} must match a U column")

    def __iter__(self) -> Iterator[str]:
        return iter(self._cols)

    def __getitem__(self, name: str) -> np.ndarray:
        return self._cols[name]

    @property
    def columns(self) -> list[str]:
        return list(self._cols)

    @property
    def n_rows(self) -> int:
        return next(iter(self._cols.values())).shape[0] if self._cols else 0

    def missing(self, name: str) -> np.ndarray | None:
        """The missing mask of a ``U`` column, or None if it has none."""
        return self._missing.get(name)

    def take(self, rows: np.ndarray) -> "RawFrame":
        """The frame of the given row indices, in their order."""
        return RawFrame(
            {n: c[rows] for n, c in self._cols.items()},
            {n: m[rows] for n, m in self._missing.items()},
        )

    def concat(self, other: "RawFrame") -> "RawFrame":
        """This frame's rows, then ``other``'s (same columns)."""
        if self.columns != other.columns:
            raise ValueError("frames with other columns cannot be concatenated")
        miss = {}
        for n in set(self._missing) | set(other._missing):
            a = self._missing.get(n, np.zeros(self.n_rows, bool))
            b = other._missing.get(n, np.zeros(other.n_rows, bool))
            miss[n] = np.concatenate([a, b])
        return RawFrame({n: np.concatenate([c, other[n]]) for n, c in self._cols.items()}, miss)


def column_names(frame: Any) -> list[str]:
    """The frame's column names, in order."""
    return [str(name) for name in frame]


def _is_missing(v: Any) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def string_column(
    frame: Any, name: str
) -> tuple[np.ndarray, np.ndarray, tuple[str, ...]] | None:
    """A string column as ``(values U array, missing mask, missing tokens)``,
    or None when the column is numeric (bool, int or float).

    The missing tokens are the sorted distinct ``str()`` of the missing
    cells, as the reference's ``astype(str)`` spells them: ``'None'`` for
    None, ``'nan'`` for NaN (a pandas string column's missing value) and for
    a masked cell of a `RawFrame`."""
    col = frame[name]
    if hasattr(col, "to_numpy"):
        col = col.to_numpy()
    arr = np.asarray(col)
    kind = arr.dtype.kind
    if kind in "biuf":
        return None
    if kind == "U":
        mask = frame.missing(name) if isinstance(frame, RawFrame) else None
        mask = np.zeros(arr.shape, bool) if mask is None else mask
        return arr, mask, ("nan",) if mask.any() else ()
    if kind != "O":
        raise TypeError(f"column {name!r} has dtype {arr.dtype}; expected numbers or strings")
    mask = np.fromiter((_is_missing(v) for v in arr), dtype=bool, count=arr.shape[0])
    tokens = tuple(sorted({str(v) for v in arr[mask]}))
    values = np.where(mask, "", arr).astype(str)
    return values, mask, tokens


def as_raw_frame(frame: Any) -> RawFrame:
    """``frame`` (anything `string_column` reads, a pandas DataFrame among
    them) as a `RawFrame` of numeric arrays and ``U`` columns with their
    missing masks; a `RawFrame` of such columns comes back as it is."""
    if isinstance(frame, RawFrame) and all(frame[n].dtype.kind in "biufU" for n in frame):
        return frame
    columns, missing = {}, {}
    for name in column_names(frame):
        s = string_column(frame, name)
        if s is None:
            col = frame[name]
            columns[name] = np.asarray(col.to_numpy() if hasattr(col, "to_numpy") else col)
        else:
            columns[name], missing[name] = s[0], s[1]
    return RawFrame(columns, missing)


def row_dicts(frame: Any, rows: np.ndarray) -> list[dict[str, Any]]:
    """Raw payloads of the given rows: {column: value}, with Python floats
    for numbers, ``str`` for strings and None for missing string cells."""
    out: list[dict[str, Any]] = [{} for _ in rows]
    for name in column_names(frame):
        s = string_column(frame, name)
        if s is None:
            vals = np.asarray(frame[name])[rows].tolist()
        else:
            values, mask, _ = s
            vals = [None if m else str(v) for v, m in zip(values[rows], mask[rows])]
        for d, v in zip(out, vals):
            d[name] = v
    return out
