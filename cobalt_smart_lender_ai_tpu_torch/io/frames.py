"""CSV text of a `RawFrame`, without pandas: the object store's frame format.

The reference stores every inter-stage table as the CSV that
``pandas.DataFrame.to_csv(index=False)`` writes and reads it back with
pandas' parser (or its own native one). The port writes and reads the same
dialect, so either package reads the other's tables:

- a header line, then one line per row, ``,`` between fields, ``\\n`` after
  each line;
- a number is written as the shortest text that reads back to it: a
  float32 column with float32 reprs, a float64 column with float64 reprs
  (so a float64 column holding float32 values keeps its float64 digits);
  an int column as decimal digits; NaN and a missing string as an empty
  field;
- a field holding ``,``, ``"``, ``\\n`` or ``\\r`` is quoted, with ``"``
  doubled; an empty string that is not missing is written ``""``.

Read back, a column is int64 when every field is an integer and none is
missing, float64 when every field is a number or missing (empty, or one of
pandas' default NA tokens), and a ``U`` array with a missing mask
otherwise. Numbers round-trip bit for bit, and so do strings and their
missing masks: a quoted field is never missing, so ``""`` reads back as the
empty string (pandas, and the reference's reader, read it as missing).

Neither direction loops over rows in Python. A numeric column is formatted
once per distinct bit pattern (``np.unique``) and gathered; the fields of a
block of rows are laid out in a zero-padded byte matrix, one fixed-width
slot per column, and the zeros are dropped. The reader finds the separators
of a block of lines with one vectorised scan and parses each column with
numpy's string casts. From ``PARALLEL_MIN_ROWS`` rows on, the columns and
the row blocks are spread over forked worker processes (numpy's string
casts hold the GIL, so threads would not run them side by side); the
workers read the parent's arrays without a copy and only compute with
numpy, and the pool is closed before the call returns.
"""

from __future__ import annotations

import multiprocessing
import os
from typing import Any, Callable, Sequence

import numpy as np

from cobalt_smart_lender_ai_tpu_torch.data.frame import RawFrame

__all__ = ["NA_TOKENS", "csv_to_frame", "frame_to_csv"]

#: Fields that read as missing: pandas' default NA tokens (and the empty
#: field).
NA_TOKENS = (
    b"", b"#N/A", b"#N/A N/A", b"#NA", b"-1.#IND", b"-1.#QNAN", b"-NaN", b"-nan",
    b"1.#IND", b"1.#QNAN", b"<NA>", b"N/A", b"NA", b"NULL", b"NaN", b"None",
    b"n/a", b"nan", b"null",
)

#: Rows per block of the byte layout (bounds the writer's and reader's
#: scratch memory to a few hundred MB on the widest tables).
BLOCK_ROWS = 65_536
#: Rows from which the work is spread over worker processes, and at most
#: how many.
PARALLEL_MIN_ROWS = 200_000
MAX_WORKERS = 8

#: What the forked workers of `_map` read: set in the parent before the
#: fork, cleared after.
_SHARED: dict[str, Any] = {}


def _workers(n_rows: int) -> int:
    return min(MAX_WORKERS, os.cpu_count() or 1) if n_rows >= PARALLEL_MIN_ROWS else 1


def _map(fn: Callable, items: Sequence, workers: int, **shared) -> list:
    """``[fn(item) for item in items]``, in up to ``workers`` forked
    processes that read ``shared`` (through ``_SHARED``) from the parent."""
    _SHARED.update(shared)
    try:
        if workers <= 1 or len(items) <= 1:
            return [fn(item) for item in items]
        with multiprocessing.get_context("fork").Pool(min(workers, len(items))) as pool:
            return pool.map(fn, items, chunksize=1)
    finally:
        _SHARED.clear()

_COMMA, _QUOTE, _NL, _CR = 44, 34, 10, 13


def _quote(cells: np.ndarray) -> np.ndarray:
    """``S`` cells, each quoted (``"`` doubled) where it holds a comma, a
    quote or a line break."""
    if cells.size == 0 or cells.dtype.itemsize == 0:
        return cells
    v = cells.view(np.uint8).reshape(cells.shape[0], cells.dtype.itemsize)
    need = ((v == _COMMA) | (v == _QUOTE) | (v == _NL) | (v == _CR)).any(axis=1)
    if not need.any():
        return cells
    out = cells.astype(object)
    idx = np.flatnonzero(need)
    out[idx] = [b'"' + c.replace(b'"', b'""') + b'"' for c in cells[idx]]
    return out.astype(bytes)


def _encode(values: np.ndarray) -> np.ndarray:
    """A ``U`` array as UTF-8 ``S`` cells."""
    try:
        return values.astype(bytes)  # ASCII, the common case: one C cast
    except UnicodeEncodeError:
        return np.char.encode(values, "utf-8")


def _column_cells(col: np.ndarray, missing: np.ndarray | None) -> tuple[np.ndarray, np.ndarray | None]:
    """``(table, index)``: the column's text is ``table[index]`` (or
    ``table`` itself when ``index`` is None)."""
    kind = col.dtype.kind
    if kind == "U":
        cells = _quote(_encode(col))
        empty = cells == b""
        if missing is not None:
            empty &= ~missing
            cells = np.where(missing, b"", cells)
        if empty.any():
            cells = np.where(empty, b'""', cells)
        return cells, None
    if kind in "iu":
        uniq, inv = np.unique(col, return_inverse=True)
        return uniq.astype(bytes), inv.astype(np.int32)
    if kind == "f":
        # Distinct bit patterns, so -0.0 keeps its sign.
        bits = col.view(np.dtype(f"i{col.dtype.itemsize}"))
        uniq, inv = np.unique(bits, return_inverse=True)
        vals = uniq.view(col.dtype)
        text = vals.astype(str).astype(bytes)
        return np.where(np.isnan(vals), b"", text), inv.astype(np.int32)
    raise TypeError(f"cannot write a column of dtype {col.dtype} as CSV")


def _layout(cols: list[np.ndarray]) -> bytes:
    """Lines of the given ``S`` cell columns (all of one length)."""
    n = cols[0].shape[0]
    widths = [c.dtype.itemsize for c in cols]
    row_w = sum(widths) + len(cols)
    M = np.zeros((n, row_w), dtype=np.uint8)
    off = 0
    for j, (c, w) in enumerate(zip(cols, widths)):
        if w:
            M[:, off : off + w] = c.view(np.uint8).reshape(n, w)
        off += w
        M[:, off] = _NL if j == len(cols) - 1 else _COMMA
        off += 1
    return M[M != 0].tobytes()


def _cells_of_column(name: str):
    frame = _SHARED["frame"]
    return _column_cells(frame[name], frame.missing(name))


def _lines_of_block(r0: int) -> bytes:
    tables, n = _SHARED["tables"], _SHARED["n_rows"]
    rows = slice(r0, min(r0 + BLOCK_ROWS, n))
    return _layout([t[rows] if i is None else t[i[rows]] for t, i in tables])


def frame_to_csv(frame: RawFrame) -> bytes:
    """The frame as CSV bytes (the dialect of the module docstring)."""
    names = frame.columns
    workers = _workers(frame.n_rows)
    header = b",".join(_quote(np.array([n.encode() for n in names])).tolist()) + b"\n"
    tables = _map(_cells_of_column, names, workers, frame=frame)
    blocks = _map(_lines_of_block, range(0, frame.n_rows, BLOCK_ROWS), workers,
                  tables=tables, n_rows=frame.n_rows)
    return b"".join([header, *blocks])


# --- reading ------------------------------------------------------------------------


def _line_ends(buf: np.ndarray) -> np.ndarray:
    """Positions of the ``\\n`` that end lines (outside quotes)."""
    nl = np.flatnonzero(buf == _NL)
    q = buf == _QUOTE
    if not q.any():
        return nl
    inside = np.bitwise_xor.accumulate(q.view(np.uint8))
    return nl[inside[nl] == 0]


def _field_bounds(buf: np.ndarray, a: int, b: int, n_cols: int) -> tuple[np.ndarray, np.ndarray]:
    """(starts, ends) of the fields of the lines in ``buf[a:b]`` (which
    ends with the last line's ``\\n``), each ``(n_lines, n_cols)``."""
    sub = buf[a:b]
    sep = (sub == _COMMA) | (sub == _NL)
    q = sub == _QUOTE
    if q.any():
        sep &= np.bitwise_xor.accumulate(q.view(np.uint8)) == 0
    ends = np.flatnonzero(sep)
    if ends.size % n_cols or not (sub[ends[n_cols - 1 :: n_cols]] == _NL).all():
        raise ValueError(f"CSV lines with other than {n_cols} fields")
    starts = np.empty_like(ends)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    return (starts + a).reshape(-1, n_cols), (ends + a).reshape(-1, n_cols)


def _cells(buf: np.ndarray, starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """The fields ``buf[s:e]`` as one ``S`` array."""
    lengths = ends - starts
    w = int(lengths.max()) if lengths.size else 0
    if w == 0:
        return np.zeros(starts.shape[0], dtype="S1")
    idx = starts[:, None] + np.arange(w)
    cells = buf[np.minimum(idx, buf.shape[0] - 1)]
    cells[np.arange(w) >= lengths[:, None]] = 0
    return cells.reshape(-1).view(f"S{w}")


def _unquote(cells: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(unquoted cells, which were quoted)."""
    quoted = cells.view(np.uint8).reshape(cells.shape[0], -1)[:, 0] == _QUOTE
    if not quoted.any():
        return cells, quoted
    out = cells.astype(object)
    idx = np.flatnonzero(quoted)
    out[idx] = [c[1:-1].replace(b'""', b'"') for c in cells[idx]]
    return out.astype(bytes), quoted


def _integers(cells: np.ndarray) -> bool:
    """Every cell is ``[+-]digits``."""
    v = cells.view(np.uint8).reshape(cells.shape[0], -1)
    digit = (v >= 48) & (v <= 57)
    sign = (v[:, :1] == 45) | (v[:, :1] == 43)
    ok = digit | (v == 0)
    ok[:, :1] |= sign
    has_digit = digit.any(axis=1)
    return bool(ok.all() and has_digit.all())


def _decode(cells: np.ndarray) -> np.ndarray:
    try:
        return cells.astype(str)  # ASCII, the common case
    except UnicodeDecodeError:
        return np.char.decode(cells, "utf-8")


def _parse_column(cells: np.ndarray) -> tuple[np.ndarray, np.ndarray | None]:
    """(values, missing mask of a string column or None)."""
    cells, quoted = _unquote(cells)
    tokens = [t for t in NA_TOKENS if len(t) <= cells.dtype.itemsize]
    missing = np.isin(cells, np.array(tokens, dtype=cells.dtype)) & ~quoted
    present = cells[~missing]
    try:
        nums = present.astype(np.float64)
    except ValueError:
        values = _decode(cells)
        values[missing] = ""
        return values, missing
    if not missing.any() and present.size and _integers(present):
        return present.astype(np.int64), None
    out = np.full(cells.shape[0], np.nan)
    out[~missing] = nums
    return out, None


def _cells_of_block(bounds: tuple[int, int]) -> list[np.ndarray]:
    buf, n_cols = _SHARED["buf"], _SHARED["n_cols"]
    s, e = _field_bounds(buf, bounds[0], bounds[1], n_cols)
    return [_cells(buf, s[:, j], e[:, j]) for j in range(n_cols)]


def _parse_shared(j: int) -> tuple[np.ndarray, np.ndarray | None]:
    return _parse_column(_SHARED["columns"][j])


def csv_to_frame(data: bytes) -> RawFrame:
    """A `RawFrame` of CSV bytes (the dialect of the module docstring)."""
    if b"\r\n" in data:
        data = data.replace(b"\r\n", b"\n")
    if not data.endswith(b"\n"):
        data += b"\n"
    buf = np.frombuffer(data, dtype=np.uint8)
    ends = _line_ends(buf)
    head_end = int(ends[0])
    header = buf[: head_end + 1]
    outside = np.bitwise_xor.accumulate((header == _QUOTE).view(np.uint8)) == 0
    n_cols = int(((header == _COMMA) & outside).sum()) + 1
    s, e = _field_bounds(buf, 0, head_end + 1, n_cols)
    names = [c.decode() for c in _unquote(_cells(buf, s[0], e[0]))[0].tolist()]
    lines = ends[1:]
    starts = [head_end + 1] + [int(lines[i - 1]) + 1 for i in range(BLOCK_ROWS, lines.shape[0], BLOCK_ROWS)]
    stops = [int(lines[min(i + BLOCK_ROWS, lines.shape[0]) - 1]) + 1
             for i in range(0, lines.shape[0], BLOCK_ROWS)]
    workers = _workers(lines.shape[0])
    blocks = _map(_cells_of_block, list(zip(starts, stops)), workers, buf=buf, n_cols=n_cols)
    cells = [np.concatenate([b[j] for b in blocks]) if blocks else np.zeros(0, dtype="S1")
             for j in range(n_cols)]
    del blocks
    parsed = _map(_parse_shared, range(n_cols), workers, columns=cells)
    columns = {name: values for name, (values, _) in zip(names, parsed)}
    missing = {name: miss for name, (_, miss) in zip(names, parsed) if miss is not None}
    return RawFrame(columns, missing)
