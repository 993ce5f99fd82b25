"""Device ingest: tokenize the raw table once on the host, then clean,
engineer and bin it as torch programs on the device.

The port's copy of the reference's ``data/device_pipeline.py``. The ingest
splits at the only boundary that is irreducibly host-bound, the *stringy
frontier*:

- `tokenize_raw_frame` (host, numpy) parses the irreducibly-string columns
  (``term``, the percents, ``emp_length``, the ``earliest_cr_line`` date age)
  and gives every other string column sorted-vocabulary integer codes,
  producing one dense ``(N, C)`` float32 matrix with NaN as the missing
  marker. It factorizes each column once and parses only the distinct
  strings, then gathers.
- `run_device_ingest` replays every observable rule of the reference's
  cleaning, preparation and engineering stages as torch operations on the
  given device: the null census, the near-complete row drop, the hardship
  and zero fills, the null-column and fixed drops, keep-first dedupe (on a
  salted 64-bit hash of each row's canonical float32 bits), the prepare
  drops and row-null threshold, the vocabulary census, label mapping,
  residual label-encode, log1p, the NaN and median stats, the tree / nn /
  label assembly and the quantile binning. Only row counts and
  ``(F,)``-sized stats come to the host; they drive the column bookkeeping
  (which names are live, in what order), never row work.

Parity with the reference: integer, categorical, one-hot, indicator and
label columns are bit-identical, and so are the bins of every column log1p
does not touch; log1p-derived values (and the medians imputed from them)
are within a few float32 ulps, because the port's ``log1p`` and XLA's
differ in the last bits. On one device, `transform_raw_rows` runs the same
log1p and one-hot code on a raw payload, so a raw row reproduces its batch
row bit for bit.

Sharding waits for the port's multi-GPU work: this runs on one device.

Telemetry, on the process-wide registry as the reference records it:
``cobalt_ingest_rows_total`` counts the raw rows entering the ingest, and
``cobalt_ingest_dispatch_seconds`` observes each device program of the
ingest (and of `transform_raw_rows`), wall seconds ending with the device
synchronised, so they hold the program's device work.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import time
from datetime import datetime
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from cobalt_smart_lender_ai_tpu_torch.data import schema
from cobalt_smart_lender_ai_tpu_torch.data.clean import (
    CleanReport,
    _number,
    parse_percent,
    parse_term,
)
from cobalt_smart_lender_ai_tpu_torch.data.features import (
    FeatureFrame,
    FeaturePlan,
    impute_with_indicators,
    log1p_masked,
    one_hot_codes,
)
from cobalt_smart_lender_ai_tpu_torch.data.frame import RawFrame, column_names, string_column
from cobalt_smart_lender_ai_tpu_torch.data.split import _mix_u32
from cobalt_smart_lender_ai_tpu_torch.device import resolve_device
from cobalt_smart_lender_ai_tpu_torch.ops.binning import (
    BinSpec,
    _nanquantile_column,
    bin_edges_and_transform,
)
from cobalt_smart_lender_ai_tpu_torch.telemetry.metrics import default_registry, log_buckets

__all__ = [
    "DeviceIngestResult",
    "TokenizedFrame",
    "run_device_ingest",
    "tokenize_raw_frame",
    "transform_raw_rows",
]

# Measured dispatch-seconds family for the run ledger's attribution
# denominator (`telemetry/runledger.py` lists it).
_INGEST_DISPATCH_S = default_registry().histogram(
    "cobalt_ingest_dispatch_seconds",
    "wall time of one device-ingest program dispatch",
    buckets=log_buckets(1e-5, 120.0, per_decade=3),
)
_INGEST_ROWS = default_registry().counter(
    "cobalt_ingest_rows_total",
    "raw rows entering the device-resident ingest flow",
)


@contextlib.contextmanager
def _dispatch(dev: torch.device):
    """Time one device program of the ingest into
    ``cobalt_ingest_dispatch_seconds``, ending with ``dev`` synchronised."""
    t0 = time.perf_counter()
    yield
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    _INGEST_DISPATCH_S.observe(time.perf_counter() - t0)


@dataclasses.dataclass(frozen=True)
class TokenizedFrame:
    """Output of the stringy frontier: one dense host matrix plus the
    bookkeeping needed to replay the reference's column semantics.

    ``X`` is ``(N, C)`` float32 (column-major) with NaN for missing;
    columns are in raw order (minus the ``Unnamed:`` artifacts). ``kinds[i]`` is ``"numeric"``
    (parsed or passthrough) or ``"categorical"`` (sorted-vocabulary codes).
    ``vocab`` / ``missing_token`` are keyed by physical column index."""

    columns: tuple[str, ...]
    X: np.ndarray
    kinds: tuple[str, ...]
    vocab: Mapping[int, tuple[str, ...]]
    missing_token: Mapping[int, tuple[str, ...]]
    today: datetime

    @property
    def n_rows(self) -> int:
        return int(self.X.shape[0])


@dataclasses.dataclass(frozen=True)
class DeviceIngestResult:
    """The engineering stage's outputs and the GBDT sketch, on the device."""

    tree: FeatureFrame
    nn: FeatureFrame
    plan: FeaturePlan
    bin_spec: BinSpec
    bins: torch.Tensor  # (N, F_tree) uint8 bin indices
    report: CleanReport
    #: The clean stage's table on the host (``keep_cleaned=True`` only):
    #: categorical codes decoded to their vocabulary strings (missing where
    #: NaN), every other column float64.
    cleaned: RawFrame | None = None


# --- Stringy frontier (host) ----------------------------------------------------


def _emp_length_number(s: str) -> float:
    """The reference's emp_length transform of one string: ``"< 1 year"``
    is 0, else the first run of digits."""
    m = re.search(r"(\d+)", "0" if s == "< 1 year" else s)
    return _number(m.group(1)) if m else float("nan")


def _date_age_days(s: str, today: datetime) -> float:
    """Days from a ``"%b-%Y"`` date (the 1st of its month) to ``today``,
    floored; NaN if the string is not such a date."""
    try:
        return float((today - datetime.strptime(s, "%b-%Y")).days)
    except ValueError:
        return float("nan")


def _parse_strings(name: str, uniq: np.ndarray, today: datetime) -> np.ndarray:
    """The frontier parse of one column's distinct strings, float64."""
    if name in schema.FRONTIER_TERM_COLS:
        return parse_term(uniq)
    if name in schema.FRONTIER_PERCENT_COLS:
        return parse_percent(uniq)
    if name in schema.FRONTIER_EMP_COLS:
        return np.array([_emp_length_number(s) for s in uniq.tolist()], np.float64)
    return np.array([_date_age_days(s, today) for s in uniq.tolist()], np.float64)


_FRONTIER = frozenset(
    schema.FRONTIER_TERM_COLS
    + schema.FRONTIER_PERCENT_COLS
    + schema.FRONTIER_EMP_COLS
    + schema.FRONTIER_DATE_COLS
)


def _numeric_column(name: str, values: np.ndarray) -> np.ndarray:
    """A numeric column's tokenized float64 values: term and the percents
    as their parsers take numbers (``revol_util`` passes through, as the
    reference's prepare leaves it); a date column of numbers is all
    missing."""
    if name in schema.FRONTIER_TERM_COLS:
        return parse_term(values)
    if name in schema.FRONTIER_PERCENT_COLS and name != "revol_util":
        return parse_percent(values)
    if name in schema.FRONTIER_DATE_COLS:
        return np.full(values.shape[0], np.nan)
    return values.astype(np.float64)


def tokenize_raw_frame(frame: Any, *, today: datetime | None = None) -> TokenizedFrame:
    """Host frontier: one factorization per string column.

    ``frame`` is a `RawFrame`, or anything that iterates over its column
    names and answers ``frame[name]`` (a pandas DataFrame among them).
    Numeric columns pass through; the frontier columns (``schema.FRONTIER_*``)
    are parsed; every other string column becomes codes into its sorted
    vocabulary. ``loan_status`` stays categorical: its label map is applied
    on the device, after the dedupe."""
    now = today or datetime.today()
    names = [n for n in column_names(frame) if n not in schema.UNNAMED_COLS]
    n_rows = len(frame[names[0]]) if names else 0
    # Column-major, so that each column is written in one contiguous run.
    X = np.empty((n_rows, len(names)), np.float32, order="F")
    kinds: list[str] = []
    vocab: dict[int, tuple[str, ...]] = {}
    missing_token: dict[int, tuple[str, ...]] = {}
    for j, name in enumerate(names):
        col = string_column(frame, name)
        if col is None:
            kinds.append("numeric")
            X[:, j] = _numeric_column(name, np.asarray(frame[name]))
            continue
        values, missing, tokens = col
        present = ~missing
        uniq, inv = np.unique(values[present], return_inverse=True)
        inv = inv.reshape(-1)
        if name in _FRONTIER:
            kinds.append("numeric")
            out = np.full(n_rows, np.nan)
            out[present] = _parse_strings(name, uniq, now)[inv]
            X[:, j] = out
            continue
        cats = uniq.tolist()
        if name == "hardship_status" and missing.any() and schema.HARDSHIP_FILL not in cats:
            # Clean rule 3 fills the missing cells with this token on the
            # device, so the vocabulary holds it whenever the column had any.
            cats = sorted(cats + [schema.HARDSHIP_FILL])
        recode = np.searchsorted(np.asarray(cats, dtype=str), uniq).astype(np.float32)
        codes = np.full(n_rows, np.nan, np.float32)
        codes[present] = recode[inv]
        kinds.append("categorical")
        vocab[j] = tuple(cats)
        missing_token[j] = tokens
        X[:, j] = codes
    return TokenizedFrame(
        columns=tuple(names),
        X=X,
        kinds=tuple(kinds),
        vocab=vocab,
        missing_token=missing_token,
        today=now,
    )


# --- Device programs ----------------------------------------------------------------


def _null_counts(X: torch.Tensor) -> np.ndarray:
    return torch.isnan(X).sum(dim=0).cpu().numpy()


def _compact_by_nonnull(X: torch.Tensor, sel: torch.Tensor, thresh: int) -> torch.Tensor:
    """Rows with at least ``thresh`` non-null cells among the ``sel``
    columns, in their order (the device ``dropna``). Always a copy."""
    keep = (~torch.isnan(X.index_select(1, sel))).sum(dim=1) >= thresh
    return X[keep]


def _fill_cols(X: torch.Tensor, sel: Sequence[int], vals: Sequence[float]) -> None:
    """In place: NaN cells of each ``sel`` column become its value."""
    for j, v in zip(sel, vals):
        col = X[:, j]
        X[:, j] = torch.where(torch.isnan(col), torch.tensor(v, dtype=X.dtype, device=X.device), col)


_U32 = 0xFFFFFFFF


def _row_hash_keys(X: torch.Tensor, sel: Sequence[int]) -> torch.Tensor:
    """Each row's salted 64-bit hash over the ``sel`` columns as one int64
    key: the reference's two 32-bit lanes (h1, h2) of the canonical float32
    bit patterns (one NaN, +0.0), accumulated column by column so that
    memory stays O(N). ``(h1 - 2^31) * 2^32 + h2`` maps each pair to a
    distinct int64 without overflow."""
    N = X.shape[0]
    acc1 = torch.zeros(N, dtype=torch.int64, device=X.device)
    acc2 = torch.zeros(N, dtype=torch.int64, device=X.device)
    nan = torch.tensor(float("nan"), dtype=torch.float32, device=X.device)
    for j, c in enumerate(sel):
        col = X[:, c]
        col = torch.where(torch.isnan(col), nan, col + 0.0)
        bits = col.view(torch.int32).to(torch.int64) & _U32
        salt = (j * 0x9E3779B9) & _U32
        acc1 += _mix_u32(bits ^ salt, 101)
        acc2 += _mix_u32(bits ^ (~salt & _U32), 107)
    h1 = _mix_u32(acc1 & _U32, 103)
    h2 = _mix_u32(acc2 & _U32, 109)
    return (h1 - 2**31) * 2**32 + h2


def _dedupe_keep_first(X: torch.Tensor, sel: Sequence[int]) -> torch.Tensor:
    """``drop_duplicates()`` on the device: a stable sort of the row keys
    puts equal rows next to each other, lowest index first, and every row
    equal to its sorted predecessor goes (keep='first'; NaN == NaN)."""
    keys = _row_hash_keys(X, sel)
    srt, order = torch.sort(keys, stable=True)
    dup = torch.zeros_like(srt, dtype=torch.bool)
    dup[1:] = srt[1:] == srt[:-1]
    keep = torch.empty_like(dup)
    keep[order] = ~dup
    return X[keep]


def _vocab_census(X: torch.Tensor, cols: Sequence[int], vmax: int) -> tuple[np.ndarray, np.ndarray]:
    """Per categorical column: which codes survive the row drops, and
    whether any missing cell does."""
    present, has_nan = [], []
    for c in cols:
        col = X[:, c]
        code = torch.where(torch.isnan(col), float(vmax), col).long()
        seen = torch.bincount(code, minlength=vmax + 1) > 0
        present.append(seen[:vmax])
        has_nan.append(seen[vmax])
    return torch.stack(present).cpu().numpy(), torch.stack(has_nan).cpu().numpy()


def _numeric_prep(
    X: torch.Tensor,
    num_idx: torch.Tensor,
    residual: Sequence[tuple[int, torch.Tensor, float]],
    log_mask: torch.Tensor,
) -> torch.Tensor:
    """The numeric block: residual label-encode (full-tokenize codes ->
    surviving vocabulary, missing -> its token's code) then masked log1p,
    the reference's order."""
    Xn = X.index_select(1, num_idx)
    for j, table, miss in residual:
        col = Xn[:, j]
        nan = torch.isnan(col)
        code = torch.where(nan, 0.0, col).long()
        Xn[:, j] = torch.where(nan, torch.tensor(miss, device=X.device), table[code])
    return log1p_masked(Xn, log_mask)


def _nanmedians(Xn: torch.Tensor) -> torch.Tensor:
    """Per-column medians ignoring NaN, the reference's ``nanmedian``
    rounding (the mean of the two middle values); all-NaN columns give 0."""
    half = torch.tensor([0.5], dtype=torch.float32, device=Xn.device)
    med = torch.cat([_nanquantile_column(Xn[:, j], half) for j in range(Xn.shape[1])])
    return torch.where(torch.isnan(med), 0.0, med)


# The reference pipeline's defaults: drop a column more than 70% missing,
# drop rows missing a value in a column with fewer than 10 nulls, and drop a
# prepared row missing more than 20 live columns; 255 quantile bins.
_NULL_COL_THRESHOLD = 70.0
_ROW_DROP_NULL_LIMIT = 10
_ROW_NULL_ALLOWANCE = 20
_N_BINS = 255


def _decode_cleaned(X: torch.Tensor, tok: TokenizedFrame, live: Sequence[str], pos: Mapping[str, int]) -> RawFrame:
    """The clean stage's table on the host, as the reference keeps it."""
    Xc = X.index_select(1, torch.tensor([pos[c] for c in live], device=X.device)).cpu().numpy()
    columns, missing = {}, {}
    for j, c in enumerate(live):
        col = Xc[:, j]
        i = pos[c]
        if tok.kinds[i] == "categorical" and tok.vocab.get(i):
            nan = np.isnan(col)
            cats = np.asarray(tok.vocab[i], dtype=str)
            columns[c] = np.where(nan, "", cats[np.where(nan, 0, col).astype(np.int64)])
            missing[c] = nan
        else:
            columns[c] = col.astype(np.float64)
    return RawFrame(columns, missing)


def run_device_ingest(
    tok: TokenizedFrame,
    *,
    device: torch.device | str = "cuda",
    n_bins: int = _N_BINS,
    null_col_threshold: float = _NULL_COL_THRESHOLD,
    row_null_allowance: int = _ROW_NULL_ALLOWANCE,
    keep_cleaned: bool = False,
) -> DeviceIngestResult:
    """Clean -> prepare -> engineer -> bin the tokenized matrix on
    ``device`` (``cuda`` unless the caller asks for ``cpu``), with the
    reference pipeline's thresholds unless given. ``keep_cleaned`` brings
    the clean stage's table to the host as ``DeviceIngestResult.cleaned``."""
    dev = resolve_device(device)
    _INGEST_ROWS.inc(tok.n_rows)
    X = torch.from_numpy(tok.X).to(dev)
    pos = {name: i for i, name in enumerate(tok.columns)}
    live = list(tok.columns)
    report = CleanReport(n_rows_in=tok.n_rows)

    def sel(names: Sequence[str]) -> torch.Tensor:
        return torch.tensor([pos[n] for n in names], dtype=torch.int64, device=dev)

    # Clean rule 2: drop rows missing a value in any near-complete column.
    with _dispatch(dev):
        counts = _null_counts(X)
    near = [n for n in live if counts[pos[n]] < _ROW_DROP_NULL_LIMIT]
    before = int(X.shape[0])
    with _dispatch(dev):
        X = _compact_by_nonnull(X, sel(near), len(near))  # a copy: tok.X stays
    report.n_rows_dropped_near_complete = before - int(X.shape[0])

    # Clean rule 3: the hardship fill, as its vocabulary code.
    if "hardship_status" in live:
        cats = tok.vocab.get(pos["hardship_status"], ())
        if schema.HARDSHIP_FILL in cats:
            with _dispatch(dev):
                _fill_cols(X, [pos["hardship_status"]], [float(cats.index(schema.HARDSHIP_FILL))])

    # Clean rule 4 (term / int_rate parse) happened at tokenize time.
    # Clean rule 5: missingness-threshold column drop.
    with _dispatch(dev):
        counts = _null_counts(X)
    n_rows = int(X.shape[0])
    too_null = [
        c for c in live
        if n_rows and 100.0 * counts[pos[c]] / n_rows > null_col_threshold
    ]
    report.dropped_null_columns = too_null
    live = [c for c in live if c not in set(too_null)]

    # Clean rule 6: fixed unnecessary-column drop.
    present_fixed = [c for c in schema.CLEAN_UNNECESSARY_COLS if c in live]
    report.dropped_fixed_columns = present_fixed
    live = [c for c in live if c not in set(present_fixed)]

    # Clean rule 7: missing-means-zero fills.
    zero_cols = [c for c in schema.FILL_ZERO_COLS if c in live]
    with _dispatch(dev):
        _fill_cols(X, [pos[c] for c in zero_cols], [0.0] * len(zero_cols))

    # Clean rule 8: keep-first dedupe over the live columns.
    before = int(X.shape[0])
    if before:
        with _dispatch(dev):
            X = _dedupe_keep_first(X, [pos[c] for c in live])
        report.n_duplicates_removed = before - int(X.shape[0])
    report.n_rows_out = int(X.shape[0])
    cleaned = _decode_cleaned(X, tok, live, pos) if keep_cleaned else None

    # Prepare: leakage/useless drop, then the row-null threshold.
    fe_drop = set(schema.FE_LEAKAGE_COLS) | set(schema.FE_USELESS_COLS)
    live = [c for c in live if c not in fe_drop]
    with _dispatch(dev):
        X = _compact_by_nonnull(X, sel(live), max(len(live) - row_null_allowance, 0))

    # Prepare renames (values already tokenized; the reference appends each
    # derived column at the end and drops its source).
    def _rename_to_tail(old: str, new: str) -> None:
        if old in live:
            pos[new] = pos[old]
            live.remove(old)
            live.append(new)

    _rename_to_tail("emp_length", "emp_length_num")
    _rename_to_tail("earliest_cr_line", "earliest_cr_line_days")
    has_label = "loan_status" in live
    label_pos = pos.get("loan_status", 0)
    if has_label:
        live.remove("loan_status")

    # Engineer bookkeeping: numeric order, categorical split.
    cat_present = [c for c in schema.ONE_HOT_COLS if c in live]
    numeric_names = [c for c in live if c not in set(cat_present)]
    residual = [c for c in numeric_names if tok.kinds[pos[c]] == "categorical"]

    # Surviving vocabularies (the reference discovers them after the drops).
    cat_all = cat_present + residual
    vocab_surv: dict[str, tuple[str, ...]] = {}
    nan_surv: dict[str, bool] = {}
    if cat_all:
        vmax = max(1, max(len(tok.vocab.get(pos[c], ())) for c in cat_all))
        with _dispatch(dev):
            present, has_nan = _vocab_census(X, [pos[c] for c in cat_all], vmax)
        for i, c in enumerate(cat_all):
            full = tok.vocab.get(pos[c], ())
            vocab_surv[c] = tuple(v for j, v in enumerate(full) if present[i, j])
            nan_surv[c] = bool(has_nan[i])

    # Residual label-encode tables: full-tokenize codes -> the sorted
    # astype(str) vocabulary (the missing token included iff missing cells
    # survived).
    label_vocab: dict[str, tuple[str, ...]] = {}
    res_tables: list[tuple[int, torch.Tensor, float]] = []
    for c in residual:
        full = tok.vocab.get(pos[c], ())
        toks = tok.missing_token.get(pos[c], ()) or ("nan",)
        surv = vocab_surv.get(c, ())
        vocab2 = sorted(set(surv) | (set(toks) if nan_surv.get(c) else set()))
        label_vocab[c] = tuple(vocab2)
        lookup = {v: i for i, v in enumerate(vocab2)}
        table = torch.tensor(
            [float(lookup.get(v, 0)) for v in full] or [0.0], dtype=torch.float32, device=dev
        )
        res_tables.append((numeric_names.index(c), table, float(lookup.get(toks[0], 0))))

    # One-hot recode tables: full-tokenize code -> surviving sorted code.
    cat_vocab: dict[str, tuple[str, ...]] = {}
    cat_tables: list[torch.Tensor] = []
    for c in cat_present:
        full = tok.vocab.get(pos[c], ())
        cats = vocab_surv.get(c, ())
        cat_vocab[c] = cats
        lookup = {v: i for i, v in enumerate(cats)}
        cat_tables.append(
            torch.tensor([float(lookup.get(v, -1)) for v in full] or [-1.0],
                         dtype=torch.float32, device=dev)
        )
    n_classes = [len(cat_vocab[c]) for c in cat_present]

    # Label map over the full tokenize vocabulary (unseen statuses -> NaN).
    lab_full = tok.vocab.get(label_pos, ()) if has_label else ()
    label_table = torch.tensor(
        [float(schema.LOAN_STATUS_MAP.get(v, np.nan)) for v in lab_full] or [np.nan],
        dtype=torch.float32, device=dev,
    )

    log_mask = torch.from_numpy(np.isin(np.asarray(numeric_names), np.asarray(schema.LOG_COLS)))
    with _dispatch(dev):
        Xn = _numeric_prep(X, sel(numeric_names), res_tables, log_mask)
    with _dispatch(dev):
        nan_any = torch.isnan(Xn).any(dim=0).cpu().numpy()
        medians = _nanmedians(Xn)
        medians_np = medians.cpu().numpy()

    dti_pos = numeric_names.index("dti") if "dti" in numeric_names else -1
    inc_pos = numeric_names.index("annual_inc") if "annual_inc" in numeric_names else -1
    need_ind = nan_any.copy()
    if dti_pos >= 0:
        need_ind[dti_pos] = False
    ind_idx = np.flatnonzero(need_ind)

    # Feature assembly: tree (numeric | one-hots), nn (imputed | indicators
    # | no_income | dti_NA | codes), label.
    with _dispatch(dev):
        new_codes = []
        for c, table in zip(cat_present, cat_tables):
            col = X[:, pos[c]]
            nan = torch.isnan(col)
            new_codes.append(torch.where(nan, -1.0, table[torch.where(nan, 0.0, col).long()]))
        tree_blocks = [Xn] + [
            one_hot_codes(code, k) for code, k in zip(new_codes, n_classes) if k > 1
        ]
        X_tree = torch.cat(tree_blocks, dim=1)
        filled, indicators = impute_with_indicators(Xn, medians, torch.from_numpy(need_ind).to(dev))
        nn_blocks = [filled]
        if ind_idx.size:
            nn_blocks.append(indicators[:, torch.from_numpy(ind_idx).to(dev)])
        if inc_pos >= 0:
            inc = Xn[:, inc_pos]
            nn_blocks.append((torch.isnan(inc) | (inc == 0)).to(torch.float32)[:, None])
        if dti_pos >= 0:
            nn_blocks.append(torch.isnan(Xn[:, dti_pos]).to(torch.float32)[:, None])
        for code, k in zip(new_codes, n_classes):
            nn_blocks.append(torch.where(code < 0, float(k), code)[:, None])
        X_nn = torch.cat(nn_blocks, dim=1)
        y = None
        if has_label:
            lcol = X[:, label_pos]
            nan = torch.isnan(lcol)
            y = torch.where(nan, float("nan"), label_table[torch.where(nan, 0.0, lcol).long()])
    del X, Xn, filled, indicators, tree_blocks, nn_blocks

    # The GBDT sketch: quantile edges and bins of the tree features.
    with _dispatch(dev):
        spec, bins = bin_edges_and_transform(X_tree, n_bins=n_bins)

    # Names and the replay plan.
    tree_names = list(numeric_names)
    for c in cat_present:
        cats = cat_vocab[c]
        if len(cats) > 1:
            tree_names.extend(f"{c}_{v}" for v in cats[1:])
    nn_names = list(numeric_names)
    nn_names.extend(f"{numeric_names[i]}_NA" for i in ind_idx)
    if inc_pos >= 0:
        nn_names.append("no_income")
    if dti_pos >= 0:
        nn_names.append("dti_NA")
    nn_names.extend(cat_present)

    plan = FeaturePlan(
        numeric_names=tuple(numeric_names),
        categorical_vocab=cat_vocab,
        label_vocab=label_vocab,
        medians={name: float(medians_np[i]) for i, name in enumerate(numeric_names)},
        log_cols=tuple(c for c in schema.LOG_COLS if c in set(numeric_names)),
        tree_feature_names=tuple(tree_names),
        nn_feature_names=tuple(nn_names),
        asof=tok.today.strftime("%Y-%m-%d"),
    )
    return DeviceIngestResult(
        tree=FeatureFrame(tuple(tree_names), X_tree, y),
        nn=FeatureFrame(tuple(nn_names), X_nn, y),
        plan=plan,
        bin_spec=spec,
        bins=bins,
        report=report,
        cleaned=cleaned,
    )


# --- Raw-row serving path ---------------------------------------------------------


def _scalar_missing(v: Any) -> bool:
    if v is None:
        return True
    if isinstance(v, float) and np.isnan(v):
        return True
    if isinstance(v, str) and not v.strip():
        return True
    return False


def _scalar_number(v: Any) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return float("nan")


def _tokenize_raw_value(name: str, v: Any, today: datetime) -> float:
    """One cell of the serving frontier: the batch frontier's parses, plus
    the clean stage's missing-means-zero fill."""
    if _scalar_missing(v):
        return 0.0 if name in schema.FILL_ZERO_COLS else float("nan")
    if name == "emp_length_num" and isinstance(v, str):
        return _emp_length_number(v)
    if name == "earliest_cr_line_days" and isinstance(v, str):
        return _date_age_days(v, today)
    if isinstance(v, str):
        s = v.strip()
        if name in schema.FRONTIER_TERM_COLS:
            return _scalar_number(s.replace("months", "").strip())
        if name in schema.FRONTIER_PERCENT_COLS or s.endswith("%"):
            return _scalar_number(s.replace("%", "")) / 100.0
        return _scalar_number(s)
    if name == "int_rate":
        return _scalar_number(v) / 100.0  # parse_percent's numeric branch
    return _scalar_number(v)


#: Raw payload keys accepted for the prepare stage's derived columns.
_RAW_ALIASES = {
    "emp_length_num": ("emp_length_num", "emp_length"),
    "earliest_cr_line_days": ("earliest_cr_line_days", "earliest_cr_line"),
}


def _raw_row_features(
    mat: torch.Tensor, log_mask: torch.Tensor, n_classes: Sequence[int], n_num: int
) -> torch.Tensor:
    """[numeric | category codes] -> tree-feature rows, through the same
    log1p and one-hot code as the batch assembly."""
    blocks = [log1p_masked(mat[:, :n_num], log_mask)]
    for i, k in enumerate(n_classes):
        col = mat[:, n_num + i]
        if k > 1:
            blocks.append(one_hot_codes(torch.where(torch.isnan(col), -1.0, col).long(), k))
    return torch.cat(blocks, dim=1)


def transform_raw_rows(
    plan: FeaturePlan,
    rows: Sequence[Mapping[str, Any]],
    *,
    today: datetime | None = None,
    device: torch.device | str = "cuda",
) -> torch.Tensor:
    """Raw payload dicts -> ``(n, len(plan.tree_feature_names))`` float32
    tree-feature rows on ``device``, through the batch assembly's log1p and
    one-hot code, so a raw row reproduces its batch row on the same device.

    Missing and unknown values follow the training-time semantics: NaN for
    the NaN-aware GBDT, all-zero one-hot blocks for unseen categories, the
    hardship fill and the missing-means-zero fills as in cleaning. Date ages
    are taken against the plan's ``asof`` date (the wall clock only for a
    plan that never recorded one), so a raw row scores the same whenever it
    is sent."""
    dev = resolve_device(device)
    if today is not None:
        now = today
    elif plan.asof:
        now = datetime.strptime(plan.asof, "%Y-%m-%d")
    else:
        now = datetime.today()
    numeric_names = tuple(plan.numeric_names)
    cat_names = tuple(plan.categorical_vocab)
    n_num = len(numeric_names)
    mat = np.full((len(rows), n_num + len(cat_names)), np.nan, np.float32)
    for r, payload in enumerate(rows):
        for j, name in enumerate(numeric_names):
            v = None
            for key in _RAW_ALIASES.get(name, (name,)):
                if key in payload:
                    v = payload[key]
                    break
            if name in plan.label_vocab:
                vocab2 = plan.label_vocab[name]
                tok = (
                    str(v) if not _scalar_missing(v)
                    else ("nan" if "nan" in vocab2 else "None")
                )
                mat[r, j] = vocab2.index(tok) if tok in vocab2 else np.nan
                continue
            mat[r, j] = _tokenize_raw_value(name, v, now)
        for i, name in enumerate(cat_names):
            v = payload.get(name)
            if name == "hardship_status" and _scalar_missing(v):
                v = schema.HARDSHIP_FILL
            cats = plan.categorical_vocab[name]
            if not _scalar_missing(v):
                s = str(v)
                mat[r, n_num + i] = cats.index(s) if s in cats else -1.0
    n_classes = [len(plan.categorical_vocab[c]) for c in cat_names]
    log_mask = torch.from_numpy(np.isin(np.asarray(numeric_names), np.asarray(plan.log_cols)))
    with _dispatch(dev):
        out = _raw_row_features(torch.from_numpy(mat).to(dev), log_mask, n_classes, n_num)
    if out.shape[1] != len(plan.tree_feature_names):
        raise ValueError(
            f"raw transform produced {out.shape[1]} features, plan expects "
            f"{len(plan.tree_feature_names)}"
        )
    return out
