"""Fused forest scoring: tree walk + margin + sigmoid + TreeSHAP in one call.

`fused_score` is the wrapper of the CUDA kernels in ``csrc/score_forest.cu``,
which replace the reference package's Pallas kernel
(``ops/score_pallas.py::_score_kernel``). On a CUDA tensor it launches them
(a walk over row tiles x tree groups, then a finalize that sums per row in
tree order) or raises; on a CPU tensor it runs `fused_score_reference`, the
plain PyTorch version of the same function. There is no fallback from one to
the other. `launch_plan` sizes the walk's grid on the host.

`pack_forest` builds the kernel's input bundle once per model, in one of
three precisions: the node tables of the forest with thresholds and leaf
values stored as f32, bf16 or int8 (affine tables per feature for the
thresholds and per tree for the leaves, as the reference quantizes them),
the row-independent per-leaf TreeSHAP tables (`explain.treeshap.leaf_tables`),
one record of all of them per tree (`tree_tables`, the layout the kernel
copies into shared memory), and the SHAP base value of the dequantized
leaves, a forest-only scalar computed here as a plain PyTorch reduction. The
kernel dequantizes inside each call; the pack also keeps the dequantized f32
thresholds and leaves (`dequantize`), which the plain version scores with.
A bf16 or int8 pack is gated at build time against `PRECISION_TOLERANCES`
(`quantization_report` on `probe_rows`), as the reference gates it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import math
import threading
import time
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from cobalt_smart_lender_ai_tpu_torch.explain.treeshap import (
    bilinear_kernel,
    expected_margin,
    leaf_tables,
    shap_phis,
)
from cobalt_smart_lender_ai_tpu_torch.models.gbdt import (
    Forest,
    landed_leaves,
    sum_trees_in_order,
)
from cobalt_smart_lender_ai_tpu_torch.ops import _build
from cobalt_smart_lender_ai_tpu_torch.telemetry.programs import launch_handle

__all__ = [
    "PRECISIONS",
    "PRECISION_TOLERANCES",
    "ForestPack",
    "LaunchPlan",
    "dequantize",
    "fused_score",
    "fused_score_reference",
    "fused_supported",
    "launch_plan",
    "pack_forest",
    "probe_rows",
    "quantization_report",
    "score_cost",
    "shap_fits",
    "shap_flops",
    "shap_smem_bytes",
    "shap_supported",
    "tree_table_layout",
    "tree_tables",
]

PRECISIONS = ("f32", "bf16", "int8")
#: Bytes of one stored threshold or leaf value at each precision.
_VALUE_BYTES = {"f32": 4, "bf16": 2, "int8": 1}

#: The reference's publish-time tolerance contract for the quantized packs,
#: measured against the f32 forest on `probe_rows`: mean and max |margin
#: delta| and mean |prob delta|. The max bound is a loose catastrophe
#: ceiling (rows sitting on a threshold may flip to a sibling leaf under any
#: quantization); the means carry the calibration contract. A pack beyond
#: its bound raises at `pack_forest(..., check=True)` and never serves.
PRECISION_TOLERANCES: dict[str, dict[str, float]] = {
    "f32": {
        "mean_abs_margin_delta": 0.0,
        "max_abs_margin_delta": 0.0,
        "mean_abs_prob_delta": 0.0,
    },
    "bf16": {
        "mean_abs_margin_delta": 0.25,
        "max_abs_margin_delta": 4.0,
        "mean_abs_prob_delta": 0.05,
    },
    "int8": {
        "mean_abs_margin_delta": 0.40,
        "max_abs_margin_delta": 4.0,
        "mean_abs_prob_delta": 0.08,
    },
}

#: Deepest tree the kernel takes (its SHAP path is instantiated per depth).
MAX_DEPTH = 10
#: Most rows one SHAP block owns.
MAX_ROWS_PER_BLOCK = 8
#: Most threads of one SHAP block (the kernel's launch bound).
MAX_SHAP_THREADS = 256
#: Rows of one margin-only block, one thread each.
WALK_ROWS = 128
#: Streaming multiprocessors of an H100.
SM_COUNT = 132
#: Blocks the walk's grid aims for, with and without SHAP: one wave of the
#: blocks an SM holds at once (four SHAP blocks of 256 threads at depth 7,
#: sixteen margin-only blocks of 128). Tree groups are split only as far as
#: the row tiles fall short of it.
SHAP_TARGET_BLOCKS = 4 * SM_COUNT
WALK_TARGET_BLOCKS = 16 * SM_COUNT
#: Shared memory one block may use on Hopper (227 KB).
SMEM_LIMIT = 232_448


@dataclasses.dataclass(frozen=True)
class ForestPack:
    """The kernel's input bundle. Node tables are (T, I); leaf tables are
    (T, L, d); ``base`` is the SHAP base value (a 0-d tensor). ``thr_q`` and
    ``leaf_q`` are stored at ``precision`` with the reference's affine
    tables beside them (identity tables at f32 and bf16); ``thr`` and
    ``leaf`` are their f32 dequantization (``thr`` is ``+inf`` where
    ``all_left``), which is ``thr_q`` and ``leaf_q`` themselves at f32."""

    feature: torch.Tensor  # (T, I) int32
    thr_q: torch.Tensor  # (T, I) float32 | bfloat16 | int8
    missing_left: torch.Tensor  # (T, I) bool
    all_left: torch.Tensor  # (T, I) bool: trivial splits (f32 threshold +inf)
    leaf_q: torch.Tensor  # (T, L) float32 | bfloat16 | int8
    thr_scale: torch.Tensor  # (1, F) float32, per feature
    thr_zero: torch.Tensor  # (1, F) float32
    leaf_scale: torch.Tensor  # (1, T) float32, per tree
    leaf_zero: torch.Tensor  # (1, T) float32
    thr: torch.Tensor  # (T, I) float32
    leaf: torch.Tensor  # (T, L) float32
    path_feature: torch.Tensor  # (T, L, d) int32
    slot: torch.Tensor  # (T, L, d) uint8
    r_play: torch.Tensor  # (T, L, d) float32
    base: torch.Tensor  # () float32
    tables: torch.Tensor  # (T, W) int32: one `tree_table_layout` record per tree
    thr_affine: torch.Tensor  # (2, F) float32: thr_scale over thr_zero, for the kernel
    depth: int
    n_features: int
    #: max |leaf| of the f32 leaves (NaN if one is NaN), read by `shap_fits`
    #: without a copy from the device.
    leaf_peak: float
    precision: str = "f32"
    #: md5 of the quantized tensors and tables, as the reference computes
    #: it; the string "f32" for an f32 pack.
    table_hash: str = "f32"

    @property
    def n_trees(self) -> int:
        return self.feature.shape[0]

    @property
    def device(self) -> torch.device:
        return self.feature.device


def _per_feature_thr_tables(
    feature: np.ndarray, thr: np.ndarray, n_features: int
) -> tuple[np.ndarray, np.ndarray]:
    """Per-feature affine tables over each feature's finite thresholds (the
    ranges in float64, the tables stored as float32)."""
    lo = np.full(n_features, np.inf, np.float64)
    hi = np.full(n_features, -np.inf, np.float64)
    finite = np.isfinite(thr)
    np.minimum.at(lo, feature[finite], thr[finite])
    np.maximum.at(hi, feature[finite], thr[finite])
    seen = np.isfinite(lo)
    lo = np.where(seen, lo, 0.0)
    hi = np.where(seen, hi, 0.0)
    span = hi - lo
    scale = np.where(span > 0, span / 254.0, 1.0)
    zero = (hi + lo) / 2.0
    return scale.astype(np.float32), zero.astype(np.float32)


def _quantize_affine(values: np.ndarray, scale: np.ndarray, zero: np.ndarray) -> np.ndarray:
    """``round((v - zero) / scale)`` in the inputs' float32, half to even,
    clipped to [-127, 127]."""
    q = np.round((values - zero) / scale)
    return np.clip(q, -127, 127).astype(np.int8)


def _table_hash(precision: str, *arrays: np.ndarray) -> str:
    h = hashlib.md5(precision.encode())
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _bits(t: torch.Tensor) -> np.ndarray:
    """A bf16 tensor's bytes as a numpy array (numpy has no bf16)."""
    return t.view(torch.int16).numpy()


def _quantize(
    precision: str, feature: np.ndarray, thr: np.ndarray, leaf: np.ndarray, n_features: int
) -> dict[str, Any]:
    """The stored thresholds and leaves, the four affine tables and the
    table hash of a pack, on the host, with the reference's dtype at every
    step. bf16 rounds to nearest even (``+inf`` stays ``+inf``); int8
    encodes each threshold through its feature's table (a trivial ``+inf``
    threshold encodes 0 and is routed by ``all_left``) and each leaf
    through its tree's."""
    T = thr.shape[0]
    thr_scale = np.ones((1, n_features), np.float32)
    thr_zero = np.zeros((1, n_features), np.float32)
    leaf_scale = np.ones((1, T), np.float32)
    leaf_zero = np.zeros((1, T), np.float32)
    if precision == "f32":
        thr_q, leaf_q = torch.from_numpy(thr), torch.from_numpy(leaf)
        table_hash = "f32"
    elif precision == "bf16":
        thr_q = torch.from_numpy(thr).to(torch.bfloat16)
        leaf_q = torch.from_numpy(leaf).to(torch.bfloat16)
        table_hash = _table_hash(precision, _bits(thr_q), _bits(leaf_q))
    else:  # int8
        scale_f, zero_f = _per_feature_thr_tables(feature, thr, n_features)
        thr_scale[0], thr_zero[0] = scale_f, zero_f
        node_scale = scale_f[feature]
        node_zero = zero_f[feature]
        thr_np = _quantize_affine(np.where(np.isposinf(thr), node_zero, thr), node_scale, node_zero)
        lo_t = leaf.min(axis=1)
        hi_t = leaf.max(axis=1)
        span_t = hi_t - lo_t
        leaf_scale[0] = np.where(span_t > 0, span_t / 254.0, 1.0)
        leaf_zero[0] = (hi_t + lo_t) / 2.0
        leaf_np = _quantize_affine(leaf, leaf_scale[0][:, None], leaf_zero[0][:, None])
        table_hash = _table_hash(
            precision, thr_np, leaf_np, thr_scale, thr_zero, leaf_scale, leaf_zero
        )
        thr_q, leaf_q = torch.from_numpy(thr_np), torch.from_numpy(leaf_np)
    return dict(
        thr_q=thr_q,
        leaf_q=leaf_q,
        thr_scale=torch.from_numpy(thr_scale),
        thr_zero=torch.from_numpy(thr_zero),
        leaf_scale=torch.from_numpy(leaf_scale),
        leaf_zero=torch.from_numpy(leaf_zero),
        table_hash=table_hash,
    )


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as ``__fmaf_rn`` and the
    reference's CPU FMA round it (two float32 roundings differ on about a
    tenth of an int8 pack's values). The product of two float32s is exact
    in float64; the float64 sum, rounded to odd (to the neighbour whose
    last bit is set when it is inexact, from TwoSum's exact error), then
    rounds to float32 as the exact sum would. A float64 sum rounded to
    nearest would round twice."""
    p = a.double() * b.double()
    c = c.double().expand_as(p)
    s = p + c
    sb = s - p
    err = (p - (s - sb)) + (c - sb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def dequantize(
    precision: str,
    feature: torch.Tensor,
    thr_q: torch.Tensor,
    leaf_q: torch.Tensor,
    all_left: torch.Tensor,
    thr_scale: torch.Tensor,
    thr_zero: torch.Tensor,
    leaf_scale: torch.Tensor,
    leaf_zero: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The f32 thresholds and leaves a pack scores with (the plain version
    of the kernel's staging step): bf16 widened; int8 as ``q * scale +
    zero`` rounded once (`_fma_f32`), thresholds through their feature's
    table and leaves through their tree's; ``+inf`` at ``all_left`` (for
    a non-NaN value the reference's ``(x <= thr) | all_left``)."""
    if precision == "f32":
        return thr_q, leaf_q
    thr, leaf = thr_q.float(), leaf_q.float()
    if precision == "int8":
        f = feature.long()
        thr = _fma_f32(thr, thr_scale[0][f], thr_zero[0][f])
        leaf = _fma_f32(leaf, leaf_scale[0][:, None], leaf_zero[0][:, None])
    return torch.where(all_left, math.inf, thr), leaf


def pack_forest(
    forest: Forest, n_features: int, precision: str = "f32", *, check: bool = True
) -> ForestPack:
    """Build the kernel's input bundle on the forest's device.

    The stored tables are built on the host in numpy, as the reference
    builds them, then uploaded. ``check`` gates a bf16 or int8 pack against
    `PRECISION_TOLERANCES` (`quantization_report`) and raises
    ``ValueError`` when it is outside, so it never serves."""
    if precision not in PRECISIONS:
        raise ValueError(f"forest_precision must be one of {PRECISIONS}, got {precision!r}")
    device = forest.feature.device
    feature = forest.feature.to(torch.int32).contiguous()
    if feature.numel() and (
        int(feature.min()) < 0 or int(feature.max()) >= n_features
    ):
        raise ValueError(f"forest tests a feature outside [0, {n_features})")
    feature_h = feature.cpu()
    thr32 = forest.thr_float.to(torch.float32).cpu().contiguous()
    q = _quantize(
        precision,
        feature_h.numpy(),
        thr32.numpy(),
        forest.leaf_value.to(torch.float32).cpu().contiguous().numpy(),
        n_features,
    )
    table_hash = q.pop("table_hash")
    q["all_left"] = torch.isposinf(thr32)
    # Dequantized on the host too, so a pack scores alike on every device.
    thr, leaf = dequantize(precision, feature_h, **q)
    leaf_peak = float(leaf.abs().max()) if leaf.numel() else 0.0
    thr, leaf = thr.to(device), leaf.to(device)
    stored = {k: v.to(device) for k, v in q.items()}
    pf, slot, r_play, ratio = leaf_tables(feature, forest.cover, forest.depth)
    parts = dict(
        feature=feature,
        missing_left=forest.missing_left.to(torch.bool).contiguous(),
        path_feature=pf.to(torch.int32).contiguous(),
        slot=slot.contiguous(),
        r_play=r_play.contiguous(),
        **stored,
    )
    pack = ForestPack(
        **parts,
        thr=thr.contiguous(),
        leaf=leaf.contiguous(),
        base=expected_margin(leaf, ratio),
        tables=tree_tables(int(forest.depth), precision, **parts),
        thr_affine=torch.cat([stored["thr_scale"], stored["thr_zero"]]).contiguous(),
        depth=int(forest.depth),
        n_features=int(n_features),
        leaf_peak=leaf_peak,
        precision=precision,
        table_hash=table_hash,
    )
    if check and precision != "f32":
        report = quantization_report(forest, pack, n_features)
        if not report["within_tolerance"]:
            raise ValueError(
                f"{precision} quantization exceeds the committed tolerance "
                f"contract: {report}"
            )
    return pack


def probe_rows(forest: Forest, n_features: int, rows: int = 64) -> np.ndarray:
    """The publish gate's deterministic probe matrix: rows straddling the
    forest's own finite thresholds at ±1% and ±3% offsets, then an all-NaN
    row and an all-zeros row. No random numbers: the gate gives the same
    verdict on every host."""
    thr = forest.thr_float.to(torch.float32).cpu().numpy()
    feature = forest.feature.to(torch.int32).cpu().numpy()
    per_feature: list[np.ndarray] = []
    for f in range(n_features):
        vals = np.unique(thr[(feature == f) & np.isfinite(thr)])
        per_feature.append(vals if vals.size else np.zeros(1, np.float32))
    n_body = max(rows - 2, 1)
    X = np.zeros((n_body + 2, n_features), np.float32)
    offsets = np.array([-0.01, 0.01, -0.03, 0.03], np.float32)
    for f, vals in enumerate(per_feature):
        idx = np.arange(n_body) % vals.size
        off = offsets[np.arange(n_body) % offsets.size]
        X[:n_body, f] = vals[idx] * (1.0 + off) + off
    X[n_body] = np.nan
    X[n_body + 1] = 0.0
    return X


def quantization_report(forest: Forest, pack: ForestPack, n_features: int) -> dict[str, Any]:
    """The publish gate: ``pack`` against an f32 pack of the same forest on
    `probe_rows`, both scored by `fused_score` on the pack's device (the
    kernel on the card, the plain version on the CPU; f32 margins equal the
    reference's ``predict_margin`` bit for bit): mean and max |margin
    delta|, mean |prob delta| against the f32 margins' sigmoid, and whether
    each is within `PRECISION_TOLERANCES[pack.precision]`."""
    X = torch.from_numpy(probe_rows(forest, n_features)).to(pack.device)
    ref = pack if pack.precision == "f32" else pack_forest(forest, n_features, "f32")
    ref_margin = fused_score(ref, X, n_features=n_features, with_shap=False)[0].cpu().numpy()
    margin, prob = fused_score(pack, X, n_features=n_features, with_shap=False)
    dm = np.abs(margin.cpu().numpy() - ref_margin)
    with np.errstate(over="ignore"):
        ref_prob = 1.0 / (1.0 + np.exp(-ref_margin))
    dp = np.abs(prob.cpu().numpy() - ref_prob)
    tol = PRECISION_TOLERANCES[pack.precision]
    report = {
        "precision": pack.precision,
        "probe_rows": int(X.shape[0]),
        "mean_abs_margin_delta": float(dm.mean()),
        "max_abs_margin_delta": float(dm.max()),
        "mean_abs_prob_delta": float(dp.mean()),
        "tolerance": dict(tol),
    }
    report["within_tolerance"] = all(report[k] <= tol[k] for k in tol)
    return report


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(n: int, multiple: int) -> int:
    return _ceil_div(n, multiple) * multiple


def tree_table_layout(
    depth: int, precision: str = "f32"
) -> tuple[dict[str, tuple[int, int]], int]:
    """One tree's record as ``score_forest.cu`` (``tree_layout``) reads it:
    ``{section: (word offset, words)}`` and the record's words. Every section
    starts on a 16-byte boundary, so the kernel copies a record 16 bytes at a
    time; 1- and 2-byte tables are packed four or two to a word. ``thr_q``
    and ``leaf_q`` are stored at ``precision``; a bf16 or int8 record adds
    the ``all_left`` bytes and the tree's leaf scale and zero
    (``leaf_affine``), after the sections an f32 record has."""
    L = 2**depth
    I, LD = L - 1, L * depth
    b = _VALUE_BYTES[precision]
    sections = [
        ("thr_q", _ceil_div(I * b, 4)),
        ("feature", I),
        ("leaf_q", _ceil_div(L * b, 4)),
        ("r_play", LD),
        ("path_feature", LD),
        ("missing_left", _ceil_div(I, 4)),
        ("slot", _ceil_div(LD, 4)),
    ]
    if precision != "f32":
        sections += [("all_left", _ceil_div(I, 4)), ("leaf_affine", 2)]
    layout, offset = {}, 0
    for name, words in sections:
        layout[name] = (offset, words)
        offset += _round_up(words, 4)
    return layout, offset


def _as_words(t: torch.Tensor) -> torch.Tensor:
    """(T, ...) tensor -> (T, words) int32 of its bytes, zero-padded to
    whole words."""
    b = t.reshape(t.shape[0], -1).contiguous().view(torch.uint8)
    return F.pad(b, (0, (-b.shape[1]) % 4)).view(torch.int32)


def tree_tables(depth: int, precision: str = "f32", **parts: torch.Tensor) -> torch.Tensor:
    """The (T, W) int32 records of `tree_table_layout`, one per tree, from
    the pack's tables (one keyword per section; ``leaf_affine`` is made
    from ``leaf_scale`` and ``leaf_zero``)."""
    layout, words = tree_table_layout(depth, precision)
    feature = parts["feature"]
    if "leaf_affine" in layout:
        parts = dict(
            parts, leaf_affine=torch.stack([parts["leaf_scale"][0], parts["leaf_zero"][0]], 1)
        )
    tables = torch.zeros((feature.shape[0], words), dtype=torch.int32, device=feature.device)
    for name, (offset, n) in layout.items():
        tables[:, offset : offset + n] = _as_words(parts[name])
    return tables


def shap_smem_bytes(depth: int, n_features: int, rows: int, precision: str = "f32") -> int:
    """Dynamic shared memory of one SHAP block (``score_forest.cu`` computes
    the same sum for its launch): two trees (double-buffered), each an image
    of its f32 record and, for a bf16 or int8 pack, its stored thresholds,
    leaves, ``all_left`` bytes and leaf affine beside it; the (rows, F)
    int64 fixed-point totals of the block's tree group, the row tile, and
    the tile's node decisions."""
    raw = 0
    if precision != "f32":
        q = tree_table_layout(depth, precision)[0]
        raw = sum(_round_up(q[k][1], 4) for k in ("thr_q", "leaf_q", "all_left", "leaf_affine"))
    image = tree_table_layout(depth)[1]
    return 8 * (image + raw) + 12 * rows * n_features + rows * (2**depth - 1)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """The walk kernel's grid: ``row_tiles`` x ``groups`` blocks of
    ``threads``. Block (i, g) takes rows ``[i R, (i+1) R)`` and trees
    ``[g G, (g+1) G)`` (R = ``rows_per_block``, G = ``trees_per_group``,
    both cut at the ends)."""

    n_rows: int
    n_trees: int
    with_shap: bool
    rows_per_block: int
    trees_per_group: int
    row_tiles: int
    groups: int
    threads: int

    @property
    def blocks(self) -> int:
        return self.row_tiles * self.groups

    def scratch_shapes(self, n_features: int) -> dict[str, tuple[int, ...]]:
        """``leaf_val`` (T, N) f32: each (tree, row)'s landed leaf value;
        with SHAP ``phi_part`` (groups, N, F) f64: each group's totals."""
        shapes = {"leaf_val": (self.n_trees, self.n_rows)}
        if self.with_shap:
            shapes["phi_part"] = (self.groups, self.n_rows, n_features)
        return shapes

    def scratch_bytes(self, n_features: int) -> tuple[int, int]:
        """(bytes, offset of ``phi_part``) of one buffer holding both
        scratches, ``phi_part`` 8-byte aligned after ``leaf_val``."""
        shapes = self.scratch_shapes(n_features)
        offset = _round_up(4 * math.prod(shapes["leaf_val"]), 8)
        return offset + 8 * math.prod(shapes.get("phi_part", (0,))), offset


@functools.lru_cache(maxsize=256)
def launch_plan(n_rows: int, n_trees: int, depth: int, with_shap: bool) -> LaunchPlan:
    """Tile and group sizes for one call.

    With SHAP a block owns up to `MAX_ROWS_PER_BLOCK` rows, one thread per
    (row, leaf) up to `MAX_SHAP_THREADS`; without, `WALK_ROWS` rows, one
    thread each. The trees are then cut into as many groups of consecutive
    trees as it takes for the grid to reach `SHAP_TARGET_BLOCKS` or
    `WALK_TARGET_BLOCKS` (one tree a group at most), so at 1 row each tree
    gets its own block, and at large row counts one group holds every tree."""
    if n_rows < 1 or n_trees < 0 or not fused_supported(depth):
        raise ValueError(f"no launch plan for {n_rows} rows, {n_trees} trees, depth {depth}")
    if with_shap:
        rows = min(MAX_ROWS_PER_BLOCK, n_rows)
        threads = min(MAX_SHAP_THREADS, _round_up(rows << depth, 32))
        target = SHAP_TARGET_BLOCKS
    else:
        rows = threads = WALK_ROWS
        target = WALK_TARGET_BLOCKS
    tiles = _ceil_div(n_rows, rows)
    per_group = max(1, _ceil_div(n_trees, _ceil_div(target, tiles)))
    return LaunchPlan(
        n_rows=n_rows,
        n_trees=n_trees,
        with_shap=with_shap,
        rows_per_block=rows,
        trees_per_group=per_group,
        row_tiles=tiles,
        groups=_ceil_div(n_trees, per_group),
        threads=threads,
    )


def fused_supported(depth: int) -> bool:
    """Shape guard of the margin-only kernel."""
    return 1 <= depth <= MAX_DEPTH


def shap_supported(depth: int, n_features: int, precision: str = "f32") -> bool:
    """Shape guard of the SHAP kernel: the depth it is instantiated for, and
    its shared memory (`shap_smem_bytes`) at the largest tile."""
    return fused_supported(depth) and (
        shap_smem_bytes(depth, n_features, MAX_ROWS_PER_BLOCK, precision) <= SMEM_LIMIT
    )


#: The SHAP kernel's totals are int64 in units of 2^-40, so they hold
#: magnitudes under 2^23; `shap_fits` keeps a forest's phis under half that.
SHAP_FIXED_LIMIT = 2.0**22


def shap_fits(pack: ForestPack) -> bool:
    """Whether the SHAP kernel's fixed-point totals hold this forest's phis.

    One tree's phi for a feature, and every partial sum of its addends, is
    at most 2 max|leaf| in magnitude (the Shapley weights sum to 1, and the
    leaf probabilities of two coalitions differ by at most 2 in total), so a
    block's totals stay under 2 max|leaf| T. A forest whose bound reaches
    `SHAP_FIXED_LIMIT`, or with a non-finite leaf, would wrap or saturate
    them into finite garbage; it is refused."""
    return 2.0 * pack.leaf_peak * pack.n_trees < SHAP_FIXED_LIMIT  # False at NaN


def fused_score_reference(
    pack: ForestPack, X: torch.Tensor, *, n_features: int, with_shap: bool = True
):
    """The plain PyTorch version of `fused_score`: same returns, same f32
    margins bit for bit, probabilities and phis to float tolerance. It
    scores with the pack's dequantized thresholds and leaves (`dequantize`)."""
    leaves = landed_leaves(pack.feature, pack.thr, pack.missing_left, pack.depth, X)
    trees = torch.arange(pack.n_trees, device=X.device)
    margin = sum_trees_in_order(pack.leaf[trees, leaves])
    prob = torch.sigmoid(margin)
    if not with_shap:
        return margin, prob
    phis = shap_phis(
        X,
        pack.thr,
        pack.missing_left,
        pack.leaf,
        pack.path_feature,
        pack.slot,
        pack.r_play,
        pack.depth,
        n_features,
    )
    return margin, prob, phis, pack.base


def shap_flops(depth: int) -> int:
    """FLOP the SHAP kernel does per (row, tree, leaf), counted from
    ``score_forest.cu``: player indicators, suffix and prefix polynomials,
    the bilinear contraction and the contribution."""
    d = depth
    return d + 2 * (d - 1) * (3 * d + 1) + d * (d * (d + 1) + 2 * d) + 3 * d


@functools.lru_cache(maxsize=1024)
def score_cost(
    n_rows: int, n_trees: int, depth: int, n_features: int, precision: str, with_shap: bool
) -> tuple[int, int]:
    """(FLOPs, bytes) of one `fused_score` call, from shapes only.

    Bytes: each input read once and each output written once — the node
    tables (feature int32, the stored threshold, ``missing_left``), the
    stored leaves, at bf16 and int8 the ``all_left`` bytes, at int8 the
    four affine tables, with SHAP the per-leaf tables (path feature int32,
    slot u8, r_play f32); the rows in, margin and prob out, with SHAP the
    phis out. Operations: ``depth`` compares and one add per (row, tree)
    and the sigmoid, plus `shap_flops` per (row, tree, leaf) with SHAP."""
    T, d, F = n_trees, depth, n_features
    n_nodes, n_leaves = 2**d - 1, 2**d
    v = _VALUE_BYTES[precision]
    nbytes = T * n_nodes * (4 + v + 1) + T * n_leaves * v
    if precision != "f32":
        nbytes += T * n_nodes
    if precision == "int8":
        nbytes += 4 * (2 * F + 2 * T)
    if with_shap:
        nbytes += T * n_leaves * d * (4 + 1 + 4)
    nbytes += n_rows * F * 4 + 2 * n_rows * 4 + (n_rows * F * 4 if with_shap else 0)
    flops = n_rows * T * (d + 1) + 3 * n_rows
    if with_shap:
        flops += n_rows * T * n_leaves * shap_flops(d)
    return flops, nbytes


def _program(
    pack: "ForestPack", n_rows: int, with_shap: bool, device: torch.device, shards: int = 1
):
    """The program handle of one call: the entry at its precision, its row
    bucket (the power of two the service pads to) and SHAP or margin; a
    shard's launch of a mesh dispatch (`parallel.partitioner`) adds
    ``/shards=<n>``, and its row carries ``shards``."""
    bucket = 1 << max(0, n_rows - 1).bit_length()
    key = f"{pack.precision}/{bucket}/{'shap' if with_shap else 'margin'}"
    meta = {}
    if shards > 1:
        key += f"/shards={shards}"
        meta["shards"] = shards
    return launch_handle(
        "score_forest", key, device, lambda: _build.take_build_seconds("score_forest"), **meta
    )


# -- the CUDA kernel ------------------------------------------------------------

_LIB_LOCK = threading.Lock()
_WT_DEVICES: set[int] = set()


def wt_table() -> np.ndarray:
    """The kernel's constant-memory Shapley table: (MAX_DEPTH+1)^3 float32,
    ``[d, a, b] = bilinear_kernel(d)[a, b]`` and zero outside ``a, b <= d``."""
    n = MAX_DEPTH + 1
    wt = np.zeros((n, n, n), np.float32)
    for d in range(1, n):
        wt[d, : d + 1, : d + 1] = bilinear_kernel(d)
    return wt


def _library(device_index: int) -> ctypes.CDLL:
    """The built kernel library, with Wt uploaded to ``device_index``."""
    lib = _build.load("score_forest")
    with _LIB_LOCK:
        if device_index not in _WT_DEVICES:
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.score_forest.argtypes = [i, p, i, p, p] + [i] * 8 + [p] * 6
            lib.score_forest.restype = i
            lib.score_forest_table_words.argtypes = [i, i]
            lib.score_forest_table_words.restype = i
            for code, precision in enumerate(PRECISIONS):
                for depth in range(1, MAX_DEPTH + 1):
                    words = tree_table_layout(depth, precision)[1]
                    if lib.score_forest_table_words(depth, code) != words:
                        raise RuntimeError(
                            "score_forest.cu and tree_table_layout disagree at "
                            f"depth {depth}, precision {precision}"
                        )
            lib.score_forest_set_wt.argtypes = [i, p]
            lib.score_forest_set_wt.restype = i
            lib.score_forest_prepare.argtypes = [i]
            lib.score_forest_prepare.restype = i
            lib.score_forest_error_string.argtypes = [i]
            lib.score_forest_error_string.restype = ctypes.c_char_p
            wt = wt_table()
            err = lib.score_forest_set_wt(device_index, wt.ctypes.data)
            _check(lib, err, "uploading the Shapley table")
            _check(lib, lib.score_forest_prepare(device_index), "loading the kernels")
            _WT_DEVICES.add(device_index)
    return lib


def prepare_kernel(device: torch.device) -> None:
    """Build (at first use) and load the kernel library for a CUDA
    ``device``, load its kernels and upload its Shapley table, so that no
    launch of a caller holds the build or a load; a no-op on the CPU."""
    if device.type == "cuda":
        _library(device.index if device.index is not None else torch.cuda.current_device())


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.score_forest_error_string(err).decode()
        raise RuntimeError(f"score_forest: CUDA error {err} ({msg}) {what}")


_COUNT_LOCK = threading.Lock()


def fused_score(
    pack: ForestPack, X: torch.Tensor, *, n_features: int, with_shap: bool = True, shards: int = 1
):
    """One fused scoring pass over the forest.

    Returns ``(margin, prob)`` with ``with_shap=False`` and
    ``(margin, prob, phis, base)`` with it — shapes ``(N,)``, ``(N,)``,
    ``(N, F)`` and a 0-d tensor. A CPU ``X`` runs `fused_score_reference`; a
    CUDA ``X`` launches the walk and finalize kernels once each on the
    current stream (one call, counted in ``fused_score.launches``) or
    raises; the walk dequantizes a bf16 or int8 pack inside the call.
    Each call is recorded on its program handle (`telemetry.programs`,
    ``score_forest/<precision>/<row bucket>/<shap|margin>``): CUDA events
    around the launch on the card, wall seconds of the plain version on
    the CPU, and `score_cost`'s FLOPs and bytes. ``shards`` > 1 marks the
    call as one shard's launch of a mesh dispatch of that many shards
    (`parallel.partitioner.MeshPartitioner`): its program row is the
    mesh's, ``.../shards=<n>``."""
    if X.device.type == "cpu":
        t0 = time.perf_counter()
        out = fused_score_reference(pack, X, n_features=n_features, with_shap=with_shap)
        N = X.shape[0]
        if N > 0:
            flops, nbytes = score_cost(
                N, pack.n_trees, pack.depth, n_features, pack.precision, with_shap
            )
            _program(pack, N, with_shap, X.device, shards).record_dispatch(
                time.perf_counter() - t0, rows=N, flops=flops, nbytes=nbytes
            )
        return out
    if X.device.type != "cuda":
        raise ValueError(f"fused_score runs on cpu or cuda tensors, got {X.device}")
    if X.dtype != torch.float32 or X.dim() != 2 or not X.is_contiguous():
        raise ValueError("X must be a contiguous 2-D float32 tensor")
    if X.shape[1] != n_features or pack.n_features != n_features:
        raise ValueError(
            f"X has {X.shape[1]} features, the pack {pack.n_features}, "
            f"n_features={n_features}"
        )
    if pack.device != X.device:
        raise ValueError(f"pack is on {pack.device}, X on {X.device}")
    if not fused_supported(pack.depth):
        raise ValueError(f"score_forest takes depth 1..{MAX_DEPTH}, got {pack.depth}")
    N = X.shape[0]
    if with_shap and not shap_supported(pack.depth, n_features, pack.precision):
        raise ValueError(
            f"score_forest's SHAP path does not take depth {pack.depth} with "
            f"{n_features} features: its shared memory would not fit"
        )
    if with_shap and not shap_fits(pack):
        raise ValueError(
            "score_forest's SHAP path does not take this forest: a non-finite "
            f"leaf, or 2 max|leaf| x {pack.n_trees} trees reaches "
            f"{SHAP_FIXED_LIMIT:g}, the range of its fixed-point totals"
        )
    # The outputs are views of one allocation, and so are the two scratches.
    out = torch.empty(N * (2 + (n_features if with_shap else 0)), dtype=torch.float32, device=X.device)
    margin, prob = out[:N], out[N : 2 * N]
    phis = out[2 * N :].view(N, n_features) if with_shap else None
    if N > 0:
        plan = launch_plan(N, pack.n_trees, pack.depth, with_shap)
        nbytes, phi_offset = plan.scratch_bytes(n_features)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=X.device)
        dev = X.device.index if X.device.index is not None else torch.cuda.current_device()
        lib = _library(dev)
        prog = _program(pack, N, with_shap, X.device, shards)
        stream = torch.cuda.current_stream(X.device)
        pair = prog.start(stream)
        err = lib.score_forest(
            dev,
            pack.tables.data_ptr(),
            PRECISIONS.index(pack.precision),
            pack.thr_affine.data_ptr(),
            X.data_ptr(),
            N,
            n_features,
            pack.n_trees,
            pack.depth,
            plan.rows_per_block,
            plan.trees_per_group,
            plan.groups,
            plan.threads,
            scratch.data_ptr(),
            scratch.data_ptr() + phi_offset if with_shap else None,
            margin.data_ptr(),
            prob.data_ptr(),
            None if phis is None else phis.data_ptr(),
            stream.cuda_stream,
        )
        _check(lib, err, "launching the kernels")
        flops, nbytes = score_cost(
            N, pack.n_trees, pack.depth, n_features, pack.precision, with_shap
        )
        prog.stop(pair, stream, rows=N, flops=flops, nbytes=nbytes)
        with _COUNT_LOCK:
            fused_score.launches += 1
    if not with_shap:
        return margin, prob
    return margin, prob, phis, pack.base


fused_score.launches = 0
