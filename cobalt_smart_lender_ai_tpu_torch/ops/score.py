"""Fused forest scoring: tree walk + margin + sigmoid + TreeSHAP in one call.

`fused_score` is the wrapper of the CUDA kernels in ``csrc/score_forest.cu``,
which replace the reference package's Pallas kernel
(``ops/score_pallas.py::_score_kernel``). On a CUDA tensor it launches them
(a walk over row tiles x tree groups, then a finalize that sums per row in
tree order) or raises; on a CPU tensor it runs `fused_score_reference`, the
plain PyTorch version of the same function. There is no fallback from one to
the other. `launch_plan` sizes the walk's grid on the host.

`pack_forest` builds the kernel's input bundle once per model: the node
tables of the forest plus the row-independent per-leaf TreeSHAP tables
(`explain.treeshap.leaf_tables`), one record of all of them per tree
(`tree_tables`, the layout the kernel copies into shared memory), and the
SHAP base value, a forest-only scalar computed here, outside the kernel, as
a plain PyTorch reduction. Only the f32 pack is ported; bf16 and int8 packs
raise ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import threading

import numpy as np
import torch

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

__all__ = [
    "PRECISIONS",
    "ForestPack",
    "LaunchPlan",
    "fused_score",
    "fused_score_reference",
    "fused_supported",
    "launch_plan",
    "pack_forest",
    "shap_smem_bytes",
    "shap_supported",
    "tree_table_layout",
    "tree_tables",
]

PRECISIONS = ("f32", "bf16", "int8")

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
    (T, L, d); ``base`` is the SHAP base value (a 0-d tensor)."""

    feature: torch.Tensor  # (T, I) int32
    thr: torch.Tensor  # (T, I) float32
    missing_left: torch.Tensor  # (T, I) bool
    leaf: torch.Tensor  # (T, L) float32
    path_feature: torch.Tensor  # (T, L, d) int32
    slot: torch.Tensor  # (T, L, d) uint8
    r_play: torch.Tensor  # (T, L, d) float32
    base: torch.Tensor  # () float32
    tables: torch.Tensor  # (T, W) int32: one `tree_table_layout` record per tree
    depth: int
    n_features: int
    precision: str = "f32"

    @property
    def n_trees(self) -> int:
        return self.feature.shape[0]

    @property
    def device(self) -> torch.device:
        return self.feature.device


def pack_forest(forest: Forest, n_features: int, precision: str = "f32") -> ForestPack:
    """Build the kernel's input bundle on the forest's device."""
    if precision not in PRECISIONS:
        raise ValueError(f"forest_precision must be one of {PRECISIONS}, got {precision!r}")
    if precision != "f32":
        raise NotImplementedError(
            f"forest_precision={precision!r} is not ported to the CUDA scoring "
            "kernel yet; only 'f32' packs are supported"
        )
    feature = forest.feature.to(torch.int32).contiguous()
    if feature.numel() and (
        int(feature.min()) < 0 or int(feature.max()) >= n_features
    ):
        raise ValueError(f"forest tests a feature outside [0, {n_features})")
    pf, slot, r_play, ratio = leaf_tables(feature, forest.cover, forest.depth)
    parts = dict(
        feature=feature,
        thr=forest.thr_float.to(torch.float32).contiguous(),
        missing_left=forest.missing_left.to(torch.bool).contiguous(),
        leaf=forest.leaf_value.to(torch.float32).contiguous(),
        path_feature=pf.to(torch.int32).contiguous(),
        slot=slot.contiguous(),
        r_play=r_play.contiguous(),
    )
    return ForestPack(
        **parts,
        base=expected_margin(forest.leaf_value, ratio),
        tables=tree_tables(int(forest.depth), **parts),
        depth=int(forest.depth),
        n_features=int(n_features),
        precision=precision,
    )


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(n: int, multiple: int) -> int:
    return _ceil_div(n, multiple) * multiple


def tree_table_layout(depth: int) -> tuple[dict[str, tuple[int, int]], int]:
    """One tree's record as ``score_forest.cu`` (``tree_layout``) reads it:
    ``{section: (word offset, words)}`` and the record's words. Every section
    starts on a 16-byte boundary, so the kernel copies a record 16 bytes at a
    time; the byte tables are packed four to a word."""
    L = 2**depth
    I, LD = L - 1, L * depth
    sections = (
        ("thr", I),
        ("feature", I),
        ("leaf", L),
        ("r_play", LD),
        ("path_feature", LD),
        ("missing_left", _ceil_div(I, 4)),
        ("slot", _ceil_div(LD, 4)),
    )
    layout, offset = {}, 0
    for name, words in sections:
        layout[name] = (offset, words)
        offset += _round_up(words, 4)
    return layout, offset


def _as_words(t: torch.Tensor) -> torch.Tensor:
    """(T, ...) tensor of 1- or 4-byte elements -> (T, words) int32, the
    bytes zero-padded to whole words."""
    t = t.reshape(t.shape[0], math.prod(t.shape[1:]))
    if t.element_size() == 4:
        return t.view(torch.int32)
    b = t.to(torch.uint8)
    padded = torch.zeros((b.shape[0], _round_up(b.shape[1], 4)), dtype=torch.uint8, device=b.device)
    padded[:, : b.shape[1]] = b
    return padded.view(torch.int32)


def tree_tables(depth: int, **parts: torch.Tensor) -> torch.Tensor:
    """The (T, W) int32 records of `tree_table_layout`, one per tree, from
    the pack's tables (one keyword per section)."""
    layout, words = tree_table_layout(depth)
    feature = parts["feature"]
    tables = torch.zeros((feature.shape[0], words), dtype=torch.int32, device=feature.device)
    for name, (offset, n) in layout.items():
        tables[:, offset : offset + n] = _as_words(parts[name].contiguous())
    return tables


def shap_smem_bytes(depth: int, n_features: int, rows: int) -> int:
    """Dynamic shared memory of one SHAP block (``score_forest.cu`` computes
    the same sum for its launch): two tree records (double-buffered), the
    (rows, F) f64 totals of the block's tree group, the row tile, this
    tree's (rows, F) f32 sums, and the tile's node decisions."""
    RF = rows * n_features
    return 8 * tree_table_layout(depth)[1] + 16 * RF + rows * (2**depth - 1)


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


def shap_supported(depth: int, n_features: int) -> bool:
    """Shape guard of the SHAP kernel: the depth it is instantiated for, and
    two tree records plus the (rows, F) accumulators in shared memory at the
    largest tile."""
    return fused_supported(depth) and (
        shap_smem_bytes(depth, n_features, MAX_ROWS_PER_BLOCK) <= SMEM_LIMIT
    )


def fused_score_reference(
    pack: ForestPack, X: torch.Tensor, *, n_features: int, with_shap: bool = True
):
    """The plain PyTorch version of `fused_score`: same returns, same f32
    margins bit for bit, probabilities and phis to float tolerance."""
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
            lib.score_forest.argtypes = [i, p, p] + [i] * 8 + [p] * 6
            lib.score_forest.restype = i
            lib.score_forest_table_words.argtypes = [i]
            lib.score_forest_table_words.restype = i
            for depth in range(1, MAX_DEPTH + 1):
                if lib.score_forest_table_words(depth) != tree_table_layout(depth)[1]:
                    raise RuntimeError(
                        f"score_forest.cu and tree_table_layout disagree at depth {depth}"
                    )
            lib.score_forest_set_wt.argtypes = [i, p]
            lib.score_forest_set_wt.restype = i
            lib.score_forest_error_string.argtypes = [i]
            lib.score_forest_error_string.restype = ctypes.c_char_p
            wt = wt_table()
            err = lib.score_forest_set_wt(device_index, wt.ctypes.data)
            _check(lib, err, "uploading the Shapley table")
            _WT_DEVICES.add(device_index)
    return lib


def _check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.score_forest_error_string(err).decode()
        raise RuntimeError(f"score_forest: CUDA error {err} ({msg}) {what}")


_COUNT_LOCK = threading.Lock()


def fused_score(
    pack: ForestPack, X: torch.Tensor, *, n_features: int, with_shap: bool = True
):
    """One fused scoring pass over the forest.

    Returns ``(margin, prob)`` with ``with_shap=False`` and
    ``(margin, prob, phis, base)`` with it — shapes ``(N,)``, ``(N,)``,
    ``(N, F)`` and a 0-d tensor. A CPU ``X`` runs `fused_score_reference`; a
    CUDA ``X`` launches the walk and finalize kernels once each on the
    current stream (one call, counted in ``fused_score.launches``) or
    raises."""
    if X.device.type == "cpu":
        return fused_score_reference(pack, X, n_features=n_features, with_shap=with_shap)
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
    if with_shap and not shap_supported(pack.depth, n_features):
        raise ValueError(
            f"score_forest's SHAP path does not take depth {pack.depth} with "
            f"{n_features} features: its shared memory would not fit"
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
        err = lib.score_forest(
            dev,
            pack.tables.data_ptr(),
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
            torch.cuda.current_stream(X.device).cuda_stream,
        )
        _check(lib, err, "launching the kernels")
        with _COUNT_LOCK:
            fused_score.launches += 1
    if not with_shap:
        return margin, prob
    return margin, prob, phis, pack.base


fused_score.launches = 0
