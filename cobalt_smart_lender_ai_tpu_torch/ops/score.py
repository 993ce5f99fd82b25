"""Fused forest scoring: tree walk + margin + sigmoid + TreeSHAP in one launch.

`fused_score` is the wrapper of the CUDA kernel ``csrc/score_forest.cu``,
which replaces the reference package's Pallas kernel
(``ops/score_pallas.py::_score_kernel``). On a CUDA tensor it launches the
kernel or raises; on a CPU tensor it runs `fused_score_reference`, the plain
PyTorch version of the same function. There is no fallback from one to the
other.

`pack_forest` builds the kernel's input bundle once per model: the node
tables of the forest plus the row-independent per-leaf TreeSHAP tables
(`explain.treeshap.leaf_tables`) and the SHAP base value, a forest-only
scalar computed here, outside the kernel, as a plain PyTorch reduction.
Only the f32 pack is ported; bf16 and int8 packs raise ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
import dataclasses
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
    "fused_score",
    "fused_score_reference",
    "fused_supported",
    "pack_forest",
    "rows_per_block",
    "shap_smem_bytes",
    "shap_supported",
]

PRECISIONS = ("f32", "bf16", "int8")

#: Deepest tree the kernel takes (its SHAP path is instantiated per depth).
MAX_DEPTH = 10
#: Most rows one SHAP block owns.
MAX_ROWS_PER_BLOCK = 8
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
    return ForestPack(
        feature=feature,
        thr=forest.thr_float.to(torch.float32).contiguous(),
        missing_left=forest.missing_left.to(torch.bool).contiguous(),
        leaf=forest.leaf_value.to(torch.float32).contiguous(),
        path_feature=pf.to(torch.int32).contiguous(),
        slot=slot.contiguous(),
        r_play=r_play.contiguous(),
        base=expected_margin(forest.leaf_value, ratio),
        depth=int(forest.depth),
        n_features=int(n_features),
        precision=precision,
    )


def shap_smem_bytes(depth: int, n_features: int, rows: int) -> int:
    """Dynamic shared memory of one SHAP block (``score_forest.cu`` computes
    the same sum for its launch): node and leaf tables of one tree, the row
    tile, its (rows, F) f64 running totals and this tree's (rows, F) f32
    sums, and the tile's node decisions."""
    L = 2**depth
    I, LD, RF = L - 1, L * depth, rows * n_features
    return 8 * RF + 4 * (2 * I + L + 2 * LD + 2 * RF) + I + LD + rows * I


def rows_per_block(n_rows: int) -> int:
    """Rows one SHAP block owns: one per block while the rows do not fill the
    card's 132 SMs, more once they do (each tree's tables are then staged
    once for several rows)."""
    return max(1, min(MAX_ROWS_PER_BLOCK, n_rows // 132))


def fused_supported(depth: int) -> bool:
    """Shape guard of the margin-only kernel."""
    return 1 <= depth <= MAX_DEPTH


def shap_supported(depth: int, n_features: int) -> bool:
    """Shape guard of the SHAP kernel: the depth it is instantiated for, and
    a (rows, F) accumulator that fits in shared memory at the largest tile."""
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
            lib.score_forest.argtypes = [i] + [p] * 8 + [i] * 5 + [p] * 4
            lib.score_forest.restype = i
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
    CUDA ``X`` launches the kernel once on the current stream (counted in
    ``fused_score.launches``) or raises."""
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
    rpb = rows_per_block(N)
    if with_shap and shap_smem_bytes(pack.depth, n_features, rpb) > SMEM_LIMIT:
        raise ValueError(
            f"score_forest's SHAP path does not take depth {pack.depth} with "
            f"{n_features} features: its shared accumulator would not fit"
        )
    margin = torch.empty(N, dtype=torch.float32, device=X.device)
    prob = torch.empty(N, dtype=torch.float32, device=X.device)
    phis = (
        torch.empty((N, n_features), dtype=torch.float32, device=X.device)
        if with_shap
        else None
    )
    if N > 0:
        dev = X.device.index if X.device.index is not None else torch.cuda.current_device()
        lib = _library(dev)
        err = lib.score_forest(
            dev,
            pack.feature.data_ptr(),
            pack.thr.data_ptr(),
            pack.missing_left.data_ptr(),
            pack.leaf.data_ptr(),
            pack.path_feature.data_ptr(),
            pack.slot.data_ptr(),
            pack.r_play.data_ptr(),
            X.data_ptr(),
            N,
            n_features,
            pack.n_trees,
            pack.depth,
            rpb,
            margin.data_ptr(),
            prob.data_ptr(),
            None if phis is None else phis.data_ptr(),
            torch.cuda.current_stream(X.device).cuda_stream,
        )
        _check(lib, err, "launching the kernel")
        with _COUNT_LOCK:
            fused_score.launches += 1
    if not with_shap:
        return margin, prob
    return margin, prob, phis, pack.base


fused_score.launches = 0
