"""Deterministic train/test splitting: the port's copy of the reference's
``data/split.py``, the same rows bit for bit.

Each row id is mixed with the seed through an integer hash and lands in the
test set iff the hash falls below the test fraction: stable under re-runs
and under appended rows, and computed on the rows' device.

torch has no uint32 arithmetic, so the hash runs on int64 holding values in
[0, 2^32): each 32-bit multiply is split into 16-bit halves of the constant,
which keeps every product below 2^48, and masked back to 32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from cobalt_smart_lender_ai_tpu_torch.device import resolve_device

__all__ = [
    "keep_order",
    "split_mask",
    "stratified_fold_ids",
    "train_test_split_hashed",
]

_U32 = 0xFFFFFFFF


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for int64 ``x`` in [0, 2^32) and a 32-bit ``c``."""
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (hi + x * (c & 0xFFFF)) & _U32


def _mix_u32(x: torch.Tensor, seed: int) -> torch.Tensor:
    """splitmix-style avalanching hash of uint32 lanes, held in int64:
    the reference's ``_mix_u32`` bit for bit."""
    x = (x.to(torch.int64) & _U32) ^ (seed * 0x9E3779B9 & _U32)
    x = _mul_u32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul_u32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def keep_order(keep: torch.Tensor) -> torch.Tensor:
    """Permutation that stably partitions rows by a boolean ``keep`` mask:
    kept rows first, each side in its original order."""
    return torch.argsort(torch.logical_not(keep).to(torch.uint8), stable=True)


def split_mask(
    n_rows: int, test_fraction: float, seed: int, device: torch.device | str = "cuda"
) -> torch.Tensor:
    """Boolean mask, True => test row, on ``device`` (``cuda`` unless the
    caller asks for ``cpu``)."""
    h = _mix_u32(torch.arange(n_rows, device=resolve_device(device)), seed)
    threshold = int(min(max(test_fraction, 0.0), 1.0) * 0xFFFFFFFF)
    return h < threshold


def train_test_split_hashed(X, y, *, test_fraction: float = 0.2, seed: int = 22):
    """Split tensors into (X_train, X_test, y_train, y_test) on their device:
    train rows first, each side in its original order (boolean indexing's
    rows). Only the train count is read on the host."""
    X, y = torch.as_tensor(X), torch.as_tensor(y)
    mask = split_mask(X.shape[0], test_fraction, seed, X.device)
    n_train = X.shape[0] - int(mask.sum())
    order = keep_order(torch.logical_not(mask))
    Xd, yd = X[order], y.to(X.device)[order]
    return Xd[:n_train], Xd[n_train:], yd[:n_train], yd[n_train:]


def stratified_fold_ids(y: np.ndarray, n_folds: int, seed: int) -> np.ndarray:
    """Per-row fold assignment, stratified by label (the reference's
    ``StratifiedKFold(3)`` stand-in): fold k's training weight is
    ``fold_ids != k``."""
    rng = np.random.default_rng(seed)
    fold = np.zeros(len(y), dtype=np.int32)
    for cls in np.unique(y):
        idx = np.flatnonzero(y == cls)
        idx = rng.permutation(idx)
        fold[idx] = np.arange(len(idx)) % n_folds
    return fold
