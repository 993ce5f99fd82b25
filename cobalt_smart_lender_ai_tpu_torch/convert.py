"""Carry a forest's weights across from the reference package.

The reference's `Forest` is a dataclass of JAX arrays; its fields, taken as
numpy arrays (``np.asarray(forest.feature)`` ..., or the arrays of a saved
``.npz`` artifact), are all this port needs.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from cobalt_smart_lender_ai_tpu_torch.models.gbdt import Forest
from cobalt_smart_lender_ai_tpu_torch.ops.binning import BinSpec

_DTYPES = {
    "feature": np.int32,
    "thr_bin": np.int32,
    "thr_float": np.float32,
    "missing_left": np.bool_,
    "gain": np.float32,
    "cover": np.float32,
    "leaf_value": np.float32,
}


def forest_from_numpy(
    arrays: Mapping[str, np.ndarray],
    depth: int,
    device: torch.device | str = "cpu",
) -> Forest:
    """Build a `Forest` on ``device`` from the reference forest's fields as
    numpy arrays. Extra keys (``bin_edges``) are ignored; shapes are checked
    against ``depth``."""
    t = {
        name: torch.from_numpy(np.array(arrays[name], dtype=dt, order="C")).to(device)
        for name, dt in _DTYPES.items()
    }
    T = t["feature"].shape[0]
    L = 2**depth
    expect = {
        "feature": (T, L - 1),
        "thr_bin": (T, L - 1),
        "thr_float": (T, L - 1),
        "missing_left": (T, L - 1),
        "gain": (T, L - 1),
        "cover": (T, 2 * L - 1),
        "leaf_value": (T, L),
    }
    for name, shape in expect.items():
        if tuple(t[name].shape) != shape:
            raise ValueError(
                f"forest field {name!r} has shape {tuple(t[name].shape)}, "
                f"expected {shape} for depth {depth}"
            )
    return Forest(**t, depth=int(depth))


def forest_to_numpy(forest: Forest) -> dict[str, np.ndarray]:
    """The forest's fields as numpy arrays in the reference's dtypes."""
    return {
        name: np.ascontiguousarray(getattr(forest, name).detach().cpu().numpy().astype(dt))
        for name, dt in _DTYPES.items()
    }


def bin_spec_from_numpy(edges: np.ndarray, device: torch.device | str = "cpu") -> BinSpec:
    """A `BinSpec` on ``device`` from ``(F, n_bins - 2)`` edges (an
    artifact's ``bin_edges``)."""
    e = np.array(edges, dtype=np.float32, order="C")
    if e.ndim != 2:
        raise ValueError(f"bin edges must be (F, n_bins - 2), got shape {e.shape}")
    return BinSpec(edges=torch.from_numpy(e).to(device))
