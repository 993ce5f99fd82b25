"""Carry weights across from the reference package.

The reference's `Forest` is a dataclass of JAX arrays; its fields, taken as
numpy arrays (``np.asarray(forest.feature)`` ..., or the arrays of a saved
``.npz`` artifact), are all this port needs.

The neural challengers' flax parameter trees (``{"params": {...}}``, numpy
or JAX leaves) map to the port's `state_dict`s and back with
`flax_params_to_state_dict` and `state_dict_to_flax_params`, for the
families ``"mlp"``, ``"ft_transformer"``, ``"tabnet"`` and ``"logistic"``
(whose reference "params" are ``coef``, ``intercept``, ``mean`` and
``scale``). A flax ``Dense`` kernel is ``(in, out)`` and an `nn.Linear`
weight ``(out, in)``; the attention's ``query``/``key``/``value`` kernels
are ``(d, heads, head_dim)`` and ``out``'s ``(heads, head_dim, d)``.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

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


# -- flax parameter trees <-> state_dicts -------------------------------------

FAMILIES = ("mlp", "ft_transformer", "tabnet", "logistic")


def _dense(path: tuple[str, ...], key: str) -> list[tuple]:
    return [(path + ("kernel",), key + ".weight", "kernel"), (path + ("bias",), key + ".bias", "same")]


def _layer_norm(path: tuple[str, ...], key: str) -> list[tuple]:
    return [(path + ("scale",), key + ".weight", "same"), (path + ("bias",), key + ".bias", "same")]


def _glu_ft(path: tuple[str, ...], key: str) -> list[tuple]:
    return [e for j in range(2)
            for e in _dense(path + (f"GLUBlock_{j}", "Dense_0"), f"{key}.glu.{j}.dense")]


def _count(names, pattern: str) -> int:
    return sum(1 for n in names if re.fullmatch(pattern, n))


def _entries(family: str, shape: Mapping[str, int]) -> list[tuple]:
    """``(flax path, state_dict key, kind)`` for every parameter of a
    ``family`` model of the given structure counts."""
    if family == "mlp":
        return [e for i in range(shape["layers"]) for e in _dense((f"Dense_{i}",), f"layers.{i}")]
    if family == "ft_transformer":
        n = shape["blocks"]
        out = [(("cls",), "cls", "same")]
        if shape["numeric"]:
            out += [(("num_w",), "num_w", "same"), (("num_b",), "num_b", "same")]
        out += [((f"cat_emb_{i}", "embedding"), f"cat_emb.{i}.weight", "same")
                for i in range(shape["categorical"])]
        for b in range(n):
            mha = (f"MultiHeadDotProductAttention_{b}",)
            for proj in ("query", "key", "value"):
                out += [(mha + (proj, "kernel"), f"blocks.{b}.attn.{proj}.weight", "qkv_kernel"),
                        (mha + (proj, "bias"), f"blocks.{b}.attn.{proj}.bias", "qkv_bias")]
            out += [(mha + ("out", "kernel"), f"blocks.{b}.attn.out.weight", "out_kernel"),
                    (mha + ("out", "bias"), f"blocks.{b}.attn.out.bias", "same")]
            out += _layer_norm((f"LayerNorm_{2 * b}",), f"blocks.{b}.ln1")
            out += _layer_norm((f"LayerNorm_{2 * b + 1}",), f"blocks.{b}.ln2")
            out += _dense((f"Dense_{2 * b}",), f"blocks.{b}.ff1")
            out += _dense((f"Dense_{2 * b + 1}",), f"blocks.{b}.ff2")
        return out + _layer_norm((f"LayerNorm_{2 * n}",), "ln_f") + _dense((f"Dense_{2 * n}",), "head")
    if family == "tabnet":
        out = _glu_ft(("shared_ft",), "shared_ft")
        for i in range(shape["steps"]):
            out += _dense((f"attn_{i}",), f"attn.{i}") + _glu_ft((f"step_ft_{i}",), f"step_ft.{i}")
        return out + _dense(("head",), "head")
    if family == "logistic":
        return [((name,), name, "same") for name in ("coef", "intercept", "mean", "scale")]
    raise ValueError(f"family must be one of {FAMILIES}, got {family!r}")


def _to_torch(value: np.ndarray, kind: str) -> np.ndarray:
    if kind == "kernel":
        return value.T
    if kind == "qkv_kernel":  # (d, H, hd) -> (H * hd, d)
        return value.reshape(value.shape[0], -1).T
    if kind == "qkv_bias":  # (H, hd) -> (H * hd,)
        return value.reshape(-1)
    if kind == "out_kernel":  # (H, hd, d) -> (d, H * hd)
        return value.reshape(-1, value.shape[-1]).T
    return value


def _to_flax(value: np.ndarray, kind: str, n_heads: int | None) -> np.ndarray:
    if kind == "kernel":
        return value.T
    if kind in ("qkv_kernel", "qkv_bias", "out_kernel"):
        if not n_heads:
            raise ValueError("the FT-Transformer's attention needs n_heads to lay its kernels out")
        if kind == "qkv_kernel":
            return value.T.reshape(value.shape[1], n_heads, -1)
        if kind == "qkv_bias":
            return value.reshape(n_heads, -1)
        return value.T.reshape(n_heads, -1, value.shape[0])
    return value


def _flax_shape(family: str, tree: Mapping[str, Any]) -> dict[str, int]:
    names = list(tree)
    return {
        "layers": _count(names, r"Dense_\d+"),
        "blocks": _count(names, r"MultiHeadDotProductAttention_\d+"),
        "numeric": int("num_w" in tree),
        "categorical": _count(names, r"cat_emb_\d+"),
        "steps": _count(names, r"attn_\d+"),
    }


def _state_shape(state_dict: Mapping[str, Any]) -> dict[str, int]:
    prefixes = {k.rsplit(".", 1)[0] for k in state_dict}
    return {
        "layers": _count(prefixes, r"layers\.\d+"),
        "blocks": _count(prefixes, r"blocks\.\d+\.ln1"),
        "numeric": int("num_w" in state_dict),
        "categorical": _count(prefixes, r"cat_emb\.\d+"),
        "steps": _count(prefixes, r"attn\.\d+"),
    }


def flax_params_to_state_dict(
    family: str, params: Any, device: torch.device | str = "cpu"
) -> dict[str, torch.Tensor]:
    """The port's `state_dict` for the reference's ``family`` parameters:
    a flax variables tree (``{"params": {...}}`` or its inner dict), or for
    ``"logistic"`` a mapping or object with ``coef``, ``intercept``,
    ``mean`` and ``scale``. Tensors are float32 on ``device``."""
    if family == "logistic" and not isinstance(params, Mapping):
        params = {n: getattr(params, n) for n in ("coef", "intercept", "mean", "scale")}
    tree = params.get("params", params) if isinstance(params, Mapping) else params
    out = {}
    for path, key, kind in _entries(family, _flax_shape(family, tree)):
        value = tree
        for part in path:
            value = value[part]
        arr = np.array(_to_torch(np.asarray(value, dtype=np.float32), kind), order="C")
        out[key] = torch.from_numpy(arr).to(device)
    return out


def state_dict_to_flax_params(
    family: str, state_dict: Mapping[str, torch.Tensor], *, n_heads: int | None = None
) -> dict:
    """The reference's parameters for a port ``family`` `state_dict`, as
    numpy float32: ``{"params": {...}}`` for the flax families (``n_heads``
    is needed for ``"ft_transformer"``), the flat ``coef``/``intercept``/
    ``mean``/``scale`` mapping for ``"logistic"``."""
    tree: dict = {}
    for path, key, kind in _entries(family, _state_shape(state_dict)):
        value = state_dict[key]
        arr = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.array(_to_flax(arr.astype(np.float32), kind, n_heads), order="C")
    return tree if family == "logistic" else {"params": tree}
