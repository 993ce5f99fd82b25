"""Model artifacts: self-describing ``.npz`` files (arrays + a JSON header).

Both read and write the reference package's formats:

- `GBDTArtifact`: a JSON header (``kind`` "gbdt", ``format_version``,
  ``library_version``, ``depth``, ``feature_names``, ``plan``, ``config``,
  ``metrics``) and eight arrays (the forest's seven fields and
  ``bin_edges``), plus a ``<key>.features.json`` sidecar with the feature
  order;
- `MLPArtifact`: a JSON header (``kind`` "mlp", ``feature_names``,
  ``hidden_sizes``, ``config``, ``metrics``), the MLP's parameters as flax's
  msgpack bytes (``params_msgpack``: ``params`` -> ``Dense_i`` -> ``kernel``
  ``(in, out)`` and ``bias``; `io.flax_msgpack`) and the min-max scaler
  (``scaler_low``, ``scaler_range``).

The feature plan (`FeaturePlan`) is written and read by `plan_to_json` /
`plan_from_json`, the reference's format, and a training run's
``metrics.json`` by `save_metrics` and `load_metrics`.
"""

from __future__ import annotations

import dataclasses
import io as _io
import json
from typing import Any, Mapping

import numpy as np
import torch

from cobalt_smart_lender_ai_tpu_torch.convert import (
    flax_params_to_state_dict,
    forest_from_numpy,
    forest_to_numpy,
    state_dict_to_flax_params,
)
from cobalt_smart_lender_ai_tpu_torch.data.features import FeaturePlan
from cobalt_smart_lender_ai_tpu_torch.device import resolve_device
from cobalt_smart_lender_ai_tpu_torch.io.flax_msgpack import pack_tree, unpack_tree
from cobalt_smart_lender_ai_tpu_torch.io.store import ObjectStore
from cobalt_smart_lender_ai_tpu_torch.models.gbdt import Forest
from cobalt_smart_lender_ai_tpu_torch.version import __version__

FORMAT_VERSION = 1


def plan_to_json(plan: FeaturePlan) -> dict:
    return {
        "numeric_names": list(plan.numeric_names),
        # Pairs, not a dict: headers are dumped with sort_keys=True, and the
        # one-hot layout that transform_raw_rows replays follows this
        # mapping's order.
        "categorical_vocab": [[k, list(v)] for k, v in plan.categorical_vocab.items()],
        "label_vocab": {k: list(v) for k, v in plan.label_vocab.items()},
        "medians": dict(plan.medians),
        "log_cols": list(plan.log_cols),
        "tree_feature_names": list(plan.tree_feature_names),
        "nn_feature_names": list(plan.nn_feature_names),
        "asof": plan.asof,
    }


def plan_from_json(d: Mapping[str, Any]) -> FeaturePlan:
    vocab = d["categorical_vocab"]
    return FeaturePlan(
        numeric_names=tuple(d["numeric_names"]),
        categorical_vocab={
            k: tuple(v) for k, v in (vocab.items() if isinstance(vocab, dict) else vocab)
        },
        label_vocab={k: tuple(v) for k, v in d["label_vocab"].items()},
        medians={k: float(v) for k, v in d["medians"].items()},
        log_cols=tuple(d["log_cols"]),
        tree_feature_names=tuple(d["tree_feature_names"]),
        nn_feature_names=tuple(d["nn_feature_names"]),
        asof=d.get("asof"),
    )


def _pack(arrays: Mapping[str, np.ndarray], header: dict) -> bytes:
    buf = _io.BytesIO()
    np.savez_compressed(
        buf,
        __header__=np.frombuffer(json.dumps(header, sort_keys=True).encode(), dtype=np.uint8),
        **arrays,
    )
    return buf.getvalue()


def _unpack(data: bytes, kind: str) -> tuple[dict[str, np.ndarray], dict]:
    z = np.load(_io.BytesIO(data), allow_pickle=False)
    header = json.loads(bytes(z["__header__"]).decode())
    if header.get("kind") != kind:
        raise ValueError(f"artifact kind {header.get('kind')!r}, expected {kind!r}")
    if header.get("format_version", 0) > FORMAT_VERSION:
        raise ValueError(
            f"artifact format v{header['format_version']} is newer than this "
            f"library understands (v{FORMAT_VERSION})"
        )
    return {k: z[k] for k in z.files if k != "__header__"}, header


@dataclasses.dataclass
class GBDTArtifact:
    """Everything serving needs to score and explain feature rows."""

    forest: Forest
    feature_names: tuple[str, ...]
    bin_edges: np.ndarray | None = None
    plan: FeaturePlan | None = None
    config: dict = dataclasses.field(default_factory=dict)
    metrics: dict = dataclasses.field(default_factory=dict)

    def to_bytes(self) -> bytes:
        """The ``.npz`` bytes, in the reference's layout."""
        if self.bin_edges is None:
            raise ValueError("a GBDT artifact needs its bin edges to be written")
        header = {
            "kind": "gbdt",
            "format_version": FORMAT_VERSION,
            "library_version": __version__,
            "depth": int(self.forest.depth),
            "feature_names": list(self.feature_names),
            "plan": None if self.plan is None else plan_to_json(self.plan),
            "config": self.config,
            "metrics": self.metrics,
        }
        arrays = forest_to_numpy(self.forest)
        arrays["bin_edges"] = np.ascontiguousarray(self.bin_edges, dtype=np.float32)
        return _pack(arrays, header)

    def save(self, store: ObjectStore, key: str) -> None:
        """Write ``<key>.npz`` and the ``<key>.features.json`` sidecar."""
        store.put_bytes(key + ".npz", self.to_bytes())
        store.put_json(key + ".features.json", list(self.feature_names))

    @classmethod
    def from_bytes(
        cls, data: bytes, device: torch.device | str = "cuda"
    ) -> "GBDTArtifact":
        """The artifact with its forest on ``device`` (``cuda`` unless the
        caller asks for ``cpu``)."""
        dev = resolve_device(device)
        arrays, header = _unpack(data, "gbdt")
        return cls(
            forest=forest_from_numpy(arrays, int(header["depth"]), dev),
            feature_names=tuple(header["feature_names"]),
            bin_edges=arrays.get("bin_edges"),
            plan=None if header.get("plan") is None else plan_from_json(header["plan"]),
            config=header.get("config", {}),
            metrics=header.get("metrics", {}),
        )

    @classmethod
    def load(
        cls, store: ObjectStore, key: str, device: torch.device | str = "cuda"
    ) -> "GBDTArtifact":
        return cls.from_bytes(store.get_bytes(key + ".npz"), device)


@dataclasses.dataclass
class MLPArtifact:
    """The MLP challenger and its scaler: the reference's ``.keras`` file
    and scaler pickle (`04_model_training.ipynb` cell 44). ``state_dict`` is
    the port's `models.nn.MLP`'s."""

    state_dict: Mapping[str, torch.Tensor]
    scaler_low: np.ndarray
    scaler_range: np.ndarray
    feature_names: tuple[str, ...]
    hidden_sizes: tuple[int, ...]
    config: dict = dataclasses.field(default_factory=dict)
    metrics: dict = dataclasses.field(default_factory=dict)

    def to_bytes(self) -> bytes:
        """The ``.npz`` bytes, in the reference's layout."""
        header = {
            "kind": "mlp",
            "format_version": FORMAT_VERSION,
            "library_version": __version__,
            "feature_names": list(self.feature_names),
            "hidden_sizes": list(self.hidden_sizes),
            "config": self.config,
            "metrics": self.metrics,
        }
        params = pack_tree(state_dict_to_flax_params("mlp", self.state_dict))
        arrays = {
            "params_msgpack": np.frombuffer(params, dtype=np.uint8),
            "scaler_low": np.asarray(self.scaler_low),
            "scaler_range": np.asarray(self.scaler_range),
        }
        return _pack(arrays, header)

    @classmethod
    def from_bytes(cls, data: bytes, device: torch.device | str = "cuda") -> "MLPArtifact":
        """The artifact with its parameters on ``device`` (``cuda`` unless
        the caller asks for ``cpu``)."""
        dev = resolve_device(device)
        arrays, header = _unpack(data, "mlp")
        params = unpack_tree(bytes(arrays["params_msgpack"]))
        return cls(
            state_dict=flax_params_to_state_dict("mlp", params, dev),
            scaler_low=arrays["scaler_low"],
            scaler_range=arrays["scaler_range"],
            feature_names=tuple(header["feature_names"]),
            hidden_sizes=tuple(header["hidden_sizes"]),
            config=header.get("config", {}),
            metrics=header.get("metrics", {}),
        )

    def save(self, store: ObjectStore, key: str) -> None:
        store.put_bytes(key + ".npz", self.to_bytes())

    @classmethod
    def load(
        cls, store: ObjectStore, key: str, device: torch.device | str = "cuda"
    ) -> "MLPArtifact":
        return cls.from_bytes(store.get_bytes(key + ".npz"), device)


def save_metrics(store: ObjectStore, key: str, metrics: Mapping[str, Any]) -> None:
    """``metrics.json`` with the reference trainer's schema: ``auc``,
    ``classification_report``, ``best_params``."""
    store.put_json(key, dict(metrics))


def load_metrics(store: ObjectStore, key: str) -> dict:
    """A ``metrics.json`` written by `save_metrics`, as a dict."""
    return store.get_json(key)
