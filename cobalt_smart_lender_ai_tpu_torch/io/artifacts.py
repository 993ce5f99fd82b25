"""GBDT model artifact: a self-describing ``.npz`` (arrays + a JSON header).

Reads the files the reference package writes (``GBDTArtifact.save``). The
feature plan and the bin edges are kept raw: scoring needs neither.
"""

from __future__ import annotations

import dataclasses
import io as _io
import json

import numpy as np
import torch

from cobalt_smart_lender_ai_tpu_torch.convert import forest_from_numpy
from cobalt_smart_lender_ai_tpu_torch.io.store import ObjectStore
from cobalt_smart_lender_ai_tpu_torch.models.gbdt import Forest

FORMAT_VERSION = 1


@dataclasses.dataclass
class GBDTArtifact:
    """Everything serving needs to score and explain feature rows."""

    forest: Forest
    feature_names: tuple[str, ...]
    bin_edges: np.ndarray | None = None
    plan: dict | None = None
    config: dict = dataclasses.field(default_factory=dict)
    metrics: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_bytes(
        cls, data: bytes, device: torch.device | str = "cpu"
    ) -> "GBDTArtifact":
        z = np.load(_io.BytesIO(data), allow_pickle=False)
        header = json.loads(bytes(z["__header__"]).decode())
        if header.get("kind") != "gbdt":
            raise ValueError(f"artifact kind {header.get('kind')!r}, expected 'gbdt'")
        if header.get("format_version", 0) > FORMAT_VERSION:
            raise ValueError(
                f"artifact format v{header['format_version']} is newer than this "
                f"library understands (v{FORMAT_VERSION})"
            )
        arrays = {k: z[k] for k in z.files if k != "__header__"}
        return cls(
            forest=forest_from_numpy(arrays, int(header["depth"]), device),
            feature_names=tuple(header["feature_names"]),
            bin_edges=arrays.get("bin_edges"),
            plan=header.get("plan"),
            config=header.get("config", {}),
            metrics=header.get("metrics", {}),
        )

    @classmethod
    def load(
        cls, store: ObjectStore, key: str, device: torch.device | str = "cpu"
    ) -> "GBDTArtifact":
        return cls.from_bytes(store.get_bytes(key + ".npz"), device)
