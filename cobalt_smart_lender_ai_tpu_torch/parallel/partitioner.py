"""Serving-side partitioners: shard the scoring launches' rows over a mesh.

The port's copy of the reference's ``parallel/partitioner.py``. Serving has
two inputs: the forest (its `ForestPack`), replicated on every shard, and
the ``(rows, F)`` feature matrix, split row-wise over the ``dp`` shards
(`DEFAULT_RULES`, `match_partition_rule`).

`SingleDevicePartitioner` is the single-device path: one ``score_forest``
launch (`ops.score.fused_score`) per call, under the program names the
service and the portfolio engine use on their own. `MeshPartitioner` cuts
the rows into ``n_shards`` equal contiguous blocks and launches
``score_forest`` once per shard, each on its own device and CUDA stream
(`parallel.mesh.RowShards.run`), its program row ``.../shards=<n>``; the
outputs come back in row order on the first shard's device. A row's
margin, probability and SHAP contributions depend only on that row (the
kernel's SHAP sums are deterministic fixed point), so a mesh dispatch gives
the single device's bits. Callers pad the row count to `shard_multiple`;
padding rows score garbage that is sliced off.

`compile_rowwise` runs any per-row torch function the same way (the device
ingest's feature assembly and bin transform, `data.device_pipeline`).
"""

from __future__ import annotations

import abc
import dataclasses
import re
from typing import Any, Callable, Sequence

import numpy as np
import torch

from cobalt_smart_lender_ai_tpu_torch import device as _device
from cobalt_smart_lender_ai_tpu_torch.ops.score import ForestPack, fused_score, pack_forest
from cobalt_smart_lender_ai_tpu_torch.config import MeshConfig
from cobalt_smart_lender_ai_tpu_torch.parallel.mesh import Mesh, RowShards, make_mesh

__all__ = [
    "DEFAULT_RULES",
    "MeshPartitioner",
    "Partitioner",
    "SingleDevicePartitioner",
    "make_partitioner",
    "match_partition_rule",
]

#: Partition rules of the serving inputs (the reference's, pjit-style):
#: regex over the input's name -> spec template; ``"{dp}"`` stands for the
#: mesh's row axis, and anything unmatched is replicated. These are the only
#: rules the port's partitioners run: the pack replicated, the rows split.
DEFAULT_RULES: tuple[tuple[str, tuple[Any, ...]], ...] = (
    (r"^(rows|X|batch)$", ("{dp}", None)),
    (r".*", ()),
)


def match_partition_rule(
    rules: Sequence[tuple[str, tuple[Any, ...]]], name: str, dp_axis: str
) -> tuple[Any, ...]:
    """The spec of input ``name`` under the first rule whose pattern it
    matches, ``"{dp}"`` bound to ``dp_axis``: ``(dp_axis, None)`` for a
    row-sharded matrix, ``()`` for a replicated input."""
    for pattern, template in rules:
        if re.search(pattern, name) is not None:
            return tuple(dp_axis if t == "{dp}" else t for t in template)
    raise ValueError(f"no partition rule matched input {name!r}")


def _as_pack(forest: Any, n_features: int) -> ForestPack:
    """A raw `Forest` packed at f32; a `ForestPack` (any precision) as is."""
    if isinstance(forest, ForestPack):
        return forest
    return pack_forest(forest, n_features, "f32")


def _pack_on(pack: ForestPack, device: torch.device) -> ForestPack:
    """The pack's tensors on ``device`` (the pack itself when it is there)."""
    if pack.device == device:
        return pack
    return dataclasses.replace(
        pack,
        **{
            f.name: getattr(pack, f.name).to(device)
            for f in dataclasses.fields(pack)
            if isinstance(getattr(pack, f.name), torch.Tensor)
        },
    )


def _as_rows(X: Any, device: torch.device) -> torch.Tensor:
    if isinstance(X, np.ndarray):
        X = torch.from_numpy(np.ascontiguousarray(X, np.float32))
    return X.to(device=device, dtype=torch.float32).contiguous()


class Partitioner(abc.ABC):
    """Where a scoring call's rows go: one device, or the shards of a
    ``dp`` mesh."""

    @property
    @abc.abstractmethod
    def mesh(self) -> Mesh | None:
        """The device mesh, or None off-mesh."""

    @property
    @abc.abstractmethod
    def n_shards(self) -> int:
        """Row shards per dispatch (1 = single device)."""

    @property
    def shard_multiple(self) -> int:
        """Row counts handed to the compiled calls must divide this."""
        return self.n_shards

    @abc.abstractmethod
    def compile_fused(
        self, forest: Any, n_features: int, rows: int, *, with_shap: bool = True
    ) -> Callable[[Any], tuple]:
        """The fused scoring call over ``rows`` rows: ``X`` (a tensor or a
        numpy array) -> ``(margin, prob)`` or, with SHAP, ``(margin, prob,
        phis, base)``, as `fused_score` returns them. ``forest`` is a
        `Forest` (packed at f32) or a `ForestPack` of any precision."""

    def compile_margin(self, forest: Any, n_features: int, rows: int) -> Callable:
        """``X -> (rows,)`` margins: `compile_fused`'s margin-only call."""
        fn = self.compile_fused(forest, n_features, rows, with_shap=False)
        return lambda X: fn(X)[0]

    def compile_shap(self, forest: Any, n_features: int, rows: int) -> Callable:
        """``X -> ((rows, F) phis, base)``: `compile_fused`'s SHAP call."""
        fn = self.compile_fused(forest, n_features, rows, with_shap=True)
        return lambda X: fn(X)[2:4]

    @abc.abstractmethod
    def compile_rowwise(self, fn: Callable[..., Any], rows: int) -> Callable[..., Any]:
        """``(*Xs) -> fn(*Xs)`` for a per-row torch function of row-aligned
        tensors over ``rows`` rows: ``fn`` returns a tensor, or a tuple of
        tensors (or None), each row-major along axis 0 and each row
        depending only on the same row of the inputs. On a mesh every shard
        calls ``fn`` on its rows (contiguous blocks, uneven by at most one
        row; fewer rows than shards run on the first device) and the
        outputs are concatenated in row order."""

    def describe(self) -> dict:
        """The mesh shape for ``/readyz``, the portfolio report and bench
        records."""
        return {"shards": self.n_shards, "mesh": None, "devices": None}


class SingleDevicePartitioner(Partitioner):
    """The single-device path: each call is one `fused_score` launch on
    ``device`` (default: the device the rows lie on), on the caller's
    current stream, under its usual program name."""

    def __init__(self, device: torch.device | str | None = None):
        self._device = None if device is None else torch.device(device)

    @property
    def mesh(self) -> Mesh | None:
        return None

    @property
    def n_shards(self) -> int:
        return 1

    def _target(self, X: Any, pack: ForestPack) -> torch.device:
        if self._device is not None:
            return self._device
        return X.device if isinstance(X, torch.Tensor) else pack.device

    def compile_fused(self, forest, n_features, rows, *, with_shap=True):
        pack = _as_pack(forest, n_features)

        def call(X):
            return fused_score(
                pack, _as_rows(X, self._target(X, pack)), n_features=n_features, with_shap=with_shap
            )

        return call

    def compile_rowwise(self, fn, rows):
        return fn

    def describe(self) -> dict:
        out = super().describe()
        if self._device is not None:
            out["devices"] = [str(self._device)]
        return out


class MeshPartitioner(Partitioner):
    """Row-sharded scoring: one dispatch cuts its rows into ``n_shards``
    contiguous blocks of equal size and launches ``score_forest`` once per
    block, each on its own device and stream (a device named twice is two
    shards on two streams), the pack replicated; the outputs come back in
    row order on the first device (so ``out[:n]`` are the caller's rows and
    the padding sits at the tail of the last shard)."""

    def __init__(
        self,
        devices: Sequence[torch.device | str] | None = None,
        *,
        dp_axis: str = "dp",
    ):
        self._dp_axis = dp_axis
        self._mesh = make_mesh(MeshConfig(axis_dp=dp_axis), devices=devices)

    @property
    def mesh(self) -> Mesh:
        return self._mesh

    @property
    def n_shards(self) -> int:
        return self._mesh.size

    def _shards(self, rows: int) -> RowShards:
        if rows % self.n_shards != 0:
            raise ValueError(
                f"rows={rows} does not divide the {self.n_shards}-way "
                f"{self._dp_axis!r} mesh axis; pad to shard_multiple first"
            )
        return self._mesh.row_shards(0, rows)

    def compile_fused(self, forest, n_features, rows, *, with_shap=True):
        dp = self._shards(rows)
        pack = _as_pack(forest, n_features)
        packs = [_pack_on(pack, d) for d in dp.devices]
        n = self.n_shards

        def call(X):
            X = _as_rows(X, dp.lead)
            if X.shape[0] != rows:
                raise ValueError(f"this call scores {rows} rows, got {X.shape[0]}")
            parts = dp.split(X)
            outs = dp.run(
                lambda s: fused_score(
                    packs[s], parts[s], n_features=n_features, with_shap=with_shap, shards=n
                )
            )
            margin = dp.gather([o[0] for o in outs])
            prob = dp.gather([o[1] for o in outs])
            if not with_shap:
                return margin, prob
            return margin, prob, dp.gather([o[2] for o in outs]), outs[0][3].to(dp.lead)

        return call

    def compile_rowwise(self, fn, rows):
        def call(*Xs):
            if Xs[0].shape[0] < self.n_shards:  # too few rows to shard
                return fn(*Xs)
            dp = self._mesh.row_shards(0, Xs[0].shape[0])
            parts = [dp.split(X) for X in Xs]
            outs = dp.run(lambda s: fn(*(p[s] for p in parts)))
            if isinstance(outs[0], torch.Tensor):
                return dp.gather(outs)
            return tuple(
                None if outs[0][k] is None else dp.gather([o[k] for o in outs])
                for k in range(len(outs[0]))
            )

        return call

    def describe(self) -> dict:
        return {
            "shards": self.n_shards,
            "mesh": {self._dp_axis: self.n_shards},
            "devices": [str(d) for d in self._mesh.devices.flat],
        }


def make_partitioner(
    bulk_shards: int,
    *,
    device: torch.device | str | None = None,
    devices: Sequence[torch.device | str] | None = None,
) -> Partitioner:
    """Resolve a shard-count knob into a partitioner, as the reference does.

    ``bulk_shards``: 0 or 1 -> single device (on ``device``); -1 -> every
    visible device; N -> an N-way ``dp`` mesh, clamped to the visible
    devices (a config asking for 8 shards on a 4-card host gets 4, not a
    crash). The visible devices are ``devices``, or
    `device.mesh_devices` of ``device`` (default the card)."""
    if bulk_shards in (0, 1):
        return SingleDevicePartitioner(device)
    if devices is None:
        devices = _device.mesh_devices(device if device is not None else "cuda")
    devs = list(devices)
    n = len(devs) if bulk_shards == -1 else min(bulk_shards, len(devs))
    if n <= 1:
        return SingleDevicePartitioner(device)
    return MeshPartitioner(devs[:n])
