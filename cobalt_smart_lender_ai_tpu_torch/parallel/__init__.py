"""Mesh-parallel execution: the (hp, dp) device mesh (`parallel.mesh`), the
row-sharded fit and predict (`parallel.sharded`), the search's CV fan-out
(`parallel.tune`) and RFE (`parallel.rfe`) over it, the serving
partitioners (`parallel.partitioner`) and the multi-process runtime
(`parallel.distributed`). The reference's names are exported here, each
imported at first use: `models.gbdt` imports `parallel.mesh`, and
`parallel.tune` imports `models.gbdt`."""

from __future__ import annotations

import importlib

_EXPORTS = {
    "DistributedConfig": "distributed",
    "init_distributed": "distributed",
    "make_global_mesh": "distributed",
    "make_mesh": "mesh",
    "pad_rows": "mesh",
    "Mesh": "mesh",
    "make_partitioner": "partitioner",
    "match_partition_rule": "partitioner",
    "MeshPartitioner": "partitioner",
    "Partitioner": "partitioner",
    "SingleDevicePartitioner": "partitioner",
    "fit_binned_dp": "sharded",
    "fit_binned_dp_chunked": "sharded",
    "predict_margin_dp": "sharded",
    "rfe_select": "rfe",
    "RFEResult": "rfe",
    "randomized_search": "tune",
    "cross_validate_gbdt": "tune",
    "sample_candidates": "tune",
    "stratified_kfold_masks": "tune",
    "successive_halving_search": "tune",
    "SearchResult": "tune",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value
