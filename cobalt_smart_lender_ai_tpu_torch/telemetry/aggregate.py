"""Fleet aggregation: merge N `parse_exposition` snapshots into one.

The reference's ``telemetry/aggregate.py``, module for module. The
observability stack's point-in-time surfaces (`/metrics`, `/slo`) are
per-process; a `ReplicaSet` needs the *sum* of its members' counters and
the *merge* of their histogram buckets to answer fleet-level questions
("total QPS", "fleet p99"). This module is that merge, operating purely
on the `parse_exposition` dict shape, so the same code aggregates
in-process replica registries and scraped remote expositions.

Semantics, per family type:

- **counter** samples with identical keys sum (this includes histogram
  ``_bucket`` / ``_sum`` / ``_count`` samples: summing cumulative bucket
  counts IS the histogram merge — the bucket edges are shared by
  construction, every registry builds them from the same `log_buckets`).
- **gauge** samples sum too; for additive gauges (queue depth,
  in-flight, RSS) the sum is the fleet value, and NaN contributions
  (dead callbacks) are skipped rather than poisoning the fleet sample.
- **label join**: pass ``extra_labels`` (one dict per snapshot, e.g.
  ``{"replica": "0"}``) and every source sample is *also* kept under its
  joined key, so the merged exposition carries fleet-level series and
  per-source series side by side — exactly what
  `telemetry.timeseries.TimeSeriesStore` wants to scrape for
  fleet-and-per-replica history.

Merging is commutative and associative (it is a keyed sum), which the
property tests pin.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Mapping, Sequence

__all__ = [
    "fleet_scraper",
    "join_sample_key",
    "merge_expositions",
    "merge_registries",
    "split_sample_key",
]


def split_sample_key(key: str) -> tuple[str, dict[str, str]]:
    """Invert `parse_exposition`'s sample key: ``name|k=v|k2=v2`` ->
    ``(name, {k: v, k2: v2})``. Label values containing ``|`` would be
    ambiguous; none of the stack's bounded label sets (routes, phases,
    device strings, error codes) do."""
    parts = key.split("|")
    labels: dict[str, str] = {}
    for part in parts[1:]:
        k, _, v = part.partition("=")
        labels[k] = v
    return parts[0], labels


def join_sample_key(name: str, labels: Mapping[str, str]) -> str:
    """The `parse_exposition` key convention: name + sorted ``|k=v``."""
    return name + "".join(f"|{k}={labels[k]}" for k in sorted(labels))


def _relabeled_key(key: str, extra: Mapping[str, str]) -> str:
    name, labels = split_sample_key(key)
    merged = dict(labels)
    for k, v in extra.items():
        merged.setdefault(k, str(v))
    return join_sample_key(name, merged)


def merge_expositions(
    snapshots: Sequence[Mapping[str, Mapping[str, Any]]],
    *,
    extra_labels: Sequence[Mapping[str, str]] | None = None,
    keep_sources: bool = False,
) -> dict[str, dict[str, Any]]:
    """Merge N `parse_exposition` outputs into one fleet-level dict.

    Samples with identical keys sum (NaN contributions skipped); with
    ``keep_sources=True`` each snapshot's samples are additionally kept
    under their ``extra_labels``-joined keys. ``extra_labels`` must be
    one mapping per snapshot when given. Family ``type``/``help`` come
    from the first snapshot that declares them; a *conflicting* type for
    the same family raises — summing a counter into a histogram is a
    bug, not a merge.
    """
    if extra_labels is not None and len(extra_labels) != len(snapshots):
        raise ValueError(
            f"extra_labels has {len(extra_labels)} entries "
            f"for {len(snapshots)} snapshots"
        )
    out: dict[str, dict[str, Any]] = {}
    for i, snap in enumerate(snapshots):
        extra = extra_labels[i] if extra_labels is not None else None
        for fam, block in snap.items():
            ftype = block.get("type", "untyped")
            dst = out.setdefault(fam, {"type": ftype, "samples": {}})
            if dst["type"] != ftype and "untyped" not in (dst["type"], ftype):
                raise ValueError(
                    f"family {fam!r}: type {ftype!r} conflicts "
                    f"with {dst['type']!r}"
                )
            if dst["type"] == "untyped":
                dst["type"] = ftype
            if "help" in block:
                dst.setdefault("help", block["help"])
            samples = dst["samples"]
            for key, value in block.get("samples", {}).items():
                v = float(value)
                if not math.isnan(v):
                    prev = samples.get(key)
                    if prev is None or math.isnan(prev):
                        samples[key] = v
                    else:
                        samples[key] = prev + v
                elif key not in samples:
                    samples[key] = v
                if keep_sources and extra:
                    samples[_relabeled_key(key, extra)] = v
    return out


def merge_registries(
    registries: Sequence[Any],
    *,
    label: str = "replica",
    keep_sources: bool = True,
    names: Sequence[str] | None = None,
) -> dict[str, dict[str, Any]]:
    """Render + parse + merge N live `MetricsRegistry` objects: the
    fleet scrape a `ReplicaSet` hands to its `TimeSeriesStore`. Each
    registry's samples are label-joined under ``{label: names[i]}``
    (default ``str(i)``) when ``keep_sources``."""
    from cobalt_smart_lender_ai_tpu_torch.telemetry.metrics import parse_exposition

    snaps = [parse_exposition(reg.render()) for reg in registries]
    extra = [
        {label: (names[i] if names is not None else str(i))}
        for i in range(len(snaps))
    ]
    return merge_expositions(
        snaps, extra_labels=extra, keep_sources=keep_sources
    )


def fleet_scraper(
    registries: Sequence[Any], *, label: str = "replica"
) -> Callable[[], dict[str, dict[str, Any]]]:
    """A zero-arg scrape callable over live registries — what
    `TimeSeriesStore(scrape=...)` takes. Resolved at call time, so
    registries swapped under it (hot reload) are re-read each tick."""
    return lambda: merge_registries(registries, label=label)
