"""Scenario-report reducers: score vectors in, decision-ready numbers out
(the port's copy of the reference's ``scenario/report.py``, output for
output).

Everything here is pure numpy over already-final score/attribution arrays,
separate from the engine so the delta math is testable on hand-computed
inputs and so the report shape is owned by one module:

- `delta_stats`: per-scenario PD shift distribution vs the baseline;
- `band_migration`: the PD-band transition matrix credit reviews read
  ("how many loans crossed a pricing band under this stress");
- `shap_top_movers`: which features' mean attribution moved most;
- `scenario_drift`: PSI of each perturbed feature against the model's
  *training* sketch (`telemetry.drift`), flagging stress points that push
  the portfolio out of the distribution the model was fit on. A flag is a
  warning in the report, never a failure: an OOD stress point is exactly
  what a severe scenario is for, but the reader must know the scores out
  there are extrapolation.

`write_report` lands the final JSON under the run's versioned prefix.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np

from cobalt_smart_lender_ai_tpu_torch.telemetry.drift import FeatureSketch, psi

__all__ = [
    "DEFAULT_PD_BANDS",
    "band_labels",
    "band_migration",
    "delta_stats",
    "pd_band_index",
    "scenario_drift",
    "shap_top_movers",
    "write_report",
]

#: Default PD cut points — five bands in the shape of a consumer-credit
#: grade ladder. Reports label them `<2%`, `2-8%`, `8-20%`, `20-50%`, `>=50%`.
DEFAULT_PD_BANDS: tuple[float, ...] = (0.02, 0.08, 0.20, 0.50)


def pd_band_index(
    scores: np.ndarray, bands: Sequence[float] = DEFAULT_PD_BANDS
) -> np.ndarray:
    """Band index per row: ``searchsorted`` against the cut points, so band
    ``k`` is ``[bands[k-1], bands[k])`` and the top band is unbounded."""
    return np.searchsorted(
        np.asarray(bands, dtype=np.float64),
        np.asarray(scores, dtype=np.float64),
        side="right",
    )


def band_labels(bands: Sequence[float] = DEFAULT_PD_BANDS) -> list[str]:
    edges = [f"{100.0 * b:g}%" for b in bands]
    labels = [f"<{edges[0]}"]
    labels += [f"{edges[i]}-{edges[i + 1]}" for i in range(len(edges) - 1)]
    labels.append(f">={edges[-1]}")
    return labels


def delta_stats(
    baseline: np.ndarray, scenario: np.ndarray
) -> dict[str, float]:
    """Distribution of per-loan PD shifts under the scenario."""
    deltas = np.asarray(scenario, np.float64) - np.asarray(
        baseline, np.float64
    )
    return {
        "mean": float(deltas.mean()),
        "p50": float(np.percentile(deltas, 50)),
        "p95": float(np.percentile(deltas, 95)),
        "max": float(deltas.max()),
        "min": float(deltas.min()),
        "mean_abs": float(np.abs(deltas).mean()),
    }


def band_migration(
    baseline: np.ndarray,
    scenario: np.ndarray,
    bands: Sequence[float] = DEFAULT_PD_BANDS,
) -> dict[str, Any]:
    """PD-band transition counts: ``matrix[i][j]`` is loans that moved from
    baseline band ``i`` to scenario band ``j``; ``downgraded`` counts rows
    whose band index *rose* (worse credit), ``upgraded`` the reverse."""
    n_bands = len(bands) + 1
    b = pd_band_index(baseline, bands)
    s = pd_band_index(scenario, bands)
    matrix = np.zeros((n_bands, n_bands), dtype=np.int64)
    np.add.at(matrix, (b, s), 1)
    return {
        "bands": [float(x) for x in bands],
        "labels": band_labels(bands),
        "matrix": matrix.tolist(),
        "downgraded": int((s > b).sum()),
        "upgraded": int((s < b).sum()),
        "unchanged": int((s == b).sum()),
    }


def shap_top_movers(
    scenario_phi_mean: np.ndarray,
    baseline_phi_mean: np.ndarray,
    feature_names: Sequence[str],
    *,
    top_k: int = 8,
) -> list[dict[str, float | str]]:
    """Features ranked by how far their mean SHAP attribution moved under
    the scenario — "the stress loads onto these inputs"."""
    s = np.asarray(scenario_phi_mean, np.float64)
    b = np.asarray(baseline_phi_mean, np.float64)
    shift = s - b
    order = np.argsort(-np.abs(shift))[:top_k]
    return [
        {
            "feature": str(feature_names[j]),
            "mean_phi": float(s[j]),
            "baseline_mean_phi": float(b[j]),
            "shift": float(shift[j]),
        }
        for j in order
        if shift[j] != 0.0 or s[j] != 0.0
    ]


def scenario_drift(
    training_sketch: FeatureSketch,
    X_scenario: np.ndarray,
    feature_names: Sequence[str],
    perturbed: Sequence[str],
    *,
    alert: float = 0.25,
) -> dict[str, Any]:
    """PSI of each *perturbed* feature's scenario distribution against the
    training sketch. Features above ``alert`` land in ``ood_features`` —
    the report's "this stress point is extrapolation" warning."""
    index = {name: j for j, name in enumerate(feature_names)}
    sketch_index = {
        name: j for j, name in enumerate(training_sketch.feature_names)
    }
    scores: dict[str, float] = {}
    for name in perturbed:
        if name not in index or name not in sketch_index:
            continue
        col = np.asarray(X_scenario[:, index[name]], dtype=np.float64)
        edges = training_sketch.edges[sketch_index[name]]
        counts = np.zeros_like(training_sketch.counts[sketch_index[name]])
        finite = np.isfinite(col)
        idx = np.searchsorted(edges, col[finite], side="right")
        np.add.at(counts, idx, 1)
        counts[-1] += int((~finite).sum())
        scores[name] = round(
            psi(training_sketch.counts[sketch_index[name]], counts), 6
        )
    flagged = sorted(n for n, v in scores.items() if v > alert)
    return {
        "psi": scores,
        "psi_alert": float(alert),
        "ood_features": flagged,
        "ood": bool(flagged),
    }


def write_report(
    store: Any,
    run_prefix: str,
    report: Mapping[str, Any],
) -> str:
    """Land the scenario report at ``<run_prefix>report.json``."""
    key = f"{run_prefix}report.json"
    store.put_json(key, dict(report))
    return key
