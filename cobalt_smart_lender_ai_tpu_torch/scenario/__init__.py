"""Portfolio & stress scenarios: offline batch scoring on one card (the
README's "Portfolio & stress scenarios", the reference's ``scenario``
package).

The serving stack answers "score this applicant now"; this package answers
the risk-review question "what happens to the *whole book* under stress":

- `grid`: the `ScenarioGrid` counterfactual DSL (rate shocks, income/DTI
  multipliers, arbitrary per-feature deltas, cross-product stress grids)
  with deterministic expansion ordering;
- `engine`: `PortfolioScorer`, chunked scoring through the fused scoring
  kernel with chunk-level checkpoint/resume (kill after K chunks, resume,
  bit-identical scores), one launch per chunk;
- `report`: pure reducers (PD deltas, band-migration matrices, SHAP
  movers, PSI OOD flags) and the JSON report writer.

Surfaced as ``python -m cobalt_smart_lender_ai_tpu_torch.tools.score_portfolio``.
"""

from cobalt_smart_lender_ai_tpu_torch.scenario.engine import (
    PortfolioInterrupted,
    PortfolioScorer,
    load_portfolio,
)
from cobalt_smart_lender_ai_tpu_torch.scenario.grid import (
    BASELINE,
    Perturbation,
    Scenario,
    ScenarioAxis,
    ScenarioGrid,
    feature_delta,
    feature_multiplier,
    feature_set,
)
from cobalt_smart_lender_ai_tpu_torch.scenario.report import (
    DEFAULT_PD_BANDS,
    band_labels,
    band_migration,
    delta_stats,
    pd_band_index,
    scenario_drift,
    shap_top_movers,
    write_report,
)

__all__ = [
    "BASELINE",
    "DEFAULT_PD_BANDS",
    "Perturbation",
    "PortfolioInterrupted",
    "PortfolioScorer",
    "Scenario",
    "ScenarioAxis",
    "ScenarioGrid",
    "band_labels",
    "band_migration",
    "delta_stats",
    "feature_delta",
    "feature_multiplier",
    "feature_set",
    "load_portfolio",
    "pd_band_index",
    "scenario_drift",
    "shap_top_movers",
    "write_report",
]
