"""The UI layer — a Streamlit front-end over the serving API.

`core` holds every piece of UI data logic (payload assembly with alias
renames, the SHAP-waterfall computation, bulk result coercion, the API
client) as plain testable functions, with neither pandas nor ``requests``;
`app` is the Streamlit render shell.
"""

from cobalt_smart_lender_ai_tpu_torch.ui.core import (
    ApiClient,
    ServiceDegraded,
    Waterfall,
    build_single_payload,
    build_waterfall,
    coerce_results_frame,
    importance_series,
    render_waterfall,
    results_row_payload,
)

__all__ = [
    "ApiClient",
    "ServiceDegraded",
    "Waterfall",
    "build_single_payload",
    "build_waterfall",
    "coerce_results_frame",
    "importance_series",
    "render_waterfall",
    "results_row_payload",
]
