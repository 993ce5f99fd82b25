"""Streamlit shell over `ui.core` (the port's copy of the reference's
``ui/app.py``).

Run with::

    streamlit run cobalt_smart_lender_ai_tpu_torch/ui/app.py --server.port=8001

Two modes, matching the reference sidebar radio: a single-borrower form (12
numeric inputs + 4 indicator checkboxes + hardship selectbox) posting to
``/predict`` and rendering the SHAP waterfall, and a bulk CSV upload posting
to ``/predict_bulk_csv`` with a results table, download button, and top-10
gain-importance bar chart. All data logic lives in `core`; this module only
draws. `streamlit` and `matplotlib` are optional — both imports are
deferred into `main`, so the package imports cleanly without them.

The API base URL comes from the ``API_URL`` env var (docker-compose wires
``http://api:8000``), defaulting to localhost for bare-metal runs. Bulk
results are a `core` results frame (float64 columns by name).
"""

from __future__ import annotations

import hashlib
import os

from cobalt_smart_lender_ai_tpu_torch.ui import core


def main() -> None:
    try:
        import streamlit as st
    except ImportError as e:  # pragma: no cover - exercised only without extra
        raise ImportError("The UI needs streamlit (pip install streamlit)") from e
    import matplotlib.pyplot as plt

    client = core.ApiClient(os.environ.get("API_URL", "http://localhost:8000"))

    st.set_page_config(page_title="Cobalt Loan Default Prediction", layout="wide")
    st.title("Loan Default Risk Predictor")
    menu = st.sidebar.radio(
        "Select Mode", ["Single Prediction", "Bulk Prediction + SHAP"]
    )

    if menu == "Single Prediction":
        st.subheader("Enter loan details for a single borrower")
        col1, col2 = st.columns(2)
        numeric: dict[str, float] = {}
        checkboxes: dict[str, bool] = {}
        with col1:
            for field, label, default in core.NUMERIC_INPUTS[:7]:
                if field == "term":
                    numeric[field] = st.selectbox(label, [36, 60], index=0)
                else:
                    numeric[field] = st.number_input(label, value=default)
        with col2:
            for field, label, default in core.NUMERIC_INPUTS[7:]:
                numeric[field] = st.number_input(label, value=default)
            for field, label in core.CHECKBOX_INPUTS:
                checkboxes[field] = st.checkbox(label)
            hardship = st.selectbox("Hardship Status", list(core.HARDSHIP_OPTIONS))

        if st.button("Predict Default Risk"):
            try:
                payload = core.build_single_payload(numeric, checkboxes, hardship)
                resp = client.predict(payload)
                st.success(
                    f"Estimated Default Probability: {resp['prob_default']:.2%}"
                )
                st.subheader("SHAP Explanation")
                wf = core.build_waterfall(resp, max_display=10)
                fig, ax = plt.subplots(figsize=(10, 6))
                core.render_waterfall(ax, wf)
                plt.tight_layout()
                st.pyplot(fig)
            except core.ServiceDegraded as e:
                # Operational backpressure (shed / breaker open / deadline),
                # not a user mistake — warn, don't stack-trace.
                st.warning(str(e))
            except Exception as e:
                st.error(f"Error during prediction: {e}")

    else:
        st.subheader("Upload CSV for Bulk Inference")
        uploaded = st.file_uploader("Upload CSV with required columns", type="csv")
        # Cached results belong to exactly one upload: replacing or removing
        # the file must drop them, or the page would keep rendering the
        # previous file's predictions under the new upload. Streamlit's
        # UploadedFile carries a stable per-upload file_id; fall back to a
        # content hash for harnesses (and streamlits) without one — that path
        # re-hashes the file each rerun, so prefer file_id when present.
        if uploaded is None:
            upload_key = None
        else:
            uid = getattr(uploaded, "file_id", None)
            if uid is None:
                uid = hashlib.md5(uploaded.getvalue()).hexdigest()
            upload_key = f"{uploaded.name}:{uid}"
        if st.session_state.get("bulk_upload_key") != upload_key:
            st.session_state.pop("bulk_results", None)
            st.session_state.pop("bulk_importance", None)
            st.session_state["bulk_upload_key"] = upload_key
        if uploaded and st.button("Run Bulk Prediction"):
            try:
                st.session_state["bulk_results"] = client.predict_bulk_csv(
                    uploaded.name, uploaded.getvalue()
                )
            except core.ServiceDegraded as e:
                st.session_state.pop("bulk_results", None)
                st.warning(str(e))
            except Exception as e:
                st.session_state.pop("bulk_results", None)
                st.error(f"Prediction failed: {e}")
            else:
                # Importance is fetched once per run, not per rerun: the
                # explorer's widgets retrigger the whole script, and
                # re-posting every record to /feature_importance_bulk on each
                # interaction would recompute bulk importances per keystroke.
                # Its failure must not discard the successful predictions —
                # the chart is simply skipped.
                try:
                    st.session_state["bulk_importance"] = (
                        client.feature_importance_bulk(
                            st.session_state["bulk_results"]
                        )
                    )
                except Exception as e:
                    st.session_state.pop("bulk_importance", None)
                    st.error(f"Feature importance unavailable: {e}")
        # Results live in session_state so the explorer's widgets survive
        # Streamlit's rerun-on-interaction (the button is only True on the
        # run it was clicked).
        records = st.session_state.get("bulk_results")
        if records is not None:
            try:
                df_result = core.coerce_results_frame(records)
                st.subheader("Prediction Results")
                st.dataframe(df_result)
                st.download_button(
                    "Download Results",
                    core.results_csv(df_result),
                    "bulk_predictions.csv",
                )
                importance = st.session_state.get("bulk_importance")
                if importance is not None:
                    st.subheader("Feature Importance (Top 10)")
                    imp = core.importance_series(importance)
                    fig, ax = plt.subplots()
                    ax.barh([n for n, _ in imp][::-1], [v for _, v in imp][::-1])
                    ax.set_xlabel("Importance (gain)")
                    ax.set_title("Top 10 Important Features")
                    st.pyplot(fig)

                # Per-row SHAP explorer — the notebook's row-slider force
                # plots, served live: pick a row, re-post it to /predict,
                # waterfall it.
                n_rows = core.frame_rows(df_result)
                if n_rows:
                    st.subheader("Per-row SHAP Explorer")
                    row_idx = int(
                        st.number_input(
                            "Row to explain",
                            min_value=0,
                            max_value=n_rows - 1,
                            value=0,
                            step=1,
                        )
                    )
                    try:
                        row_resp = client.predict(
                            core.results_row_payload(df_result, row_idx)
                        )
                        st.caption(
                            f"Row {row_idx}: estimated default probability "
                            f"{row_resp['prob_default']:.2%}"
                        )
                        wf = core.build_waterfall(row_resp, max_display=10)
                        fig, ax = plt.subplots(figsize=(10, 6))
                        core.render_waterfall(ax, wf)
                        plt.tight_layout()
                        st.pyplot(fig)
                    except Exception as e:
                        st.info(f"Row explanation unavailable: {e}")
            except Exception as e:
                st.error(f"Rendering results failed: {e}")


if __name__ == "__main__":
    main()
