"""Command-line tools of the port: the retrain driver (`tools.retrain`), the
model registry's garbage collector (`tools.registry_gc`), the portfolio
stress sweep (`tools.score_portfolio`), the run-ledger renderer
(`tools.obs_report`), the servable model's trainer (`tools.train_artifact`),
the event journal's postmortem (`tools.incident_report`), the protocol's
parity head-to-head against a scikit-learn oracle (`tools.parity`) and the
trend gate (`tools.perf_sentinel`), run as
``python -m cobalt_smart_lender_ai_tpu_torch.tools.<name>``."""
