"""Command-line tools of the port: the retrain driver (`tools.retrain`), the
model registry's garbage collector (`tools.registry_gc`), the portfolio
stress sweep (`tools.score_portfolio`) and the run-ledger renderer
(`tools.obs_report`), run as
``python -m cobalt_smart_lender_ai_tpu_torch.tools.<name>``."""
