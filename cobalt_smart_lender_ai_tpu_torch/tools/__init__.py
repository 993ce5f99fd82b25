"""Command-line tools of the port: the retrain driver (`tools.retrain`), the
model registry's garbage collector (`tools.registry_gc`), the portfolio
stress sweep (`tools.score_portfolio`), the run-ledger renderer
(`tools.obs_report`), the servable model's trainer (`tools.train_artifact`),
the event journal's postmortem (`tools.incident_report`), the protocol's
parity head-to-head against a scikit-learn oracle (`tools.parity`), the
trend gate (`tools.perf_sentinel`) and the measurement harnesses that write
the records it reads: the serving benchmarks (`tools.bench_serve`: the
closed loop, the async HTTP grid, the chaos and traffic fleets, bulk
scoring), the full-table fit and the whole protocol (`tools.bench`), the
scoring kernel against its plain pair (`tools.bench_kernels`), halving
against the exhaustive search (`tools.bench_search`), host against device
ingest (`tools.bench_pipeline`) and the challenger families
(`tools.bench_models`), with what they share in `tools.bench_common`; run
as ``python -m cobalt_smart_lender_ai_tpu_torch.tools.<name>``."""
