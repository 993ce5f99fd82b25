"""PyTorch/CUDA port of the credit-risk scoring service and its GBDT trainer.

The JAX package (``cobalt_smart_lender_ai_tpu``) is the reference this port
is held against; nothing here imports it or JAX. Module names mirror the
reference so each file's counterpart is easy to find:

- `data` — the raw LendingClub table without pandas (`data.frame.RawFrame`,
  `data.synthetic`), the host tokenizer and the device ingest
  (`data.device_pipeline`: clean, engineer and bin as torch on the device,
  and the raw-row transform of serving), the hashed split, the schema;
- `models.gbdt` — the tensorized `Forest`, its fit (`GBDTClassifier`,
  `fit_binned*`), `predict_margin`, gain importances;
- `ops.binning` — quantile bin edges and bins, bit-identical to the
  reference's;
- `ops.histogram` — the gradient-histogram kernel's wrapper
  (`gradient_histogram_channels`) and its plain version; the kernel is
  ``csrc/gradient_histogram.cu``;
- `ops.metrics` — ``roc_auc`` and the classification report;
- `explain.treeshap` — path-dependent TreeSHAP as plain PyTorch;
- `ops.score` — the fused scoring kernels' wrapper (`fused_score`), its plain
  version, its launch plan and the packed forest; the kernels (a walk with
  TreeSHAP, then a finalize that sums in tree order) are
  ``csrc/score_forest.cu``; both sources are built by `ops._build`;
- `io` — the object store and the ``.npz`` model artifact with its feature
  plan (read and write);
- `device` — the device rule every entry point follows;
- `serve` — the micro-batching `ScorerService` (with raw-row scoring,
  `predict_raw`), the asyncio HTTP server and
  the ``python -m cobalt_smart_lender_ai_tpu_torch.serve`` CLI.

Entry points run on the CUDA device unless the caller asks for ``cpu``,
where every kernel is replaced by its plain PyTorch version.
"""

from cobalt_smart_lender_ai_tpu_torch.version import __version__

__all__ = ["__version__"]
