"""PyTorch/CUDA port of the credit-risk scoring service.

The JAX package (``cobalt_smart_lender_ai_tpu``) is the reference this port
is held against; nothing here imports it or JAX. Module names mirror the
reference so each file's counterpart is easy to find:

- `models.gbdt` — the tensorized `Forest`, `predict_margin`, gain importances;
- `explain.treeshap` — path-dependent TreeSHAP as plain PyTorch;
- `ops.score` — the fused scoring kernel's wrapper (`fused_score`), its plain
  version and the packed forest; the kernel itself is
  ``csrc/score_forest.cu``, built by `ops._build`;
- `io` — the object store and the ``.npz`` model artifact;
- `serve` — the micro-batching `ScorerService`, the asyncio HTTP server and
  the ``python -m cobalt_smart_lender_ai_tpu_torch.serve`` CLI.

Entry points run on the CUDA device unless the caller asks for ``cpu``,
where every kernel is replaced by its plain PyTorch version.
"""

__version__ = "0.1.0"
