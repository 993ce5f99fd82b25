"""Command-line tools of the port: the retrain driver (`tools.retrain`) and
the model registry's garbage collector (`tools.registry_gc`), run as
``python -m cobalt_smart_lender_ai_tpu_torch.tools.<name>``."""
