"""Serving: the scoring service, its asyncio HTTP server and the CLI."""

from cobalt_smart_lender_ai_tpu_torch.serve.service import (
    MicroBatcher,
    ScorerService,
    validate_single_input,
)

__all__ = ["MicroBatcher", "ScorerService", "validate_single_input"]
